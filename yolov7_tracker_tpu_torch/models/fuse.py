"""BN and implicit-head folding for inference (port of
yolov7_tracker_tpu/models/fuse.py), on state_dicts.

``fuse_state_dict`` turns an unfused state_dict (as from_jax produces it)
into the one ``YoloV7(spec, fused=True)`` loads: each Conv+BN becomes one
biased conv, and IDetect's ImplicitA/ImplicitM fold into the lead head
convs (``im * conv(x + ia)`` == a 1x1 conv with kernel k*im and bias
(b + k.ia)*im).
"""

from __future__ import annotations

import re
from typing import Dict

import torch

BN_EPS = 1e-5


def fuse_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(sd)
    for key in [k for k in sd if k.endswith(".bn.weight")]:
        prefix = key[:-len(".bn.weight")]
        scale = sd[f"{prefix}.bn.weight"] / torch.sqrt(
            sd[f"{prefix}.bn.running_var"] + BN_EPS)
        out[f"{prefix}.conv.weight"] = (
            sd[f"{prefix}.conv.weight"] * scale[:, None, None, None])
        out[f"{prefix}.conv.bias"] = (
            sd[f"{prefix}.bn.bias"] - sd[f"{prefix}.bn.running_mean"] * scale)
        for leaf in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            out.pop(f"{prefix}.bn.{leaf}", None)
    for key in [k for k in sd if re.fullmatch(r"head_ia_\d+\.implicit", k)]:
        i = key.split("_")[2].split(".")[0]
        ia = out.pop(f"head_ia_{i}.implicit")
        im = out.pop(f"head_im_{i}.implicit")
        k = out[f"head_m_{i}.weight"]                # (cout, cin, 1, 1)
        b = out[f"head_m_{i}.bias"] + k[:, :, 0, 0] @ ia
        out[f"head_m_{i}.weight"] = k * im[:, None, None, None]
        out[f"head_m_{i}.bias"] = b * im
    return out
