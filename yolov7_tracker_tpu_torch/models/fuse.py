"""BN, RepConv and implicit-head folding for inference (port of
yolov7_tracker_tpu/models/fuse.py), on state_dicts.

``fuse_state_dict`` turns an unfused state_dict (as from_jax produces it)
into the one ``YoloV7(spec, fused=True)`` loads: each Conv+BN becomes one
biased conv; each RepConv becomes one biased 3x3 ``rbr_reparam``, the sum
of its dense branch, its 1x1 branch padded to 3x3 and, where it has one,
its identity branch as a 3x3 identity kernel through its BN (the
reference's fuse_repvgg_block); and IDetect's ImplicitA/ImplicitM fold
into the lead head convs (``im * conv(x + ia)`` == a 1x1 conv with kernel
k*im and bias (b + k.ia)*im), IAuxDetect's and IBin's alike: the fold is
keyed by the ``head_ia_{i}`` names.

What JAX's ``_fuse_node`` does not fold stays as it is here: RepConv_OREPA
(its BNs have no ``conv`` beside them, and the block has no fused form),
CrossConv's ``cv{1,2}_bn`` and MixConv2d's ``bn``. JAX's fuse_variables
then drops every BN statistic, so its fused OREPA model cannot run; the
port keeps those statistics, and its fused model runs the block in its
training form.
"""

from __future__ import annotations

import re
from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def _fold(kernel, sd, bn):
    """A conv kernel (cout, cin/g, kh, kw) and the BN ``bn`` after it ->
    (kernel, bias) of the one biased conv."""
    scale = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + BN_EPS)
    return (kernel * scale[:, None, None, None],
            sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * scale)


def _pop_bn(out, bn):
    for leaf in _BN_LEAVES:
        out.pop(f"{bn}.{leaf}", None)


def fuse_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(sd)
    for key in [k for k in sd if k.endswith(".bn.weight")]:
        prefix = key[:-len(".bn.weight")]
        if f"{prefix}.conv.weight" not in sd:
            continue            # a BN with no conv beside it: OREPA's
        out[f"{prefix}.conv.weight"], out[f"{prefix}.conv.bias"] = _fold(
            sd[f"{prefix}.conv.weight"], sd, f"{prefix}.bn")
        _pop_bn(out, f"{prefix}.bn")
    for key in [k for k in sd if k.endswith(".rbr_dense_conv.weight")]:
        p = key[:-len(".rbr_dense_conv.weight")]
        k, b = _fold(sd[key], sd, f"{p}.rbr_dense_bn")
        k1, b1 = _fold(sd[f"{p}.rbr_1x1_conv.weight"], sd, f"{p}.rbr_1x1_bn")
        k, b = k + F.pad(k1, (1, 1, 1, 1)), b + b1
        if f"{p}.rbr_identity.weight" in sd:
            # output channel o reads input channel o, which is channel
            # o % (cin / g) of its group
            ident = torch.zeros_like(k)
            rows = torch.arange(k.shape[0])
            ident[rows, rows % k.shape[1], 1, 1] = 1.0
            ki, bi = _fold(ident, sd, f"{p}.rbr_identity")
            k, b = k + ki, b + bi
            _pop_bn(out, f"{p}.rbr_identity")
        for branch in ("rbr_dense", "rbr_1x1"):
            out.pop(f"{p}.{branch}_conv.weight")
            _pop_bn(out, f"{p}.{branch}_bn")
        out[f"{p}.rbr_reparam.weight"], out[f"{p}.rbr_reparam.bias"] = k, b
    for key in [k for k in sd if re.fullmatch(r"head_ia_\d+\.implicit", k)]:
        i = key.split("_")[2].split(".")[0]
        ia = out.pop(f"head_ia_{i}.implicit")
        im = out.pop(f"head_im_{i}.implicit")
        k = out[f"head_m_{i}.weight"]                # (cout, cin, 1, 1)
        b = out[f"head_m_{i}.bias"] + k[:, :, 0, 0] @ ia
        out[f"head_m_{i}.weight"] = k * im[:, None, None, None]
        out[f"head_m_{i}.bias"] = b * im
    return out
