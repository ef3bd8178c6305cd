"""Appearance models: the DeepSORT CNN and OSNet (port of
yolov7_tracker_tpu/reid), with their checkpoint rules and seeded
weights."""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .osnet import OSNET_CONFIGS

DEEPSORT_CROP_HW = (128, 64)     # deepsort_reid.py:123-146
OSNET_CROP_HW = (128, 256)       # strongsort.py:56-58 quirk


def build_reid(name: str) -> Tuple[nn.Module, Tuple[int, int]]:
    """(model, crop (h, w)) for "deepsort_cnn" or an OSNet name."""
    if name == "deepsort_cnn":
        from .deepsort_cnn import DeepSortCNN

        return DeepSortCNN(), DEEPSORT_CROP_HW
    if name not in OSNET_CONFIGS:
        raise ValueError(f"unknown ReID model {name!r}; have deepsort_cnn, "
                         f"{', '.join(OSNET_CONFIGS)}")
    from .osnet import build_osnet

    return build_osnet(name), OSNET_CROP_HW


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls while inside,
    whatever the process had set, and restored after. The ReID models run
    in float32, as the JAX package's do; PyTorch's own default lets cuDNN
    convolutions round their inputs to TF32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def random_reid_state_dict(model: nn.Module, seed: int = 0
                           ) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``model`` from numpy: lecun-normal kernels,
    biases near 0, random BN affine terms and statistics, so that
    untrained embeddings still tell crops apart."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.long)
            continue
        if leaf == "weight" and len(shape) > 1:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf == "weight":
            x = rng.uniform(0.8, 1.2, shape)
        elif leaf == "running_mean":
            x = rng.normal(0.0, 0.1, shape)
        elif leaf == "running_var":
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = rng.normal(0.0, 0.05, shape)
        out[name] = torch.from_numpy(x.astype(np.float32))
    return out


def load_reid_state_dict(model: nn.Module, sd) -> nn.Module:
    """Load a torchreid / reference checkpoint the way the reference's
    load_pretrained_weights does: strip ``module.``, keep the entries whose
    name and shape the model has, leave the rest of the model as it is.
    Raises if nothing matches (the wrong file)."""
    own = model.state_dict()
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    matched = {k: torch.as_tensor(v) for k, v in sd.items()
               if k in own and tuple(own[k].shape) == tuple(v.shape)}
    if not matched:
        raise ValueError("no entry of the checkpoint matches the ReID model")
    if len(matched) < len(own):
        warnings.warn(f"ReID checkpoint: {len(own) - len(matched)} of the "
                      f"model's {len(own)} entries not in it; "
                      f"{len(sd) - len(matched)} of its entries discarded",
                      stacklevel=2)
    model.load_state_dict({**own, **matched})
    return model


def resolve_reid(tracker: str, path: str
                 ) -> Tuple[str, Optional[Dict[str, torch.Tensor]]]:
    """(tracker name, --reid_model_path) -> (ReID model name, state_dict):
    OSNet of the width the file name gives (``osnet_x1_0_msmt17.pth``);
    a file name that gives none means deepsort's CNN (the reference's
    ckpt.t7 ``net_dict``) for deepsort and osnet_x0_25 (the checkpoint
    the reference ships) for every other tracker. DeepSORT with a
    torchreid OSNet is the Yolov5_DeepSort_OSNet deployment. Takes torch
    checkpoints (.pth, .pt, .t7)."""
    if not path:
        return "none", None
    base = os.path.basename(path)
    name = next((n for n in OSNET_CONFIGS if n in base),
                "deepsort_cnn" if tracker == "deepsort" else "osnet_x0_25")
    if not path.endswith((".pth", ".pt", ".t7")):
        raise ValueError(f"{path}: the port reads torch ReID checkpoints "
                         "(.pth, .pt, .t7)")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return name, ckpt.get("net_dict", ckpt.get("state_dict", ckpt))
