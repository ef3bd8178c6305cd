"""W8A8 static post-training quantization of the fused detector (port of
yolov7_tracker_tpu/models/quant.py).

The scheme is the JAX package's:

- weights: symmetric int8 per output channel, scale absmax / 127 (the
  port's kernels are OIHW, so the absmax runs over dims 1, 2, 3), rounded
  half to even with the same float32 division, on the host in numpy as
  JAX does it;
- activations: one static per-tensor scale per conv, absmax / 127 of its
  input over the calibration batches, taken with forward pre-hooks on
  every ConvBnAct and RepConv outside the heads of the float32 fused
  model (JAX's folded ReOrg stem records the raw image, the port the
  ReOrg output: the same values, permuted);
- the heads (``head*``) and every block that is not a plain ConvBnAct or
  RepConv stay float.

``quantize_state_dict`` turns a ``fuse_state_dict`` output into the state
of ``YoloV7(spec, fused="int8")`` (blocks.QuantConv buffers). Synthetic
calibration (``default_calib_batches``) makes the mode a performance
measurement, not an accuracy claim: calibrate on real frames, as
cli/track.py --quant int8 does, before serving.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.letterbox import resize_linear
from . import blocks
from .spec import ModelSpec
from .yolo import YoloV7

_EPS = 1e-12


def quant_targets(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """{module name: module} of the ConvBnAct and RepConv modules outside
    the heads (JAX quant._is_quant_target), e.g. ``layer5.cv1``."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, (blocks.ConvBnAct, blocks.RepConv))
            and not name.startswith("head")}


@torch.no_grad()
def calibrate(spec: ModelSpec, fused_state_dict: Dict[str, torch.Tensor],
              batches: List, device=None) -> Dict[str, float]:
    """{module name: max |input|} of every quantization target over the
    calibration ``batches`` ((B, H, W, 3) float images in [0, 1]), from
    the float32 fused model on ``device`` (None: the card). Every layer
    runs, the auxiliary heads' inputs too, as in the JAX module."""
    device = resolve_device(device)
    model = YoloV7(spec, fused=True)
    model.load_state_dict(fused_state_dict)
    model = model.to(device, torch.float32).eval()
    amax: Dict[str, torch.Tensor] = {}

    def record(name):
        def hook(_, args):
            v = args[0].abs().amax().float()
            amax[name] = v if name not in amax else torch.maximum(
                amax[name], v)
        return hook

    hooks = [m.register_forward_pre_hook(record(name))
             for name, m in quant_targets(model).items()]
    try:
        for b in batches:
            if not isinstance(b, torch.Tensor):
                b = torch.from_numpy(np.array(b, np.float32))
            model(b.to(device, torch.float32), every_layer=True)
    finally:
        for h in hooks:
            h.remove()
    return {name: float(v) for name, v in amax.items()}


def default_calib_batches(rng: np.random.Generator, n: int = 2,
                          batch: int = 1, size: int = 384
                          ) -> List[torch.Tensor]:
    """Synthetic calibration images (JAX quant.py:87-101): uniform noise
    on a (size / 16)^2 grid, bilinearly upsampled (jax.image.resize's
    weights, data/letterbox.resize_linear) and clipped to [0, 1], float32
    on the host."""
    out = []
    for _ in range(n):
        coarse = torch.from_numpy(rng.uniform(
            0.0, 1.0, (batch, size // 16, size // 16, 3)).astype(np.float32))
        out.append(torch.clamp(resize_linear(coarse, size, size,
                                             antialias=True), 0.0, 1.0))
    return out


def quantize_conv(weight: torch.Tensor, bias: torch.Tensor, amax: float
                  ) -> Dict[str, torch.Tensor]:
    """A fused conv's float32 (c2, c1/g, k, k) kernel and bias, and its
    input's absmax -> the QuantConv buffers (JAX quant._quantize_conv, in
    numpy on the host, so both packages round the same float32
    quotients)."""
    k = weight.detach().cpu().numpy().astype(np.float32)
    w_scale = np.maximum(np.max(np.abs(k), axis=(1, 2, 3)), _EPS) / 127.0
    qk = np.clip(np.round(k / w_scale[:, None, None, None]), -127, 127)
    return {"weight": torch.from_numpy(qk.astype(np.int8)),
            "w_scale": torch.from_numpy(w_scale.astype(np.float32)),
            "bias": bias.detach().cpu().float().clone(),
            "a_scale": torch.tensor(np.float32(max(amax, _EPS) / 127.0))}


def quantize_state_dict(spec: ModelSpec,
                        fused_state_dict: Dict[str, torch.Tensor],
                        calib_batches: Optional[List] = None,
                        absmax: Optional[Dict[str, float]] = None,
                        device=None) -> Dict[str, torch.Tensor]:
    """``fuse_state_dict`` output -> the state_dict of ``YoloV7(spec,
    fused="int8")``. Pass ``absmax`` (``calibrate``'s, or the JAX
    package's with its module paths joined by dots) or ``calib_batches``
    (calibrated on ``device``); with neither, synthetic batches
    (``default_calib_batches``) are used."""
    if absmax is None:
        if calib_batches is None:
            calib_batches = default_calib_batches(np.random.default_rng(0))
        absmax = calibrate(spec, fused_state_dict, calib_batches, device)
    with torch.device("meta"):
        qmodel = YoloV7(spec, fused=blocks.INT8)
    out = dict(fused_state_dict)
    for name, m in quant_targets(qmodel).items():
        if name not in absmax:
            raise KeyError(f"{name}: no calibrated absmax")
        conv = f"{name}.rbr_reparam" if isinstance(
            m, blocks.RepConv) else f"{name}.conv"
        q = quantize_conv(fused_state_dict[f"{conv}.weight"],
                          fused_state_dict[f"{conv}.bias"], absmax[name])
        out.update({f"{conv}.{leaf}": v for leaf, v in q.items()})
    return out
