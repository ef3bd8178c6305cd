"""YOLOv7 detector as a torch nn.Module built from a ModelSpec (port of
yolov7_tracker_tpu/models/yolo.py, inference path).

The forward pass replays the spec's layer DAG like the JAX module and
returns the RAW lead head levels, each (B, ny, nx, na, no) pre-sigmoid,
which is what the pipeline's score-first NMS consumes. Input is the JAX
layout (B, H, W, 3) in [0, 1]; inside, tensors are NCHW. Layers that feed
only IAuxDetect's auxiliary heads are skipped: at inference the JAX
module computes them and then drops their outputs (yolo.py:430-432), so
the lead outputs are the same either way. Module and parameter names
follow the Flax tree (``layer{i}``, ``head_m_{i}``, ``head_ia_{i}`` ...),
which keeps the weight bridge (models/from_jax.py) a renaming.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from . import blocks
from .spec import ModelSpec

HEAD_KINDS = ("Detect", "IDetect", "IAuxDetect")
_IMPLICIT_HEADS = ("IDetect", "IAuxDetect")


class ImplicitA(nn.Module):
    """Learned additive embedding (models/common.py:433-443)."""

    def __init__(self, c: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return x + self.implicit[None, :, None, None]


class ImplicitM(nn.Module):
    """Learned multiplicative embedding (models/common.py:446-457)."""

    def __init__(self, c: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.ones(c))

    def forward(self, x):
        return x * self.implicit[None, :, None, None]


def _in_channels(spec: ModelSpec, layer) -> int:
    return spec.layers[layer.frm[0]].c_out if layer.index > 0 else 3


class YoloV7(nn.Module):
    def __init__(self, spec: ModelSpec, fused: bool = False):
        super().__init__()
        if spec.head_kind not in HEAD_KINDS:
            raise NotImplementedError(
                f"head {spec.head_kind!r} is not ported yet")
        self.spec = spec
        self.fused = fused
        head = spec.layers[-1]
        self._head_from = head.frm
        # layers the lead heads depend on (aux-head-only layers are skipped)
        needed = set(x for x in head.frm[:spec.nl] if x >= 0)
        for l in reversed(spec.layers[:-1]):
            if l.index in needed:
                needed.update(x for x in l.frm if x >= 0)
        self._needed = needed
        for l in spec.layers[:-1]:
            name = f"layer{l.index}"
            c1 = _in_channels(spec, l)
            if l.kind == "Conv":
                k, s, g, act, p = l.args
                self.add_module(name, blocks.ConvBnAct(
                    c1, l.c_out, k, s, g, act, fused=fused, p=p))
            elif l.kind == "SPPCSPC":
                self.add_module(name, blocks.SPPCSPC(c1, l.c_out,
                                                     fused=fused))
            elif l.kind not in ("MP", "SP", "ReOrg", "Upsample", "Concat"):
                raise NotImplementedError(
                    f"layer {l.index}: {l.kind!r} is not ported yet")
        na, no = spec.na, spec.no
        for i, src in enumerate(head.frm):
            c = spec.layers[src].c_out
            self.add_module(
                f"head_m{'2' if i >= spec.nl else ''}_{i % spec.nl}",
                nn.Conv2d(c, na * no, 1, bias=True))
            if i < spec.nl and spec.head_kind in _IMPLICIT_HEADS and not fused:
                self.add_module(f"head_ia_{i}", ImplicitA(c))
                self.add_module(f"head_im_{i}", ImplicitM(na * no))

    def forward(self, x) -> List[torch.Tensor]:
        """x: (B, H, W, 3) in [0, 1] -> nl raw levels (B, ny, nx, na, no)."""
        spec = self.spec
        x = x.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        saved = {}
        y = x
        for l in spec.layers[:-1]:
            if l.index not in self._needed:
                continue
            inp = x if l.index == 0 else (
                y if l.frm[0] == l.index - 1 else saved[l.frm[0]])
            if l.kind in ("Conv", "SPPCSPC"):
                y = getattr(self, f"layer{l.index}")(inp)
            elif l.kind == "MP":
                y = blocks.mp(inp, l.args[0])
            elif l.kind == "SP":
                y = blocks.sp(inp, *l.args)
            elif l.kind == "ReOrg":
                y = blocks.reorg(inp)
            elif l.kind == "Upsample":
                y = blocks.upsample_nearest(inp, l.args[0])
            else:  # Concat
                y = torch.cat([y if i == l.index - 1 else saved[i]
                               for i in l.frm], dim=1)
            if l.index in spec.save:
                saved[l.index] = y
        raw = []
        for i in range(spec.nl):
            src = self._head_from[i]
            feat = saved[src] if src in saved else y
            if hasattr(self, f"head_ia_{i}"):
                feat = getattr(self, f"head_ia_{i}")(feat)
            p = getattr(self, f"head_m_{i}")(feat)
            if hasattr(self, f"head_im_{i}"):
                p = getattr(self, f"head_im_{i}")(p)
            b, _, ny, nx = p.shape
            raw.append(p.permute(0, 2, 3, 1).reshape(b, ny, nx, spec.na,
                                                     spec.no))
        return raw


def init_head_biases(state_dict, spec: ModelSpec) -> None:
    """Detection-head bias prior (models/yolo.py:353-368): obj
    log(8 / (640/stride)^2), cls log(0.6 / (nc - 0.99)). In place."""
    nl, na, nc = spec.nl, spec.na, spec.nc
    for i in range(len(spec.layers[-1].frm)):
        key = f"head_m{'2' if i >= nl else ''}_{i % nl}.bias"
        b = state_dict[key].view(na, spec.no)
        b[:, 4] += math.log(8.0 / (640.0 / float(spec.strides[i % nl])) ** 2)
        b[:, 5:] += math.log(0.6 / (nc - 0.99))


def random_state_dict(spec: ModelSpec, seed: int = 0, gain: float = 1.0):
    """Seeded random weights in the unfused layout: Flax-style lecun-normal
    conv kernels (truncated at 2 std), zero conv biases, identity BN
    statistics, implicit vectors around 0 and 1, and the head bias prior.
    ``gain`` scales the std of every conv kernel below the head: at 1.0 the
    signal of a deep model (yolov7-w6) dies out through its SiLU layers and
    the heads emit their biases whatever the image shows."""
    g = torch.Generator().manual_seed(seed)
    model = YoloV7(spec, fused=False)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.endswith("weight") and v.dim() == 4:
            std = math.sqrt(1.0 / (v[0].numel())) / 0.87962566103423978
            if not k.startswith("head_m"):
                std *= gain
            nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std, generator=g)
        elif k.endswith("implicit"):
            base = 0.0 if k.startswith("head_ia") else 1.0
            v.copy_(base + 0.02 * torch.randn(v.shape, generator=g))
        elif k.endswith(".bias") and k.startswith("head_m"):
            v.zero_()
    init_head_biases(sd, spec)
    return sd


def sharpen_heads(state_dict, spec: ModelSpec, seed: int = 1,
                  sharpen: float = 8.0, obj_boost: float = 6.0,
                  jitter: float = 3.0) -> None:
    """Spread random-init scores so NMS keeps a realistic detection load
    (bench.py:46-72): scale the head kernels, raise the objectness and
    class logits, jitter the class logits per anchor. In place, unfused
    layout."""
    g = torch.Generator().manual_seed(seed)
    for i in range(len(spec.layers[-1].frm)):
        name = f"head_m{'2' if i >= spec.nl else ''}_{i % spec.nl}"
        state_dict[f"{name}.weight"].mul_(sharpen)
        b = state_dict[f"{name}.bias"].view(spec.na, spec.no)
        b[:, 4] += obj_boost
        b[:, 5:] += obj_boost + jitter * (
            2.0 * torch.rand((spec.na, spec.no - 5), generator=g) - 1.0)
