"""The detector zoo as a torch nn.Module built from a ModelSpec (port of
yolov7_tracker_tpu/models/yolo.py, inference path).

The forward pass replays the spec's layer DAG like the JAX module. The
anchor heads (Detect, IDetect, IAuxDetect, IBin) return the RAW lead head
levels, each (B, ny, nx, na, no) pre-sigmoid, which is what the
pipeline's score-first NMS consumes (IBin's, whose w and h are SigmoidBin
logits, through ``decode_levels`` and the plain NMS); the anchor-free
DetectV8 head returns its decoded (B, N, 5 + nc) predictions, which go
through the plain NMS.
Input is the JAX layout (B, H, W, 3) in [0, 1]; inside, tensors are NCHW.
Layers that feed only IAuxDetect's auxiliary heads are skipped: at
inference the JAX module computes them and then drops their outputs
(yolo.py:430-432), so the lead outputs are the same either way. The
training call (``forward(x, training=True)``, JAX yolo.py:292 with
training=True) computes every layer and returns every head's raw level:
nl, or 2 * nl for IAuxDetect (lead, then aux). Module
and parameter names follow the Flax tree (``layer{i}``, ``head_m_{i}``,
``head_ia_{i}``, ``head_cv2_{i}_{j}`` ...), which keeps the weight bridge
(models/from_jax.py) a renaming.
"""

from __future__ import annotations

import functools
import math
import re
from typing import List

import torch
from torch import nn

from . import blocks
from . import spec as spec_mod
from .ibin import sigmoid_bin_decode
from .spec import ModelSpec

HEAD_KINDS = ("Detect", "IDetect", "IAuxDetect", "IBin", "DetectV8")
_IMPLICIT_HEADS = ("IDetect", "IAuxDetect", "IBin")
_PLAIN_KINDS = ("MP", "SP", "ReOrg", "Upsample", "Concat", "Shortcut",
                "Contract", "Expand", "Chuncat", "Foldcut")
_STCSP_KINDS = ("STCSPA", "STCSPB", "STCSPC", "ST2CSPA", "ST2CSPB",
                "ST2CSPC")
# the biased output convs of the heads: what the bias prior and the head
# sharpening write, and what random_state_dict's gain leaves alone
_HEAD_OUT = re.compile(r"head_m2?_\d+\.|head_cv[23]_\d+_2\.")


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


def _layer_module(spec: ModelSpec, l, fused):
    """The nn.Module of one spec layer (JAX yolo.py:118-243), or None for
    the kinds without parameters."""
    c1, c2, a = _in_channels(spec, l), l.c_out, l.args
    if l.kind == "Conv":
        k, s, g, act, p = a
        return blocks.ConvBnAct(c1, c2, k, s, g, act, fused=fused, p=p)
    if l.kind == "DWConv":          # a Conv with groups gcd(c1, c2)
        return blocks.ConvBnAct(c1, c2, a[0], a[1], g=math.gcd(c1, c2),
                                fused=fused)
    if l.kind == "RepConv":
        return blocks.RepConv(c1, c2, a[1], fused=fused)
    if l.kind == "DownC":
        return blocks.DownC(c1, c2, a[0], fused=fused)
    if l.kind == "SPPCSPC":
        return blocks.SPPCSPC(c1, c2, fused=fused)
    if l.kind == "Bottleneck":
        return blocks.Bottleneck(c1, c2, n=a[0], shortcut=a[1], fused=fused)
    if l.kind in spec_mod.CSP_KINDS:
        variant, inner, sc, g, ie = spec_mod.CSP_KINDS[l.kind]
        return blocks.CSP(c1, c2, n=a[0], variant=variant, inner=inner,
                          shortcut=sc, g=g, inner_e=ie, fused=fused)
    if l.kind == "SPP":
        return blocks.SPP(c1, c2, k=a[0], fused=fused)
    if l.kind == "Stem":
        return blocks.Stem(c1, c2, fused=fused)
    if l.kind == "C3":
        return blocks.C3(c1, c2, n=a[0], shortcut=a[1], fused=fused)
    if l.kind == "C2f":
        return blocks.C2f(c1, c2, n=a[0], shortcut=a[1], fused=fused)
    if l.kind == "SPPF":
        return blocks.SPPF(c1, c2, k=a[0], fused=fused)
    if l.kind == "Focus":
        return blocks.Focus(c1, c2, k=a[0], s=a[1], fused=fused)
    if l.kind == "RepConv_OREPA":       # no fused form (JAX yolo.py:134)
        return blocks.RepConvOREPA(c1, c2, a[1])
    if l.kind == "RobustConv":
        return blocks.RobustConv(c1, c2, a[0], a[1], fused=fused)
    if l.kind == "RobustConv2":
        return blocks.RobustConv2(c1, c2, a[0], a[1], fused=fused)
    if l.kind == "GhostSPPCSPC":
        return blocks.GhostSPPCSPC(c1, c2, fused=fused)
    if l.kind == "GhostConv":
        return blocks.GhostConv(c1, c2, k=a[0], s=a[1], fused=fused)
    if l.kind == "Ghost":
        return blocks.Ghost(c1, c2, k=a[0], s=a[1], fused=fused)
    if l.kind in ("SwinTransformerBlock", "SwinTransformer2Block"):
        v2 = l.kind == "SwinTransformer2Block"
        return blocks.SwinBlock(c1, c2, a[0], a[1], ws=7 if v2 else 8,
                                v2=v2, fused=fused)
    if l.kind in _STCSP_KINDS:
        return blocks.STCSP(c1, c2, n=a[0], variant=l.kind[-1].lower(),
                            v2=l.kind.startswith("ST2"), fused=fused)
    if l.kind in _PLAIN_KINDS:
        return None
    raise NotImplementedError(f"layer {l.index}: unknown kind {l.kind!r}")



class YoloV7(nn.Module):
    """fused: False (training form), True (BN, RepConv and ia / im
    folded: models/fuse.py) or "int8" (the folded model with every
    ConvBnAct and RepConv outside the heads in W8A8 form, models/
    quant.py). The int8 model's float parameters stay float32, as the
    JAX pipeline leaves them (pipeline.py:144-160); a layer that holds
    some, and each head, takes its input promoted to float32, as Flax
    promotes a bf16 input against float32 parameters.

    ``level_hook`` (JAX's ``decode_hook``, yolo.py:78): None, or a
    function applied to each head level's output, (B, C, ny, nx), before
    it is reshaped or decoded; parallel/spatial.py gathers a
    height-sharded level there."""

    level_hook = None

    def __init__(self, spec: ModelSpec, fused=False):
        super().__init__()
        if spec.head_kind not in HEAD_KINDS:
            raise NotImplementedError(
                f"unknown head {spec.head_kind!r}")
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
        self._float_in = set()
        for l in spec.layers[:-1]:
            m = _layer_module(spec, l, fused)
            if m is not None:
                self.add_module(f"layer{l.index}", m)
                # a QuantConv holds buffers: a parameter left is float
                if fused == blocks.INT8 and any(True for _ in m.parameters()):
                    self._float_in.add(l.index)
        if spec.head_kind == "DetectV8":
            self._build_v8_head(bool(fused))
            return
        na, no = spec.na, spec.no
        for i, src in enumerate(head.frm):
            c = spec.layers[src].c_out
            self.add_module(
                f"head_m{'2' if i >= spec.nl else ''}_{i % spec.nl}",
                nn.Conv2d(c, na * no, 1, bias=True))
            if i < spec.nl and spec.head_kind in _IMPLICIT_HEADS and not fused:
                self.add_module(f"head_ia_{i}", ImplicitA(c))
                self.add_module(f"head_im_{i}", ImplicitM(na * no))

    def _build_v8_head(self, fused: bool):
        """The decoupled anchor-free head (JAX yolo.py:244-275): per level
        a box tower ending in 4 * REG_MAX DFL logits (cv2) and a class
        tower ending in nc logits (cv3)."""
        spec = self.spec
        reg = spec_mod.REG_MAX
        c0 = spec.layers[self._head_from[0]].c_out
        widths = {"cv2": (max(16, c0 // 4, 4 * reg), 4 * reg),
                  "cv3": (max(c0, min(spec.nc, 100)), spec.nc)}
        for i in range(spec.nl):
            c = spec.layers[self._head_from[i]].c_out
            for br, (cw, cout) in widths.items():
                self.add_module(f"head_{br}_{i}_0", blocks.ConvBnAct(
                    c, cw, 3, 1, fused=fused))
                self.add_module(f"head_{br}_{i}_1", blocks.ConvBnAct(
                    cw, cw, 3, 1, fused=fused))
                self.add_module(f"head_{br}_{i}_2",
                                nn.Conv2d(cw, cout, 1, bias=True))

    def forward(self, x, training: bool = False, every_layer: bool = False):
        """x: (B, H, W, 3) in [0, 1] -> the anchor heads' nl raw levels
        (B, ny, nx, na, no), or DetectV8's decoded predictions (B, N,
        5 + nc) [xywh, obj = 1, class scores] in float32.

        every_layer=True also computes the layers that feed only the
        auxiliary heads, as the JAX module does at inference (what
        models/quant.calibrate needs to see every conv); the output is
        the same.

        training=True is the JAX module's training call of the anchor
        heads: every layer runs, and every head's raw level comes back, nl
        or 2 * nl (IAuxDetect: lead, then aux). BatchNorm follows the
        module's mode (``train()`` for batch statistics). A fused model
        does not train, nor does DetectV8, which has no loss."""
        spec = self.spec
        if training and self.fused:
            raise ValueError("a fused model does not train; build "
                             "YoloV7(spec, fused=False)")
        if training and spec.head_kind == "DetectV8":
            raise NotImplementedError(
                "DetectV8 has no training loss in the JAX package")
        x = x.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        saved = {}
        y = x
        for l in spec.layers[:-1]:
            if not (training or every_layer) and l.index not in self._needed:
                continue
            inp = x if l.index == 0 else (
                y if l.frm[0] == l.index - 1 else saved[l.frm[0]])
            if l.index in self._float_in:
                inp = inp.float()
            if l.kind == "MP":
                y = blocks.mp(inp, l.args[0])
            elif l.kind == "SP":
                y = blocks.sp(inp, *l.args)
            elif l.kind == "ReOrg":
                y = blocks.reorg(inp)
            elif l.kind == "Upsample":
                y = blocks.upsample_nearest(inp, l.args[0])
            elif l.kind == "Contract":
                y = blocks.contract(inp, l.args[0])
            elif l.kind == "Expand":
                y = blocks.expand(inp, l.args[0])
            elif l.kind == "Foldcut":
                y = blocks.foldcut(inp)
            elif l.kind in ("Concat", "Shortcut", "Chuncat"):
                parts = [y if i == l.index - 1 else saved[i] for i in l.frm]
                y = (torch.cat(parts, dim=1) if l.kind == "Concat"
                     else blocks.chuncat(parts) if l.kind == "Chuncat"
                     else functools.reduce(torch.add, parts))
            else:
                y = getattr(self, f"layer{l.index}")(inp)
            if l.index in spec.save:
                saved[l.index] = y
        heads = self._head_from if training else self._head_from[:spec.nl]
        feats = [saved[src] if src in saved else y for src in heads]
        if self.fused == blocks.INT8:
            feats = [f.float() for f in feats]
        if spec.head_kind == "DetectV8":
            return self._decode_v8(feats)
        raw = []
        for i, feat in enumerate(feats):
            lead = i < spec.nl
            if lead and hasattr(self, f"head_ia_{i}"):
                feat = getattr(self, f"head_ia_{i}")(feat)
            p = getattr(self, f"head_m{'' if lead else '2'}_{i % spec.nl}")(
                feat)
            if lead and hasattr(self, f"head_im_{i}"):
                p = getattr(self, f"head_im_{i}")(p)
            if self.level_hook is not None:
                p = self.level_hook(p)
            b, _, ny, nx = p.shape
            raw.append(p.permute(0, 2, 3, 1).reshape(b, ny, nx, spec.na,
                                                     spec.no))
        return raw

    def _decode_v8(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """The DFL decode (JAX yolo.py:434-481): a softmax over the REG_MAX
        bins of each side, whose expectation is the side's distance in
        cells from the cell centre (x + 0.5, y + 0.5); xy = (centre + (rb
        - lt) / 2) * stride, wh = (lt + rb) * stride, obj = 1, sigmoid
        class scores. It runs in float32: in JAX the softmax meets the
        float32 bins and grid, so its boxes come out float32 too."""
        spec = self.spec
        reg = spec_mod.REG_MAX
        out = []
        for i, feat in enumerate(feats):
            d, c = feat, feat
            for j in range(3):
                d = getattr(self, f"head_cv2_{i}_{j}")(d)
                c = getattr(self, f"head_cv3_{i}_{j}")(c)
            if self.level_hook is not None:
                d, c = self.level_hook(d), self.level_hook(c)
            b, _, ny, nx = d.shape
            dev = d.device
            bins = torch.arange(reg, dtype=torch.float32, device=dev)
            dist = torch.softmax(d.float().reshape(b, 4, reg, ny, nx), dim=2)
            dist = torch.einsum("bsrhw,r->bhws", dist, bins)   # ltrb
            gy, gx = torch.meshgrid(
                torch.arange(ny, dtype=torch.float32, device=dev),
                torch.arange(nx, dtype=torch.float32, device=dev),
                indexing="ij")
            centre = torch.stack([gx, gy], dim=-1) + 0.5
            lt, rb = dist[..., :2], dist[..., 2:]
            stride = float(spec.strides[i])
            score = torch.sigmoid(c.float()).permute(0, 2, 3, 1)
            out.append(torch.cat([
                (centre + (rb - lt) / 2.0) * stride, (lt + rb) * stride,
                torch.ones_like(score[..., :1]), score],
                dim=-1).reshape(b, ny * nx, 5 + spec.nc))
        return torch.cat(out, dim=1)


def decoded(model: YoloV7, x: torch.Tensor) -> torch.Tensor:
    """The inference output of the JAX module (its ``decoded``): (B, N,
    no) [xywh pixels, obj, class scores], from DetectV8's head as it is
    or from the anchor heads' raw levels through ``decode_levels``."""
    out = model(x)
    return out if model.spec.head_kind == "DetectV8" else decode_levels(
        out, model.spec)


def ensemble_apply(members, x: torch.Tensor, mode: str = "nms"
                   ) -> torch.Tensor:
    """Output-space ensemble (JAX yolo.py:592-614; models/experimental.py
    Ensemble): every YoloV7 in ``members`` on the same input, their
    decoded (B, N, no) predictions concatenated along the candidate axis
    ('nms', for NMS to merge) or reduced elementwise ('mean', 'max';
    members of one topology)."""
    ys = [decoded(m, x) for m in members]
    if mode == "nms":
        return torch.cat(ys, dim=1)
    stacked = torch.stack(ys)
    if mode == "mean":
        return stacked.mean(0)
    if mode == "max":
        return stacked.amax(0)
    raise ValueError(f"unknown ensemble mode {mode!r}")


def decode_levels(raw: List[torch.Tensor], spec: ModelSpec) -> torch.Tensor:
    """The anchor heads' inference decode (JAX yolo.py:407-431): raw lead
    levels (B, ny, nx, na, no) -> (B, N, no) [xywh pixels, obj, class
    scores] in float32 (float64 stays float64), levels and then (y, x,
    anchor) in order. IBin (JAX yolo.py:412-425) gives (B, N, nc + 5):
    w and h are the SigmoidBin decode times the anchor; its sigmoid and
    residuals run in the levels' dtype, as the JAX module decodes in the
    model's, and the sums with the float32 grid, bins and anchors
    promote."""
    anchors = torch.as_tensor(spec.anchors_per_level(), dtype=torch.float32,
                              device=raw[0].device)
    out = []
    for i, p in enumerate(raw):
        b, ny, nx, na, no = p.shape
        gy, gx = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=p.device),
            torch.arange(nx, dtype=torch.float32, device=p.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]
        if spec.head_kind == "IBin":
            out.append(_decode_ibin(p, grid, anchors[i],
                                    float(spec.strides[i])).reshape(
                b, ny * nx * na, spec.nc + 5))
            continue
        y = torch.sigmoid(p.to(torch.promote_types(p.dtype,
                                                   torch.float32)))
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(spec.strides[i])
        wh = (y[..., 2:4] * 2.0) ** 2 * anchors[i]
        out.append(torch.cat([xy, wh, y[..., 4:]], dim=-1).reshape(
            b, ny * nx * na, no))
    return torch.cat(out, dim=1)


def _decode_ibin(p, grid, anchors, stride: float):
    """One IBin level (B, ny, nx, na, nc + 47) -> (B, ny, nx, na, nc + 5)
    [xy, w, h, obj, cls]."""
    n_bin = spec_mod.BIN_COUNT + 1
    y = torch.sigmoid(p)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    pw = sigmoid_bin_decode(y[..., 2:2 + n_bin]) * anchors[..., 0]
    ph = sigmoid_bin_decode(y[..., 2 + n_bin:2 + 2 * n_bin]) * anchors[..., 1]
    return torch.cat([xy, pw[..., None], ph[..., None],
                      y[..., 2 + 2 * n_bin:].to(xy.dtype)], dim=-1)


def init_head_biases(state_dict, spec: ModelSpec) -> None:
    """Detection-head bias prior (models/yolo.py:353-368): obj
    log(8 / (640/stride)^2), cls log(0.6 / (nc - 0.99)); DetectV8 (JAX
    yolo.py:515-529): box logits 1, cls log(5 / nc / (640/stride)^2);
    IBin none, as in JAX (the bin layout has no plain obj / cls slots).
    In place."""
    nl, na, nc = spec.nl, spec.na, spec.nc
    if spec.head_kind == "IBin":
        return
    if spec.head_kind == "DetectV8":
        for i, s in enumerate(spec.strides):
            state_dict[f"head_cv2_{i}_2.bias"].fill_(1.0)
            state_dict[f"head_cv3_{i}_2.bias"].fill_(
                math.log(5.0 / nc / (640.0 / float(s)) ** 2))
        return
    for i in range(len(spec.layers[-1].frm)):
        key = f"head_m{'2' if i >= nl else ''}_{i % nl}.bias"
        b = state_dict[key].view(na, spec.no)
        b[:, 4] += math.log(8.0 / (640.0 / float(spec.strides[i % nl])) ** 2)
        b[:, 5:] += math.log(0.6 / (nc - 0.99))


def random_state_dict(spec: ModelSpec, seed: int = 0, gain: float = 1.0):
    """Seeded random weights in the unfused layout: Flax-style lecun-normal
    conv kernels (truncated at 2 std), zero conv biases, identity BN
    statistics, implicit vectors around 0 and 1, and the head bias prior.
    ``gain`` scales the std of every conv kernel but the heads' output
    convs: at 1.0 the signal of a deep model (yolov7-w6) dies out through
    its SiLU layers and the heads emit their biases whatever the image
    shows. The tail blocks' other leaves: Dense kernels and OREPA's
    branch kernels lecun-normal as the convs, OREPA's ``vector`` around
    its init rows, Swin's bias tables N(0, 0.02), and LayerScale
    ``gamma`` in [0.5, 1.5] rather than 1e-6, so that seeded weights let
    the image through those blocks."""
    g = torch.Generator().manual_seed(seed)
    model = YoloV7(spec, fused=False)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        head_out = _HEAD_OUT.match(k) is not None
        if k.endswith("weight") and v.dim() == 4:
            std = math.sqrt(1.0 / (v[0].numel())) / 0.87962566103423978
            if not head_out:
                std *= gain
            nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std, generator=g)
        elif k.endswith("implicit"):
            base = 0.0 if k.startswith("head_ia") else 1.0
            v.copy_(base + 0.02 * torch.randn(v.shape, generator=g))
        elif k.endswith(".bias") and head_out:
            v.zero_()
        elif ((k.endswith("weight") and v.dim() == 2)
              or k.endswith(("qkv_kernel", "in_proj_weight"))
              or ".weight_rbr_" in k):
            fan_in = v.shape[0] if k.endswith("qkv_kernel") else v[0].numel()
            std = gain * math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std, generator=g)
        elif k.endswith(".vector"):
            base = torch.tensor([0.25, 0.25, 0.0, 0.5, 0.5]
                                + [0.0] * (v.shape[0] - 5))
            v.copy_(base[:, None] + 0.1 * torch.randn(v.shape, generator=g))
        elif k.endswith("relative_position_bias_table"):
            v.copy_(0.02 * torch.randn(v.shape, generator=g))
        elif k.endswith(".gamma"):
            v.copy_(0.5 + torch.rand(v.shape, generator=g))
    init_head_biases(sd, spec)
    return sd


def sharpen_heads(state_dict, spec: ModelSpec, seed: int = 1,
                  sharpen: float = 8.0, obj_boost: float = 6.0,
                  jitter: float = 3.0) -> None:
    """Spread random-init scores so NMS keeps a realistic detection load
    (bench.py:46-72): scale the head kernels, raise the objectness and
    class logits, jitter the class logits per anchor. DetectV8 has no
    objectness: its box and class kernels are scaled and its class logits
    raised by ``obj_boost`` and jittered. IBin's objectness and class
    logits sit after its two bin heads (``obj_index``). In place, unfused
    layout."""
    g = torch.Generator().manual_seed(seed)
    if spec.head_kind == "DetectV8":
        for i in range(spec.nl):
            state_dict[f"head_cv2_{i}_2.weight"].mul_(sharpen)
            state_dict[f"head_cv3_{i}_2.weight"].mul_(sharpen)
            state_dict[f"head_cv3_{i}_2.bias"].add_(obj_boost + jitter * (
                2.0 * torch.rand((spec.nc,), generator=g) - 1.0))
        return
    for i in range(len(spec.layers[-1].frm)):
        name = f"head_m{'2' if i >= spec.nl else ''}_{i % spec.nl}"
        state_dict[f"{name}.weight"].mul_(sharpen)
        b = state_dict[f"{name}.bias"].view(spec.na, spec.no)
        obj = obj_index(spec)
        b[:, obj] += obj_boost
        b[:, obj + 1:] += obj_boost + jitter * (
            2.0 * torch.rand((spec.na, spec.nc), generator=g) - 1.0)


def obj_index(spec: ModelSpec) -> int:
    """The objectness channel of an anchor head's raw level; the class
    logits follow it. 4, or 2 + 2 * (BIN_COUNT + 1) = 46 for IBin."""
    return spec.no - spec.nc - 1
