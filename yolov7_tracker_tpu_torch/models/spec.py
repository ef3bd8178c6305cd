"""Model topology spec + reference-yaml-DSL parser.

The reference encodes every model as a yaml list of
``[from, number, module, args]`` rows interpreted by parse_model
(models/yolo.py:443-520). We keep *compatibility* with that format (a
user's cfg yaml loads unchanged) but normalize it into a typed
``ModelSpec`` that records, per layer: resolved input indices, module
kind, static arguments, output channels and spatial stride — so the Flax
builder and the checkpoint converter are driven by plain data and the
head strides are known analytically (no dummy forward needed, unlike
models/yolo.py:260-294).

Supported module kinds cover every cfg shipped by the reference's
training/deploy zoo (Conv, MP, SP, SPPCSPC, RepConv, ReOrg, DownC,
Concat, nn.Upsample, Detect, IDetect, IAuxDetect).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

SUPPORTED = {
    "Conv", "MP", "SP", "SPPCSPC", "RepConv", "ReOrg", "DownC", "Concat",
    "Shortcut", "Upsample", "Detect", "IDetect", "IAuxDetect", "IBin",
    # baseline-cfg zoo blocks (yolov3/yolov4-csp/yolor/r50/x50)
    "Bottleneck", "SPP", "Stem",
    "BottleneckCSPA", "BottleneckCSPB", "BottleneckCSPC",
    "ResCSPA", "ResCSPB", "ResCSPC",
    "ResXCSPA", "ResXCSPB", "ResXCSPC",
    # yolov5 / yolov8 families (the reference's track_yolov5/track_yolov8
    # entries swap in these detectors via ultralytics; here they are
    # first-class spec citizens so the same compiled pipeline runs them)
    "C3", "C2f", "SPPF", "DetectV8",
    # extended zoo (models/common.py blocks unused by shipped cfgs but
    # accepted by the reference parse_model)
    "Focus", "DWConv", "GhostConv", "Ghost", "GhostSPPCSPC",
    "Contract", "Expand",
    "RepBottleneckCSPA", "RepBottleneckCSPB", "RepBottleneckCSPC",
    "RepResCSPA", "RepResCSPB", "RepResCSPC",
    "RepResXCSPA", "RepResXCSPB", "RepResXCSPC",
    "GhostCSPA", "GhostCSPB", "GhostCSPC",
    "SwinTransformerBlock", "SwinTransformer2Block",
    "STCSPA", "STCSPB", "STCSPC", "ST2CSPA", "ST2CSPB", "ST2CSPC",
    "RepConv_OREPA", "RobustConv", "RobustConv2", "Chuncat", "Foldcut",
}

REG_MAX = 16  # DFL bins per box side (yolov8 head)

# CSP variant table: (split topology, inner block, inner shortcut,
# inner groups, inner expansion) — models/common.py:307-404 defaults as
# instantiated by parse_model from yaml args [c2] (+ repeat n)
CSP_KINDS = {
    "BottleneckCSPA": ("a", "bottleneck", True, 1, 1.0),
    "BottleneckCSPB": ("b", "bottleneck", False, 1, 1.0),
    "BottleneckCSPC": ("c", "bottleneck", True, 1, 1.0),
    "ResCSPA": ("a", "res", True, 1, 0.5),
    "ResCSPB": ("b", "res", True, 1, 0.5),
    "ResCSPC": ("c", "res", True, 1, 0.5),
    "ResXCSPA": ("a", "res", True, 32, 1.0),
    "ResXCSPB": ("b", "res", True, 32, 1.0),
    "ResXCSPC": ("c", "res", True, 32, 1.0),
    # RepConv-cv2 variants (common.py:654-742). RepResXCSP* and
    # RepBottleneckCSP* mirror the evident intent; the reference classes
    # are unbuildable (ResX ctor typo 'shortcu' at common.py:712;
    # RepBottleneck inner e=1.0 vs the parent's pinned e=0.5 cv1 at
    # :646-675) so no torch golden exists for them
    "RepBottleneckCSPA": ("a", "rep_bottleneck", True, 1, 1.0),
    "RepBottleneckCSPB": ("b", "rep_bottleneck", False, 1, 1.0),
    "RepBottleneckCSPC": ("c", "rep_bottleneck", True, 1, 1.0),
    "RepResCSPA": ("a", "rep_res", True, 1, 0.5),
    "RepResCSPB": ("b", "rep_res", False, 1, 0.5),
    "RepResCSPC": ("c", "rep_res", True, 1, 0.5),
    # inner_e=1.0 like the working ResXCSP convention: the upstream
    # e=0.5 would give 16 channels in 32 groups, an invalid conv
    "RepResXCSPA": ("a", "rep_res", True, 32, 1.0),
    "RepResXCSPB": ("b", "rep_res", False, 32, 1.0),
    "RepResXCSPC": ("c", "rep_res", True, 32, 1.0),
    # Ghost-bottleneck inner stacks (common.py:385-404)
    "GhostCSPA": ("a", "ghost", True, 1, 1.0),
    "GhostCSPB": ("b", "ghost", True, 1, 1.0),
    "GhostCSPC": ("c", "ghost", True, 1, 1.0),
}

BIN_COUNT = 21  # IBin default (models/yolo.py:165)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    kind: str
    frm: Tuple[int, ...]      # absolute input layer indices (-1 = image)
    args: Tuple[Any, ...]     # normalized static args (kind-specific)
    c_out: int
    scale: int                # spatial downscale factor vs input image


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    nc: int
    layers: Tuple[LayerSpec, ...]
    anchors: Tuple[Tuple[float, ...], ...]   # per level, flat (w,h) pairs
    head_kind: str                           # Detect / IDetect / IAuxDetect
    head_from: Tuple[int, ...]               # head input layer indices
    strides: Tuple[int, ...]                 # per detection level
    save: Tuple[int, ...]                    # layer outputs needed later

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def nl(self) -> int:
        return len(self.strides)

    @property
    def no(self) -> int:
        if self.head_kind == "IBin":
            # classes + (x, y, obj) + two (bin_count+1) sigmoid-bin heads
            # (models/yolo.py:167-175)
            return self.nc + 3 + 2 * (BIN_COUNT + 1)
        if self.head_kind == "DetectV8":
            # anchor-free: 4 DFL distributions + class logits, no obj
            return self.nc + 4 * REG_MAX
        return self.nc + 5

    def anchors_per_level(self):
        """(nl, na, 2) anchor sizes in pixels."""
        import numpy as np

        return np.asarray(self.anchors, np.float32).reshape(self.nl, self.na, 2)


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


_ACT_RE = re.compile(r"nn\.LeakyReLU\(\s*([0-9.]+)\s*\)")


def _parse_act(a: Any) -> str:
    """Map the yaml's activation token to a name ('silu'/'leaky:<s>'/'id')."""
    if a is True or a is None:
        return "silu"
    if isinstance(a, str):
        m = _ACT_RE.fullmatch(a.strip())
        if m:
            return f"leaky:{m.group(1)}"
        if a.strip() in ("nn.SiLU()", "True"):
            return "silu"
        if a.strip() in ("nn.Identity()", "False"):
            return "id"
        token = {
            "nn.ReLU()": "relu", "nn.Mish()": "mish", "Mish()": "mish",
            "nn.Hardswish()": "hardswish",
        }.get(a.strip())
        if token:
            return token
        raise ValueError(f"unsupported activation {a!r}")
    if a is False:
        return "id"
    raise ValueError(f"unsupported activation {a!r}")


def parse_yaml_cfg(cfg: Dict[str, Any], name: str = "model",
                   nc: Optional[int] = None,
                   anchors: Optional[Sequence] = None) -> ModelSpec:
    """Normalize a reference-format cfg dict into a ModelSpec.

    Channel/depth propagation mirrors parse_model (models/yolo.py:443-520):
    width_multiple rounds channels to /8; Concat sums inputs; ReOrg
    quadruples; detection heads collect their input channel list.
    """
    nc = nc if nc is not None else cfg["nc"]
    gd = cfg.get("depth_multiple", 1.0)
    gw = cfg.get("width_multiple", 1.0)
    anchors = anchors if anchors is not None else cfg["anchors"]
    na = len(anchors[0]) // 2
    no = na * (nc + 5)

    rows = list(cfg["backbone"]) + list(cfg["head"])
    layers: List[LayerSpec] = []
    ch: List[int] = []       # output channels per layer
    scales: List[int] = []   # spatial scale per layer
    save: set = set()
    head = None

    for i, (f, n, m, args) in enumerate(rows):
        m = m.strip() if isinstance(m, str) else m
        kind = {"nn.Upsample": "Upsample"}.get(m, m)
        if kind not in SUPPORTED:
            raise NotImplementedError(
                f"layer {i}: module {m!r} not supported yet"
            )
        frm = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        absfrm = tuple(x if x >= 0 else i + x for x in frm)
        in_ch = ch[absfrm[0]] if i > 0 else 3
        in_scale = scales[absfrm[0]] if i > 0 else 1
        n = max(round(n * gd), 1) if n > 1 else n
        norm_args: Tuple[Any, ...]

        if kind == "Conv":
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            k = args[1] if len(args) > 1 else 1
            if isinstance(k, (list, tuple)):  # e.g. [512, [1, 1]]
                k = k[0]
            s = args[2] if len(args) > 2 else 1
            # explicit pad; reference yamls write the literal token None,
            # which yaml parses as the *string* "None" (autopad)
            p = args[3] if len(args) > 3 else None
            if not isinstance(p, int):
                p = None
            g = args[4] if len(args) > 4 else 1
            act = _parse_act(args[5]) if len(args) > 5 else "silu"
            norm_args = (k, s, g, act, p)
            out_ch, out_scale = c2, in_scale * s
        elif kind in ("RepConv", "RepConv_OREPA"):
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            k = args[1] if len(args) > 1 else 3
            s = args[2] if len(args) > 2 else 1
            norm_args = (k, s)
            out_ch, out_scale = c2, in_scale * s
        elif kind == "DownC":
            c2 = make_divisible(args[0] * gw, 8)
            kk = args[1] if len(args) > 1 else 2
            norm_args = (kk,)
            out_ch, out_scale = c2, in_scale * kk
        elif kind in ("SPPCSPC", "GhostSPPCSPC"):
            c2 = make_divisible(args[0] * gw, 8)
            norm_args = ()
            out_ch, out_scale = c2, in_scale
        elif kind in ("Focus", "DWConv", "GhostConv"):
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            k = args[1] if len(args) > 1 else 1
            st = args[2] if len(args) > 2 else 1
            norm_args = (k, st)
            out_ch = c2
            out_scale = in_scale * st * (2 if kind == "Focus" else 1)
        elif kind == "Ghost":
            c2 = make_divisible(args[0] * gw, 8)
            k = args[1] if len(args) > 1 else 3
            st = args[2] if len(args) > 2 else 1
            norm_args = (k, st)
            out_ch, out_scale = c2, in_scale * st
        elif kind == "Contract":
            gctr = args[0] if args else 2
            norm_args = (gctr,)
            out_ch, out_scale = in_ch * gctr ** 2, in_scale * gctr
        elif kind == "Expand":
            gctr = args[0] if args else 2
            norm_args = (gctr,)
            out_ch, out_scale = in_ch // gctr ** 2, in_scale // gctr
        elif kind == "RobustConv":
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            k = args[1] if len(args) > 1 else 7
            st = args[2] if len(args) > 2 else 1
            norm_args = (k, st)
            out_ch, out_scale = c2, in_scale * st
        elif kind == "RobustConv2":
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            k = args[1] if len(args) > 1 else 7
            st = args[2] if len(args) > 2 else 4
            norm_args = (k, st)
            out_ch, out_scale = c2, in_scale   # stride-s then deconv-s
        elif kind == "Chuncat":
            norm_args = ()
            out_ch = sum(ch[x] for x in absfrm)
            out_scale = in_scale
        elif kind == "Foldcut":
            norm_args = ()
            out_ch, out_scale = in_ch // 2, in_scale
        elif kind in ("SwinTransformerBlock", "SwinTransformer2Block"):
            # yaml args [c2, num_heads, num_layers] (no n-insert in the
            # reference parse_model for these)
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            norm_args = (args[1], args[2])
            out_ch, out_scale = c2, in_scale
        elif kind in ("STCSPA", "STCSPB", "STCSPC",
                      "ST2CSPA", "ST2CSPB", "ST2CSPC"):
            c2 = make_divisible(args[0] * gw, 8)
            norm_args = (n,)
            out_ch, out_scale = c2, in_scale
        elif kind == "Bottleneck":
            c2 = make_divisible(args[0] * gw, 8)
            shortcut = bool(args[1]) if len(args) > 1 else True
            norm_args = (n, shortcut)  # sequential repeats, residual flag
            out_ch, out_scale = c2, in_scale
        elif kind in ("C3", "C2f"):
            c2 = make_divisible(args[0] * gw, 8)
            shortcut = (bool(args[1]) if len(args) > 1
                        else kind == "C3")  # C3 defaults True, C2f False
            norm_args = (n, shortcut)
            out_ch, out_scale = c2, in_scale
        elif kind == "SPPF":
            c2 = make_divisible(args[0] * gw, 8)
            k = args[1] if len(args) > 1 else 5
            norm_args = (k,)
            out_ch, out_scale = c2, in_scale
        elif kind in CSP_KINDS:
            c2 = make_divisible(args[0] * gw, 8)
            norm_args = (n,)          # inner stack depth
            out_ch, out_scale = c2, in_scale
        elif kind == "SPP":
            c2 = make_divisible(args[0] * gw, 8)
            k = tuple(args[1]) if len(args) > 1 else (5, 9, 13)
            norm_args = (k,)
            out_ch, out_scale = c2, in_scale
        elif kind == "Stem":
            c2 = make_divisible(args[0] * gw, 8)
            norm_args = ()
            out_ch, out_scale = c2, in_scale * 4
        elif kind == "MP":
            k = args[0] if args else 2
            norm_args = (k,)
            out_ch, out_scale = in_ch, in_scale * k
        elif kind == "SP":
            k = args[0] if args else 3
            s = args[1] if len(args) > 1 else 1
            norm_args = (k, s)
            out_ch, out_scale = in_ch, in_scale * s
        elif kind == "ReOrg":
            norm_args = ()
            out_ch, out_scale = in_ch * 4, in_scale * 2
        elif kind == "Concat":
            norm_args = ()
            out_ch = sum(ch[x] for x in absfrm)
            out_scale = in_scale
        elif kind == "Shortcut":
            norm_args = ()
            out_ch = ch[absfrm[0]]
            out_scale = in_scale
        elif kind == "Upsample":
            # yaml form: [None, 2, 'nearest']
            factor = args[1]
            norm_args = (factor,)
            out_ch, out_scale = in_ch, in_scale // factor
        elif kind in ("Detect", "IDetect", "IAuxDetect", "IBin",
                      "DetectV8"):
            head = (kind, absfrm, i)
            norm_args = ()
            out_ch, out_scale = 0, in_scale
        else:  # pragma: no cover
            raise AssertionError(kind)

        layers.append(
            LayerSpec(i, kind, absfrm, norm_args, out_ch, out_scale)
        )
        for x in absfrm:
            if x != i - 1 and x >= 0:
                save.add(x)
        ch.append(out_ch)
        scales.append(out_scale)

    assert head is not None, "cfg has no detection head"
    head_kind, head_from, head_idx = head
    nl = len(anchors)
    lead_from = head_from[:nl]
    strides = tuple(scales[x] for x in lead_from)
    return ModelSpec(
        name=name,
        nc=nc,
        layers=tuple(layers),
        anchors=tuple(tuple(a) for a in anchors),
        head_kind=head_kind,
        head_from=head_from,
        strides=strides,
        save=tuple(sorted(save)),
    )


def load_yaml_file(path: str, name: Optional[str] = None,
                   nc: Optional[int] = None) -> ModelSpec:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    return parse_yaml_cfg(cfg, name or path, nc=nc)
