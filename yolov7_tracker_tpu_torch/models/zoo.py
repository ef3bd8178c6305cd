"""Programmatic YOLOv7-family topologies.

The reference ships architectures as yaml row lists (cfg/training/*).
Here the same architectures are expressed as small Python builders over
the row grammar that ``spec.parse_yaml_cfg`` consumes — E-ELAN blocks,
MP-conv downsample pairs and FPN/PAN stages become loops instead of
hundreds of copied rows. Users can still load their own reference-format
yaml via spec.load_yaml_file; this module is the built-in zoo
(yolov7-tiny, yolov7, yolov7x, yolov7-w6 — cited against
cfg/training/yolov7-tiny.yaml, yolov7.yaml, yolov7x.yaml,
yolov7-w6.yaml).
"""

from __future__ import annotations

from typing import List, Optional

from .spec import ModelSpec, parse_yaml_cfg

LEAKY = "nn.LeakyReLU(0.1)"

# anchor sets (cfg/training/*.yaml headers)
ANCHORS_P5_TINY = [
    [10, 13, 16, 30, 33, 23],
    [30, 61, 62, 45, 59, 119],
    [116, 90, 156, 198, 373, 326],
]
ANCHORS_P5 = [
    [12, 16, 19, 36, 40, 28],
    [36, 75, 76, 55, 72, 146],
    [142, 110, 192, 243, 459, 401],
]
ANCHORS_P6 = [
    [19, 27, 44, 40, 38, 94],
    [96, 68, 86, 152, 180, 137],
    [140, 301, 303, 264, 238, 542],
    [436, 615, 739, 380, 925, 792],
]


class Rows:
    """Row-list builder with current-index bookkeeping."""

    def __init__(self):
        self.rows: List[list] = []

    @property
    def i(self) -> int:
        return len(self.rows) - 1

    def add(self, frm, kind, args, n: int = 1):
        self.rows.append([frm, n, kind, list(args)])
        return self.i

    def conv(self, c, k=1, s=1, frm=-1, act=None):
        a = [c, k, s] if act is None else [c, k, s, None, 1, act]
        return self.add(frm, "Conv", a)

    def concat(self, frm):
        return self.add(list(frm), "Concat", [1])

    def up(self):
        return self.add(-1, "nn.Upsample", [None, 2, "nearest"])


def _tiny_elan(r: Rows, c: int, c_out: int):
    """tiny E-ELAN: two 1x1 branches + two chained 3x3, concat, fuse
    (cfg/training/yolov7-tiny.yaml rows 2-7 pattern)."""
    r.conv(c, 1, act=LEAKY)
    r.conv(c, 1, frm=-2, act=LEAKY)
    r.conv(c, 3, act=LEAKY)
    r.conv(c, 3, act=LEAKY)
    r.concat([-1, -2, -3, -4])
    return r.conv(c_out, 1, act=LEAKY)


def yolov7_tiny_rows():
    r = Rows()
    r.conv(32, 3, 2, act=LEAKY)          # 0 P1/2
    r.conv(64, 3, 2, act=LEAKY)          # 1 P2/4
    _tiny_elan(r, 32, 64)                # ..7
    p3_elans = []
    for c in (64, 128, 256):             # P3/8, P4/16, P5/32
        r.add(-1, "MP", [])
        p3_elans.append(_tiny_elan(r, c, c * 2))
    p3, p4, p5 = p3_elans
    # SPP-CSP-lite head neck (rows 29-37)
    r.conv(256, 1, act=LEAKY)
    r.conv(256, 1, frm=-2, act=LEAKY)
    r.add(-1, "SP", [5])
    r.add(-2, "SP", [9])
    r.add(-3, "SP", [13])
    r.concat([-1, -2, -3, -4])
    r.conv(256, 1, act=LEAKY)
    r.concat([-1, -7])
    spp = r.conv(256, 1, act=LEAKY)      # 37
    # FPN up to P4
    r.conv(128, 1, act=LEAKY)
    r.up()
    r.conv(128, 1, frm=p4, act=LEAKY)
    r.concat([-1, -2])
    f_p4 = _tiny_elan(r, 64, 128)        # 47
    # FPN up to P3
    r.conv(64, 1, act=LEAKY)
    r.up()
    r.conv(64, 1, frm=p3, act=LEAKY)
    r.concat([-1, -2])
    out_p3 = _tiny_elan(r, 32, 64)       # 57
    # PAN down
    r.conv(128, 3, 2, act=LEAKY)
    r.concat([-1, f_p4])
    out_p4 = _tiny_elan(r, 64, 128)      # 65
    r.conv(256, 3, 2, act=LEAKY)
    r.concat([-1, spp])
    out_p5 = _tiny_elan(r, 128, 256)     # 73
    h3 = r.conv(128, 3, 1, frm=out_p3, act=LEAKY)
    h4 = r.conv(256, 3, 1, frm=out_p4, act=LEAKY)
    h5 = r.conv(512, 3, 1, frm=out_p5, act=LEAKY)
    r.add([h3, h4, h5], "IDetect", ["nc", "anchors"])
    return r.rows


def _elan(r: Rows, mid: int, inner: int, out: int, taps, n_inner=4):
    """standard E-ELAN: 2 branch 1x1s + chain of 3x3s, tap concat, fuse."""
    r.conv(mid, 1)
    r.conv(mid, 1, frm=-2)
    for _ in range(n_inner):
        r.conv(inner, 3)
    r.concat(list(taps))
    return r.conv(out, 1)


def _mp_down(r: Rows, c: int, extra_tap: Optional[int] = None):
    """MP + strided-conv two-path downsample (yolov7.yaml rows 12-16)."""
    r.add(-1, "MP", [])
    r.conv(c, 1)
    r.conv(c, 1, frm=-3)
    r.conv(c, 3, 2)
    taps = [-1, -3] if extra_tap is None else [-1, -3, extra_tap]
    return r.concat(taps)


def yolov7_rows():
    r = Rows()
    r.conv(32, 3, 1)                     # 0
    r.conv(64, 3, 2)                     # 1 P1/2
    r.conv(64, 3, 1)
    r.conv(128, 3, 2)                    # 3 P2/4
    _elan(r, 64, 64, 256, [-1, -3, -5, -6])          # 11
    _mp_down(r, 128)
    p3 = _elan(r, 128, 128, 512, [-1, -3, -5, -6])   # 24
    _mp_down(r, 256)
    p4 = _elan(r, 256, 256, 1024, [-1, -3, -5, -6])  # 37
    _mp_down(r, 512)
    _elan(r, 256, 256, 1024, [-1, -3, -5, -6])       # 50
    spp = r.add(-1, "SPPCSPC", [512])                # 51
    r.conv(256, 1)
    r.up()
    r.conv(256, 1, frm=p4)
    r.concat([-1, -2])
    f_p4 = _elan(r, 256, 128, 256, [-1, -2, -3, -4, -5, -6])  # 63
    r.conv(128, 1)
    r.up()
    r.conv(128, 1, frm=p3)
    r.concat([-1, -2])
    out_p3 = _elan(r, 128, 64, 128, [-1, -2, -3, -4, -5, -6])  # 75
    _mp_down(r, 128, extra_tap=f_p4)
    out_p4 = _elan(r, 256, 128, 256, [-1, -2, -3, -4, -5, -6])  # 88
    _mp_down(r, 256, extra_tap=spp)
    out_p5 = _elan(r, 512, 256, 512, [-1, -2, -3, -4, -5, -6])  # 101
    h3 = r.add(out_p3, "RepConv", [256, 3, 1])
    h4 = r.add(out_p4, "RepConv", [512, 3, 1])
    h5 = r.add(out_p5, "RepConv", [1024, 3, 1])
    r.add([h3, h4, h5], "IDetect", ["nc", "anchors"])
    return r.rows


def _w6_elan(r: Rows, mid: int, out: int, taps):
    r.conv(mid, 1)
    r.conv(mid, 1, frm=-2)
    for _ in range(4):
        r.conv(mid, 3)
    r.concat(list(taps))
    return r.conv(out, 1)


def _w6_head_elan(r: Rows, mid: int, out: int):
    r.conv(mid, 1)
    r.conv(mid, 1, frm=-2)
    for _ in range(4):
        r.conv(mid // 2, 3)
    r.concat([-1, -2, -3, -4, -5, -6])
    return r.conv(out, 1)


def yolov7_w6_rows():
    r = Rows()
    r.add(-1, "ReOrg", [])               # 0
    r.conv(64, 3, 1)                     # 1 P1/2
    widths = [(128, 64, 128), (256, 128, 256), (512, 256, 512),
              (768, 384, 768), (1024, 512, 1024)]
    stage_out = []
    for down_c, mid, out in widths:
        r.conv(down_c, 3, 2)
        stage_out.append(_w6_elan(r, mid, out, [-1, -3, -5, -6]))
    _, p3, p4, p5, _ = stage_out        # 10, 19, 28, 37, 46
    spp = r.add(-1, "SPPCSPC", [512])    # 47
    # FPN: P6->P5->P4->P3
    fpn_out = [spp]
    for route, mid in ((p5, 384), (p4, 256), (p3, 128)):
        r.conv(mid, 1)
        r.up()
        r.conv(mid, 1, frm=route)
        r.concat([-1, -2])
        fpn_out.append(_w6_head_elan(r, mid, mid))
    spp, f5, f4, out_p3 = fpn_out        # 47, 59, 71, 83
    # PAN back down
    pan = [out_p3]
    for route, c in ((f4, 256), (f5, 384), (spp, 512)):
        r.conv(c, 3, 2)
        r.concat([-1, route])
        pan.append(_w6_head_elan(r, c, c))
    out_p3, out_p4, out_p5, out_p6 = pan  # 83, 93, 103, 113
    h = [
        r.conv(256, 3, 1, frm=out_p3),
        r.conv(512, 3, 1, frm=out_p4),
        r.conv(768, 3, 1, frm=out_p5),
        r.conv(1024, 3, 1, frm=out_p6),
        # aux heads (training only)
        r.conv(320, 3, 1, frm=out_p3),
        r.conv(640, 3, 1, frm=f4),
        r.conv(960, 3, 1, frm=f5),
        r.conv(1280, 3, 1, frm=spp),
    ]
    r.add(h, "IAuxDetect", ["nc", "anchors"])
    return r.rows


def _elan_x(r: Rows, mid: int, out: int):
    """yolov7x E-ELAN: 6 inner 3x3s, taps [-1, -3, -5, -7, -8]
    (cfg/training/yolov7x.yaml rows 4-13)."""
    r.conv(mid, 1)
    r.conv(mid, 1, frm=-2)
    for _ in range(6):
        r.conv(mid, 3)
    r.concat([-1, -3, -5, -7, -8])
    return r.conv(out, 1)


def yolov7x_rows():
    r = Rows()
    r.conv(40, 3, 1)
    r.conv(80, 3, 2)
    r.conv(80, 3, 1)
    r.conv(160, 3, 2)
    _elan_x(r, 64, 320)                              # 13
    _mp_down(r, 160)
    p3 = _elan_x(r, 128, 640)                        # 28
    _mp_down(r, 320)
    p4 = _elan_x(r, 256, 1280)                       # 43
    _mp_down(r, 640)
    _elan_x(r, 256, 1280)                            # 58
    spp = r.add(-1, "SPPCSPC", [640])                # 59
    r.conv(320, 1)
    r.up()
    r.conv(320, 1, frm=p4)
    r.concat([-1, -2])
    f_p4 = _elan_x(r, 256, 320)                      # 73
    r.conv(160, 1)
    r.up()
    r.conv(160, 1, frm=p3)
    r.concat([-1, -2])
    out_p3 = _elan_x(r, 128, 160)                    # 87
    _mp_down(r, 160, extra_tap=f_p4)
    out_p4 = _elan_x(r, 256, 320)                    # 102
    _mp_down(r, 320, extra_tap=spp)
    out_p5 = _elan_x(r, 512, 640)                    # 117
    h3 = r.conv(320, 3, 1, frm=out_p3)
    h4 = r.conv(640, 3, 1, frm=out_p4)
    h5 = r.conv(1280, 3, 1, frm=out_p5)
    r.add([h3, h4, h5], "IDetect", ["nc", "anchors"])
    return r.rows


def _elan_e6(r: Rows, mid: int, out: int, inner: Optional[int] = None,
             n_inner: int = 6, taps=(-1, -3, -5, -7, -8)):
    r.conv(mid, 1)
    r.conv(mid, 1, frm=-2)
    for _ in range(n_inner):
        r.conv(inner or mid, 3)
    r.concat(list(taps))
    return r.conv(out, 1)


def _e6_family_rows(widths, elan_inner, head_detect="IAuxDetect",
                    double_elan=False, stem=80):
    """Shared builder for e6 / d6 / e6e (cfg/training/yolov7-{e6,d6,e6e}
    .yaml): ReOrg stem, DownC downsamples, 6-or-8-conv ELANs, FPN+PAN
    with DownC, 4 lead (+4 aux) heads. double_elan adds the e6e twin
    block merged by Shortcut."""
    # widths: per stage (downc_out, elan_mid, elan_fuse)
    n_inner, taps = elan_inner

    r = Rows()
    r.add(-1, "ReOrg", [])
    r.conv(stem, 3, 1)

    def elan(mid, out):
        first = _elan_e6(r, mid, out, n_inner=n_inner, taps=taps)
        if not double_elan:
            return first
        # e6e: twin ELAN branched from the SAME input (offsets -11/-12
        # in the yaml), merged with Shortcut (yolov7-e6e.yaml rows 13-23)
        span = n_inner + 4  # rows consumed by one ELAN block
        r.conv(mid, 1, frm=-(span + 1))  # branch from the ELAN's input
        r.conv(mid, 1, frm=-(span + 2))
        for _ in range(n_inner):
            r.conv(mid, 3)
        r.concat(list(taps))
        second = r.conv(out, 1)
        return r.add([second, first], "Shortcut", [1])

    stage_out = []
    for downc, mid, fuse in widths:
        r.add(-1, "DownC", [downc])
        stage_out.append(elan(mid, fuse))
    _, p3, p4, p5, _ = stage_out
    spp = r.add(-1, "SPPCSPC", [widths[-1][2] // 2])

    def head_elan(mid, out):
        """head E-ELAN: branch width = the matching backbone stage's elan
        mid, inner convs at mid//2, dense taps (e6 rows 62-71)."""
        dense = tuple(range(-1, -(n_inner + 3), -1))
        first = _elan_e6(r, mid, out, inner=mid // 2, n_inner=n_inner,
                         taps=dense)
        if not double_elan:
            return first
        span = n_inner + 4
        r.conv(mid, 1, frm=-(span + 1))  # branch from the ELAN's input
        r.conv(mid, 1, frm=-(span + 2))
        for _ in range(n_inner):
            r.conv(mid // 2, 3)
        r.concat(dense)
        second = r.conv(out, 1)
        return r.add([second, first], "Shortcut", [1])

    fpn = [spp]
    up_mids = [widths[3][2] // 2, widths[2][2] // 2, widths[1][2] // 2]
    elan_mids = [widths[3][1], widths[2][1], widths[1][1]]
    for route, mid, emid in zip((p5, p4, p3), up_mids, elan_mids):
        r.conv(mid, 1)
        r.up()
        r.conv(mid, 1, frm=route)
        r.concat([-1, -2])
        fpn.append(head_elan(emid, mid))
    spp_o, f5, f4, out_p3 = fpn
    pan = [out_p3]
    pan_cs = (up_mids[2] * 2, up_mids[0], widths[-1][2] // 2)
    pan_emids = (widths[2][1], widths[3][1], widths[4][1])
    for route, c, emid in zip((f4, f5, spp_o), pan_cs, pan_emids):
        r.add(-1, "DownC", [c])
        r.concat([-1, route])
        pan.append(head_elan(emid, c))
    out_p3, out_p4, out_p5, out_p6 = pan
    h = [
        r.conv(up_mids[2] * 2, 3, 1, frm=out_p3),
        r.conv(up_mids[1] * 2, 3, 1, frm=out_p4),
        r.conv(up_mids[0] * 2, 3, 1, frm=out_p5),
        r.conv(widths[-1][2], 3, 1, frm=out_p6),
    ]
    if head_detect == "IAuxDetect":
        h += [
            r.conv(up_mids[2] * 2, 3, 1, frm=pan[0]),
            r.conv(up_mids[1] * 2, 3, 1, frm=f4),
            r.conv(up_mids[0] * 2, 3, 1, frm=f5),
            r.conv(widths[-1][2], 3, 1, frm=spp_o),
        ]
    r.add(h, head_detect, ["nc", "anchors"])
    return r.rows


def yolov7_e6_rows():
    widths = [(160, 64, 160), (320, 128, 320), (640, 256, 640),
              (960, 384, 960), (1280, 512, 1280)]
    return _e6_family_rows(widths, (6, (-1, -3, -5, -7, -8)), stem=80)


def yolov7_d6_rows():
    widths = [(192, 64, 192), (384, 128, 384), (768, 256, 768),
              (1152, 384, 1152), (1536, 512, 1536)]
    return _e6_family_rows(widths, (8, (-1, -3, -5, -7, -9, -10)), stem=96)


def yolov7_e6e_rows():
    widths = [(160, 64, 160), (320, 128, 320), (640, 256, 640),
              (960, 384, 960), (1280, 512, 1280)]
    return _e6_family_rows(widths, (6, (-1, -3, -5, -7, -8)), stem=80,
                           double_elan=True)


def _yolov3_rows(spp: bool = False):
    """Darknet53 + YOLOv3 FPN head (cfg/baseline/yolov3{,-spp}.yaml)."""
    r = Rows()
    r.conv(32, 3, 1)
    r.conv(64, 3, 2)
    r.add(-1, "Bottleneck", [64])
    r.conv(128, 3, 2)
    r.add(-1, "Bottleneck", [128], n=2)
    r.conv(256, 3, 2)
    p3 = r.add(-1, "Bottleneck", [256], n=8)
    r.conv(512, 3, 2)
    p4 = r.add(-1, "Bottleneck", [512], n=8)
    r.conv(1024, 3, 2)
    r.add(-1, "Bottleneck", [1024], n=4)
    # head
    r.add(-1, "Bottleneck", [1024, False])
    if spp:
        r.add(-1, "SPP", [512, [5, 9, 13]])
    else:
        r.conv(512, 1, 1)
    r.conv(1024, 3, 1)
    r.conv(512, 1, 1)
    p5_out = r.conv(1024, 3, 1)
    r.conv(256, 1, 1, frm=-2)
    r.up()
    r.concat([-1, p4])
    r.add(-1, "Bottleneck", [512, False])
    r.add(-1, "Bottleneck", [512, False])
    r.conv(256, 1, 1)
    p4_out = r.conv(512, 3, 1)
    r.conv(128, 1, 1, frm=-2)
    r.up()
    r.concat([-1, p3])
    r.add(-1, "Bottleneck", [256, False])
    p3_out = r.add(-1, "Bottleneck", [256, False], n=2)
    r.add([p3_out, p4_out, p5_out], "Detect", ["nc", "anchors"])
    return r.rows


def yolov3_rows():
    return _yolov3_rows(spp=False)


def yolov3_spp_rows():
    return _yolov3_rows(spp=True)


def _csp_darknet_rows(head_kind: str):
    """CSP-Darknet + CSP-Dark-PAN (cfg/baseline/yolov4-csp.yaml /
    yolor-csp.yaml — identical bodies, Detect vs IDetect head)."""
    r = Rows()
    r.conv(32, 3, 1)
    r.conv(64, 3, 2)
    r.add(-1, "Bottleneck", [64])
    r.conv(128, 3, 2)
    r.add(-1, "BottleneckCSPC", [128], n=2)
    r.conv(256, 3, 2)
    p3 = r.add(-1, "BottleneckCSPC", [256], n=8)
    r.conv(512, 3, 2)
    p4 = r.add(-1, "BottleneckCSPC", [512], n=8)
    r.conv(1024, 3, 2)
    r.add(-1, "BottleneckCSPC", [1024], n=4)
    # head
    spp = r.add(-1, "SPPCSPC", [512])
    r.conv(256, 1, 1)
    r.up()
    r.conv(256, 1, 1, frm=p4)
    r.concat([-1, -2])
    f16 = r.add(-1, "BottleneckCSPB", [256], n=2)
    r.conv(128, 1, 1)
    r.up()
    r.conv(128, 1, 1, frm=p3)
    r.concat([-1, -2])
    r.add(-1, "BottleneckCSPB", [128], n=2)
    p3_out = r.conv(256, 3, 1)
    r.conv(256, 3, 2, frm=-2)
    r.concat([-1, f16])
    r.add(-1, "BottleneckCSPB", [256], n=2)
    p4_out = r.conv(512, 3, 1)
    r.conv(512, 3, 2, frm=-2)
    r.concat([-1, spp])
    r.add(-1, "BottleneckCSPB", [512], n=2)
    p5_out = r.conv(1024, 3, 1)
    r.add([p3_out, p4_out, p5_out], head_kind, ["nc", "anchors"])
    return r.rows


def yolov4_csp_rows():
    return _csp_darknet_rows("Detect")


def yolor_csp_rows():
    return _csp_darknet_rows("IDetect")


ANCHORS_P5_V3 = [
    [10, 13, 16, 30, 33, 23],
    [30, 61, 62, 45, 59, 119],
    [116, 90, 156, 198, 373, 326],
]

# anchor-free families carry a dummy 1-anchor set (na=1); the DetectV8
# decode never reads it
ANCHORS_FREE = [[1.0, 1.0], [1.0, 1.0], [1.0, 1.0]]


def yolov5_rows():
    """YOLOv5 v6.0+ topology (clean-room; the published C3/SPPF network
    behind the reference's track_yolov5.py entry). Channels/depths here
    are the base 'l' scale — per-model depth/width multiples are applied
    by the parser from the _ZOO table."""
    r = Rows()
    r.add(-1, "Conv", [64, 6, 2, 2])       # 0 P1/2 (6x6 s2 p2 stem)
    r.add(-1, "Conv", [128, 3, 2])         # 1 P2/4
    r.add(-1, "C3", [128], n=3)
    r.add(-1, "Conv", [256, 3, 2])         # 3 P3/8
    b_p3 = r.add(-1, "C3", [256], n=6)
    r.add(-1, "Conv", [512, 3, 2])         # 5 P4/16
    b_p4 = r.add(-1, "C3", [512], n=9)
    r.add(-1, "Conv", [1024, 3, 2])        # 7 P5/32
    r.add(-1, "C3", [1024], n=3)
    r.add(-1, "SPPF", [1024, 5])           # 9
    n_p5 = r.add(-1, "Conv", [512, 1, 1])  # 10
    r.up()
    r.concat([-1, b_p4])
    r.add(-1, "C3", [512, False], n=3)
    n_p4 = r.add(-1, "Conv", [256, 1, 1])  # 14
    r.up()
    r.concat([-1, b_p3])
    out_p3 = r.add(-1, "C3", [256, False], n=3)   # 17
    r.add(-1, "Conv", [256, 3, 2])
    r.concat([-1, n_p4])
    out_p4 = r.add(-1, "C3", [512, False], n=3)   # 20
    r.add(-1, "Conv", [512, 3, 2])
    r.concat([-1, n_p5])
    out_p5 = r.add(-1, "C3", [1024, False], n=3)  # 23
    r.add([out_p3, out_p4, out_p5], "Detect", ["nc", "anchors"])
    return r.rows


def _yolov8_rows(max_ch: int):
    """YOLOv8 topology (clean-room; the published C2f/SPPF anchor-free
    network behind the reference's track_yolov8.py entry). max_ch is the
    per-scale channel ceiling applied before the width multiple."""
    def c(x):
        return min(x, max_ch)

    r = Rows()
    r.add(-1, "Conv", [c(64), 3, 2])          # 0 P1/2
    r.add(-1, "Conv", [c(128), 3, 2])         # 1 P2/4
    r.add(-1, "C2f", [c(128), True], n=3)
    r.add(-1, "Conv", [c(256), 3, 2])         # 3 P3/8
    b_p3 = r.add(-1, "C2f", [c(256), True], n=6)
    r.add(-1, "Conv", [c(512), 3, 2])         # 5 P4/16
    b_p4 = r.add(-1, "C2f", [c(512), True], n=6)
    r.add(-1, "Conv", [c(1024), 3, 2])        # 7 P5/32
    r.add(-1, "C2f", [c(1024), True], n=3)
    b_p5 = r.add(-1, "SPPF", [c(1024), 5])    # 9
    r.up()
    r.concat([-1, b_p4])
    h_p4 = r.add(-1, "C2f", [c(512)], n=3)    # 12
    r.up()
    r.concat([-1, b_p3])
    out_p3 = r.add(-1, "C2f", [c(256)], n=3)  # 15
    r.add(-1, "Conv", [c(256), 3, 2])
    r.concat([-1, h_p4])
    out_p4 = r.add(-1, "C2f", [c(512)], n=3)  # 18
    r.add(-1, "Conv", [c(512), 3, 2])
    r.concat([-1, b_p5])
    out_p5 = r.add(-1, "C2f", [c(1024)], n=3)  # 21
    r.add([out_p3, out_p4, out_p5], "DetectV8", ["nc"])
    return r.rows


_ZOO = {
    "yolov7-tiny": (yolov7_tiny_rows, ANCHORS_P5_TINY, 1.0, 1.0),
    "yolov3": (yolov3_rows, ANCHORS_P5_V3, 1.0, 1.0),
    "yolov3-spp": (yolov3_spp_rows, ANCHORS_P5_V3, 1.0, 1.0),
    "yolov4-csp": (yolov4_csp_rows, ANCHORS_P5, 1.0, 1.0),
    "yolor-csp": (yolor_csp_rows, ANCHORS_P5, 1.0, 1.0),
    "yolov7": (yolov7_rows, ANCHORS_P5, 1.0, 1.0),
    "yolov7x": (yolov7x_rows, ANCHORS_P5, 1.0, 1.0),
    "yolov7-w6": (yolov7_w6_rows, ANCHORS_P6, 1.0, 1.0),
    "yolov7-e6": (yolov7_e6_rows, ANCHORS_P6, 1.0, 1.0),
    "yolov7-d6": (yolov7_d6_rows, ANCHORS_P6, 1.0, 1.0),
    "yolov7-e6e": (yolov7_e6e_rows, ANCHORS_P6, 1.0, 1.0),
    # yolov5 family (anchor-based, C3/SPPF): depth/width multiples per
    # the published n/s/m/l/x scales
    "yolov5n": (yolov5_rows, ANCHORS_P5_TINY, 0.33, 0.25),
    "yolov5s": (yolov5_rows, ANCHORS_P5_TINY, 0.33, 0.50),
    "yolov5m": (yolov5_rows, ANCHORS_P5_TINY, 0.67, 0.75),
    "yolov5l": (yolov5_rows, ANCHORS_P5_TINY, 1.0, 1.0),
    "yolov5x": (yolov5_rows, ANCHORS_P5_TINY, 1.33, 1.25),
    # yolov8 family (anchor-free, C2f/DFL): (depth, width, max_channels)
    "yolov8n": (lambda: _yolov8_rows(1024), ANCHORS_FREE, 0.33, 0.25),
    "yolov8s": (lambda: _yolov8_rows(1024), ANCHORS_FREE, 0.33, 0.50),
    "yolov8m": (lambda: _yolov8_rows(768), ANCHORS_FREE, 0.67, 0.75),
    "yolov8l": (lambda: _yolov8_rows(512), ANCHORS_FREE, 1.0, 1.0),
    "yolov8x": (lambda: _yolov8_rows(512), ANCHORS_FREE, 1.0, 1.25),
}


def get_spec(name: str, nc: int = 80) -> ModelSpec:
    if name not in _ZOO:
        raise KeyError(f"unknown model {name!r}; have {sorted(_ZOO)}")
    rows_fn, anchors, gd, gw = _ZOO[name]
    rows = rows_fn()
    # split rows into backbone/head shape for the parser (the split point
    # is cosmetic; parse concatenates them anyway)
    cfg = {
        "nc": nc,
        "depth_multiple": gd,
        "width_multiple": gw,
        "anchors": anchors,
        "backbone": rows,
        "head": [],
    }
    return parse_yaml_cfg(cfg, name=name, nc=nc)
