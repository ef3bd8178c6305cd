"""OSNet's OSBlock stages against the least time the card could take
for their work: the published convs of ``conv2``, ``conv3`` and
``conv4`` (their OSBlocks, gates and transitions: 1.736 GFLOP a 128 x
256 crop, 88.7% of the network's) on the crop of each valid detection,
as mfu_pct counts crops, over the float32 peak (the network runs in
float32 with TF32 off), divided by the time of the program's
``reid.osnet.conv2|3|4`` spans. The ops bound is the larger: the stages'
input and output once and their weights over HBM bandwidth take about
1% of it. The count is the architecture's, from the reference's
shapes (``stage_flops``), whatever the program computes."""

import torch

from perfbench.harness import yardstick
from perfbench.reference.reid import network

SPANS = {}

STAGES = ("reid.osnet.conv2", "reid.osnet.conv3", "reid.osnet.conv4")


def stage_flops(name: str) -> int:
    """Operations of the OSBlock stages (``Net.STAGES``) of the reference
    network ``name`` on one crop, each counted by yardstick.conv_flops at
    the input shape the stage gets."""
    arch = network(name)
    net = arch.Net().to("meta")
    shapes = {}
    hooks = [getattr(net, s).register_forward_hook(
        lambda m, inp, out, s=s: shapes.__setitem__(s, tuple(inp[0].shape)))
        for s in arch.Net.STAGES]
    try:
        with torch.no_grad():
            net(torch.empty((1, 3) + tuple(arch.CROP_HW), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return sum(yardstick.conv_flops(getattr(net, s), shapes[s])
               for s in arch.Net.STAGES)


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.totals()
    ms = sum(spans[s]["ms"] for s in STAGES if s in spans)
    if not ms or not r.detections:
        return None
    need_s = (stage_flops(r.config["pipeline"]["reid"]) * r.detections
              / yardstick.peak_flops("float32"))
    return 100.0 * need_s / (ms * 1e-3)
