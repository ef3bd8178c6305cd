"""OSNet's OSBlock stages a frame: the program's ``reid.osnet.conv2``,
``reid.osnet.conv3`` and ``reid.osnet.conv4`` spans
(yolov7_tracker_tpu_torch/utils/trace.py) summed, each stage's two
OSBlocks and its transition on every crop of the forward.
The benchmark wraps nothing for it; a program without the spans gives
nothing to read."""

SPANS = {}

STAGES = ("reid.osnet.conv2", "reid.osnet.conv3", "reid.osnet.conv4")


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.totals()
    ms = sum(spans[s]["ms"] for s in STAGES if s in spans)
    return ms / r.frames if ms and r.frames else None
