"""The ReID network a frame: the program's ``reid.cnn`` spans
(yolov7_tracker_tpu_torch/utils/trace.py) around each forward, the
crop gather left out.
The benchmark wraps nothing for it; a program without the tracer gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.totals().get("reid.cnn")
    return s["ms"] / r.frames if s and r.frames else None
