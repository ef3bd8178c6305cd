"""data/letterbox a frame: the program's ``detector.letterbox`` spans
(yolov7_tracker_tpu_torch/utils/trace.py), the resize matmuls and the
padded canvas, as the detector calls them.
The benchmark wraps nothing for it; a program without the tracer gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.totals().get("detector.letterbox")
    return s["ms"] / r.frames if s and r.frames else None
