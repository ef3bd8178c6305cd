"""The frame hand-over a frame: the program's ``pipeline.frames_in`` spans
(yolov7_tracker_tpu_torch/utils/trace.py), the batch stacked on the host
and its copy to the card.
The benchmark wraps nothing for it; a program without the tracer gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.totals().get("pipeline.frames_in")
    return s["ms"] / r.frames if s and r.frames else None
