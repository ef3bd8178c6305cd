"""The rows' way out a frame: the program's ``pipeline.rows_out`` spans
(yolov7_tracker_tpu_torch/utils/trace.py), packing, the D2H and the
emit.
The benchmark wraps nothing for it; a program without the tracer gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.totals().get("pipeline.rows_out")
    return s["ms"] / r.frames if s and r.frames else None
