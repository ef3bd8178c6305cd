"""ops/kalman a frame: the program's ``tracker.kalman`` spans
(yolov7_tracker_tpu_torch/utils/trace.py), each call of the filter's
initiate, predict, project, update and gating distance.
The benchmark wraps nothing for it; a program without the tracer gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.totals().get("tracker.kalman")
    return s["ms"] / r.frames if s and r.frames else None
