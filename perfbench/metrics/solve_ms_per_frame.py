"""ops/assignment a frame: the program's ``tracker.solve`` spans
(yolov7_tracker_tpu_torch/utils/trace.py), each solve's preparation and
its K1, K3, K4 or cascade launch.
The benchmark wraps nothing for it; a program without the tracer gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.totals().get("tracker.solve")
    return s["ms"] / r.frames if s and r.frames else None
