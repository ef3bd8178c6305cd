"""Host syncs a frame: the program's ``host_syncs.<site>`` counters
(yolov7_tracker_tpu_torch/utils/trace.py) summed, each a device-to-host
read (NMS's loop conditions, the rows' D2H, the frame counter). The
benchmark wraps nothing for it; a program without the tracer gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    n = sum(v for k, v in trace.counters().items()
            if k.startswith("host_syncs."))
    return n / r.frames if n and r.frames else None
