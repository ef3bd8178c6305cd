"""The tracker steps replayed as one CUDA graph: the program's counter
``tracker.graph_replays`` over the count of its ``tracker`` spans, in %
(yolov7_tracker_tpu_torch/utils/trace.py, trackers/graphed.py). A
program whose steps are not graphed counts no replay and no eager step,
and gives nothing to read; one whose steps all ran eagerly reads 0."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    if not {"tracker.graph_replays", "tracker.graph_eager"} & set(counts):
        return None
    steps = trace.totals().get("tracker")
    if not steps or not steps["count"]:
        return None
    return 100.0 * counts.get("tracker.graph_replays", 0) / steps["count"]
