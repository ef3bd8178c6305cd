"""data/letterbox + models/yolo a frame: the span around detect_batch
less the NMS span inside it."""

SPANS = {"detect_batch": "detector", "nms": "nms"}


def read(r):
    s = r.spans.get("detector")
    return s["self_ms"] / r.frames if s and r.frames else None
