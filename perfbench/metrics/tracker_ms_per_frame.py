"""The tracker step a frame (trackers/*, slab, appearance, ops/kalman,
ops/boxes, the solver): the span around each step."""

SPANS = {"step": "tracker"}


def read(r):
    s = r.spans.get("tracker")
    return s["ms"] / r.frames if s and r.frames else None
