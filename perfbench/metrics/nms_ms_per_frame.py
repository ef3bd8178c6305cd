"""ops/nms a frame: the span around the pipeline's nms."""

SPANS = {"nms": "nms"}


def read(r):
    s = r.spans.get("nms")
    return s["ms"] / r.frames if s and r.frames else None
