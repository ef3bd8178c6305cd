"""reid/extractor + reid/deepsort_cnn a frame: the span around each
embed_dets call (the crop gather and the network)."""

SPANS = {"embed_dets": "reid"}


def read(r):
    s = r.spans.get("reid")
    return s["ms"] / r.frames if s and r.frames else None
