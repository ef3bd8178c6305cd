"""TrackingPipeline's own host work a frame (frame hand-over and H2D,
dets_to_slab, packing, D2H, emit): the span around each entry call less
the detector, ReID and tracker spans inside it."""

# every span of the program's layers inside an entry call
SPANS = {"detect_batch": "detector", "nms": "nms", "embed_dets": "reid",
         "step": "tracker"}


def read(r):
    s = r.spans.get("pipeline")
    return s["self_ms"] / r.frames if s and r.frames else None
