"""reid/extractor a frame: the program's ``reid.crops`` spans
(yolov7_tracker_tpu_torch/utils/trace.py) around the crop gather of
each embed_dets call, every slot of the frame cropped, resized and
normalised on the card.
The benchmark wraps nothing for it; a program without the span gives
nothing to read."""

SPANS = {}


def read(r):
    try:
        from yolov7_tracker_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.totals().get("reid.crops")
    return s["ms"] / r.frames if s and r.frames else None
