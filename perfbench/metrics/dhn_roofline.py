"""DeepMOT's Deep Hungarian Net against the least time the card could
take for its work: the network's operations on the capacity x
det_capacity cost it scores each frame (``reference/dhn.dhn_flops``:
the row and column BiGRUs' gates on the input and the state at every
step, and the dense head on every cell; 8,162,432 a cell at hidden 256),
on each frame, over the float32 peak (the DHN runs in float32 with TF32
off), divided by the time of the DHN's kernels (dhn_ms_per_frame's
pattern). The count is the architecture's, from the reference's shapes,
whatever the program computes. The bytes bound is far lower: the
weights (16 MB) once a frame over HBM bandwidth."""

from perfbench.harness import yardstick
from perfbench.named import by_name
from perfbench.reference.dhn import dhn_flops

SPANS = {}


def read(r):
    t = r.config["tracker"]
    if t.get("tracker") != "deepmot" or not t.get("dhn_weights"):
        return None
    kernel_s = by_name("metrics", "dhn_ms_per_frame").kernel_s(r)
    if kernel_s <= 0 or not r.frames:
        return None
    need_s = (r.frames * dhn_flops(t["dhn_hidden"], t["capacity"],
                                   t["det_capacity"])
              / yardstick.peak_flops("float32"))
    return 100.0 * need_s / kernel_s
