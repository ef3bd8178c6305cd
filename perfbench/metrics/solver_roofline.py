"""The trackers' solver kernels (K4, its cascade entry, K3, K1 and K2 of
ops/auction*.py) against the least time the card could take for the
association problems the frames needed: the problems a frame that the
tracker's plain reference states (ByteTrack: three stages; DeepSORT: a
cascade level for each frame a track may stay lost, then two), each a
capacity x det_capacity cost read once and its results written once over
HBM bandwidth, or one pass of 2 float32 operations a cell over the
float32 peak, whichever is larger. The count is the algorithm's, not the
number of launches or sweeps of this implementation."""

import re

from perfbench.harness import yardstick
from perfbench.named import by_name

SOLVER = re.compile(r"twin_kernel|twin_cascade_kernel|auction_kernel|"
                    r"auction_square")


def read(r):
    t = r.config["tracker"]
    kernel_s = sum(s for n, s in r.device_ops.items() if SOLVER.search(n))
    if kernel_s <= 0 or not r.frames:
        return None
    solves = by_name("reference/trackers", t["tracker"]).solves_per_frame(t)
    need = (r.frames * solves
            * yardstick.solve_bound_s(t["capacity"], t["det_capacity"]))
    return 100.0 * need / kernel_s
