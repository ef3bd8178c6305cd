"""tic/toc fps accumulator (port of yolov7_tracker_tpu/utils/timer.py;
reference tracker/timer.py:4-37), with a device-aware variant that waits
for the card's queued work before reading the clock (the reference's
time_synchronized, utils/torch_utils.py:89-93)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.duration = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True):
        self.duration = time.time() - self.start_time
        self.total_time += self.duration
        self.calls += 1
        if average:
            return self.total_time / self.calls
        return self.duration

    def clear(self):
        self.__init__()


def block_and_time(fn, *args, **kwargs):
    """Run fn, wait until the card has finished its work, return (out,
    secs)."""
    import torch

    t0 = time.time()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.time() - t0
