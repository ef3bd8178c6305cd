"""Share of the traced window in which no kernel, copy or set ran on the
card (torch.profiler)."""


def read(r):
    if r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
