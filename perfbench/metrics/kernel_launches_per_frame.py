"""Kernels the card ran in the traced window, a frame."""


def read(r):
    return r.kernels / r.frames if r.kernels and r.frames else None
