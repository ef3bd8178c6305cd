"""One long video: a uniform noise scene (``pixel_max``) of ``height`` x
``width`` panning ``pan_px`` a frame, cut from a canvas as a reader hands
frames over (chip_smoke.offline_frames, continued for as long as the
window). Every seed gives the same sizes."""

from __future__ import annotations

import numpy as np

from perfbench.harness.seeds import sub_seed


class Panning:
    """Frame k of a scene ``base`` (h, w, 3) shifted right by ``k * px``
    with wrap-around, as np.roll would give it, but as a view."""

    def __init__(self, base: np.ndarray, px: int):
        self.w = base.shape[1]
        self.canvas = np.concatenate([base, base], axis=1)
        self.px = px

    def frame(self, k: int) -> np.ndarray:
        off = (-k * self.px) % self.w
        return self.canvas[:, off:off + self.w]

    def first_frame(self) -> np.ndarray:
        return self.frame(0)


def make(seed: int, p: dict) -> Panning:
    rng = np.random.default_rng(sub_seed(seed, 2))
    base = rng.integers(0, p["pixel_max"], (p["height"], p["width"], 3),
                        np.uint8)
    return Panning(base, p["pan_px"])
