"""Seeds derived from ``--seed``: each use of randomness draws from its
own stream, so the same seed gives the same inputs and weights."""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``path``."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), *path])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))
