"""Linear assignment with ``cost_limit`` gating (port of
yolov7_tracker_tpu/ops/assignment.py).

``solve_assignment`` is the trackers' solver. It runs what the JAX
package's ``solve_assignment`` runs on its chip: the XLA twin
``masked_assignment_v2``, a private-dummy rectangular auction whose
release fixpoint is kept apart from its bid rounds (ops/auction.py: the
hand-written CUDA kernel K4 on a CUDA tensor, its plain version on a CPU
tensor), with the steep schedule of that branch: 2 eps phases at factor
4^(n/2), which ends at the same final eps as n phases at factor 4, and at
most 512 bid rounds a phase.
``masked_assignment`` is the JAX module's function of that name: the
square lapjv-extended auction (ops/auction_square.py: the K1/K3 CUDA
kernels on a CUDA tensor, their plain version on a CPU tensor). It is the
solver the JAX package runs wherever it is not on a TPU, and the exact
one; the streaming entry points of pipeline.py use it for stage 1.
``linear_assignment_host`` is the scipy ground truth for tests.
"""

from __future__ import annotations

import numpy as np

from .auction import masked_assignment_twin
from .auction_square import masked_assignment_square

DEFAULT_PHASES = 5


def solve_assignment(cost, row_mask, col_mask, thresh,
                     n_phases: int = DEFAULT_PHASES):
    """Masked assignment with cost-limit gating on the cost's device.

    cost (N, M) or (B, N, M) float32; row_mask (N,) or (B, N) bool;
    col_mask (M,) or (B, M) bool; thresh a scalar or (B,) tensor (one per
    problem). Returns int32 (row_to_col (..., N), col_to_row (..., M)),
    -1 where unmatched.
    """
    return masked_assignment_twin(
        cost.float().contiguous(), row_mask, col_mask, thresh, n_phases=2,
        phase_factor=4.0 ** (n_phases / 2.0))


def masked_assignment(cost, row_mask, col_mask, thresh,
                      n_phases: int = DEFAULT_PHASES):
    """Exact masked assignment with cost-limit gating on the cost's
    device, by the square auction: a 2-D cost is one problem (kernel K1),
    a 3-D cost (B, N, M) with masks (B, N) / (B, M) is B problems in one
    launch (kernel K3). Same contract as :func:`solve_assignment`."""
    return masked_assignment_square(
        cost.float().contiguous(), row_mask, col_mask, thresh,
        n_phases=n_phases)


def linear_assignment_host(cost: np.ndarray, thresh: float):
    """Host solve of lapjv(extend_cost=True, cost_limit=thresh)
    (tracker/matching.py:30-41). Returns (matches (K, 2), unmatched_rows,
    unmatched_cols)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    if cost.size == 0:
        return (np.empty((0, 2), dtype=int), np.arange(n, dtype=int),
                np.arange(m, dtype=int))
    ext = np.full((n + m, n + m), thresh / 2.0, dtype=np.float64)
    ext[n:, m:] = 0.0
    ext[:n, :m] = cost
    rows, cols = linear_sum_assignment(ext)
    matches = [(r, c) for r, c in zip(rows, cols) if r < n and c < m]
    matched_r = {r for r, _ in matches}
    matched_c = {c for _, c in matches}
    unmatched_rows = np.array([i for i in range(n) if i not in matched_r],
                              dtype=int)
    unmatched_cols = np.array([j for j in range(m) if j not in matched_c],
                              dtype=int)
    return (np.asarray(matches, dtype=int).reshape(-1, 2), unmatched_rows,
            unmatched_cols)
