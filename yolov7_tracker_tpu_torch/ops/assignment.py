"""Linear assignment with ``cost_limit`` gating (port of
yolov7_tracker_tpu/ops/assignment.py).

``solve_assignment`` is the trackers' solver. It runs what the JAX
package's ``solve_assignment`` runs on its chip: the XLA twin
``masked_assignment_v2``, a private-dummy rectangular auction whose
release fixpoint is kept apart from its bid rounds (ops/auction.py: the
hand-written CUDA kernel K4 on a CUDA tensor, its plain version on a CPU
tensor), with the steep schedule of that branch: 2 eps phases at factor
4^(n/2), which ends at the same final eps as n phases at factor 4, and at
most 512 bid rounds a phase. ``solve_cascade`` runs every level of the
trackers' age-layered matching cascade with that solver: one launch of
K4's cascade entry on a CUDA tensor, ``masked_assignment_twin_cascade_torch``
(the level loop ``cascade_levels`` over the twin's plain version) on a
CPU tensor.
``masked_assignment`` is the JAX module's function of that name: the
square lapjv-extended auction (ops/auction_square.py: the K1/K3 CUDA
kernels on a CUDA tensor, their plain version on a CPU tensor). It is the
solver the JAX package runs wherever it is not on a TPU, and the exact
one; the streaming entry points of pipeline.py use it for stage 1.
``linear_assignment_host`` is the scipy ground truth for tests.
Each call of the three solvers is a span ``tracker.solve`` (utils/
trace.py): the preparation and the launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from . import auction
from .auction import masked_assignment_twin
from .auction_square import masked_assignment_square

DEFAULT_PHASES = 5
# the twin's steep schedule: 2 phases ending at the eps of DEFAULT_PHASES
# phases at factor 4
STEEP_FACTOR = 4.0 ** (DEFAULT_PHASES / 2.0)


@trace.traced("tracker.solve", trace.first_tensor)
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


def rows_to_cols_inverse(r2c, n_cols: int):
    """col_to_row (..., D) of a row_to_col (..., T), -1 where unmatched."""
    t = r2c.shape[-1]
    c2r = torch.full(r2c.shape[:-1] + (n_cols + 1,), -1, dtype=torch.int32,
                     device=r2c.device)
    rows = torch.arange(t, dtype=torch.int32, device=r2c.device)
    c2r.scatter_(-1, torch.where(r2c >= 0, r2c, n_cols).long(),
                 torch.where(r2c >= 0, rows, -1))
    return c2r[..., :n_cols]


def cascade_levels(cost, row_mask, col_mask, time_since_update, thresh,
                   depth: int, solve):
    """The matching cascade's level loop (matching.py:216-277): level l
    solves the rows ``row_mask & (time_since_update == 1 + l)`` against the
    columns no level before took with ``solve(cost, rows, cols, thresh)``
    -> (row_to_col, col_to_row), and merges its pairs into row_to_col.
    Every one of the ``depth`` levels is solved, empty or not. Returns
    int32 (row_to_col (..., N), col_to_row (..., M))."""
    r2c = torch.full(row_mask.shape, -1, dtype=torch.int32,
                     device=cost.device)
    det_avail = col_mask
    for lvl in range(depth):
        rows_l = row_mask & (time_since_update == 1 + lvl)
        r2c_l, c2r_l = solve(cost, rows_l, det_avail, thresh)
        r2c = torch.where(rows_l & (r2c_l >= 0), r2c_l, r2c)
        det_avail = det_avail & (c2r_l < 0)
    return r2c, rows_to_cols_inverse(r2c, cost.shape[-1])


def masked_assignment_twin_cascade_torch(
        cost, row_mask, col_mask, time_since_update, thresh, depth: int,
        max_iters: int = auction.TWIN_MAX_ITERS, n_phases: int = 5,
        phase_factor: float = 4.0, sweeps=None):
    """Plain PyTorch version of K4's cascade entry: :func:`cascade_levels`
    over the twin's plain version (``_solve_one_twin`` a problem). Shapes
    as ``auction.masked_assignment_twin`` plus time_since_update (N,) or
    (B, N); ``sweeps`` (B, depth) int32, if given, receives each level's
    sweeps."""
    counts = []

    def solve(c, rows, cols, th):
        level = torch.zeros(rows.shape[0] if rows.dim() == 2 else 1,
                            dtype=torch.int32)
        out = auction.masked_assignment_twin_torch(
            c, rows, cols, th, max_iters, n_phases, phase_factor,
            sweeps=level)
        counts.append(level)
        return out

    r2c, c2r = cascade_levels(cost.float(), row_mask.bool(), col_mask.bool(),
                              time_since_update, thresh, depth, solve)
    if sweeps is not None and depth:
        sweeps.copy_(torch.stack(counts, dim=1))
    return r2c, c2r


@trace.traced("tracker.solve", trace.first_tensor)
def solve_cascade(cost, row_mask, col_mask, time_since_update, thresh,
                  depth: int):
    """The matching cascade with :func:`solve_assignment` at every level,
    on the cost's device: one launch of K4's cascade entry on a CUDA
    tensor (no per-level fallback), its plain version on a CPU tensor.
    Returns int32 (row_to_col (..., N), col_to_row (..., M))."""
    args = (cost.float().contiguous(), row_mask, col_mask,
            time_since_update, thresh, depth)
    if cost.is_cuda:
        return auction.masked_assignment_twin_cascade_cuda(
            *args, n_phases=2, phase_factor=STEEP_FACTOR)
    if cost.device.type != "cpu":
        raise ValueError(f"no auction implementation for {cost.device}")
    return masked_assignment_twin_cascade_torch(
        *args, n_phases=2, phase_factor=STEEP_FACTOR)


@trace.traced("tracker.solve", trace.first_tensor)
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
