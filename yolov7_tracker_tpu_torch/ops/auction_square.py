"""Square lapjv-extended auction: the CUDA kernels K1/K3 and their plain
version.

Port of ``masked_assignment_pallas`` (K1, one problem) and
``masked_assignment_pallas_batched`` (K3, B problems) of
yolov7_tracker_tpu/ops/pallas_auction.py, which compute the function of
``yolov7_tracker_tpu.ops.assignment.masked_assignment``: the (n, m) cost
problem with cost limit ``thresh`` is extended to an (n+m, n+m) square
max-weight matching -- real block ``-min(cost, thresh + 1)`` (masked pairs
``-(thresh + 1)``), real row i reserved dummy column m+i and dummy row n+j
reserved real column j at ``-thresh / 2``, dummy-dummy block a 1e-6
jitter, everything else -1e9 -- and solved by an eps-scaled Jacobi
auction that starts from the all-dummies matching and releases, at each
phase, the pairs that violate eps-complementary-slackness. Pairs are
gated by ``cost <= thresh`` on output. It is the exact solver (within
(n+m) * eps_final of the optimum) and pays for it in sweeps: hundreds to
a few thousand per solve where the private-dummy auction of
ops/auction.py needs a handful.

Two implementations with the same function, bit for bit:

* ``masked_assignment_square_torch`` -- the plain version. It mirrors
  ``_auction_kernel`` / ``_auction_kernel_batched`` step by step on the
  (B, S, S) extended matrix, S = n + m, with one host-synced while loop
  for the whole batch (lockstep, as the batched TPU kernel). The TPU
  kernel's padding of S to 128 lanes is dropped: padding rows hold their
  own padding column at weight 1.0 from start to end and never bid.
* ``masked_assignment_square_cuda`` -- the hand-written kernels of
  ``csrc/auction_square.cu``: a 2-D cost launches K1 (one block), a 3-D
  cost launches K3 (one block per problem, each leaving its loop when its
  own problem is done).

``masked_assignment_square`` dispatches on the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor launches a kernel (or
raises). Every step of a sweep is a max, a min, a compare or one rounded
add, so the two agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from .auction import MAX_ITERS, NEG_F, _batched_args, _powers, eps_schedule
from .cuda_build import build_library

_MAX_PHASES = 8     # csrc/auction_square.cu MAX_PHASES

_LIBS = {}          # bound libraries: False the timed build, True profiling
BUILD_SECONDS = None
BUILD_LOG = ""      # nvcc's -Xptxas -v report (registers, shared memory)

# The profiling build of the same source (-DAUCTION_PROFILE): lane 0 of
# each warp of a block sums its clock cycles over these parts of a solve.
# "long-list sweeps" is all of the sweeps with more bidders than warps;
# "solo sweeps" the sweeps this warp ran alone for the last bidder of a
# phase and "solo wait" its wait while another warp did; "top" (loop
# control, the deferred key clear) to "award barrier" are the parts of a
# shared-out sweep, in which a warp without a bidder waits in the two
# barriers. The last two entries are counts of sweeps, not cycles.
PROFILE_PARTS = ("stage", "release", "long-list sweeps", "top",
                 "scan + reduce", "bid + atomic", "bid barrier", "award",
                 "award barrier", "solo sweeps", "solo wait", "gate",
                 "long-list sweep count", "solo sweep count")
PROFILE_WARPS = 32      # csrc/auction_square.cu PROFILE_WARPS


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _extended_weights(cost, rm, cm, th):
    """(B, N, M) costs -> ((B, S, S) extended weights, (B, N, M) gate
    costs), as pallas_auction.py:163-177."""
    b, n, m = cost.shape
    dev = cost.device
    lim = (th + 1.0)[:, None, None]
    valid = rm[:, :, None] & cm[:, None, :]
    c = torch.where(valid, torch.minimum(cost, lim), lim)
    w = torch.full((b, n + m, n + m), NEG_F, dtype=torch.float32, device=dev)
    w[:, :n, :m] = -c
    half = (-th / 2.0)[:, None]
    rows, cols = torch.arange(n, device=dev), torch.arange(m, device=dev)
    w[:, rows, m + rows] = half
    w[:, n + cols, cols] = half
    unit = torch.tensor(1e-6 / 97.0, dtype=torch.float32, device=dev)
    jitter = torch.remainder(
        cols.float()[:, None] * 37.0 + rows.float()[None, :], 97.0) * unit
    w[:, n:, m:] = -jitter
    return w, c


def _solve_torch(cost, rm, cm, th, sched, cap, max_iters, on_sweep=None):
    """Lockstep solve of B problems. Returns (r2c (B, N) int32, c2r (B, M)
    int32, sweeps (B, P) int32, cells (B,) int64): cells counts the finite
    entries of the extended matrix the solve had to read -- every row's
    at each phase's release, the unassigned rows' at each sweep.
    ``on_sweep(phase, sweep, r2c)``, if given, sees the extended (B, S)
    matching after each release (sweep -1) and after each sweep."""
    b, n, m = cost.shape
    s = n + m
    dev = cost.device
    w, c = _extended_weights(cost, rm, cm, th)
    neg = torch.tensor(NEG_F, dtype=torch.float32, device=dev)
    ids = torch.arange(s, device=dev)
    col_ids = ids[None, None, :]
    row_ids = ids[None, :, None]
    cap = cap[:, None]

    # initial matching through the reserved dummies: real row i holds
    # column m+i, dummy row n+j holds column j
    r2c = torch.where(ids < n, ids + m, ids - n).expand(b, s)
    c2r = torch.where(ids < m, ids + n, ids - m).expand(b, s)
    prices = torch.zeros((b, s), dtype=torch.float32, device=dev)
    sweeps = torch.zeros((b, sched.shape[1]), dtype=torch.int32, device=dev)
    cells = torch.zeros(b, dtype=torch.int64, device=dev)

    for ph in range(sched.shape[1]):
        eps = sched[:, ph, None]
        # warm-start release: drop pairs that violate eps-CS
        values = w - prices[:, None, :]
        v1 = values.max(dim=2).values
        own = col_ids == r2c[:, :, None]
        cur = torch.where(own, values, neg).max(dim=2).values
        keep = (r2c >= 0) & (cur >= v1 - eps)
        r2c = torch.where(keep, r2c, -1)
        c2r = torch.where(own & keep[:, :, None], row_ids, -1).max(
            dim=1).values

        cells += n * (m + 1) + m * (n + 1)
        it = 0
        unassigned = r2c < 0
        if on_sweep is not None:
            on_sweep(ph, -1, r2c)
        while it < max_iters and bool(unassigned.any()):
            sweeps[:, ph] += unassigned.any(dim=1)
            cells += (unassigned[:, :n].sum(dim=1) * (m + 1)
                      + unassigned[:, n:].sum(dim=1) * (n + 1))
            values = w - prices[:, None, :]
            v1, best_j = values.max(dim=2)          # first maximal column
            best_oh = col_ids == best_j[:, :, None]
            v2 = torch.where(best_oh, neg, values).max(dim=2).values
            bid = (prices.gather(1, best_j)
                   + torch.minimum(v1 - v2, cap) + eps)
            bid_eff = torch.where(unassigned, bid, neg)
            col_best = torch.where(best_oh, bid_eff[:, :, None],
                                   neg).max(dim=1).values
            cand = (best_oh & (bid_eff[:, :, None] >= col_best[:, None, :])
                    & unassigned[:, :, None])
            winner = torch.where(cand, row_ids, s).min(
                dim=1).values                       # lowest row wins a tie
            contested = winner < s
            won = cand & (row_ids == winner[:, None, :])
            won_row = won.any(dim=2)
            new_col = torch.where(won, col_ids, -1).max(dim=2).values

            prev_owner = torch.where(contested, c2r, -1)
            evicted = (row_ids == prev_owner[:, None, :]).any(dim=2)
            r2c = torch.where(evicted, -1, r2c)
            r2c = torch.where(won_row, new_col, r2c)
            c2r = torch.where(contested, winner, c2r)
            prices = torch.where(contested, col_best, prices)
            unassigned = r2c < 0
            if on_sweep is not None:
                on_sweep(ph, it, r2c)
            it += 1

    r2c_ext = r2c[:, :n]
    gate = c.gather(2, r2c_ext.clamp(0, m - 1)[:, :, None])[:, :, 0]
    row_to_col = torch.where(
        (r2c_ext < m) & rm & (gate <= th[:, None]), r2c_ext,
        -1).to(torch.int32)
    col_to_row = torch.full((b, m + 1), -1, dtype=torch.int32, device=dev)
    col_to_row.scatter_(
        1, torch.where(row_to_col >= 0, row_to_col, m).long(),
        torch.where(row_to_col >= 0,
                    torch.arange(n, dtype=torch.int32, device=dev), -1))
    return row_to_col, col_to_row[:, :m], sweeps, cells


def _check_sweeps(sweeps, cells, b, n_phases, device):
    if sweeps is not None and (sweeps.shape != (b, n_phases)
                               or sweeps.dtype != torch.int32
                               or sweeps.device != device):
        raise ValueError(
            "sweeps must be a (B, n_phases) int32 tensor on the cost's "
            "device")
    if cells is not None and (cells.shape != (b,)
                              or cells.dtype != torch.int64
                              or cells.device != device):
        raise ValueError(
            "cells must be a (B,) int64 tensor on the cost's device")


def masked_assignment_square_torch(cost, row_mask, col_mask, thresh,
                                   max_iters: int = MAX_ITERS,
                                   n_phases: int = 6,
                                   phase_factor: float = 4.0, sweeps=None,
                                   cells=None):
    """Plain PyTorch version of K1 and K3. cost (N, M) or (B, N, M);
    row_mask (N,) or (B, N); col_mask (M,) or (B, M); thresh a scalar or
    (B,). Returns int32 (r2c (..., N), c2r (..., M)), -1 where unmatched.
    ``sweeps`` (B, n_phases) int32, if given, receives the bid sweeps of
    each problem in each phase; ``cells`` (B,) int64, if given, the finite
    entries of the extended matrix each solve had to read."""
    batched, rm, cm, th = _batched_args(cost, row_mask, col_mask, thresh)
    b = rm.shape[0]
    _check_sweeps(sweeps, cells, b, n_phases, cost.device)
    sched, cap = eps_schedule(th, n_phases, phase_factor)
    costs = cost.float()
    if costs.dim() == 2:
        costs = costs[None].expand(b, -1, -1)
    r2c, c2r, n_sweeps, n_cells = _solve_torch(costs, rm, cm, th, sched, cap,
                                               max_iters)
    if sweeps is not None:
        sweeps.copy_(n_sweeps)
    if cells is not None:
        cells.copy_(n_cells)
    return (r2c, c2r) if batched else (r2c[0], c2r[0])


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

def load_library(profile: bool = False):
    """Build csrc/auction_square.cu (see ops/cuda_build.py) at first use
    and bind it with ctypes. ``profile``: the build with -DAUCTION_PROFILE,
    cached under its own name, which no path uses (see ``profile_square``)."""
    global BUILD_SECONDS, BUILD_LOG
    if profile in _LIBS:
        return _LIBS[profile]
    lib, seconds, log = build_library(
        "auction_square.cu", ("AUCTION_PROFILE",) if profile else ())
    if not profile:
        BUILD_SECONDS, BUILD_LOG = seconds, log
    for fn in (lib.auction_square_launch, lib.auction_square_batched_launch):
        fn.argtypes = [
            ctypes.c_void_p,                           # cost (B, N, M)
            ctypes.c_void_p, ctypes.c_void_p,          # row_mask, col_mask
            ctypes.c_void_p,                           # thresh (B,)
            ctypes.POINTER(ctypes.c_float),            # powers (P,), host
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, M
            ctypes.c_int, ctypes.c_int,                # n_phases, max_iters
            ctypes.c_void_p, ctypes.c_void_p,          # r2c out, c2r out
            ctypes.c_void_p,                           # sweeps (nullable)
            ctypes.c_void_p,                           # cells (nullable)
            ctypes.c_void_p,                           # profile (nullable)
            ctypes.c_void_p,                           # stream
        ]
        fn.restype = ctypes.c_int
    _LIBS[profile] = lib
    return lib


def _launch(profile, cost, row_mask, col_mask, thresh, max_iters, n_phases,
            phase_factor, sweeps, cells):
    """Check the arguments and launch K1 or K3 of the timed build or, with
    ``profile`` a (B, PROFILE_WARPS, len(PROFILE_PARTS)) int64 CUDA
    tensor, of the profiling build. Returns (batched, r2c (B, N),
    c2r (B, M))."""
    if not cost.is_cuda:
        raise ValueError("masked_assignment_square_cuda needs CUDA tensors")
    if cost.dtype != torch.float32 or not cost.is_contiguous():
        raise ValueError("cost must be a contiguous float32 tensor")
    if cost.dim() not in (2, 3):
        raise ValueError("cost must be (N, M) or (B, N, M), got "
                         f"{tuple(cost.shape)}")
    if (cost.dim() == 3) != (row_mask.dim() == 2):
        raise ValueError("a batched cost needs batched masks and a single "
                         "cost single masks")
    batched, rm, cm, th = _batched_args(cost, row_mask, col_mask, thresh)
    b = rm.shape[0]
    n, m = cost.shape[-2:]
    if batched and cost.shape[0] != b:
        raise ValueError("cost batch does not match the masks")
    if rm.shape != (b, n) or cm.shape != (b, m):
        raise ValueError(
            f"mask shapes {tuple(rm.shape)}, {tuple(cm.shape)} do not "
            f"match cost {tuple(cost.shape)}")
    for t in (rm, cm):
        if t.device != cost.device:
            raise ValueError("masks must be on the cost's device")
    if not 1 <= n_phases <= _MAX_PHASES:
        raise ValueError(f"n_phases must be in 1..{_MAX_PHASES}")
    _check_sweeps(sweeps, cells, b, n_phases, cost.device)
    rm = rm.contiguous()
    cm = cm.contiguous()
    th = th.contiguous()
    powers = (ctypes.c_float * n_phases)(*_powers(n_phases, phase_factor))
    r2c = torch.empty((b, n), dtype=torch.int32, device=cost.device)
    c2r = torch.empty((b, m), dtype=torch.int32, device=cost.device)
    lib = load_library(profile is not None)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    launch = (lib.auction_square_batched_launch if batched
              else lib.auction_square_launch)
    err = launch(
        cost.data_ptr(), rm.data_ptr(), cm.data_ptr(), th.data_ptr(), powers,
        b, n, m, n_phases, max_iters, r2c.data_ptr(), c2r.data_ptr(),
        sweeps.data_ptr() if sweeps is not None else None,
        cells.data_ptr() if cells is not None else None,
        profile.data_ptr() if profile is not None else None, stream)
    if err != 0:
        raise RuntimeError(
            f"square auction kernel launch failed: CUDA error {err}")
    return batched, r2c, c2r


def masked_assignment_square_cuda(cost, row_mask, col_mask, thresh,
                                  max_iters: int = MAX_ITERS,
                                  n_phases: int = 6,
                                  phase_factor: float = 4.0, sweeps=None,
                                  cells=None):
    """Launch K1 (cost (N, M), one block) or K3 (cost (B, N, M), one block
    per problem): all phases of every problem in one launch.

    cost float32, contiguous; row_mask (N,) / (B, N) and col_mask (M,) /
    (B, M) bool; thresh a scalar or (B,). ``sweeps``: optional
    (B, n_phases) int32 CUDA tensor that receives each problem's bid
    sweeps per phase; ``cells``: optional (B,) int64 CUDA tensor that
    receives the finite entries of the extended matrix each solve read.
    """
    batched, r2c, c2r = _launch(None, cost, row_mask, col_mask, thresh,
                                max_iters, n_phases, phase_factor, sweeps,
                                cells)
    # counted while utils/trace.py records: chip_smoke.py reads them to
    # show that step_frame went through K1 and serving through K3
    trace.count("launches.k3" if batched else "launches.k1")
    return (r2c, c2r) if batched else (r2c[0], c2r[0])


def profile_square(cost, row_mask, col_mask, thresh,
                   max_iters: int = MAX_ITERS, n_phases: int = 6,
                   phase_factor: float = 4.0, sweeps=None):
    """Where a solve's cycles go: launch the profiling build of K1/K3 on the
    same arguments as ``masked_assignment_square_cuda`` and return
    (r2c, c2r, cycles): cycles (B, PROFILE_WARPS, len(PROFILE_PARTS))
    int64, clock64() sums by warp (zeros beyond the block's warps) and
    part. It exists for chip_smoke.py to measure with: no path calls it,
    it adds to no launch count and its times are not the kernel's (the
    clock reads cost cycles themselves)."""
    b = row_mask.shape[0] if row_mask.dim() == 2 else 1
    cycles = torch.zeros((b, PROFILE_WARPS, len(PROFILE_PARTS)),
                         dtype=torch.int64, device=cost.device)
    batched, r2c, c2r = _launch(cycles, cost, row_mask, col_mask, thresh,
                                max_iters, n_phases, phase_factor, sweeps,
                                None)
    return ((r2c, c2r) if batched else (r2c[0], c2r[0])) + (cycles,)


def masked_assignment_square(cost, row_mask, col_mask, thresh,
                             max_iters: int = MAX_ITERS, n_phases: int = 6,
                             phase_factor: float = 4.0):
    """K1/K3 on the tensor's device: the plain version for a CPU tensor,
    the CUDA kernels for a CUDA tensor. Returns int32 (r2c (..., N),
    c2r (..., M))."""
    if cost.is_cuda:
        return masked_assignment_square_cuda(
            cost, row_mask, col_mask, thresh, max_iters, n_phases,
            phase_factor)
    if cost.device.type != "cpu":
        raise ValueError(f"no auction implementation for {cost.device}")
    return masked_assignment_square_torch(
        cost, row_mask, col_mask, thresh, max_iters, n_phases, phase_factor)
