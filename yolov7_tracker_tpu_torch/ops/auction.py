"""Private-dummy rectangular auction: the CUDA kernel and its plain version.

Port of ``masked_assignment_pallas_v2`` (yolov7_tracker_tpu/ops/
pallas_auction.py). Contract: ``(cost, row_mask, col_mask, thresh) ->
(row_to_col, col_to_row)``, the max-weight free-disposal matching of
weight ``thresh - cost`` in which each row i owns a private weight-0
dummy column m+i, solved by an eps-scaled Jacobi auction and gated by
``cost <= thresh`` on output. See the JAX module's header for why the
forward auction from zero prices is optimal here.

Two implementations with the same function, bit for bit:

* ``masked_assignment_auction_torch`` -- the plain version. It mirrors
  ``_auction_phase_kernel_v2`` step by step on the padded (Np, Mp)
  weight matrix, with host-synced while loops. It runs on any device.
* ``masked_assignment_auction_cuda`` -- the hand-written kernel in
  ``csrc/auction.cu``: all phases of B problems in one launch, one
  thread block per problem. A sweep there scans only what it can change
  (a row's real columns and its own dummy; the rows that bid; the rows
  whose release test can have changed), and ends with the same state.

``masked_assignment_auction`` dispatches on the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (or
raises). Every step of the sweep is a max, a min, a compare or a single
rounded add, so the two agree exactly.

K4 is the same matching problem solved as the JAX package's XLA twin
``masked_assignment_v2`` (yolov7_tracker_tpu/ops/assignment.py:311)
solves it, the form the JAX package runs on its chip: per phase a
clamp-and-release fixpoint kept apart from the bid rounds, which K2 fuses
into every sweep (and so, on dense costs, may stop short of the optimum).
``masked_assignment_twin_torch`` is its plain version,
``masked_assignment_twin_cuda`` the kernel (the second entry of
``csrc/auction.cu``), ``masked_assignment_twin`` the dispatcher; it is the
solver of ops/assignment.solve_assignment. K4's cascade entry (the third)
runs every level of the trackers' matching cascade in one launch:
``masked_assignment_twin_cascade_cuda`` launches it, under
ops/assignment.solve_cascade, where its plain version is (the cascade's
level loop over the twin's). K2 stays as the counterpart of the Pallas
kernel, which no tracker path calls, in JAX as here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import trace
from .cuda_build import build_library

NEG_F = -1e9
MAX_ITERS = 4096
TWIN_MAX_ITERS = 512    # masked_assignment_v2's max_iters (bid rounds a phase)
_MAX_PHASES = 8     # csrc/auction.cu MAX_PHASES

_LIBS = {}          # bound libraries: False the timed build, True profiling
BUILD_SECONDS = None
BUILD_LOG = ""      # nvcc's -Xptxas -v report (registers, shared memory)
PROFILE_BUILD_LOG = ""  # the same of the profiling build
PROFILE_WARPS = 32  # csrc/auction.cu PROFILE_WARPS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=16)
def _powers(n_phases: int, phase_factor: float) -> tuple:
    """phase_factor ** (1 .. n_phases) in float32, as Python floats (the
    kernel takes them by value)."""
    return tuple(torch.pow(
        torch.tensor(phase_factor, dtype=torch.float32),
        torch.arange(1, n_phases + 1, dtype=torch.float32)).tolist())


def eps_schedule(thresh: torch.Tensor, n_phases: int, phase_factor: float):
    """(B,) float32 thresholds -> (sched (B, n_phases), cap (B,)), in the
    float32 arithmetic of pallas_auction.py:402-410."""
    scale = thresh + 1.0
    powers = torch.tensor(_powers(n_phases, phase_factor),
                          dtype=torch.float32, device=thresh.device)
    sched = torch.maximum(
        scale[:, None] / powers[None, :],
        torch.tensor(2e-4, dtype=torch.float32, device=thresh.device))
    return sched, 2.0 * scale


def _jitter(n: int, m: int, device):
    """Deterministic sub-resolution tie-break jitter
    (pallas_auction.py:391)."""
    rows = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(m, dtype=torch.float32, device=device)[None, :]
    unit = torch.tensor(1e-6 / 17.0, dtype=torch.float32, device=device)
    return torch.remainder(rows * 131.0 + cols * 7.0, 17.0) * unit


def _gate(cost, r2c_ext, row_mask, thresh):
    """Keep a pair only if it is real and cost <= thresh; rebuild c2r."""
    n, m = cost.shape
    rows = torch.arange(n, device=cost.device)
    gate = cost[rows, r2c_ext.clamp(0, m - 1)]
    r2c = torch.where((r2c_ext >= 0) & (r2c_ext < m) & row_mask
                      & (gate <= thresh), r2c_ext, -1).to(torch.int32)
    c2r = torch.full((m + 1,), -1, dtype=torch.int32, device=cost.device)
    c2r[torch.where(r2c >= 0, r2c, m).long()] = torch.where(
        r2c >= 0, rows.to(torch.int32), -1)
    return r2c, c2r[:m]


def _solve_one_torch(cost, row_mask, col_mask, thresh, sched, cap,
                     max_iters, on_sweep=None):
    """One problem, every phase. ``on_sweep(phase, sweep, r2c, c2r,
    prices)``, if given, sees the padded state after each sweep."""
    n, m = cost.shape
    dev = cost.device
    np_r = _round_up(max(n, 1), 128)
    mp = _round_up(m + np_r, 128)
    neg = torch.tensor(NEG_F, dtype=torch.float32, device=dev)
    valid = row_mask[:, None] & col_mask[None, :]
    w = torch.where(valid, thresh - cost, neg)
    w = torch.where(valid, w + _jitter(n, m, dev), neg)
    w_p = torch.full((np_r, mp), NEG_F, dtype=torch.float32, device=dev)
    w_p[:n, :m] = w
    diag = torch.arange(np_r, device=dev)
    w_p[diag, m + diag] = 0.0

    col_ids = torch.arange(mp, device=dev)
    row_ids = torch.arange(np_r, device=dev)
    r2c = torch.full((np_r,), -1, dtype=torch.long, device=dev)
    c2r = torch.full((mp,), -1, dtype=torch.long, device=dev)
    prices = torch.zeros(mp, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sweeps = 0
    for ph, eps in enumerate(sched):
        it, n_open = 0, 1
        while it < max_iters and n_open > 0:
            before = (r2c, c2r, prices)
            # clamp unowned columns to price 0, release eps-CS violators
            prices = torch.where(c2r < 0, zero, prices)
            values = w_p - prices
            v1r = values.max(dim=1).values
            own = col_ids[None, :] == r2c[:, None]
            cur = torch.where(own, values, neg).max(dim=1).values
            keep = (r2c >= 0) & (cur >= v1r - eps)
            n_released = (r2c >= 0) & ~keep
            r2c = torch.where(keep, r2c, -1)
            c2r = torch.where(own & keep[:, None], row_ids[:, None],
                              -1).max(dim=0).values
            prices = torch.where(c2r < 0, zero, prices)

            # one Jacobi bid round over the unassigned rows
            unassigned = r2c < 0
            values = w_p - prices
            v1 = values.max(dim=1).values
            best_j = values.argmax(dim=1)           # first maximal column
            best_oh = col_ids[None, :] == best_j[:, None]
            v2 = torch.where(best_oh, neg, values).max(dim=1).values
            bid = prices[best_j] + torch.minimum(v1 - v2, cap) + eps
            bid_eff = torch.where(unassigned, bid, neg)
            col_best = torch.where(best_oh, bid_eff[:, None],
                                   neg).max(dim=0).values
            cand = (best_oh & (bid_eff[:, None] >= col_best[None, :])
                    & unassigned[:, None])
            winner = torch.where(cand, row_ids[:, None],
                                 np_r).min(dim=0).values  # lowest row wins
            contested = winner < np_r
            won = cand & (row_ids[:, None] == winner[None, :])
            won_row = won.any(dim=1)
            new_col = torch.where(won, col_ids[None, :], -1).max(dim=1).values

            prev_owner = torch.where(contested, c2r, -1)
            evicted = (row_ids[:, None] == prev_owner[None, :]).any(dim=1)
            r2c = torch.where(evicted, -1, r2c)
            r2c = torch.where(won_row, new_col, r2c)
            c2r = torch.where(contested, winner, c2r)
            prices = torch.where(contested, col_best, prices)
            n_open = int(((r2c < 0).sum() + n_released.sum()).item())
            if on_sweep is not None:
                on_sweep(ph, it, r2c, c2r, prices)
            it += 1
            sweeps += 1
            if _same_state(before, (r2c, c2r, prices)):
                # an unchanged state repeats unchanged until max_iters
                break
    return _gate(cost, r2c[:n], row_mask, thresh) + (sweeps,)


def _same_state(a, b) -> bool:
    """Bitwise equality of two (r2c, c2r, prices) auction states."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2].view(torch.int32), b[2].view(torch.int32)))


@functools.lru_cache(maxsize=64)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 tensor of Python numbers, made once per device (no
    host-to-device copy on every solve)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _batched_args(cost, row_mask, col_mask, thresh):
    """Normalise to cost (N,M) or (B,N,M), masks (B,N)/(B,M), thresh (B,).
    thresh: a number, a sequence of numbers or a tensor; k thresholds
    for B = g * k problems repeat over the g groups."""
    batched = row_mask.dim() == 2
    rm = row_mask if batched else row_mask[None]
    cm = col_mask if batched else col_mask[None]
    if isinstance(thresh, torch.Tensor):
        th = thresh.to(device=cost.device, dtype=torch.float32)
    else:
        values = (tuple(float(t) for t in thresh)
                  if isinstance(thresh, (tuple, list)) else (float(thresh),))
        th = _constant(values, cost.device)
    th = th.reshape(-1)
    b = rm.shape[0]
    if th.numel() == 1:
        th = th.expand(b)
    elif th.numel() != b:
        if b % th.numel():
            raise ValueError(f"{th.numel()} thresholds for {b} problems")
        th = th.repeat(b // th.numel())     # (t0, t1, t0, t1, ...)
    return batched, rm.bool(), cm.bool(), th


def _solve_one_twin(cost, row_mask, col_mask, thresh, sched, cap,
                    max_iters, on_sweep=None):
    """One problem of the twin, every phase, as ``masked_assignment_v2``
    computes it: the dense (n, m + n) weights, a release fixpoint, then
    Jacobi bid rounds. Returns (r2c, c2r, sweeps): sweeps counts release
    iterations and bid rounds together. ``on_sweep(phase, kind, it, r2c,
    c2r, prices)``, if given, sees the state after each release iteration
    (kind "release"; prices not yet clamped) and each bid round ("bid")."""
    n, m = cost.shape
    dev = cost.device
    mt = m + n
    neg = torch.tensor(NEG_F, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    valid = row_mask[:, None] & col_mask[None, :]
    w = torch.where(valid, thresh - cost, neg)
    w = torch.where(valid, w + _jitter(n, m, dev), neg)
    w = torch.cat([w, torch.where(torch.eye(n, dtype=torch.bool, device=dev),
                                  zero, neg)], dim=1)
    row_ids = torch.arange(n, device=dev)
    # masked-out rows start on their own dummies
    r2c = torch.where(row_mask, -1, m + row_ids)
    c2r = torch.full((mt,), -1, dtype=torch.long, device=dev)
    c2r[m + row_ids] = torch.where(row_mask, -1, row_ids)
    prices = torch.zeros(mt, dtype=torch.float32, device=dev)
    sweeps = 0
    for ph, eps in enumerate(sched):
        # clamp unowned columns to price 0 and release the eps-CS violators
        # until none is released (at most n + 1 times)
        it, n_rel = 0, 1
        while it < n + 1 and n_rel > 0:
            prices = torch.where(c2r < 0, zero, prices)
            values = w - prices
            v1 = values.max(dim=1).values
            cur = values[row_ids, r2c.clamp(0, mt - 1)]
            keep = (r2c >= 0) & (cur >= v1 - eps)
            rel = (r2c >= 0) & ~keep
            c2r = c2r.clone()
            c2r[r2c[rel]] = -1
            r2c = torch.where(keep, r2c, -1)
            n_rel = int(rel.sum())
            if on_sweep is not None:
                on_sweep(ph, "release", it, r2c, c2r, prices)
            it += 1
            sweeps += 1
        prices = torch.where(c2r < 0, zero, prices)

        # Jacobi bid rounds until every row is assigned
        it = 0
        while it < max_iters and bool((r2c < 0).any()):
            unassigned = r2c < 0
            values = w - prices
            v1 = values.max(dim=1).values
            best_j = values.argmax(dim=1)           # first maximal column
            second = values.clone()
            second[row_ids, best_j] = neg
            v2 = second.max(dim=1).values
            bid = prices[best_j] + torch.minimum(v1 - v2, cap) + eps
            bid_eff = torch.where(unassigned, bid, neg)
            col_best = torch.full((mt,), NEG_F, dtype=torch.float32,
                                  device=dev).scatter_reduce(
                0, best_j, bid_eff, "amax")
            cand = unassigned & (bid_eff >= col_best[best_j])
            winner = torch.full((mt,), n, dtype=torch.long,
                                device=dev).scatter_reduce(
                0, best_j, torch.where(cand, row_ids, n), "amin")
            won = cand & (winner[best_j] == row_ids)
            contested = winner < n
            prev_owner = torch.where(contested, c2r, -1)
            evicted = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            evicted[torch.where(prev_owner >= 0, prev_owner, n)] = True
            r2c = torch.where(evicted[:n], -1, r2c)
            r2c = torch.where(won, best_j, r2c)
            c2r = torch.where(contested, winner, c2r)
            prices = torch.where(contested, col_best, prices)
            if on_sweep is not None:
                on_sweep(ph, "bid", it, r2c, c2r, prices)
            it += 1
            sweeps += 1
    return _gate(cost, r2c, row_mask, thresh) + (sweeps,)


def masked_assignment_twin_torch(cost, row_mask, col_mask, thresh,
                                 max_iters: int = TWIN_MAX_ITERS,
                                 n_phases: int = 5,
                                 phase_factor: float = 4.0, sweeps=None):
    """Plain PyTorch version of the K4 kernel: ``masked_assignment_v2``
    (yolov7_tracker_tpu/ops/assignment.py:311), one problem at a time.
    Shapes as :func:`masked_assignment_twin`; ``sweeps`` (B,) int32, if
    given, receives each problem's release iterations plus bid rounds."""
    batched, rm, cm, th = _batched_args(cost, row_mask, col_mask, thresh)
    sched, cap = eps_schedule(th, n_phases, phase_factor)
    costs = cost.float()
    outs = [
        _solve_one_twin(costs[b] if costs.dim() == 3 else costs, rm[b],
                        cm[b], th[b], sched[b], cap[b], max_iters)
        for b in range(rm.shape[0])
    ]
    r2c = torch.stack([o[0] for o in outs])
    c2r = torch.stack([o[1] for o in outs])
    if sweeps is not None:
        sweeps.copy_(torch.tensor([o[2] for o in outs], dtype=torch.int32))
    return (r2c, c2r) if batched else (r2c[0], c2r[0])


def masked_assignment_auction_torch(cost, row_mask, col_mask, thresh,
                                    max_iters: int = MAX_ITERS,
                                    n_phases: int = 5,
                                    phase_factor: float = 4.0, sweeps=None):
    """Plain PyTorch version of the K2 kernel. Shapes as
    :func:`masked_assignment_auction`; ``sweeps`` (B,) int32, if given,
    receives each problem's sweep count."""
    batched, rm, cm, th = _batched_args(cost, row_mask, col_mask, thresh)
    sched, cap = eps_schedule(th, n_phases, phase_factor)
    costs = cost.float()
    outs = [
        _solve_one_torch(costs[b] if costs.dim() == 3 else costs, rm[b],
                         cm[b], th[b], sched[b], cap[b], max_iters)
        for b in range(rm.shape[0])
    ]
    r2c = torch.stack([o[0] for o in outs])
    c2r = torch.stack([o[1] for o in outs])
    if sweeps is not None:
        sweeps.copy_(torch.tensor([o[2] for o in outs], dtype=torch.int32))
    return (r2c, c2r) if batched else (r2c[0], c2r[0])


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def load_library(profile: bool = False):
    """Build csrc/auction.cu (see ops/cuda_build.py) at first use and bind
    it with ctypes. ``profile``: the build with -DAUCTION_PROFILE, cached
    under its own name, which no path uses (see ``profile_auction``)."""
    global BUILD_SECONDS, BUILD_LOG, PROFILE_BUILD_LOG
    if profile in _LIBS:
        return _LIBS[profile]
    lib, seconds, log = build_library(
        "auction.cu", ("AUCTION_PROFILE",) if profile else ())
    if profile:
        PROFILE_BUILD_LOG = log
    else:
        BUILD_SECONDS, BUILD_LOG = seconds, log
    lib.auction_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,        # cost, batch stride
        ctypes.c_void_p, ctypes.c_void_p,          # row_mask, col_mask
        ctypes.c_void_p,                           # thresh (B,)
        ctypes.POINTER(ctypes.c_float),            # powers (P,), host
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, M
        ctypes.c_int, ctypes.c_int,                # n_phases, max_iters
        ctypes.c_void_p, ctypes.c_void_p,          # r2c out, c2r out
        ctypes.c_void_p,                           # sweeps out (nullable)
        ctypes.c_void_p,                           # profile (nullable)
        ctypes.c_void_p,                           # stream
    ]
    lib.auction_launch.restype = ctypes.c_int
    lib.auction_twin_launch.argtypes = lib.auction_launch.argtypes
    lib.auction_twin_launch.restype = ctypes.c_int
    lib.auction_twin_cascade_launch.argtypes = (
        lib.auction_launch.argtypes[:4]            # cost .. col_mask
        + [ctypes.c_void_p]                        # time_since_update
        + lib.auction_launch.argtypes[4:9]         # thresh .. M
        + [ctypes.c_int]                           # depth
        + lib.auction_launch.argtypes[9:14]        # n_phases .. sweeps
        + [ctypes.c_void_p])                       # stream
    lib.auction_twin_cascade_launch.restype = ctypes.c_int
    lib.auction_profile_parts.argtypes = []
    lib.auction_profile_parts.restype = ctypes.c_char_p
    _LIBS[profile] = lib
    return lib


def profile_parts() -> tuple:
    """Names of the parts of a solve over which the profiling build sums
    its clock cycles, as the source lists them (the last entries, named
    "... count", are counts and not cycles)."""
    return tuple(load_library(True).auction_profile_parts().decode()
                 .split(","))


def _prepare(profile, cost, row_mask, col_mask, thresh, max_iters, n_phases,
             phase_factor, sweeps, twin=False, cascade=None):
    """Check the arguments and allocate the outputs of a launch of K2, of
    K4 (``twin``) or of K4's cascade (``cascade`` = (time_since_update
    (B, N), depth); ``sweeps`` then (B, depth)); with ``profile`` a (B,
    PROFILE_WARPS, parts) int64 CUDA tensor, of K2's or K4's profiling
    build.
    Returns (fire, batched, r2c (B, N), c2r (B, M)): ``fire()`` launches
    the kernel once on these arguments and raises if the launch is
    refused."""
    if not cost.is_cuda:
        raise ValueError("the auction kernels need CUDA tensors")
    if cost.dtype != torch.float32 or not cost.is_contiguous():
        raise ValueError("cost must be a contiguous float32 tensor")
    if cost.dim() not in (2, 3):
        raise ValueError("cost must be (N, M) or (B, N, M), got "
                         f"{tuple(cost.shape)}")
    batched, rm, cm, th = _batched_args(cost, row_mask, col_mask, thresh)
    b = rm.shape[0]
    n, m = cost.shape[-2:]
    if cost.dim() == 3 and cost.shape[0] != b:
        raise ValueError("cost batch does not match the masks")
    if rm.shape != (b, n) or cm.shape != (b, m):
        raise ValueError(
            f"mask shapes {tuple(rm.shape)}, {tuple(cm.shape)} do not "
            f"match cost {tuple(cost.shape)}")
    tsu = None
    if cascade is not None:
        tsu, depth = cascade
        tsu = (tsu if batched else tsu[None]).to(torch.int32).contiguous()
        if tsu.shape != (b, n) or depth < 0:
            raise ValueError(f"time_since_update {tuple(tsu.shape)} does "
                             f"not match cost {tuple(cost.shape)}")
    for t in (rm, cm) + ((tsu,) if tsu is not None else ()):
        if t.device != cost.device:
            raise ValueError("masks must be on the cost's device")
    rm = rm.contiguous()
    cm = cm.contiguous()
    th = th.contiguous()
    if not 1 <= n_phases <= _MAX_PHASES:
        raise ValueError(f"n_phases must be in 1..{_MAX_PHASES}")
    powers = (ctypes.c_float * n_phases)(*_powers(n_phases, phase_factor))
    r2c = torch.empty((b, n), dtype=torch.int32, device=cost.device)
    c2r = torch.empty((b, m), dtype=torch.int32, device=cost.device)
    shape = (b,) if cascade is None else (b, cascade[1])
    if sweeps is not None and (sweeps.shape != shape
                               or sweeps.dtype != torch.int32
                               or sweeps.device != cost.device
                               or not sweeps.is_contiguous()):
        raise ValueError(f"sweeps must be a {shape} int32 tensor on the "
                         "device")
    lib = load_library(profile is not None)
    head = (cost.data_ptr(), n * m if cost.dim() == 3 else 0,
            rm.data_ptr(), cm.data_ptr())
    tail = (r2c.data_ptr(), c2r.data_ptr(),
            sweeps.data_ptr() if sweeps is not None else None)
    if cascade is not None:
        if profile is not None:
            raise ValueError("K4's cascade entry has no profiling build")
        launch = lib.auction_twin_cascade_launch
        args = head + (tsu.data_ptr(), th.data_ptr(), powers, b, n, m,
                       cascade[1], n_phases, max_iters) + tail
    else:
        launch = lib.auction_twin_launch if twin else lib.auction_launch
        args = head + (th.data_ptr(), powers, b, n, m, n_phases,
                       max_iters) + tail + (
            profile.data_ptr() if profile is not None else None,)
    # every buffer the kernel reads or writes lives as long as fire does
    keep = (cost, rm, cm, th, tsu, r2c, c2r, sweeps, profile)

    def fire():
        stream = torch.cuda.current_stream(keep[0].device).cuda_stream
        err = launch(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"auction kernel launch failed: CUDA error {err}")
        if profile is not None:
            return
        # the launches of each kernel, counted while utils/trace.py
        # records: the tests and chip_smoke.py read which kernel a path
        # went through
        trace.count("launches.k4_cascade" if cascade is not None else
                    "launches.k4" if twin else "launches.k2")

    return fire, batched, r2c, c2r


def masked_assignment_auction_cuda(cost, row_mask, col_mask, thresh,
                                   max_iters: int = MAX_ITERS,
                                   n_phases: int = 5,
                                   phase_factor: float = 4.0, sweeps=None):
    """Launch the K2 kernel: all phases of every problem in one launch.

    cost: (N, M) shared by all problems or (B, N, M), float32, contiguous.
    row_mask (N,) or (B, N), col_mask (M,) or (B, M), bool.
    thresh: scalar or (B,). ``sweeps``: optional (B,) int32 CUDA tensor
    that receives each problem's sweep count.
    """
    fire, batched, r2c, c2r = _prepare(None, cost, row_mask, col_mask, thresh,
                                       max_iters, n_phases, phase_factor,
                                       sweeps)
    fire()
    return (r2c, c2r) if batched else (r2c[0], c2r[0])


def prepared_auction(cost, row_mask, col_mask, thresh,
                     max_iters: int = MAX_ITERS, n_phases: int = 5,
                     phase_factor: float = 4.0, profile=None):
    """``fire``: one launch of the K2 kernel on these arguments per call,
    into the same output buffers, with none of the wrapper's host work (a
    solve of a few sweeps is shorter than that work, so a loop over
    ``masked_assignment_auction_cuda`` times the host). With ``profile``
    (see ``profile_auction``) it launches the profiling build. For
    measuring: the paths call the wrapper."""
    return _prepare(profile, cost, row_mask, col_mask, thresh, max_iters,
                    n_phases, phase_factor, None)[0]


def profile_auction(cost, row_mask, col_mask, thresh,
                    max_iters: int = MAX_ITERS, n_phases: int = 5,
                    phase_factor: float = 4.0, sweeps=None):
    """Where a solve's cycles go: launch the profiling build of K2 on the
    same arguments as ``masked_assignment_auction_cuda`` and return
    (r2c, c2r, cycles): cycles (B, PROFILE_WARPS, len(profile_parts()))
    int64, clock64() sums by warp (zeros beyond the block's warps) and
    part. It exists for chip_smoke.py to measure with: no path calls it,
    it adds to no launch count and its times are not the kernel's (the
    clock reads cost cycles themselves)."""
    if not cost.is_cuda:
        raise ValueError("profile_auction needs CUDA tensors")
    b = row_mask.shape[0] if row_mask.dim() == 2 else 1
    cycles = torch.zeros((b, PROFILE_WARPS, len(profile_parts())),
                         dtype=torch.int64, device=cost.device)
    fire, batched, r2c, c2r = _prepare(cycles, cost, row_mask, col_mask,
                                       thresh, max_iters, n_phases,
                                       phase_factor, sweeps)
    fire()
    return ((r2c, c2r) if batched else (r2c[0], c2r[0])) + (cycles,)


def masked_assignment_auction(cost, row_mask, col_mask, thresh,
                              max_iters: int = MAX_ITERS, n_phases: int = 5,
                              phase_factor: float = 4.0):
    """K2 on the tensor's device: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor. Returns int32 (r2c (..., N),
    c2r (..., M))."""
    if cost.is_cuda:
        return masked_assignment_auction_cuda(
            cost, row_mask, col_mask, thresh, max_iters, n_phases,
            phase_factor)
    if cost.device.type != "cpu":
        raise ValueError(f"no auction implementation for {cost.device}")
    return masked_assignment_auction_torch(
        cost, row_mask, col_mask, thresh, max_iters, n_phases, phase_factor)


# ---------------------------------------------------------------------------
# K4: the XLA twin (masked_assignment_v2), the trackers' solver
# ---------------------------------------------------------------------------

def masked_assignment_twin_cuda(cost, row_mask, col_mask, thresh,
                                max_iters: int = TWIN_MAX_ITERS,
                                n_phases: int = 5, phase_factor: float = 4.0,
                                sweeps=None):
    """Launch the K4 kernel (csrc/auction.cu, auction_twin_launch): all
    phases of every problem in one launch, one block each. Arguments as
    :func:`masked_assignment_auction_cuda`."""
    fire, batched, r2c, c2r = _prepare(None, cost, row_mask, col_mask, thresh,
                                       max_iters, n_phases, phase_factor,
                                       sweeps, twin=True)
    fire()
    return (r2c, c2r) if batched else (r2c[0], c2r[0])


def prepared_twin(cost, row_mask, col_mask, thresh,
                  max_iters: int = TWIN_MAX_ITERS, n_phases: int = 5,
                  phase_factor: float = 4.0, profile=None):
    """``fire``: one launch of the K4 kernel on these arguments per call,
    as :func:`prepared_auction` does for K2 (``profile``: K4's profiling
    build). For measuring."""
    return _prepare(profile, cost, row_mask, col_mask, thresh, max_iters,
                    n_phases, phase_factor, None, twin=True)[0]


def profile_twin(cost, row_mask, col_mask, thresh,
                 max_iters: int = TWIN_MAX_ITERS, n_phases: int = 5,
                 phase_factor: float = 4.0, sweeps=None):
    """:func:`profile_auction` for K4: its profiling build on these
    arguments; returns (r2c, c2r, cycles (B, PROFILE_WARPS, parts))."""
    if not cost.is_cuda:
        raise ValueError("profile_twin needs CUDA tensors")
    b = row_mask.shape[0] if row_mask.dim() == 2 else 1
    cycles = torch.zeros((b, PROFILE_WARPS, len(profile_parts())),
                         dtype=torch.int64, device=cost.device)
    fire, batched, r2c, c2r = _prepare(cycles, cost, row_mask, col_mask,
                                       thresh, max_iters, n_phases,
                                       phase_factor, sweeps, twin=True)
    fire()
    return ((r2c, c2r) if batched else (r2c[0], c2r[0])) + (cycles,)


def masked_assignment_twin(cost, row_mask, col_mask, thresh,
                           max_iters: int = TWIN_MAX_ITERS, n_phases: int = 5,
                           phase_factor: float = 4.0):
    """K4 on the tensor's device: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor. Returns int32 (r2c (..., N),
    c2r (..., M))."""
    if cost.is_cuda:
        return masked_assignment_twin_cuda(
            cost, row_mask, col_mask, thresh, max_iters, n_phases,
            phase_factor)
    if cost.device.type != "cpu":
        raise ValueError(f"no auction implementation for {cost.device}")
    return masked_assignment_twin_torch(
        cost, row_mask, col_mask, thresh, max_iters, n_phases, phase_factor)


# ---------------------------------------------------------------------------
# K4's cascade: matching_cascade (trackers/appearance.py) in one launch
# ---------------------------------------------------------------------------

def masked_assignment_twin_cascade_cuda(cost, row_mask, col_mask,
                                        time_since_update, thresh,
                                        depth: int,
                                        max_iters: int = TWIN_MAX_ITERS,
                                        n_phases: int = 5,
                                        phase_factor: float = 4.0,
                                        sweeps=None):
    """Launch K4's cascade entry (csrc/auction.cu,
    auction_twin_cascade_launch): every level of every problem in one
    launch, one block a problem, the weights staged once. Arguments as
    ops/assignment.masked_assignment_twin_cascade_torch, on the card."""
    fire, batched, r2c, c2r = _prepare(
        None, cost, row_mask, col_mask, thresh, max_iters, n_phases,
        phase_factor, sweeps, twin=True, cascade=(time_since_update, depth))
    fire()
    return (r2c, c2r) if batched else (r2c[0], c2r[0])


def prepared_twin_cascade(cost, row_mask, col_mask, time_since_update,
                          thresh, depth: int,
                          max_iters: int = TWIN_MAX_ITERS, n_phases: int = 5,
                          phase_factor: float = 4.0):
    """``fire``: one launch of K4's cascade entry on these arguments per
    call, as :func:`prepared_twin` does for K4. For measuring."""
    return _prepare(None, cost, row_mask, col_mask, thresh, max_iters,
                    n_phases, phase_factor, None, twin=True,
                    cascade=(time_since_update, depth))[0]
