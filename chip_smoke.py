#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (yolov7_tracker_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build   -- nvcc builds csrc/auction.cu (K2, the private-dummy
                auction), csrc/auction_square.cu (K1 and K3, the square
                lapjv-extended auction) and the profiling build of each
                (-DAUCTION_PROFILE) for sm_90a from the checkout, side by
                side.
  2. kernels -- each kernel against its plain PyTorch version on the card
                at the tracker's shape (128, 300), exact equality of
                r2c/c2r and of every problem's sweep count. K2: >= 32
                seeded problems (association-shaped and dense U[0,1],
                random masks) plus batch-2 launches at the stage-2/3
                thresholds, a few association problems against scipy, and
                problems that stress the sweep: every row bidding on equal
                costs, 256 x 300 (weights not staged), 7 x 5, 300 x 128
                (never settles), 127 x 301 (no 16-byte loads), everything
                masked out, max_iters hit, a phase that ends on an
                unchanged state,
                5 phases at factor 4, a (B, N, M) cost with B thresholds,
                and B = 264. K1: seeded association-shaped and dense
                problems, against scipy too. K3: batches of 8 and 16, of
                which each problem is also solved alone by K1 with the
                same result (a block that leaves when its own problem is
                done == the lockstep form). K1/K3 also on problems that
                stress the sweep: every row bidding after each release,
                256 x 300 (weights not staged), 7 x 5 and other shapes
                with N > M or odd widths, everything masked out, max_iters
                hit, 6 phases, and B = 264 (two waves of blocks). For
                K1/K3 the sweeps of every phase and the cells read are
                compared as well.
  3. main    -- yolov7-w6 at full width (nc=80, 1088 px, bf16, BN folded,
                seeded weights with sharpened heads) -> NMS -> ByteTrack
                (capacity 128, det_capacity 300) over 16 synthetic
                1080x1920 frames through TrackingPipeline.run_sequence,
                with the K2 launch count reset just before and read just
                after (2 per frame). The main path's own auction problems
                are then re-solved by the kernel and the plain version,
                the tracker is replayed on the CPU from the same
                detections, and a small detector input is checked
                against a float32 CPU reference.
  4. serving -- cli/serve.py on the same detector: 8 synthetic 1080x1920
                cameras, 16 ticks with state checkpoints, then a second
                call that resumes from them for 8 more. 8 result files
                with rows for 24 consecutive frames and ids that continue
                across the resume; one K3 and one K2 launch per tick (the
                counts are reset just before each call and read just
                after); the last tick's own stage-1 problems re-solved by
                the plain version; ms/tick, frames/s and a per-stage
                breakdown of a tick.
  5. step    -- step_frame on one stream for 8 frames: 8 K1 launches, and
                the same slab as lane 0 of a one-stream
                process_multistream run.
Then K2 on the offline path's last stage-1 and stage-2/3 problems and on
the last tick's 2S problems, K1 on step_frame's last problem and K3 on the
last tick's are timed (ms, us per sweep, bound) and profiled (where a
solve's cycles go, by the profiling builds, which no path uses), and the
problems are written to chiprun_out/chip_smoke/k2_problems.pt and
square_problems.pt.
It prints the kernel JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}. It exits non-zero, printing no result, if
there is no CUDA device or if any phase fails. It imports nothing of JAX.

    python3 chip_smoke.py --square-only [--problems square_problems.pt]

is a short run for work on K1/K3 alone: build, phase 2 for K1/K3, and,
given the file a full run wrote, the timing and profile on the paths'
problems. It prints no result line.

    python3 chip_smoke.py --k2-only [--problems k2_problems.pt]

is its twin for work on K2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
REPLACES = "yolov7_tracker_tpu/ops/pallas_auction.py:412"
SOURCE = "yolov7_tracker_tpu_torch/csrc/auction.cu"
REPLACES_K1 = "yolov7_tracker_tpu/ops/pallas_auction.py:196"
REPLACES_K3 = "yolov7_tracker_tpu/ops/pallas_auction.py:631"
SOURCE_SQUARE = "yolov7_tracker_tpu_torch/csrc/auction_square.cu"
# std gain of the random conv kernels below the heads. At 1.0 (and still at
# 1.4) w6's signal dies out on its way through ~100 SiLU layers and every
# frame gets the same boxes, so every camera would hand the tracker one and
# the same problem; from 1.8 on every score saturates at 1.0. At 1.6 the
# boxes follow the image.
DETECTOR_GAIN = 1.6
SQUARE_PHASES = 5             # ops/assignment.DEFAULT_PHASES, the tracker's
# K2's eps schedule in the tracker (ops/assignment.solve_assignment)
K2_STEEP = dict(n_phases=2, phase_factor=4.0 ** 2.5)
# weight a K1 solve of the seeded (128, 300) problems may leave against
# scipy's optimum: twice the most measured there (0.025)
SCIPY_GAP_LIMIT = 0.05
N_STREAMS = 8
SERVE_TICKS = (16, 8)         # first call, resumed call
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean ms per call of fn() on the card, CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fire, launches=20, replays=10):
    """Mean ms per launch of fire() on the card with no host work between
    launches: `launches` of them captured into one CUDA graph, which is
    replayed `replays` times between two CUDA events after a warm-up. For
    kernels shorter than the host takes to launch them, which a loop over
    the wrapper (or over fire) would time instead."""
    import torch

    fire()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fire()
    return cuda_ms(graph.replay, replays) / launches


# ---------------------------------------------------------------------------
# phase 2: the K2 kernel against its plain version
# ---------------------------------------------------------------------------

def seeded_problem(rng, n=128, m=300, kind="assoc"):
    """One (cost, row_mask, col_mask). 'assoc' is IoU-distance shaped:
    a sparse background of barely-overlapping pairs, one true pair per
    matched track and some distractor pairs, with every cost at least
    0.02 from the thresholds 0.5/0.7/0.9 (the auction is exact up to
    n * eps_final = 0.2, so a pair within eps of the threshold may
    legitimately go either way). 'dense' is U[0, 1]."""
    if kind == "assoc":
        iou = np.where(rng.random((n, m)) < 0.05,
                       rng.uniform(0.0, 0.05, (n, m)), 0.0)
        k = int(rng.integers(n // 4, n))
        rows = rng.permutation(n)[:k]
        cols = rng.permutation(m)[:k]
        iou[rows, cols] = rng.uniform(0.55, 0.95, k)
        d = k // 3
        iou[rng.choice(rows, d), rng.choice(cols, d)] = rng.uniform(
            0.32, 0.45, d)
        cost = (1.0 - iou).astype(np.float32)
    else:
        cost = rng.random((n, m)).astype(np.float32)
    return cost, rng.random(n) < 0.8, rng.random(m) < 0.85


def k2_both(auction, cost, rm, cm, th, dev, **kw):
    """K2 and its plain version on one problem or batch on the card: the
    max |difference| over r2c, c2r and every problem's sweep count (0 means
    bit-identical), the kernel's r2c and its sweeps per problem."""
    import torch

    kw = {**K2_STEEP, **kw}
    b = rm.shape[0] if rm.dim() == 2 else 1
    ks = torch.zeros(b, dtype=torch.int32, device=dev)
    ps = torch.zeros(b, dtype=torch.int32, device=dev)
    kr, kc = auction.masked_assignment_auction_cuda(cost, rm, cm, th,
                                                    sweeps=ks, **kw)
    pr, pc = auction.masked_assignment_auction_torch(cost, rm, cm, th,
                                                     sweeps=ps, **kw)
    torch.cuda.synchronize()
    worst = max(int((kr.long() - pr.long()).abs().max()),
                int((kc.long() - pc.long()).abs().max()),
                int((ks - ps).abs().max()))
    return worst, kr, ks.tolist()


def compare(auction, problems, dev):
    """Kernel vs plain version on each (cost, rm, cm, thresh) at the
    tracker's schedule; returns the max |difference| over r2c, c2r and the
    sweep counts (0 means bit-identical)."""
    return max(k2_both(auction, cost.to(dev), rm.to(dev), cm.to(dev),
                       th.to(dev) if hasattr(th, "to") else th, dev)[0]
               for cost, rm, cm, th in problems)


def dense_host_case(k):
    """The k-th of the twelve dense U[0, 1] problems of random shape that
    tests/test_torch_auction.py pins K2 on (same generator, same seed)."""
    rng = np.random.default_rng(3)
    for _ in range(k + 1):
        n, m = int(rng.integers(2, 60)), int(rng.integers(2, 60))
        cost = rng.random((n, m)).astype(np.float32)
        rm = rng.random(n) < 0.85
        cm = rng.random(m) < 0.85
        th = float(rng.choice([0.3, 0.5, 0.8]))
    return cost, rm, cm, th


def k2_stress_problems(rng, dev):
    """(name, cost, rm, cm, thresh, kwargs) of problems that stress K2's
    sweep: long bidder lists with ties, the unstaged and the scalar paths,
    more rows than columns, nothing to match, a sweep limit that is hit, a
    phase that ends on an unchanged state, more phases, a batch with its
    own cost and threshold for each problem, and two waves of blocks."""
    import torch

    def on_card(*xs):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in xs)

    out = []
    # one cost everywhere: every row bids, and only the jitter and the
    # lowest row break the ties
    out.append(("equal costs, no masks (every row bids, ties)",
                *on_card(np.full((128, 300), 0.25, np.float32),
                         np.ones(128, bool), np.ones(300, bool)), 0.9, {}))
    for kind in ("assoc", "dense"):
        out.append((f"256 x 300 {kind} (cost matrix read through L2)",
                    *on_card(*seeded_problem(rng, 256, 300, kind)), 0.9, {}))
    # 300 x 128 never settles (rows outbid each other for too few columns):
    # the sweep limit ends its phases, at 64 to keep the plain version short
    for n, m, extra in ((7, 5, {}), (300, 128, {"max_iters": 64}),
                        (127, 301, {})):
        out.append((f"{n} x {m} dense" + (", max_iters = 64 (hit)"
                                          if extra else ""),
                    *on_card(*seeded_problem(rng, n, m, "dense")), 0.7,
                    extra))
    cost, _, _ = seeded_problem(rng)
    out.append(("all masked out",
                *on_card(cost, np.zeros(128, bool), np.zeros(300, bool)),
                0.9, {}))
    dense = on_card(*seeded_problem(rng, kind="dense"))
    out.append(("max_iters = 3 (hit)", *dense, 0.9, {"max_iters": 3}))
    *case, th = dense_host_case(9)
    out.append(("dense host case 9 (a phase ends on an unchanged state)",
                *on_card(*case), th, {}))
    out.append(("5 phases at factor 4", *dense, 0.9,
                {"n_phases": 5, "phase_factor": 4.0}))
    probs = [seeded_problem(rng, kind="assoc" if i % 2 else "dense")
             for i in range(6)]
    out.append(("(B, N, M) cost, B = 6 distinct thresholds",
                *on_card(*(np.stack(x) for x in zip(*probs))),
                torch.tensor([0.3, 0.5, 0.6, 0.7, 0.8, 0.9]), {}))
    probs = [seeded_problem(rng, kind="assoc" if i % 8 else "dense")
             for i in range(264)]
    out.append(("B = 264 (two waves of blocks)",
                *on_card(*(np.stack(x) for x in zip(*probs))), 0.9, {}))
    return out


def kernel_phase(dev):
    import torch

    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops.assignment import linear_assignment_host

    rng = np.random.default_rng(0)
    problems = []
    for i in range(32):
        cost, rm, cm = seeded_problem(rng, kind="assoc" if i % 2 == 0
                                      else "dense")
        th = float(rng.choice([0.9, 0.5, 0.7]))
        problems.append((torch.from_numpy(cost), torch.from_numpy(rm),
                         torch.from_numpy(cm), torch.tensor(th)))
    t0 = time.time()
    worst = compare(auction, problems, dev)
    log(f"32 single problems (128, 300): max |kernel - plain| (r2c, c2r, "
        f"sweeps) = {worst} ({time.time() - t0:.1f} s)")
    pairs = []
    for _ in range(4):
        cost, _, _ = seeded_problem(rng)
        rms = torch.from_numpy(rng.random((2, 128)) < 0.5)
        cms = torch.from_numpy(rng.random((2, 300)) < 0.6)
        pairs.append((torch.from_numpy(cost), rms, cms,
                      torch.tensor([0.5, 0.7])))
    worst = max(worst, compare(auction, pairs, dev))
    log(f"4 batch-2 launches at thresholds [0.5, 0.7]: max |kernel - plain| "
        f"so far = {worst}")
    t0 = time.time()
    for name, cost, rm, cm, th, extra in k2_stress_problems(rng, dev):
        d, r2c, sw = k2_both(auction, cost, rm, cm, th, dev, **extra)
        worst = max(worst, d)
        log(f"K2 stress, {name}: max |kernel - plain| (r2c, c2r, sweeps) = "
            f"{d}; sweeps {sw if len(sw) <= 8 else (min(sw), max(sw))}, "
            f"pairs {int((r2c >= 0).sum())}")
    log(f"K2 stress problems: {time.time() - t0:.1f} s")
    if worst != 0:
        raise AssertionError(f"kernel differs from its plain version: {worst}")

    for cost, rm, cm, th in problems[:16:2]:
        r2c, _ = auction.masked_assignment_auction_cuda(
            cost.to(dev), rm.to(dev), cm.to(dev), th.to(dev), **K2_STEEP)
        r2c = r2c.cpu().numpy()
        c = cost.numpy()
        big = np.where(rm.numpy()[:, None] & cm.numpy()[None, :], c, 1e9)
        m0, _, _ = linear_assignment_host(big, float(th))
        got = {(i, int(j)) for i, j in enumerate(r2c) if j >= 0}
        want = {(int(a), int(b)) for a, b in m0}
        gc = sum(float(c[i, j]) for i, j in got)
        wc = sum(float(c[i, j]) for i, j in want)
        if got != want or abs(gc - wc) > 1e-3:
            raise AssertionError(
                f"kernel vs scipy: {len(got)} vs {len(want)} pairs, cost "
                f"{gc} vs {wc}")
    log("8 association problems: kernel == scipy (same pairs, cost 1e-3)")

    # the three ways the kernel holds the weights, timed on seeded problems
    log(f"K2 on seeded problems, on {card_line()}")
    for name, (n, m, kind) in {
            "staged, 16-byte loads": (128, 300, "assoc"),
            "read through L2": (256, 300, "assoc"),
            "staged, scalar loads": (127, 301, "dense")}.items():
        cost, rm, cm = (torch.from_numpy(x).to(dev)
                        for x in seeded_problem(rng, n, m, kind))
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        auction.masked_assignment_auction_cuda(cost, rm, cm, 0.9,
                                               sweeps=sweeps, **K2_STEEP)
        ms = graph_ms(auction.prepared_auction(cost, rm, cm, 0.9,
                                               **K2_STEEP))
        log(f"K2 ({n}, {m}) {kind}, weights {name}: kernel {ms:.4f} ms, "
            f"{int(sweeps)} sweeps, {ms * 1e3 / int(sweeps):.3f} us/sweep")
    return worst


def time_kernel(auction, problem, dev):
    """Kernel ms (launches that follow each other in a CUDA graph, no host
    work between them), ms per call of the wrapper (which its host work
    bounds when the kernel is shorter), plain ms, per-problem sweeps, us
    per sweep of the slowest problem and the bound for one main-path
    problem (cost, rm, cm, thresh) on the card."""
    import torch

    cost, rm, cm, th = (t.to(dev) for t in problem)
    b = rm.shape[0] if rm.dim() == 2 else 1
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    auction.masked_assignment_auction_cuda(cost, rm, cm, th, sweeps=sweeps,
                                           **K2_STEEP)
    k_ms = graph_ms(auction.prepared_auction(cost, rm, cm, th, **K2_STEEP))
    w_ms = cuda_ms(lambda: auction.masked_assignment_auction_cuda(
        cost, rm, cm, th, **K2_STEEP), 50)
    p_ms = cuda_ms(lambda: auction.masked_assignment_auction_torch(
        cost, rm, cm, th, **K2_STEEP), 3)
    n, m = cost.shape[-2:]
    # each input read once, each output written once
    nbytes = cost.numel() * 4 + b * (n + m) + b * 4 + b * (n + m) * 4
    # the function's sweep: every row makes one pass over its m + n
    # columns, one subtract and one max/compare per element
    ops = int(sweeps.sum()) * n * (m + n) * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    sweeps = sweeps.tolist()
    return dict(ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, sweeps=sweeps,
                us_per_sweep=k_ms * 1e3 / max(max(sweeps), 1),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k2_profile_line(auction, name, problem, dev):
    """Log where the cycles of a K2 solve go, by the profiling build
    (clock64() sums on lane 0 of each warp): of a batch the problem with
    the most cycles, and of its warps the one with the most cycles outside
    the barriers (the block's warps meet at every barrier, so any warp's
    parts add up to the solve). Also times the profiling build against the
    timed one. Returns the cycles by part."""
    import torch

    cost, rm, cm, th = (t.to(dev) for t in problem)
    b = rm.shape[0] if rm.dim() == 2 else 1
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    *_, cycles = auction.profile_auction(cost, rm, cm, th, sweeps=sweeps,
                                         **K2_STEEP)
    prof_ms = graph_ms(auction.prepared_auction(
        cost, rm, cm, th, profile=torch.zeros_like(cycles), **K2_STEEP))
    timed_ms = graph_ms(auction.prepared_auction(cost, rm, cm, th,
                                                 **K2_STEEP))
    parts = auction.profile_parts()
    timed = [k for k, part in enumerate(parts) if not part.endswith("count")]
    counts = [k for k, part in enumerate(parts) if part.endswith("count")]
    work = [k for k in timed if "barrier" not in parts[k]]
    slow = int(cycles[:, 0, timed].sum(dim=1).argmax())
    warp = int(cycles[slow][:, work].sum(dim=1).argmax())
    cyc = {parts[k]: int(cycles[slow, warp, k]) for k in timed}
    cyc.update({parts[k]: int(cycles[slow, :, k].sum()) for k in counts})
    total = sum(cyc[parts[k]] for k in timed)
    n_sweeps = max(int(sweeps[slow]), 1)
    log(f"profile of {name} (problem {slow} of {b}, warp {warp}; "
        f"{n_sweeps} sweeps; {total} cycles, {total / n_sweeps:.0f} a "
        f"sweep; profiling build {prof_ms:.4f} ms against "
        f"{timed_ms:.4f} ms): "
        + ", ".join(f"{parts[k]} {cyc[parts[k]]} "
                    f"({100.0 * cyc[parts[k]] / total:.1f}%)" for k in timed)
        + "; " + ", ".join(f"{parts[k]} {cyc[parts[k]]}" for k in counts))
    return cyc | {"sweeps": n_sweeps, "problem": slow, "warp": warp,
                  "cycles": total, "profile_build_ms": prof_ms}


def k2_path_timings(auction, problems, dev):
    """K2 on the problems its paths gave it last ({name: (cost, rm, cm,
    thresh)}): time, sweeps and bound of the timed build, then the
    profiling build's shares. Returns {name: record}."""
    log(f"K2 timings on {card_line()}")
    out = {}
    for name, problem in problems.items():
        t = time_kernel(auction, problem, dev)
        b = len(t["sweeps"])
        log(f"K2 {name} (B={b}, {tuple(problem[0].shape[-2:])}): kernel "
            f"{t['ms']:.4f} ms, sweeps {t['sweeps']}, "
            f"{t['us_per_sweep']:.3f} us/sweep"
            f"{' of the slowest' if b > 1 else ''}, through the wrapper "
            f"{t['wrapper_ms']:.4f} ms a call, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
        out[name] = t
    for name, problem in problems.items():
        out[name]["profile_cycles"] = k2_profile_line(
            auction, f"K2 {name}", problem, dev)
    return out


# ---------------------------------------------------------------------------
# phase 2, continued: K1 and K3 against their plain version
# ---------------------------------------------------------------------------

def scipy_gap(cost, rm, cm, thresh, r2c):
    """Weight (thresh - cost over the pairs) left against scipy's optimum."""
    from yolov7_tracker_tpu_torch.ops.assignment import linear_assignment_host

    big = np.where(rm[:, None] & cm[None, :], cost, 1e9)
    m0, _, _ = linear_assignment_host(big, thresh)
    want = sum(thresh - float(cost[a, b]) for a, b in m0)
    got = sum(thresh - float(cost[i, j]) for i, j in enumerate(r2c) if j >= 0)
    return want - got


def square_bound(n_problems, n, m, cells):
    """(bound ms, bound by) of a square-auction solve: every input read
    once and every output written once, against the operations this data
    needs: one subtract and one compare for each finite cell of the
    extended matrix that the solve must read (every row at each phase's
    release, only the unassigned rows at each sweep; counted by the kernel
    and, identically, by the plain version)."""
    nbytes = n_problems * (n * m * 4 + n + m + 4 + (n + m) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int(cells) * 2 / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_square(square, cost, rm, cm, thresh, dev, reps, plain=True):
    """Kernel ms (CUDA events), plain ms (one run, if asked for), per-problem
    sweeps, cells read and the bound for one (N, M) or (B, N, M) problem on
    the card."""
    import torch

    b = cost.shape[0] if cost.dim() == 3 else 1
    n, m = cost.shape[-2:]
    sweeps = torch.zeros((b, SQUARE_PHASES), dtype=torch.int32, device=dev)
    cells = torch.zeros(b, dtype=torch.int64, device=dev)
    square.masked_assignment_square_cuda(cost, rm, cm, thresh,
                                         n_phases=SQUARE_PHASES,
                                         sweeps=sweeps, cells=cells)
    k_ms = cuda_ms(lambda: square.masked_assignment_square_cuda(
        cost, rm, cm, thresh, n_phases=SQUARE_PHASES), reps)
    p_ms = None
    if plain:
        torch.cuda.synchronize()
        t0 = time.time()
        square.masked_assignment_square_torch(cost, rm, cm, thresh,
                                              n_phases=SQUARE_PHASES)
        torch.cuda.synchronize()
        p_ms = (time.time() - t0) * 1e3
    per_problem = sweeps.sum(dim=1).tolist()
    bound, by = square_bound(b, n, m, int(cells.sum()))
    return dict(ms=k_ms, plain_ms=p_ms, sweeps=per_problem,
                cells=cells.tolist(),
                us_per_sweep=k_ms * 1e3 / max(max(per_problem), 1),
                bound_ms=bound, bound_by=by)


def square_diff(a, b):
    """max |difference| over two (r2c, c2r) results."""
    return max(int((a[0].long() - b[0].long()).abs().max()),
               int((a[1].long() - b[1].long()).abs().max()))


def square_check(square, cost, rm, cm, thresh, dev, **kw):
    """K1 or K3 against the plain version on one problem or batch: the max
    |difference| over r2c, c2r, the sweeps of every phase and problem and
    the cells read (0 means bit-identical), with the kernel's result and
    its sweeps per problem."""
    import torch

    kw.setdefault("n_phases", SQUARE_PHASES)
    b = cost.shape[0] if cost.dim() == 3 else 1
    outs = []
    for solve in (square.masked_assignment_square_cuda,
                  square.masked_assignment_square_torch):
        sweeps = torch.zeros((b, kw["n_phases"]), dtype=torch.int32,
                             device=dev)
        cells = torch.zeros(b, dtype=torch.int64, device=dev)
        outs.append((solve(cost, rm, cm, thresh, sweeps=sweeps, cells=cells,
                           **kw), sweeps, cells))
    torch.cuda.synchronize()
    (k, ks, kc), (p, ps, pc) = outs
    worst = max(square_diff(k, p), int((ks - ps).abs().max()),
                int((kc - pc).abs().max()))
    return worst, k, ks.sum(dim=1).tolist()


def stress_problems(rng, dev):
    """(name, cost, rm, cm, thresh, kwargs) of problems that stress the
    sweep: long bidder lists, the unstaged and the scalar paths, a list that
    is empty from the start, a sweep limit that is hit, more phases, and a
    batch of two waves of blocks."""
    import torch

    def on_card(*xs):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in xs)

    out = []
    # every cost far under the limit: each release frees every row, so the
    # first sweeps of a phase have hundreds of bidders
    cost = rng.uniform(0.0, 0.4, (128, 300)).astype(np.float32)
    out.append(("dense under the limit, no masks (all rows bid)",
                *on_card(cost, np.ones(128, bool), np.ones(300, bool)), 0.9,
                {}))
    for kind in ("assoc", "dense"):
        out.append((f"256 x 300 {kind} (cost matrix read through L2)",
                    *on_card(*seeded_problem(rng, 256, 300, kind)), 0.9, {}))
    for n, m in ((7, 5), (130, 100), (40, 23)):
        out.append((f"{n} x {m} dense",
                    *on_card(*seeded_problem(rng, n, m, "dense")), 0.7, {}))
    cost, _, _ = seeded_problem(rng)
    out.append(("all masked out",
                *on_card(cost, np.zeros(128, bool), np.zeros(300, bool)),
                0.9, {}))
    assoc = on_card(*seeded_problem(rng))
    out.append(("max_iters = 20 (hit)", *assoc, 0.9, {"max_iters": 20}))
    out.append(("6 phases", *assoc, 0.9, {"n_phases": 6}))
    probs = [seeded_problem(rng, kind="assoc" if i % 8 else "dense")
             for i in range(264)]
    out.append(("K3, B = 264 (two waves of blocks), 3 phases",
                *on_card(*(np.stack(x) for x in zip(*probs))), 0.9,
                {"n_phases": 3}))
    return out


def profile_line(square, name, cost, rm, cm, thresh, dev):
    """Log where the cycles of a solve go, by the profiling build of K1/K3
    (clock64() sums on lane 0 of each warp): of a batch the problem with
    the most cycles; the shares of the whole solve, and the parts of a
    shared-out sweep on the warp that worked the most in them. Also times
    the profiling build against the timed one."""
    import torch

    b = cost.shape[0] if cost.dim() == 3 else 1
    kw = dict(n_phases=SQUARE_PHASES)
    sweeps = torch.zeros((b, SQUARE_PHASES), dtype=torch.int32, device=dev)
    *_, cycles = square.profile_square(cost, rm, cm, thresh, sweeps=sweeps,
                                       **kw)
    prof_ms = cuda_ms(lambda: square.profile_square(cost, rm, cm, thresh,
                                                    **kw), 5)
    timed_ms = cuda_ms(lambda: square.masked_assignment_square_cuda(
        cost, rm, cm, thresh, **kw), 5)
    parts = square.PROFILE_PARTS[:-2]
    per_solve = ("stage", "release", "long-list sweeps", "solo sweeps",
                 "solo wait", "gate")
    in_sweep = [k for k in parts if k not in per_solve]
    work = [parts.index(k) for k in in_sweep if not k.endswith("barrier")]
    slow = int(cycles[:, 0, :-2].sum(dim=1).argmax())
    n_long = int(cycles[slow, 0, -2])
    n_solo = int(cycles[slow, :, -1].sum())
    solo_cycles = int(cycles[slow, :, parts.index("solo sweeps")].sum())
    warp = int(cycles[slow][:, work].sum(dim=1).argmax())
    cyc = dict(zip(parts, cycles[slow, warp, :-2].tolist()))
    n_sweeps = max(int(sweeps[slow].sum()), 1)
    n_short = max(n_sweeps - n_long - n_solo, 1)
    # the block's warps meet at every barrier, so any warp's parts add up
    # to the solve; only one warp at a time runs solo sweeps
    shared = sum(cyc[k] for k in in_sweep)
    walls = {"stage": cyc["stage"], "release": cyc["release"],
             "long-list sweeps": cyc["long-list sweeps"],
             "shared-out sweeps": shared, "solo sweeps": solo_cycles,
             "gate": cyc["gate"]}
    total = sum(walls.values())
    each = {"long-list sweeps": n_long, "shared-out sweeps": n_short,
            "solo sweeps": n_solo}
    log(f"profile of {name} (problem {slow} of {b}; {n_sweeps} sweeps: "
        f"{n_long} with long lists, {n_short} shared out, {n_solo} solo; "
        f"{total} cycles; profiling build {prof_ms:.4f} ms against "
        f"{timed_ms:.4f} ms): "
        + ", ".join(
            f"{k} {v} ({100.0 * v / total:.1f}%"
            + (f", {v / max(each[k], 1):.0f} each)" if k in each else ")")
            for k, v in walls.items())
        + f"; a shared-out sweep on its busiest warp ({warp}): "
        + ", ".join(f"{k} {cyc[k] / n_short:.0f}" for k in in_sweep))
    return cyc | walls | {
        "sweeps": n_sweeps, "long_list_sweep_count": n_long,
        "shared_out_sweep_count": n_short, "solo_sweep_count": n_solo,
        "problem": slow, "warp": warp, "profile_build_ms": prof_ms}


def square_phase(dev):
    """K1 and K3 against the plain version at (128, 300) and on the stress
    problems; returns the max |difference| over every r2c, c2r, sweep count
    and cell count compared, and timings of one association-shaped K1
    problem and one K3 batch of 8."""
    import torch

    from yolov7_tracker_tpu_torch.ops import auction_square as square

    diff = square_diff
    kw = dict(n_phases=SQUARE_PHASES)
    rng = np.random.default_rng(1)
    worst = 0
    t0 = time.time()
    singles, results, gaps = [], [], []
    ks = torch.zeros((8, SQUARE_PHASES), dtype=torch.int32, device=dev)
    kc = torch.zeros(8, dtype=torch.int64, device=dev)
    for i in range(8):
        cost, rm, cm = seeded_problem(rng, kind="assoc" if i % 2 == 0
                                      else "dense")
        th = float(rng.choice([0.9, 0.7]))
        args = tuple(torch.from_numpy(x).to(dev) for x in (cost, rm, cm))
        k = square.masked_assignment_square_cuda(
            *args, th, sweeps=ks[i:i + 1], cells=kc[i:i + 1], **kw)
        gap = scipy_gap(cost, rm, cm, th, k[0].cpu().numpy())
        # the auction guarantees (n + m) * eps_final of the optimum (0.7
        # to 0.8 at the tracker's 5 phases), which a visibly wrong matching
        # would meet too; these seeded problems leave 0.025 at most, so
        # hold them to twice that
        gaps.append(gap)
        if abs(gap) > SCIPY_GAP_LIMIT:
            raise AssertionError(f"K1 vs scipy, problem {i}: gap {gap}")
        singles.append(args + (th,))
        results.append(k)
    # the plain version solves the eight in lockstep, each as it would
    # alone (tests/test_torch_auction_square.py holds it to that), in a
    # sixth of the time of eight solves
    ps = torch.zeros_like(ks)
    pc = torch.zeros_like(kc)
    p = square.masked_assignment_square_torch(
        *(torch.stack(x) for x in list(zip(*singles))[:3]),
        torch.tensor([x[3] for x in singles]), sweeps=ps, cells=pc, **kw)
    torch.cuda.synchronize()
    worst = max([diff(k, (p[0][i], p[1][i])) for i, k in enumerate(results)]
                + [int((ks - ps).abs().max()), int((kc - pc).abs().max())])
    log(f"K1: 8 single problems (128, 300): max |kernel - plain| (r2c, c2r, "
        f"sweeps per phase, cells) = {worst}; "
        f"weight left against scipy, association "
        f"{[round(g, 5) for g in gaps[0::2]]}, dense "
        f"{[round(g, 5) for g in gaps[1::2]]} (limit {SCIPY_GAP_LIMIT}) "
        f"({time.time() - t0:.1f} s)")

    batches = {}
    for b in (8, 16):
        probs = [seeded_problem(rng, kind="assoc" if i % 4 else "dense")
                 for i in range(b)]
        cost, rm, cm = (torch.from_numpy(np.stack(x)).to(dev)
                        for x in zip(*probs))
        d, k, _ = square_check(square, cost, rm, cm, 0.9, dev)
        alone = 0
        for i in range(b):
            one = square.masked_assignment_square_cuda(
                cost[i].contiguous(), rm[i], cm[i], 0.9, **kw)
            alone = max(alone, diff(one, (k[0][i], k[1][i])))
        torch.cuda.synchronize()
        worst = max(worst, d, alone)
        log(f"K3: batch of {b}: max |kernel - plain| = {d}, max "
            f"|K3 - K1 on each problem alone| = {alone}")
        batches[b] = (cost, rm, cm)
    t0 = time.time()
    for name, cost, rm, cm, th, extra in stress_problems(rng, dev):
        d, k, sw = square_check(square, cost, rm, cm, th, dev, **extra)
        worst = max(worst, d)
        log(f"stress, {name}: max |kernel - plain| = {d} (r2c, c2r, sweeps "
            f"per phase, cells); sweeps {sw if len(sw) <= 8 else max(sw)}, "
            f"pairs {int((k[0] >= 0).sum())}")
    log(f"stress problems: {time.time() - t0:.1f} s")
    if worst != 0:
        raise AssertionError(
            f"square auction kernel differs from its plain version: {worst}")

    t1 = time_square(square, *singles[0], dev, reps=20, plain=False)
    t3 = {b: time_square(square, *batches[b], 0.9, dev, reps=10, plain=False)
          for b in batches}
    log(f"K1/K3 timings on {card_line()}")
    log(f"K1 (128, 300) association: kernel {t1['ms']:.4f} ms, "
        f"{t1['sweeps'][0]} sweeps, {t1['us_per_sweep']:.3f} us/sweep, "
        f"bound {t1['bound_ms']:.6f} ms ({t1['bound_by']})")
    for b, t in t3.items():
        log(f"K3 B={b}: kernel {t['ms']:.4f} ms, sweeps {t['sweeps']}, "
            f"{t['us_per_sweep']:.3f} us/sweep of the slowest, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    profile_line(square, "K1 on the seeded association problem", *singles[0],
                 dev)
    profile_line(square, "K3 on the seeded batch of 8", *batches[8], 0.9,
                 dev)
    # K3's time against the batch: one block per problem, so up to the
    # card's 132 SMs a launch should cost what its slowest problem costs
    probs = [seeded_problem(rng) for _ in range(264)]
    cost, rm, cm = (torch.from_numpy(np.stack(x)).to(dev)
                    for x in zip(*probs))
    against_b = {}
    for b in (1, 8, 32, 132, 264):
        sweeps = torch.zeros((b, SQUARE_PHASES), dtype=torch.int32,
                             device=dev)
        square.masked_assignment_square_cuda(
            cost[:b], rm[:b], cm[:b], 0.9, sweeps=sweeps, **kw)
        ms = cuda_ms(lambda: square.masked_assignment_square_cuda(
            cost[:b], rm[:b], cm[:b], 0.9, **kw), 10)
        against_b[b] = (ms, int(sweeps.sum(dim=1).max()))
    log("K3 against the batch (association problems; ms, sweeps of the "
        "slowest): " + ", ".join(
            f"B={b}: {ms:.3f} ms, {sw}" for b, (ms, sw) in against_b.items()))
    return worst, t1, t3


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def build_w6(dev):
    """yolov7-w6 at full width with seeded, head-sharpened weights, as a
    TrackingPipeline (ByteTrack 128 / 300); returns (state_dict, pipe)."""
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import (random_state_dict,
                                                      sharpen_heads)
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as S

    spec = zoo.get_spec("yolov7-w6", nc=80)
    sd = random_state_dict(spec, seed=0, gain=DETECTOR_GAIN)
    sharpen_heads(sd, spec)
    pcfg = PipelineConfig(model="yolov7-w6", nc=80, img_size=1088,
                          detector_batch=8, dtype="bfloat16", fuse=True)
    tcfg = S.TrackerConfig(tracker="bytetrack", conf_thresh=0.5,
                           capacity=128, det_capacity=300)
    return sd, TrackingPipeline(pcfg, tcfg, state_dict=sd, spec=spec,
                                device=dev)


def main_phase(pipe, dev):
    import torch

    from yolov7_tracker_tpu_torch.data import writer
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.trackers import bytetrack
    from yolov7_tracker_tpu_torch.trackers import slab as S

    rng = np.random.default_rng(0)
    f0 = rng.integers(0, 255, (8, 1080, 1920, 3), np.uint8)
    f1 = np.roll(f0, 8, axis=2)       # an 8-px shift: the scene persists
    frames = [f for k in range(2) for f in (f0, f1)[k % 2]]      # 16

    t0 = time.time()
    pipe.run_sequence(iter(frames[:8]))         # warm-up, not counted
    torch.cuda.synchronize()
    log(f"warm-up batch (cuDNN autotune, first launches): "
        f"{time.time() - t0:.1f} s")

    dets = []                 # what the detector handed the tracker
    solves = []               # the tracker's auction problems
    detect_batch, solve = pipe.detect_batch, bytetrack.solve_assignment

    def recording_detect(frames_u8):
        out = detect_batch(frames_u8)
        dets.append(tuple(t.clone() for t in out))
        return out

    def recording_solve(cost, rm, cm, th):
        solves.append((cost.float().clone(), rm.clone(), cm.clone(),
                       torch.as_tensor(th, dtype=torch.float32,
                                       device=cost.device).clone()))
        return solve(cost, rm, cm, th)

    pipe.detect_batch = recording_detect
    bytetrack.solve_assignment = recording_solve
    auction.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    results, slab = pipe.run_sequence_stateful(iter(frames))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = auction.LAUNCHES
    bytetrack.solve_assignment = solve
    del pipe.detect_batch

    n = len(frames)
    if launches != 2 * n:
        raise AssertionError(f"{launches} auction launches for {n} frames")
    tracks = [len(ids) for _, ids, _, _ in results]
    if len(results) != n or max(tracks) < 1:
        raise AssertionError(f"tracks per frame {tracks}")
    counts = torch.cat([d[3] for d in dets]).cpu()
    boxes = torch.cat([d[0] for d in dets])
    if not bool(torch.isfinite(boxes).all()):
        raise AssertionError("non-finite detector boxes")
    path = writer.save_results(OUT_DIR, "synthetic", results)
    with open(path) as f:
        rows = sum(1 for _ in f)
    if rows != sum(tracks):
        raise AssertionError(f"{rows} MOT rows for {sum(tracks)} tracks")
    log(f"main path on {card_line()}: {n} frames in {wall:.3f} s = "
        f"{n / wall:.2f} frames/s, "
        f"{wall / n * 1e3:.2f} ms/frame; {launches} K2 launches; NMS "
        f"survivors/frame {counts.float().mean():.1f}; tracks/frame "
        f"min {min(tracks)} mean {np.mean(tracks):.1f} max {max(tracks)}; "
        f"{rows} MOT rows -> {path}")

    breakdown(pipe, f1, dets[-1], dev)

    # the main path's own auction problems: kernel == plain version
    worst = compare(auction, solves[-16:], dev)
    log(f"last 16 main-path solves re-run: max |kernel - plain| = {worst}")
    if worst != 0:
        raise AssertionError("kernel differs from its plain version on "
                             "the main path's problems")

    # replay the tracker on the CPU (plain auction) from the same dets
    cpu_slab = S.init_slab(pipe.tcfg, "cpu")
    frame = 0
    for boxes_b, score_b, cls_b, count_b in dets:
        for i in range(boxes_b.shape[0]):
            det = pipe.dets_to_slab(boxes_b[i].cpu(), score_b[i].cpu(),
                                    cls_b[i].cpu(), count_b[i].cpu())
            cpu_slab, out = pipe.step(cpu_slab, det)
            _, ids, tlwhs, _ = results[frame]
            v = out.valid.numpy()
            if out.track_id.numpy()[v].tolist() != ids or not np.allclose(
                    out.tlwh.numpy()[v], np.asarray(tlwhs).reshape(-1, 4),
                    atol=1e-2):
                raise AssertionError(f"CPU replay differs at frame {frame}")
            frame += 1
    log(f"CPU tracker replay of {frame} frames: same ids, boxes within "
        "1e-2 px")
    return launches, solves


def breakdown(pipe, frames_u8, batch_dets, dev):
    """Where one batch of 8 frames spends its time, each stage timed
    alone with CUDA events (the NMS and tracker stages include their host
    syncs and launch gaps)."""
    import torch

    from yolov7_tracker_tpu_torch.data import letterbox
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    frames = pipe._frames(frames_u8)
    src_hw = tuple(frames.shape[1:3])
    out_hw, unpad_hw = pipe._geometry(src_hw)
    with torch.no_grad():
        imgs, _ = letterbox.device_preprocess(
            frames, src_hw, out_hw, unpad_hw=unpad_hw, dtype=pipe.dtype)
        raw = pipe.model(imgs)
        t_h2d = cuda_ms(lambda: pipe._frames(frames_u8), 3)
        t_pre = cuda_ms(lambda: letterbox.device_preprocess(
            frames, src_hw, out_hw, unpad_hw=unpad_hw, dtype=pipe.dtype), 5)
        t_model = cuda_ms(lambda: pipe.model(imgs), 5)
        t_nms = cuda_ms(lambda: nms_mod.nms_from_raw(
            raw, pipe._anchors, tuple(pipe.spec.strides),
            pipe.pcfg.conf_thres, pipe.pcfg.iou_thres,
            max_det=pipe.pcfg.max_det, top_k=pipe.pcfg.nms_top_k), 2)
    boxes, score, cls, counts = batch_dets
    slabs = [pipe.dets_to_slab(boxes[b], score[b], cls[b], counts[b])
             for b in range(boxes.shape[0])]
    t_track = cuda_ms(lambda: pipe.track_frames(pipe.init_tracker(), slabs),
                      2)
    b = frames.shape[0]
    log(f"per-frame breakdown on {card_line()} (batch {b}): "
        f"H2D {t_h2d / b:.2f} ms, "
        f"letterbox {t_pre / b:.2f} ms, w6 forward {t_model / b:.2f} ms, "
        f"NMS {t_nms / b:.2f} ms, ByteTrack step {t_track / b:.2f} ms")


# ---------------------------------------------------------------------------
# phase 4: many-camera serving through cli/serve.py
# ---------------------------------------------------------------------------

def read_mot(path):
    """{frame: set(ids)} of one MOT txt."""
    by_frame = {}
    with open(path) as f:
        for line in f:
            frame, tid = line.split(",")[:2]
            by_frame.setdefault(int(frame), set()).add(int(tid))
    return by_frame


def serving_phase(sd, pipe, dev):
    """Drive cli.serve.main twice (16 ticks, then 8 resumed) on 8 synthetic
    cameras and check its outputs, its launch counts and its last tick's
    stage-1 solves; returns (K3 launches, K2 launches, last stage-1
    problem, last stage-2/3 problem)."""
    import torch

    from yolov7_tracker_tpu_torch import pipeline as pipeline_mod
    from yolov7_tracker_tpu_torch.cli import serve
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square
    from yolov7_tracker_tpu_torch.trackers import bytetrack

    total = sum(SERVE_TICKS)
    streams = [f"synth://{total}x1080x1920?seed={k + 1}&shift=8"
               for k in range(N_STREAMS)]
    last = {}                   # the newest problem handed to each solver
    stamps = []                 # (start, end) of every tick, synchronized
    solve1, solve23 = pipeline_mod.masked_assignment, \
        bytetrack.solve_assignment
    tick_fn = pipeline_mod.TrackingPipeline.process_multistream

    def recording(name, solve):
        def wrapped(cost, rm, cm, th, *args, **kw):
            last[name] = (cost.float().clone(), rm.clone(), cm.clone(), th)
            return solve(cost, rm, cm, th, *args, **kw)
        return wrapped

    def timed_tick(self, slabs, frames_u8):
        torch.cuda.synchronize()
        t0 = time.time()
        out = tick_fn(self, slabs, frames_u8)
        torch.cuda.synchronize()
        stamps.append((t0, time.time()))
        return out

    counts = []
    pipeline_mod.masked_assignment = recording("stage1", solve1)
    bytetrack.solve_assignment = recording("stage23", solve23)
    pipeline_mod.TrackingPipeline.process_multistream = timed_tick
    try:
        with tempfile.TemporaryDirectory() as tmp:
            weights = os.path.join(tmp, "w6.pt")
            torch.save(sd, weights)
            save_dir = os.path.join(OUT_DIR, "serve")
            state_dir = os.path.join(tmp, "state")
            for ticks in SERVE_TICKS:
                argv = ["--streams", *streams, "--model", "yolov7-w6",
                        "--model_path", weights, "--nc", "80", "--img_size",
                        "1088", "--conf_thresh", "0.5", "--capacity", "128",
                        "--det_capacity", "300", "--max_frames", str(ticks),
                        "--save_dir", save_dir, "--state_dir", state_dir]
                auction.LAUNCHES = 0
                square.LAUNCHES_K1 = square.LAUNCHES_K3 = 0
                results, preempted = serve.main(argv)
                torch.cuda.synchronize()
                counts.append((square.LAUNCHES_K3, auction.LAUNCHES,
                               square.LAUNCHES_K1))
                if preempted or [len(r) for r in results] != \
                        [ticks] * N_STREAMS:
                    raise AssertionError(
                        f"serve: {[len(r) for r in results]} frames per "
                        f"stream for {ticks} ticks")
            states = sorted(os.listdir(state_dir))
            slabs = [pipe.load_tracker_state(os.path.join(state_dir, f),
                                             expect_tag=streams[i])
                     for i, f in enumerate(states)]
    finally:
        pipeline_mod.masked_assignment = solve1
        bytetrack.solve_assignment = solve23
        pipeline_mod.TrackingPipeline.process_multistream = tick_fn

    for (k3, k2, k1), ticks in zip(counts, SERVE_TICKS):
        if (k3, k2, k1) != (ticks, ticks, 0):
            raise AssertionError(
                f"serve: {k3} K3, {k2} K2, {k1} K1 launches in {ticks} ticks")
    files = sorted(os.listdir(save_dir))
    if len(files) != N_STREAMS or len(slabs) != N_STREAMS:
        raise AssertionError(f"serve: result files {files}, states {states}")
    rows = 0
    first = SERVE_TICKS[0]
    for f, slab in zip(files, slabs):
        by_frame = read_mot(os.path.join(save_dir, f))
        if sorted(by_frame) != list(range(1, total + 1)):
            raise AssertionError(f"{f}: rows for frames {sorted(by_frame)}")
        rows += sum(len(v) for v in by_frame.values())
        before = set().union(*(by_frame[k] for k in range(1, first + 1)))
        carried = by_frame[first] & by_frame[first + 1]
        fresh = set().union(*(by_frame[k] for k in range(first + 1,
                                                         total + 1))) - before
        # ids live across the restart, and ids born after it lie above
        # every id given out before it
        if not carried or (fresh and min(fresh) <= max(before)) or \
                int(slab.frame) != total:
            raise AssertionError(
                f"{f}: ids do not continue across the resume (carried "
                f"{len(carried)}, new {sorted(fresh)[:4]}, before max "
                f"{max(before)}, state frame {int(slab.frame)})")
    steady = stamps[2:first] + stamps[first + 2:]
    tick_ms = float(np.mean([b - a for a, b in steady])) * 1e3
    span = [(stamps[first - 1][1] - stamps[2][0]) / (first - 2),
            (stamps[-1][1] - stamps[first + 2][0]) / (total - first - 2)]
    loop_ms = float(np.mean(span)) * 1e3
    log(f"serving on {card_line()}: {N_STREAMS} streams x "
        f"{SERVE_TICKS[0]} + {SERVE_TICKS[1]} ticks (resumed), "
        f"{rows} MOT rows in {len(files)} files, ids continue; launches per "
        f"call (K3, K2, K1) {counts}; process_multistream "
        f"{tick_ms:.2f} ms/tick, whole loop (frame queues, stacking, "
        f"harvest) {loop_ms:.2f} ms/tick = "
        f"{N_STREAMS / loop_ms * 1e3:.2f} frames/s aggregate, "
        f"{loop_ms / N_STREAMS:.2f} ms/frame")

    # the last tick's own stage-1 problems: kernel == plain version
    cost, rm, cm, th = last["stage1"]
    worst, k, _ = square_check(square, cost, rm, cm, th, dev)
    distinct = len({c.cpu().numpy().tobytes() for c in cost})
    log(f"last tick's {cost.shape[0]} stage-1 problems ({distinct} distinct "
        f"cost matrices) re-solved: max |K3 - plain| (r2c, c2r, sweeps per "
        f"phase, cells) = {worst}; pairs per "
        f"stream {(k[0] >= 0).sum(dim=1).tolist()}")
    if worst != 0:
        raise AssertionError("K3 differs from its plain version on the "
                             "serving path's problems")
    serving_breakdown(pipe, slabs, streams, last, dev)
    return sum(c[0] for c in counts), sum(c[1] for c in counts), last


def serving_breakdown(pipe, slabs, streams, last, dev):
    """Where one tick of 8 streams spends its time, each stage timed alone
    (CUDA events; NMS and the tracker step include their host syncs and
    launch gaps), beside the solvers' kernels on the tick's own problems."""
    import torch

    from yolov7_tracker_tpu_torch.data import letterbox
    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod
    from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
    from yolov7_tracker_tpu_torch.trackers import slab as S

    # each camera's last served frame, and the state before it was stepped
    # is gone: step the final states once more on the same frame instead
    frames_u8 = np.stack([list(SynthFrames(s))[-1] for s in streams])
    stacked = S.TrackSlab(*(torch.stack(x) for x in zip(*slabs)))
    t0 = time.time()
    for _ in range(3):
        np.stack(list(frames_u8))
    t_stack = (time.time() - t0) / 3 * 1e3
    frames = pipe._frames(frames_u8)
    src_hw = tuple(frames.shape[1:3])
    out_hw, unpad_hw = pipe._geometry(src_hw)
    with torch.no_grad():
        imgs, _ = letterbox.device_preprocess(
            frames, src_hw, out_hw, unpad_hw=unpad_hw, dtype=pipe.dtype)
        raw = pipe.model(imgs)
        t_h2d = cuda_ms(lambda: pipe._frames(frames_u8), 3)
        t_pre = cuda_ms(lambda: letterbox.device_preprocess(
            frames, src_hw, out_hw, unpad_hw=unpad_hw, dtype=pipe.dtype), 5)
        t_model = cuda_ms(lambda: pipe.model(imgs), 5)
        t_nms = cuda_ms(lambda: nms_mod.nms_from_raw(
            raw, pipe._anchors, tuple(pipe.spec.strides),
            pipe.pcfg.conf_thres, pipe.pcfg.iou_thres,
            max_det=pipe.pcfg.max_det, top_k=pipe.pcfg.nms_top_k), 2)
    dets = pipe.dets_to_slab(*pipe.detect_batch(frames_u8))
    t_step = cuda_ms(lambda: pipe.step(stacked, dets,
                                       solve_stage1=masked_assignment), 3)
    t_one = cuda_ms(lambda: pipe.step(
        slabs[0], S.DetSlab(*(x[0] for x in dets))), 3)
    c1, r1, m1, th1 = last["stage1"]
    c2, r2, m2, th2 = last["stage23"]
    t_k3 = cuda_ms(lambda: square.masked_assignment_square_cuda(
        c1, r1, m1, th1, n_phases=SQUARE_PHASES), 10)
    t_k2 = graph_ms(auction.prepared_auction(c2.contiguous(), r2, m2, th2,
                                             **K2_STEEP))
    n = frames.shape[0]
    log(f"per-tick breakdown on {card_line()} ({n} streams): stack frames "
        f"on the host {t_stack:.2f} ms, H2D {t_h2d:.2f} ms, letterbox "
        f"{t_pre:.2f} ms, w6 forward {t_model:.2f} ms, NMS {t_nms:.2f} ms, "
        f"stacked ByteTrack step {t_step:.2f} ms (of which K3 B={n} "
        f"{t_k3:.4f} ms and K2 B={2 * n} {t_k2:.4f} ms); the same step on "
        f"one stream alone (K2 for every stage) {t_one:.2f} ms, so "
        f"{t_step / n:.2f} against {t_one:.2f} ms of tracker per frame")


# ---------------------------------------------------------------------------
# phase 5: step_frame, the one-stream streaming mode
# ---------------------------------------------------------------------------

def step_frame_phase(pipe, dev):
    """8 frames of one camera through step_frame (K1 once per frame) and
    through a one-stream process_multistream (K3, B = 1): the same slab.
    Returns (K1 launches, the last stage-1 problem)."""
    import torch

    from yolov7_tracker_tpu_torch import pipeline as pipeline_mod
    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
    from yolov7_tracker_tpu_torch.ops import auction_square as square

    frames = list(SynthFrames("synth://8x1080x1920?seed=11&shift=8"))
    last = {}
    solve1 = pipeline_mod.masked_assignment

    def recording(cost, rm, cm, th, *args, **kw):
        last["stage1"] = (cost.float().clone(), rm.clone(), cm.clone(), th)
        return solve1(cost, rm, cm, th, *args, **kw)

    pipeline_mod.masked_assignment = recording
    try:
        square.LAUNCHES_K1 = square.LAUNCHES_K3 = 0
        slab = pipe.init_tracker()
        per_frame = []
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.time()
            slab, out = pipe.step_frame(slab, f)
            torch.cuda.synchronize()
            per_frame.append((time.time() - t0) * 1e3)
        k1, k3 = square.LAUNCHES_K1, square.LAUNCHES_K3
    finally:
        pipeline_mod.masked_assignment = solve1
    if (k1, k3) != (len(frames), 0):
        raise AssertionError(f"step_frame: {k1} K1 and {k3} K3 launches for "
                             f"{len(frames)} frames")
    slabs = pipe.init_multistream(1)
    for f in frames:
        slabs, outs = pipe.process_multistream(slabs, f[None])
    for name, a, b in zip(slab._fields, slab, slabs):
        same = (torch.equal(a, b[0]) if not a.dtype.is_floating_point
                else torch.allclose(a, b[0], rtol=1e-5, atol=1e-4))
        if not same:
            raise AssertionError(f"step_frame vs one-stream multistream: "
                                 f"{name} differs")
    # the last frame's own stage-1 problem: kernel == plain version
    cost, rm, cm, th = last["stage1"]
    worst, k, _ = square_check(square, cost, rm, cm, th, dev)
    if worst != 0:
        raise AssertionError("K1 differs from its plain version on "
                             f"step_frame's own problem: {worst}")
    if not bool(out.valid.any()) or not torch.equal(out.valid, outs.valid[0]):
        raise AssertionError("step_frame emitted no track, or other tracks "
                             "than the one-stream multistream run")
    log(f"step_frame on {card_line()}: {len(frames)} frames, {k1} K1 "
        f"launches, ms per frame {[round(t, 2) for t in per_frame]} (the "
        f"first pays the batch-1 warm-up), median "
        f"{float(np.median(per_frame)):.2f}; "
        f"{int(out.valid.sum())} tracks on the last; slab == lane 0 of a "
        "one-stream process_multistream run (integers exact, floats "
        f"1e-5 / 1e-4); last frame's stage-1 problem re-solved: max "
        f"|K1 - plain| (r2c, c2r, sweeps per phase, cells) = {worst}, "
        f"{int((k[0] >= 0).sum())} pairs")
    return k1, last["stage1"]


def detector_reference_check(dev):
    """A small detector input on the card (float32, TF32 off) against the
    same computation on the CPU: preprocess + raw head levels."""
    import torch

    from yolov7_tracker_tpu_torch.data import letterbox
    from yolov7_tracker_tpu_torch.models import spec as spec_mod
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import (YoloV7,
                                                      random_state_dict)

    spec = spec_mod.parse_yaml_cfg(
        {"nc": 8, "depth_multiple": 1.0, "width_multiple": 0.25,
         "anchors": zoo.ANCHORS_P6, "backbone": zoo.yolov7_w6_rows(),
         "head": []})
    sd = fuse_state_dict(random_state_dict(spec, seed=3))
    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, (2, 180, 320, 3), np.uint8))
    outs = []
    for d in ("cpu", dev):
        model = YoloV7(spec, fused=True)
        model.load_state_dict(sd)
        model = model.to(d).eval()
        with torch.no_grad():
            img, _ = letterbox.device_preprocess(
                frames.to(d), (180, 320), (192, 320), unpad_hw=(180, 320))
            outs.append([img.cpu()] + [r.cpu() for r in model(img)])
    worst = max(float((a - b).abs().max()) for a, b in zip(*outs))
    if not worst <= 1e-3 or not all(bool(torch.isfinite(t).all())
                                    for t in outs[1]):
        raise AssertionError(f"card vs CPU detector: max |diff| {worst}")
    log(f"detector on a small input, card vs CPU float32: max |diff| "
        f"{worst:.2e} (tolerance 1e-3)")


def path_timings(square, step_last, tick_last, dev):
    """K1 on step_frame's last problem and K3 on a serving tick's, as their
    paths gave them: time, sweeps, cells and bound of the timed build, then
    the profiling build's shares. Returns the two records."""
    on_step = time_square(square, *step_last, dev, reps=20)
    on_tick = time_square(square, *tick_last, dev, reps=10)
    b = tick_last[0].shape[0]
    log(f"K1/K3 on their paths' problems, on {card_line()}")
    log(f"K1 on step_frame's last problem: kernel {on_step['ms']:.4f} ms, "
        f"sweeps {on_step['sweeps']}, {on_step['us_per_sweep']:.3f} "
        f"us/sweep, cells {on_step['cells']}, plain "
        f"{on_step['plain_ms']:.1f} ms, bound {on_step['bound_ms']:.6f} ms "
        f"({on_step['bound_by']})")
    log(f"K3 on the last serving tick's problems (B={b}): kernel "
        f"{on_tick['ms']:.4f} ms, sweeps {on_tick['sweeps']}, "
        f"{on_tick['us_per_sweep']:.3f} us/sweep of the slowest, cells "
        f"{on_tick['cells']}, plain "
        f"{on_tick['plain_ms']:.1f} ms, bound {on_tick['bound_ms']:.6f} ms "
        f"({on_tick['bound_by']})")
    on_step["profile_cycles"] = profile_line(
        square, "K1 on step_frame's last problem", *step_last, dev)
    on_tick["profile_cycles"] = profile_line(
        square, f"K3 on the last serving tick's problems (B={b})",
        *tick_last, dev)
    return on_step, on_tick


def build_kernels(mods):
    """One nvcc per build, all started together; mods: (module, source,
    load_library arguments). Raises if a build failed."""
    t0 = time.time()
    threads = [threading.Thread(target=mod.load_library, args=args)
               for mod, _, args in mods]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for mod, source, args in mods:
        mod.load_library(*args)      # raises here if its build failed
        if args:
            # the profiling build, same source: what its counters cost
            for line in getattr(mod, "PROFILE_BUILD_LOG", "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas, profiling build of {source}: "
                        f"{line.strip()}")
            continue
        log(f"built {source} for sm_90a in {mod.BUILD_SECONDS:.1f} s")
        for line in mod.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")
            elif "Compiling entry" in line or "Function properties" in line:
                # name the function the next lines speak of, without its
                # mangled arguments
                log(f"ptxas: {line.strip()[:150]}")
    log(f"{len(mods)} builds, side by side: {time.time() - t0:.1f} s")


def to_card(problem, dev):
    """A saved problem's tensors on the card."""
    import torch

    return tuple(x.to(dev) if isinstance(x, torch.Tensor) else x
                 for x in problem)


def to_host(problem):
    import torch

    return tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                 for x in problem)


def square_only(dev, problems_file):
    """The short run behind --square-only: build K1/K3 and their profiling
    build, hold them against the plain version (seeded and stress
    problems), time them, and, given the square_problems.pt that a full
    run wrote, time and profile them on those problems of the paths."""
    import torch

    from yolov7_tracker_tpu_torch.ops import auction_square as square

    build_kernels([(square, SOURCE_SQUARE, ()), (square, SOURCE_SQUARE,
                                                 (True,))])
    square_phase(dev)
    if problems_file:
        saved = torch.load(problems_file)
        path_timings(square, to_card(saved["step"], dev),
                     to_card(saved["tick"], dev), dev)
    log("square-only run done (not the smoke run: no result line)")
    return 0


def k2_only(dev, problems_file):
    """The short run behind --k2-only: build K2 and its profiling build,
    hold K2 against the plain version (seeded and stress problems), and,
    given the k2_problems.pt that a full run wrote, time and profile it on
    those problems of the paths."""
    import torch

    from yolov7_tracker_tpu_torch.ops import auction

    build_kernels([(auction, SOURCE, ()), (auction, SOURCE, (True,))])
    kernel_phase(dev)
    if problems_file:
        saved = torch.load(problems_file)
        k2_path_timings(auction, {name: to_card(problem, dev)
                                  for name, problem in saved.items()}, dev)
    log("k2-only run done (not the smoke run: no result line)")
    return 0


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--square-only", action="store_true",
                    help="only build, check, time and profile K1/K3")
    ap.add_argument("--k2-only", action="store_true",
                    help="only build, check, time and profile K2")
    ap.add_argument("--problems", default="",
                    help="with --square-only or --k2-only: the "
                         "square_problems.pt or k2_problems.pt written by a "
                         "full run (the paths' own last problems)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # float32 comparisons below run in full float32 (the bf16 main path
    # does not use these paths)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square

    dev = torch.device("cuda")
    if args.square_only:
        return square_only(dev, args.problems)
    if args.k2_only:
        return k2_only(dev, args.problems)
    t0 = time.time()
    build_kernels([(auction, SOURCE, ()), (square, SOURCE_SQUARE, ()),
                   (auction, SOURCE, (True,)),
                   (square, SOURCE_SQUARE, (True,))])

    worst = kernel_phase(dev)
    worst_sq, t_k1, t_k3 = square_phase(dev)
    sd, pipe = build_w6(dev)
    launches, solves = main_phase(pipe, dev)
    k3_launches, k2_serving, serve_last = serving_phase(sd, pipe, dev)
    k1_launches, step_last = step_frame_phase(pipe, dev)
    detector_reference_check(dev)

    # K2 on the last frame's two solves, as the main path gave them, and on
    # the serving path's stages 2+3: one launch of B = 2 S problems
    c23, r23, m23, th23 = serve_last["stage23"]
    k2_problems = {
        "stage 1 offline": solves[-2],
        "stages 2+3 offline": solves[-1],
        "stages 2+3 of a serving tick": (
            c23.contiguous(), r23, m23,
            torch.as_tensor(th23, dtype=torch.float32).repeat(
                r23.shape[0] // 2))}
    on_k2 = k2_path_timings(auction, k2_problems, dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.save({name: to_host(problem)
                for name, problem in k2_problems.items()},
               os.path.join(OUT_DIR, "k2_problems.pt"))
    t1, t2, t16 = on_k2.values()
    record = {"name": "auction_k2_private_dummy", "route": "cuda",
              "source": SOURCE, "replaces": REPLACES, "launches": launches,
              "launches_serving": k2_serving,
              "max_abs_err": float(worst), "library_ms": None, **t1,
              **{f"{k}_b2": v for k, v in t2.items()},
              **{f"{k}_serving": v for k, v in t16.items()}}

    # K1 and K3 on the problems their own paths gave them last, which are
    # kept for a later --square-only run
    on_step, on_tick = path_timings(square, step_last, serve_last["stage1"],
                                    dev)
    torch.save({"step": to_host(step_last),
                "tick": to_host(serve_last["stage1"])},
               os.path.join(OUT_DIR, "square_problems.pt"))
    rec_k1 = {"name": "auction_k1_square", "route": "cuda",
              "source": SOURCE_SQUARE, "replaces": REPLACES_K1,
              "launches": k1_launches, "max_abs_err": float(worst_sq),
              "library_ms": None, **on_step,
              "seeded_problem": t_k1}
    rec_k3 = {"name": "auction_k3_square_batched", "route": "cuda",
              "source": SOURCE_SQUARE, "replaces": REPLACES_K3,
              "launches": k3_launches, "max_abs_err": float(worst_sq),
              "library_ms": None, **on_tick,
              "seeded_batches": {str(b): t for b, t in t_k3.items()}}
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [rec_k1, record, rec_k3]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
