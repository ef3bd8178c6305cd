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
  6. trackers -- the same detector through
                TrackingPipeline.run_sequence_stateful for sort,
                c_bioutracker, uavmot, deepsort (DeepSORT CNN) and
                bytetrack with OSNet x1_0 appearance fusion on the 16
                frames of phase 3, and for botsort (ECC) and strongsort
                (OSNet x1_0 on all 300 det slots, ECC) on 16 frames of a
                camera panning 8 px a frame over phase 3's first frame
                smoothed (see TRACKER_RUNS); seeded ReID weights with BN
                statistics measured on the first frame's crops
                (calibrate_bn). The phase runs under PyTorch's default
                TF32 flags (cuDNN may use TF32), as a user's process
                would: the pipeline itself runs ReID in float32. For each:
                K2 launches (reset just before the run, read just after)
                equal to its solves a frame x 16; every tracker step under
                torch.cuda.set_sync_debug_mode("error") (a host sync inside
                a step fails the phase), for botsort and strongsort also
                without the GMC's warp; a CPU replay of the tracker step on
                the detections, features and warps the card gave (K2's
                plain version) with the same ids and boxes; ms/frame. Also
                each ReID model on 16 crops through the pipeline's
                reid_forward on the card against the CPU (relative 1e-3), ECC
                on two frames of the pan (the 8-px shift within 0.5 px),
                strongsort's frame split into crops, ReID forward, ECC and
                tracker step, and the deepsort cascade's K2 levels timed
                from a CUDA graph. deepmot runs here twice at its
                registered capacities (128 x 48): with the trained GRU
                DHN (weights/dhn_h32.msgpack) and with the Sinkhorn DHN
                (weights/dhn_sinkhorn.msgpack); its CPU replay takes the
                card's DHN scores, and the CPU copy of the DHN runs on
                each frame's compacted cost from the card, its scores
                within DHN_SCORE_TOL of the card's (frames whose stage-1
                pairs change on the CPU's scores are reported).
  7. streaming -- strongsort with OSNet x1_0 (seeded, calibrated as in
                phase 6, saved under OUT_DIR with osnet_x1_0 in its
                name) through cli.serve.main on the 8 cameras of phase 4
                with --reid_capacity 128: 16 ticks, then 8 resumed from
                the state files, whose MOT files must equal those of one
                uninterrupted 24-tick run byte for byte (one K3 and two K2
                launches a tick); the same through step_frame for 8
                frames (one K1 and two K2 a frame); deepmot with the GRU
                DHN through process_multistream at S = 8 for 8 ticks (one
                K3 and one K2 a tick, the DHN on the last tick's compacted
                costs card against CPU). Each of these three keeps its
                last tick's or frame's stage-1 and stage-2/3 problems
                (path_solves) and re-solves them by the plain versions:
                K1/K3 and K2 bit for bit. Then each DHN head alone on a 128 x 48
                cost (GRU h32, GRU h256 seeded, Sinkhorn, GRU h32 at
                S = 8; CUDA events; card against CPU within 1e-4); AFLink
                with a seeded PostLinker and GSI on phase 6's strongsort
                rows, the same on the card and the CPU.
  8. scoring -- (a) a seeded MOT17-layout dataset (3 sequences of 200
                frames at 1920x1080, 40-60 constant-velocity pedestrians
                each, crossing pairs, class 2 / 7 distractor rows;
                placeholder frame files) with detection files made from
                its gt (jitter, misses, low-score false positives) is
                tracked and scored through cli.track.main (--detections,
                --track_eval true, the CLI's capacity 256 / det_capacity
                300) for bytetrack and sort, on the card and with --device
                cpu: MOT txts and CSVs byte for byte and every number of
                the score tables equal, 2 K2 launches a frame on the card,
                every step but a run's first (it makes the solver's
                constants) with no host sync; cli.evaluate.main on the
                card's folder writes the table track printed (HOTA, MOTA,
                IDF1, ms/frame and a frame's parts, scoring seconds).
                (b) --detect_per_frame k = 1, 2, 3 on phase 3's path and
                frames: K2 only on detected frames, no host sync in any
                step (the predict-only ones too), a run resumed from the
                state saved after frame 7 equal to one run, the
                predict-only step timed alone, a CPU replay with the same
                ids.
Then K2 on the offline path's last stage-1 and stage-2/3 problems and on
the last tick's 2S problems, K1 on step_frame's last problem and K3 on the
last tick's are timed (ms, us per sweep, bound) and profiled (where a
solve's cycles go, by the profiling builds, which no path uses), and the
problems are written to chiprun_out/chip_smoke/k2_problems.pt and
square_problems.pt.
It prints the trackers JSON line, the kernel JSON line, the card's name
and power limit, and last
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

import collections
import contextlib
import functools
import json
import os
import shutil
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
# phase 6: (name, TrackerConfig fields, PipelineConfig fields, K2 solves a
# frame); deepsort's cascade solves each of its max_time_lost (30) levels.
# The GMC trackers (botsort, strongsort) run on a camera pan (pan_frames):
# between two unrelated noise frames of phase 3, ECC returns a wild but
# finite warp (a scale of 4 and a 113 degree turn on the card), which the
# reference's semantics apply, and the NSA Kalman update on such states
# turns float32 rounding into 1e-3 of relative box error between the card
# and the CPU (same ids), beyond phase 3's replay tolerance.
DHN_GRU = "weights/dhn_h32.msgpack"            # trained, GRU hidden 32
DHN_SINKHORN = "weights/dhn_sinkhorn.msgpack"
# card vs CPU DHN scores, float32: about nine times the most measured on
# deepmot's 128 x 48 costs (1.11e-5, GRU h32 on phase 6's frames; NVIDIA
# H100 80GB HBM3, 700.00 W)
DHN_SCORE_TOL = 1e-4
TRACKER_RUNS = (
    ("sort", dict(tracker="sort"), {}, 2),
    ("c_bioutracker", dict(tracker="c_bioutracker"), {}, 3),
    ("uavmot", dict(tracker="uavmot"), {}, 3),
    ("botsort", dict(tracker="botsort"), dict(gmc_method="ecc"), 2),
    ("deepsort", dict(tracker="deepsort"), dict(reid="deepsort_cnn"), 32),
    ("strongsort", dict(tracker="strongsort"),
     dict(reid="osnet_x1_0", reid_capacity=0, gmc_method="ecc"), 3),
    ("bytetrack_osnet", dict(tracker="bytetrack", feature_dim=512),
     dict(reid="osnet_x1_0"), 2),
    # deepmot at its registered capacities (128 x 48): the DHN on the
    # compacted 128 x 48 cost, then K2 for stage 1 and for stages 2+3
    ("deepmot_gru_h32", dict(tracker="deepmot", det_capacity=48,
                             dhn_weights=DHN_GRU, dhn_hidden=32), {}, 2),
    ("deepmot_sinkhorn", dict(tracker="deepmot", det_capacity=48,
                              dhn_weights=DHN_SINKHORN, dhn_arch="sinkhorn"),
     {}, 2),
)
PAN_PX = 8                    # the pan's shift a frame
REID_REL_TOL = 1e-3           # card vs CPU, float32 (TF32 off)
ECC_SHIFT_TOL = 0.5           # px
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
# phase 8a: the seeded MOT17-layout dataset scored through cli.track
SCORE_DATASET = "smoke_mot17"
SCORE_SEQS = 3
SCORE_FRAMES = 200
SCORE_HW = (1080, 1920)
DETECT_EVERY = (2, 3)         # phase 8b: --detect_per_frame k


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


def offline_frames():
    """The 16 synthetic 1080x1920 frames of phases 3 and 6: 8 noise frames,
    then the same 8 shifted 8 px to the right."""
    rng = np.random.default_rng(0)
    f0 = rng.integers(0, 255, (8, 1080, 1920, 3), np.uint8)
    f1 = np.roll(f0, 8, axis=2)       # an 8-px shift: the scene persists
    return [f for k in range(2) for f in (f0, f1)[k % 2]]


def main_phase(pipe, dev):
    import torch

    from yolov7_tracker_tpu_torch.data import writer
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.trackers import bytetrack
    from yolov7_tracker_tpu_torch.trackers import slab as S

    frames = offline_frames()
    f1 = np.stack(frames[8:])

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


# ---------------------------------------------------------------------------
# phase 6: the other trackers, ReID and GMC on the offline path
# ---------------------------------------------------------------------------

def tracker_pipeline(sd, dev, tracker_kw, pipe_kw, reid_state_dict=None):
    """A TrackingPipeline on phase 3's detector (yolov7-w6, nc=80, 1088 px,
    bf16, BN folded) with the given tracker and ReID / GMC settings; ReID
    weights are ``reid_state_dict`` or the pipeline's seeded ones (random
    BN statistics)."""
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as S

    pcfg = PipelineConfig(model="yolov7-w6", nc=80, img_size=1088,
                          detector_batch=8, dtype="bfloat16", fuse=True,
                          **pipe_kw)
    tcfg = S.TrackerConfig(**{**dict(conf_thresh=0.5, capacity=128,
                                      det_capacity=300), **tracker_kw})
    return TrackingPipeline(pcfg, tcfg, state_dict=sd,
                            spec=zoo.get_spec("yolov7-w6", nc=80),
                            device=dev, reid_state_dict=reid_state_dict)


def calibrate_reid(pipe, frame):
    """Seeded ReID weights that tell crops apart: ``calibrate_bn`` on the
    crops of the frame's detections."""
    from yolov7_tracker_tpu_torch.reid import extractor

    boxes = pipe.detect_batch(frame[None])[0][0, :pipe.tcfg.det_capacity]
    calibrate_bn(pipe.reid_model, extractor.extract_crops(
        pipe._frames(frame), boxes, pipe.reid_hw).permute(0, 3, 1, 2))


def calibrate_bn(model, crops):
    """With random BN statistics alone, embeddings of different crops come
    out nearly parallel (tests/test_torch_reid.py measures it), so the
    statistics are measured instead, as training would leave them: one
    train-mode pass over ``crops`` (N, 3, H, W). OSNet's embedding is then
    scaled to unit mean norm, the scale at which ByteTrack's 1 - f.f' reads
    as a cosine distance; the DeepSORT CNN normalises its own output."""
    import torch

    norms = [m for m in model.modules()
             if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None                # a plain average over the pass
    with torch.no_grad():
        model.train()(crops)
        model.eval()
        for m in norms:
            m.momentum = 0.1
        if hasattr(model, "fc"):
            scale = 1.0 / float(model(crops).norm(dim=1).mean())
            model.fc[1].weight.mul_(scale)
            model.fc[1].bias.mul_(scale)


def recording_dhn(pipe):
    """Make deepmot's step keep each DHN input and output (the compacted
    cost and its scores, clones on the card, no sync); returns the list
    they go to (None for another tracker)."""
    dhn = pipe.step.keywords.get("dhn")
    if dhn is None:
        return None
    kept = []

    def record(comp):
        out = dhn(comp)
        kept.append((comp.clone(), out.clone()))
        return out

    pipe.step = functools.partial(pipe.step.func, **{**pipe.step.keywords,
                                                     "dhn": record})
    return kept


def dhn_scores_check(cpu_dhn, comp, card):
    """The CPU copy of a DHN on the compacted cost the card's step gave its
    own DHN: the max |score difference|, which must be within
    DHN_SCORE_TOL; returns it with the CPU's scores."""
    import torch

    from yolov7_tracker_tpu_torch.reid import float32_exact

    comp, card = comp.cpu(), card.cpu()
    with torch.no_grad(), float32_exact():
        cpu = cpu_dhn(comp)
    diff = float((cpu - card).abs().max())
    if not diff <= DHN_SCORE_TOL or not bool(torch.isfinite(card).all()):
        raise AssertionError(f"DHN on the path's compacted cost, card vs "
                             f"CPU: max |score difference| {diff}")
    return diff, cpu


def dhn_replay(step, kept):
    """deepmot's CPU step (``step``, from build_tracker on the CPU, with
    the CPU copy of the DHN) made to take the card's DHN scores frame by
    frame in place of its own, so that the replay holds the rest of the
    step to the card's; the DHN itself is held on the card's own inputs:
    each frame, the CPU copy runs on the compacted cost the card's step
    gave its DHN (``kept``, recording_dhn) through dhn_scores_check. 1 - DHN
    is a dense cost, on which a score difference of 1e-7 can move K2's
    matching: the frames where the compacted stage-1 problem pairs
    otherwise on the CPU's scores than on the card's (K2's plain version,
    valid rows and columns first, as compact_cost puts them) are reported,
    not held. Returns (step, report)."""
    import torch

    from yolov7_tracker_tpu_torch.ops.assignment import solve_assignment

    cpu_dhn = step.keywords["dhn"]
    frames = iter(kept)
    report = {"max_abs_diff": 0.0, "frames": 0, "pairing_differs": []}
    scores = {}

    def dhn(_):
        comp, card = next(frames)
        diff, cpu = dhn_scores_check(cpu_dhn, comp, card)
        report["max_abs_diff"] = max(report["max_abs_diff"], diff)
        scores.update(card=card.cpu(), cpu=cpu)
        return scores["card"]

    def solve_stage1(cost, rm, cm, th):
        n, m = scores["card"].shape[-2:]
        rows, cols = torch.arange(n) < rm.sum(), torch.arange(m) < cm.sum()
        pairs = [solve_assignment(1.0 - s, rows, cols, th)[0]
                 for s in (scores["card"], scores["cpu"])]
        if not torch.equal(*pairs):
            report["pairing_differs"].append(report["frames"])
        report["frames"] += 1
        return solve_assignment(cost, rm, cm, th)

    return functools.partial(step, dhn=dhn, solve_stage1=solve_stage1), report


def replay_on_cpu(pipe, dets, slabs, results, name, dhn_kept=None):
    """Step the tracker on the CPU (K2's plain version) through the
    detections, features and warps the card's run gave it; ids must equal
    the card's and boxes agree as in phase 3. ``slabs``: the card's slab
    before each step, compared field by field where the replay differs
    (that frame's inputs are then saved under OUT_DIR). ``dhn_kept``:
    deepmot's DHN inputs and outputs on the card, frame by frame, which the
    replay takes in place of its own DHN, holding the DHN on them
    (dhn_replay). Returns dhn_replay's report, or None."""
    import torch

    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

    step, _ = build_tracker(pipe.tcfg, "cpu")
    report = None
    if dhn_kept is not None:
        step, report = dhn_replay(step, dhn_kept)
    slab = S.init_slab(pipe.tcfg, "cpu")
    for k, det in enumerate(dets):
        before = slab
        slab, out = step(slab, S.DetSlab(*(x.cpu() for x in det)))
        _, ids, tlwhs, _ = results[k]
        v = out.valid.numpy()
        if out.track_id.numpy()[v].tolist() != ids or not np.allclose(
                out.tlwh.numpy()[v], np.asarray(tlwhs).reshape(-1, 4),
                atol=1e-2):
            diffs = {f: float((a.cpu().double() - b.double()).abs().max())
                     for f, a, b in zip(S.TrackSlab._fields, slabs[k],
                                        before) if a.numel()}
            cpu_ids = out.track_id.numpy()[v].tolist()
            log(f"{name}: replay differs at frame {k}: card {len(ids)} rows, "
                f"CPU {len(cpu_ids)}; ids only on the card "
                f"{sorted(set(ids) - set(cpu_ids))[:8]}, only on the CPU "
                f"{sorted(set(cpu_ids) - set(ids))[:8]}; slab before the "
                f"step, card - CPU, max |diff| by field {diffs}")
            os.makedirs(OUT_DIR, exist_ok=True)
            torch.save({"det": S.DetSlab(*(x.cpu() for x in det)),
                        "slab": S.TrackSlab(*(x.cpu() for x in slabs[k])),
                        "card": results[k], "cfg": vars(pipe.tcfg)},
                       os.path.join(OUT_DIR, f"replay_{name}_{k}.pt"))
            raise AssertionError(f"{name}: CPU replay differs at frame {k}")
    return report


def tracker_run(sd, dev, frames, name, tracker_kw, pipe_kw, per_frame):
    """Drive one tracker through run_sequence_stateful (after a warm-up
    batch); check its K2 launches and its CPU replay. Returns (record,
    pipe, the detections the step got, the results)."""
    import torch

    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.trackers import slab as S

    pipe = tracker_pipeline(sd, dev, tracker_kw, pipe_kw)
    if pipe.reid_model is not None:
        calibrate_reid(pipe, frames[0])
    pipe.run_sequence(iter(frames[:8]))        # warm-up, not counted
    if pipe.gmc is not None:
        pipe.gmc.set_state({})                 # start as a new sequence
    dets, slabs = [], []
    plain_step = pipe.step
    dhn_kept = recording_dhn(pipe)
    step = pipe.step

    def recording_step(slab, det, **kw):
        dets.append(S.DetSlab(*(x.clone() for x in det)))  # no host sync
        slabs.append(S.TrackSlab(*(x.clone() for x in slab)))
        return no_sync_step(step, slab, det, **kw)

    pipe.step = recording_step
    torch.cuda.synchronize()
    auction.LAUNCHES = 0
    t0 = time.time()
    results, slab = pipe.run_sequence_stateful(iter(frames))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = auction.LAUNCHES
    pipe.step = plain_step
    n = len(frames)
    if launches != per_frame * n:
        raise AssertionError(f"{name}: {launches} K2 launches in {n} frames, "
                             f"expected {per_frame} a frame")
    tracks = [len(ids) for _, ids, _, _ in results]
    if len(results) != n or max(tracks) < 1 or int(slab.frame) != n:
        raise AssertionError(f"{name}: tracks per frame {tracks}")
    if not all(bool(torch.isfinite(d.feature).all()) for d in dets):
        raise AssertionError(f"{name}: non-finite ReID features")
    t0 = time.time()
    dhn_report = replay_on_cpu(pipe, dets, slabs, results, name, dhn_kept)
    replay_s = time.time() - t0
    if pipe.gmc is not None:
        without_gmc(pipe, dets)
    warps = torch.stack([d.warp.to(dev) for d in dets])
    rec = {"ms_per_frame": wall / n * 1e3, "k2_launches": launches,
           "k2_per_frame": per_frame, "tracks_per_frame_mean":
           float(np.mean(tracks)), "tracks_per_frame_max": max(tracks),
           "ids": int(slab.next_id), "cpu_replay": "same ids, boxes 1e-2",
           "cpu_replay_s": replay_s,
           "feature_dim": pipe.tcfg.feature_dim, "reid": pipe.pcfg.reid,
           "gmc": pipe.pcfg.gmc_method,
           "warp_tx_range": [float(warps[:, 0, 2].min()),
                             float(warps[:, 0, 2].max())]}
    if dhn_report is not None:
        rec["cpu_replay"] += ", on the card's DHN scores"
        rec["dhn_card_vs_cpu"] = dhn_report
        log(f"{name}: the DHN on the CPU on each frame's compacted cost from "
            f"the card: max |score difference| "
            f"{dhn_report['max_abs_diff']:.2e} (tolerance {DHN_SCORE_TOL}); "
            f"on the CPU's scores the compacted stage-1 problem pairs "
            f"otherwise in {len(dhn_report['pairing_differs'])} of "
            f"{dhn_report['frames']} frames {dhn_report['pairing_differs']}")
    log(f"{name} on {card_line()}: {wall / n * 1e3:.2f} ms/frame over {n} "
        f"frames, {launches} K2 launches ({per_frame} a frame), tracks/frame "
        f"mean {np.mean(tracks):.1f} max {max(tracks)}, {int(slab.next_id)} "
        f"ids; CPU replay ({replay_s:.1f} s): same ids, boxes within 1e-2")
    return rec, pipe, dets, results


def no_sync_step(step, *args, **kw):
    """One tracker step (or predict-only step) with
    torch.cuda.set_sync_debug_mode("error"): a device-to-host wait inside
    the step raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return step(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def without_gmc(pipe, dets):
    """The run's detections and features as a pipeline without GMC hands
    them to the step (dets_to_slab's identity warp, made on the card),
    stepped from a fresh slab with no host sync inside a step."""
    import torch

    slab = pipe.init_tracker()
    for det in dets:
        plain = pipe.dets_to_slab(det.tlbr, det.score, det.cls,
                                  det.valid.sum())
        if not (plain.warp.is_cuda and torch.equal(plain.valid, det.valid)):
            raise AssertionError("dets_to_slab: warp or mask off the card")
        slab, out = no_sync_step(pipe.step, slab,
                                 plain._replace(feature=det.feature))
    if int(out.valid.sum()) < 1:
        raise AssertionError(f"{pipe.tcfg.tracker} without GMC: no tracks")
    log(f"{pipe.tcfg.tracker} without GMC: {len(dets)} steps with no host "
        f"sync, {int(out.valid.sum())} tracks on the last frame")


def reid_check(pipe, frame, det, dev):
    """The pipeline's ReID model on 16 crops of its own detections, on the
    card through reid_forward (as embed_dets runs it) and on a CPU copy:
    max relative difference of the features."""
    import copy

    import torch

    from yolov7_tracker_tpu_torch.reid import extractor

    frame = pipe._frames(frame)
    crops = extractor.extract_crops(frame, det.tlbr[:16], pipe.reid_hw)
    cpu_crops = extractor.extract_crops(frame.cpu(), det.tlbr[:16].cpu(),
                                        pipe.reid_hw)
    cpu_model = copy.deepcopy(pipe.reid_model).cpu().to(
        memory_format=torch.contiguous_format)
    card = pipe.reid_forward(crops).cpu()
    with torch.no_grad():
        cpu = cpu_model(cpu_crops.permute(0, 3, 1, 2))
    crop_diff = float((crops.cpu() - cpu_crops).abs().max())
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    if not rel <= REID_REL_TOL or not crop_diff < 1e-4:
        raise AssertionError(f"{pipe.pcfg.reid}: card vs CPU, crops "
                             f"{crop_diff}, features relative {rel}")
    log(f"{pipe.pcfg.reid} on 16 crops, card vs CPU float32: crops max "
        f"|diff| {crop_diff:.2e}, features max relative diff {rel:.2e} "
        f"(tolerance {REID_REL_TOL})")
    return {"crops_max_abs_diff": crop_diff, "features_max_rel_diff": rel}


def smooth_frame(frame, dev, k=8):
    """The frame's k x k grid of pixels, bilinearly upsampled back to its
    size on the card: texture that varies over a few pixels."""
    import torch

    small = torch.from_numpy(frame[::k, ::k]).to(dev).permute(2, 0, 1)
    big = torch.nn.functional.interpolate(
        small[None].float(), size=frame.shape[:2], mode="bilinear",
        align_corners=False)[0]
    return big.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0)


def pan_frames(frames, dev):
    """A camera panning PAN_PX to the right a frame over phase 3's first
    frame smoothed (``smooth_frame``): on white noise at this size ECC's
    Gauss-Newton steps diverge even for the 8-px pair
    (tests/test_torch_gmc.py). As many frames as ``frames``, uint8 on the
    host."""
    import torch

    base = smooth_frame(frames[0], dev)
    return [torch.roll(base, PAN_PX * t, dims=1).cpu().numpy()
            for t in range(len(frames))]


def ecc_check(frames, dev):
    """GMC('ecc') between two frames of the pan: the warp must recover the
    PAN_PX shift. Returns the warp and the ms of one ECC estimate (gray,
    downscale, 50 steps)."""
    import torch

    from yolov7_tracker_tpu_torch.trackers.gmc import GMC

    a, b = (torch.from_numpy(f).to(dev) for f in frames[:2])
    gmc = GMC("ecc")
    gmc.apply(a)
    warp = gmc.apply(b)
    tx, ty = float(warp[0, 2]), float(warp[1, 2])
    if abs(tx - PAN_PX) > ECC_SHIFT_TOL or abs(ty) > ECC_SHIFT_TOL:
        raise AssertionError(f"ECC on the 8-px pair: warp {warp.tolist()}")

    prev_gray = gmc.prev_gray

    def once():
        gmc.prev_gray = prev_gray
        return gmc.apply(b)

    ms = cuda_ms(once, 3)
    log(f"ECC on the 8-px-shifted pair: tx {tx:.4f}, ty {ty:.4f} px "
        f"(tolerance {ECC_SHIFT_TOL}), {ms:.2f} ms an estimate")
    return {"warp": warp.tolist(), "ms": ms}


def strongsort_breakdown(pipe, frames, dets, dev):
    """strongsort's frame split into its parts, each timed alone with CUDA
    events on the run's last frame: crops of all 300 det slots, the OSNet
    forward on them, one ECC estimate, the tracker step."""
    from yolov7_tracker_tpu_torch.reid import extractor
    from yolov7_tracker_tpu_torch.trackers import slab as S

    frame = pipe._frames(frames[-1])
    det = dets[-1]
    crops = extractor.extract_crops(frame, det.tlbr, pipe.reid_hw)
    x = crops.permute(0, 3, 1, 2)
    t_crops = cuda_ms(lambda: extractor.extract_crops(
        frame, det.tlbr, pipe.reid_hw), 5)
    t_reid = cuda_ms(lambda: pipe.reid_forward(crops), 3)
    gmc = pipe.gmc
    prev_gray = gmc.prev_gray

    def ecc_once():
        gmc.prev_gray = prev_gray
        return gmc.apply(frame)

    t_ecc = cuda_ms(ecc_once, 3)
    ecc_ops = profile_ops(ecc_once)
    slab = S.init_slab(pipe.tcfg, dev)
    for d in dets[:-1]:
        slab, _ = pipe.step(slab, d)
    t_step = cuda_ms(lambda: pipe.step(slab, det), 3)
    # OSNet x1_0: about 1 GMAC a 256x128 crop (torchreid's count: 0.98
    # GFLOPs as multiply-adds), 2 operations each
    macs = sum(m.weight.numel() * int(np.prod(o))
               for m, o in conv_out_sizes(pipe.reid_model, x[:1]))
    rec = {"crops_ms": t_crops, "reid_forward_ms": t_reid, "ecc_ms": t_ecc,
           "tracker_step_ms": t_step, "crops": int(det.tlbr.shape[0]),
           "reid_gmac_per_crop": float(macs) / 1e9, "ecc_profile": ecc_ops}
    log(f"strongsort frame on {card_line()}: crops of {det.tlbr.shape[0]} "
        f"slots {t_crops:.2f} ms, OSNet x1_0 forward {t_reid:.2f} ms "
        f"({macs / 1e9:.3f} GMAC a crop, float32, TF32 off), ECC "
        f"{t_ecc:.2f} ms, tracker step {t_step:.2f} ms")
    return rec


def profile_ops(fn, top=6):
    """torch.profiler over one call of fn: the ops with the most CUDA time
    and the most CPU time (ms, calls), the host syncs, and the device's
    share of the call's wall time; logged and returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        events = prof.key_averages()
    except RuntimeError as e:        # a profiler that cannot trace the card
        log(f"profile: torch.profiler failed: {e}")
        return {"error": str(e)}

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    by_dev = sorted(events, key=device_us, reverse=True)[:top]
    by_cpu = sorted(events, key=lambda e: e.cpu_time_total,
                    reverse=True)[:top]
    syncs = sum(e.count for e in events if "Synchronize" in e.key)
    device_ms = sum(device_us(e) for e in events) / 1e3
    rec = {"wall_ms": wall_ms, "device_ms": device_ms, "syncs": syncs,
           "launches": sum(e.count for e in events
                           if e.key == "cudaLaunchKernel"),
           "top_device": [(e.key[:48], device_us(e) / 1e3, e.count)
                          for e in by_dev],
           "top_cpu": [(e.key[:48], e.cpu_time_total / 1e3, e.count)
                       for e in by_cpu]}
    log(f"profile: {wall_ms:.2f} ms wall, {device_ms:.2f} ms on the "
        f"device, {rec['launches']} kernel launches, {syncs} host syncs; "
        f"most device time {rec['top_device']}; most CPU time "
        f"{rec['top_cpu']}")
    return rec


def conv_out_sizes(model, x):
    """(conv, output spatial size) of every Conv2d of ``model`` on x, for
    counting multiply-adds."""
    import torch

    sizes = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: sizes.append((m, o.shape[-2:])))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return sizes


def cascade_timing(pipe, dets, dev):
    """deepsort's cascade on the run's last frame, replayed on the CPU to
    capture its 30 level problems, each then timed on the card from a CUDA
    graph (kernel only) and through the wrapper (a call as the path makes
    it)."""
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.trackers import appearance
    from yolov7_tracker_tpu_torch.trackers import slab as S

    problems = []
    solve = appearance.solve_assignment

    def capture(cost, rm, cm, th):
        problems.append((cost.clone(), rm.clone(), cm.clone(), th))
        return solve(cost, rm, cm, th)

    slab = S.init_slab(pipe.tcfg, "cpu")
    for d in dets[:-1]:
        slab, _ = pipe.step(slab, S.DetSlab(*(x.cpu() for x in d)))
    appearance.solve_assignment = capture
    try:
        pipe.step(slab, S.DetSlab(*(x.cpu() for x in dets[-1])))
    finally:
        appearance.solve_assignment = solve
    kernel, wrapper, rows = [], [], []
    for cost, rm, cm, th in problems:
        cost, rm, cm = (t.to(dev) for t in (cost, rm, cm))
        kernel.append(graph_ms(auction.prepared_auction(
            cost.contiguous(), rm, cm, th, **K2_STEEP)))
        wrapper.append(cuda_ms(lambda: auction.masked_assignment_auction_cuda(
            cost.contiguous(), rm, cm, th, **K2_STEEP), 20))
        rows.append(int(rm.sum()))
    empty = [k for k, r in zip(kernel, rows) if r == 0]
    card_slab = S.init_slab(pipe.tcfg, dev)
    for d in dets[:-1]:
        card_slab, _ = pipe.step(card_slab, d)
    log("deepsort step of the last frame on the card:")
    step_ops = profile_ops(lambda: pipe.step(card_slab, dets[-1]))
    rec = {"levels": len(problems), "rows_per_level": rows,
           "step_profile": step_ops,
           "kernel_ms_sum": float(sum(kernel)),
           "kernel_ms_empty_level": float(np.mean(empty)) if empty else None,
           "kernel_ms_max": float(max(kernel)),
           "wrapper_ms_sum": float(sum(wrapper))}
    log(f"deepsort cascade on {card_line()}: {len(problems)} levels, rows "
        f"{rows}; K2 from a CUDA graph {sum(kernel):.4f} ms in all "
        f"({rec['kernel_ms_empty_level']} ms an empty level, "
        f"{max(kernel):.4f} the longest); through the wrapper "
        f"{sum(wrapper):.3f} ms a frame")
    return rec


def trackers_phase(sd, dev):
    """Phase 6, under PyTorch's default TF32 flags (main() turns TF32 off
    for the earlier phases). Returns the trackers JSON record, K2's
    launches by tracker and strongsort's results."""
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    try:
        return run_trackers(sd, dev)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def run_trackers(sd, dev):
    frames = offline_frames()
    pan = pan_frames(frames, dev)
    out, launches = {}, {}
    for name, tracker_kw, pipe_kw, per_frame in TRACKER_RUNS:
        run_frames = pan if "gmc_method" in pipe_kw else frames
        rec, pipe, dets, results = tracker_run(
            sd, dev, run_frames, name, tracker_kw, pipe_kw, per_frame)
        rec["frames"] = "pan" if run_frames is pan else "phase 3"
        if pipe.reid_model is not None and pipe.pcfg.reid not in {
                r.get("reid") for r in out.values()}:
            rec["reid_card_vs_cpu"] = reid_check(pipe, frames[-1], dets[-1],
                                                 dev)
        if name == "strongsort":
            rec["breakdown"] = strongsort_breakdown(pipe, run_frames, dets,
                                                    dev)
            strongsort_rows = results
        if name == "deepsort":
            rec["cascade"] = cascade_timing(pipe, dets, dev)
        out[name] = rec
        launches[name] = rec["k2_launches"]
        del pipe, dets
    out["ecc_8px_pair"] = ecc_check(pan, dev)
    return out, launches, strongsort_rows


# ---------------------------------------------------------------------------
# phase 7: ReID in the streaming modes, DeepMOT at S streams, the DHN
# alone, AFLink + GSI
# ---------------------------------------------------------------------------

def seeded_osnet(sd, dev):
    """OSNet x1_0 weights calibrated as phase 6 does (calibrate_bn on the
    first serving camera's crops), saved under OUT_DIR with osnet_x1_0 in
    the file name (the serve CLI reads the width from it). Returns the
    path."""
    import torch

    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames

    pipe = tracker_pipeline(sd, dev, dict(tracker="strongsort"),
                            dict(reid="osnet_x1_0"))
    calibrate_reid(pipe, next(iter(SynthFrames(serve_streams(1)[0]))))
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "osnet_x1_0_seeded.pth")
    torch.save({k: v.cpu() for k, v in pipe.reid_model.state_dict().items()},
               path)
    return path


@contextlib.contextmanager
def path_solves(k2_kept):
    """Keep the newest problems the tracker steps hand K1/K3 (the last one)
    and K2 (the last ``k2_kept``) while the block runs: clones on the card,
    no host sync. Yields {"square": [...], "k2": [...]}, each entry
    (cost, row_mask, col_mask, thresh, solver keywords)."""
    import torch

    from yolov7_tracker_tpu_torch.ops import assignment

    names = {"square": "masked_assignment_square",
             "k2": "masked_assignment_auction"}
    solvers = {k: getattr(assignment, v) for k, v in names.items()}
    kept = {"square": collections.deque(maxlen=1),
            "k2": collections.deque(maxlen=k2_kept)}

    def keeping(key):
        def solve(cost, rm, cm, th, **kw):
            kept[key].append((cost.clone(), rm.clone(), cm.clone(),
                              th.clone() if torch.is_tensor(th) else th, kw))
            return solvers[key](cost, rm, cm, th, **kw)
        return solve

    for key, name in names.items():
        setattr(assignment, name, keeping(key))
    try:
        yield kept
    finally:
        for key, name in names.items():
            setattr(assignment, name, solvers[key])


def path_solves_check(kept, name, dev):
    """The problems path_solves kept, re-solved by the plain versions on the
    card: K1/K3 by square_check, K2 by k2_both. Raises unless both are bit
    for bit the kernel's; returns the max |difference| (0)."""
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square

    if not kept["square"] or not kept["k2"]:
        raise AssertionError(f"{name}: no solve was kept")
    sq = max(square_check(square, c, rm, cm, th, dev, **kw)[0]
             for c, rm, cm, th, kw in kept["square"])
    k2 = max(k2_both(auction, c, rm, cm, th, dev, **kw)[0]
             for c, rm, cm, th, kw in kept["k2"])
    shapes = [tuple(p[0].shape) for p in (*kept["square"], *kept["k2"])]
    log(f"{name}: the last stage-1 and stage-2/3 problems {shapes} "
        f"re-solved: max |K1/K3 - plain| (r2c, c2r, sweeps per phase, "
        f"cells) = {sq}, max |K2 - plain| (r2c, c2r, sweeps) = {k2}")
    if sq or k2:
        raise AssertionError(f"{name}: a kernel differs from its plain "
                             "version on the path's own problems")
    return max(sq, k2)


def serve_streams(total):
    return [f"synth://{total}x1080x1920?seed={k + 1}&shift=8"
            for k in range(N_STREAMS)]


def serving_reid_phase(sd, dev, reid_path):
    """strongsort with OSNet x1_0 through cli.serve.main on 8 cameras:
    16 ticks with state files, then 8 resumed from them, and one
    uninterrupted 24-tick run; the two runs' MOT files must be equal byte
    for byte. One K3 (stage 1) and two K2 launches (stages 2 and 3) a
    tick; the last tick's three problems re-solved by the plain versions.
    Returns (record, K3 launches, K2 launches)."""
    import torch

    from yolov7_tracker_tpu_torch import pipeline as pipeline_mod
    from yolov7_tracker_tpu_torch.cli import serve
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square

    total = sum(SERVE_TICKS)
    streams = serve_streams(total)
    tick_fn = pipeline_mod.TrackingPipeline.process_multistream
    stamps = []

    def timed_tick(self, slabs, frames_u8, warps=None):
        torch.cuda.synchronize()
        t0 = time.time()
        out = tick_fn(self, slabs, frames_u8, warps)
        torch.cuda.synchronize()
        stamps.append(time.time() - t0)
        return out

    counts = []
    pipeline_mod.TrackingPipeline.process_multistream = timed_tick
    try:
        # kept: the last tick's solves (K3, then K2 for stages 2 and 3)
        with tempfile.TemporaryDirectory() as tmp, path_solves(2) as kept:
            weights = os.path.join(tmp, "w6.pt")
            torch.save(sd, weights)
            state_dir = os.path.join(tmp, "state")
            runs = [(t, "resumed", state_dir) for t in SERVE_TICKS] + \
                [(total, "whole", "")]
            for ticks, name, state in runs:
                argv = ["--streams", *streams, "--tracker", "strongsort",
                        "--reid_model_path", reid_path, "--reid_capacity",
                        "128", "--model", "yolov7-w6", "--model_path",
                        weights, "--nc", "80", "--img_size", "1088",
                        "--conf_thresh", "0.5", "--capacity", "128",
                        "--det_capacity", "300", "--max_frames", str(ticks),
                        "--save_dir", os.path.join(OUT_DIR, "serve_reid",
                                                   name)]
                if state:
                    argv += ["--state_dir", state]
                auction.LAUNCHES = 0
                square.LAUNCHES_K1 = square.LAUNCHES_K3 = 0
                results, preempted = serve.main(argv)
                torch.cuda.synchronize()
                counts.append((square.LAUNCHES_K3, auction.LAUNCHES,
                               square.LAUNCHES_K1))
                if preempted or [len(r) for r in results] != \
                        [ticks] * N_STREAMS:
                    raise AssertionError(
                        f"serve with ReID: {[len(r) for r in results]} "
                        f"frames per stream for {ticks} ticks")
            with np.load(os.path.join(state_dir, "stream_00.npz")) as z:
                feat = z["feature"][z["occupied"]]
    finally:
        pipeline_mod.TrackingPipeline.process_multistream = tick_fn

    for (k3, k2, k1), (ticks, _, _) in zip(counts, runs):
        if (k3, k2, k1) != (ticks, 2 * ticks, 0):
            raise AssertionError(f"serve with ReID: {k3} K3, {k2} K2, {k1} "
                                 f"K1 launches in {ticks} ticks")
    if feat.shape[-1] != 512 or not np.abs(feat).max() > 0:
        raise AssertionError("serve with ReID: no features in the state")
    resumed, whole = (os.path.join(OUT_DIR, "serve_reid", n)
                      for n in ("resumed", "whole"))
    files = sorted(os.listdir(whole))
    rows = 0
    for f in files:
        with open(os.path.join(resumed, f)) as a, \
                open(os.path.join(whole, f)) as b:
            got, want = a.read(), b.read()
        if got != want:
            raise AssertionError(f"serve with ReID: {f} resumed != one run")
        rows += want.count("\n")
        frames = sorted(read_mot(os.path.join(whole, f)))
        if frames != list(range(1, total + 1)):
            raise AssertionError(f"serve with ReID: {f} frames {frames}")
    if len(files) != N_STREAMS:
        raise AssertionError(f"serve with ReID: files {files}")
    worst = path_solves_check(kept, "serving with ReID", dev)
    # ticks 3.. of each call (the first ones pay cuDNN's autotune)
    first = SERVE_TICKS[0]
    steady = stamps[2:first] + stamps[first + 2:total]
    tick_ms = float(np.median(steady)) * 1e3
    rec = {"ms_per_tick": tick_ms, "ms_per_frame": tick_ms / N_STREAMS,
           "streams": N_STREAMS, "ticks": list(SERVE_TICKS),
           "resume_equals_one_run": True, "mot_rows": rows,
           "launches_k3_k2_k1": counts, "reid": "osnet_x1_0",
           "reid_capacity": 128, "tracker": "strongsort",
           "last_tick_kernels_vs_plain_max_abs_diff": worst}
    log(f"serving with ReID on {card_line()}: strongsort + OSNet x1_0 "
        f"(128 crops a camera), {N_STREAMS} streams x {SERVE_TICKS[0]} + "
        f"{SERVE_TICKS[1]} ticks (resumed) == {total} ticks in one run, "
        f"byte for byte ({rows} MOT rows); launches per call (K3, K2, K1) "
        f"{counts}; process_multistream median {tick_ms:.2f} ms/tick = "
        f"{tick_ms / N_STREAMS:.2f} ms/frame")
    k3 = sum(c[0] for c in counts[:2])
    k2 = sum(c[1] for c in counts[:2])
    return rec, k3, k2


def step_frame_reid_phase(sd, dev, reid_path):
    """strongsort with OSNet x1_0 through step_frame, 8 frames of one
    camera: one K1 and two K2 launches a frame, the last frame's three
    problems re-solved by the plain versions. Returns (record, K1
    launches, K2 launches)."""
    import torch

    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square
    from yolov7_tracker_tpu_torch.reid import resolve_reid

    name, reid_sd = resolve_reid("strongsort", reid_path)
    pipe = tracker_pipeline(sd, dev, dict(tracker="strongsort"),
                            dict(reid=name, reid_capacity=128),
                            reid_state_dict=reid_sd)
    frames = list(SynthFrames("synth://8x1080x1920?seed=11&shift=8"))
    pipe.step_frame(pipe.init_tracker(), frames[0])     # warm-up
    torch.cuda.synchronize()
    auction.LAUNCHES = 0
    square.LAUNCHES_K1 = square.LAUNCHES_K3 = 0
    slab, per_frame = pipe.init_tracker(), []
    with path_solves(2) as kept:        # the last frame's K1, K2, K2
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.time()
            slab, out = pipe.step_frame(slab, f)
            torch.cuda.synchronize()
            per_frame.append((time.time() - t0) * 1e3)
    k1, k2, k3 = square.LAUNCHES_K1, auction.LAUNCHES, square.LAUNCHES_K3
    n = len(frames)
    if (k1, k2, k3) != (n, 2 * n, 0):
        raise AssertionError(f"step_frame with ReID: {k1} K1, {k2} K2, {k3} "
                             f"K3 launches in {n} frames")
    if not int(out.valid.sum()) or not bool(slab.feature.abs().max() > 0):
        raise AssertionError("step_frame with ReID: no tracks or features")
    worst = path_solves_check(kept, "step_frame with ReID", dev)
    rec = {"ms_per_frame_median": float(np.median(per_frame)),
           "ms_per_frame": per_frame, "k1_launches": k1, "k2_launches": k2,
           "tracks_last_frame": int(out.valid.sum()),
           "last_frame_kernels_vs_plain_max_abs_diff": worst}
    log(f"step_frame with ReID on {card_line()}: strongsort + OSNet x1_0, "
        f"{n} frames, {k1} K1 and {k2} K2 launches, ms/frame "
        f"{[round(t, 2) for t in per_frame]}, median "
        f"{rec['ms_per_frame_median']:.2f}")
    return rec, k1, k2


def deepmot_streams_phase(sd, dev):
    """deepmot with the trained GRU h32 DHN through process_multistream on
    the 8 serving cameras for 8 ticks: the DHN batched over the streams,
    stage 1 by K3, stages 2+3 by one K2 launch. The last tick's two
    problems are re-solved by the plain versions and its DHN run again on
    the CPU on the same compacted costs. Returns (record, K3
    launches, K2 launches)."""
    import copy

    import torch

    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square

    pipe = tracker_pipeline(sd, dev, dict(
        tracker="deepmot", det_capacity=48, dhn_weights=DHN_GRU,
        dhn_hidden=32), {})
    ticks = 8
    cams = [list(SynthFrames(s)) for s in serve_streams(ticks)]
    frames = [np.stack(f) for f in zip(*cams)]
    pipe.process_multistream(pipe.init_multistream(N_STREAMS), frames[0])
    torch.cuda.synchronize()
    auction.LAUNCHES = 0
    square.LAUNCHES_K1 = square.LAUNCHES_K3 = 0
    cpu_dhn = copy.deepcopy(pipe.step.keywords["dhn"]).cpu()
    dhn_kept = recording_dhn(pipe)
    slabs, per_tick, tracks = pipe.init_multistream(N_STREAMS), [], []
    with path_solves(1) as kept:        # the last tick's K3 and K2
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.time()
            slabs, outs = pipe.process_multistream(slabs, f)
            torch.cuda.synchronize()
            per_tick.append((time.time() - t0) * 1e3)
            tracks.append(outs.valid.sum(dim=1).tolist())
            if not bool(torch.isfinite(outs.tlwh[outs.valid]).all()):
                raise AssertionError(f"deepmot at S = {N_STREAMS}: boxes")
    k3, k2, k1 = square.LAUNCHES_K3, auction.LAUNCHES, square.LAUNCHES_K1
    if (k3, k2, k1) != (ticks, ticks, 0):
        raise AssertionError(f"deepmot at S = {N_STREAMS}: {k3} K3, {k2} K2, "
                             f"{k1} K1 launches in {ticks} ticks")
    if min(map(sum, zip(*tracks))) < 1:        # every stream tracked
        raise AssertionError(f"deepmot at S = {N_STREAMS}: tracks {tracks}")
    worst = path_solves_check(kept, f"deepmot at S = {N_STREAMS}", dev)
    # the batched DHN on the last tick's S compacted costs, card vs CPU
    diff, _ = dhn_scores_check(cpu_dhn, *dhn_kept[-1])
    log(f"deepmot at S = {N_STREAMS}: the DHN on the last tick's "
        f"{tuple(dhn_kept[-1][0].shape)} compacted costs, card vs CPU: max "
        f"|score difference| {diff:.2e} (tolerance {DHN_SCORE_TOL})")
    rec = {"ms_per_tick_median": float(np.median(per_tick[1:])),
           "ms_per_tick": per_tick, "k3_launches": k3, "k2_launches": k2,
           "tracks_per_tick": tracks, "dhn": "gru h32",
           "last_tick_kernels_vs_plain_max_abs_diff": worst,
           "last_tick_dhn_card_vs_cpu_max_abs_diff": diff}
    log(f"deepmot (GRU h32) at S = {N_STREAMS} on {card_line()}: {ticks} "
        f"ticks, {k3} K3 and {k2} K2 launches, ms/tick "
        f"{[round(t, 2) for t in per_tick]}, median of ticks 2.. "
        f"{rec['ms_per_tick_median']:.2f}; tracks a tick by stream {tracks}")
    return rec, k3, k2


def dhn_timings(dev):
    """Each DHN head alone on one 128 x 48 compacted cost (deepmot's
    registered capacities; valid cells U[0, 1] in the top-left 40 x 30, pad
    cells 1.0), CUDA events, float32 (reid.float32_exact): GRU hidden 32
    (the trained file), GRU hidden 256 (the reference's width, seeded),
    Sinkhorn (the trained file), and GRU h32 over S = 8 such costs; each
    against the same head on the CPU."""
    import copy

    import torch

    from yolov7_tracker_tpu_torch.reid import float32_exact
    from yolov7_tracker_tpu_torch.reid import random_reid_state_dict
    from yolov7_tracker_tpu_torch.reid import dhn as dhn_mod

    rng = np.random.default_rng(7)
    cost = np.ones((N_STREAMS, 128, 48), np.float32)
    cost[:, :40, :30] = rng.uniform(0, 1, (N_STREAMS, 40, 30))
    cost = torch.from_numpy(cost)
    h256 = dhn_mod.build_dhn("gru", 256)
    h256.load_state_dict(random_reid_state_dict(h256, seed=3))
    heads = [("gru_h32", dhn_mod.load_dhn(DHN_GRU, "gru", 32, dev), 1),
             ("gru_h256", h256.to(dev).eval(), 1),
             ("sinkhorn", dhn_mod.load_dhn(DHN_SINKHORN, "sinkhorn",
                                           device=dev), 1),
             ("gru_h32_s8", dhn_mod.load_dhn(DHN_GRU, "gru", 32, dev),
              N_STREAMS)]
    out = {}
    for name, model, s in heads:
        x = cost[0] if s == 1 else cost
        with torch.no_grad(), float32_exact():
            ms = cuda_ms(lambda: model(x.to(dev)), 5)
            card = model(x.to(dev)).cpu()
            cpu = copy.deepcopy(model).cpu()(x)
        diff = float((card - cpu).abs().max())
        if not diff <= 1e-4 or not bool(torch.isfinite(card).all()):
            raise AssertionError(f"DHN {name}: card vs CPU {diff}")
        out[name] = {"ms": ms, "card_vs_cpu_max_abs_diff": diff,
                     "streams": s, "cost": [128, 48],
                     "recurrent_steps": (4 * 128 * 48 if "gru" in name
                                         else None)}
    log(f"DHN alone on {card_line()} (128 x 48, float32): " + ", ".join(
        f"{k} {v['ms']:.2f} ms (card vs CPU "
        f"{v['card_vs_cpu_max_abs_diff']:.2e})" for k, v in out.items()))
    return out


def aflink_phase(results, dev):
    """AFLink (a seeded PostLinker) and GSI on phase 6's strongsort rows,
    the linker on the card and on the CPU: the same linked ids, the same
    smoothed rows."""
    import copy

    from yolov7_tracker_tpu_torch.reid import random_reid_state_dict
    from yolov7_tracker_tpu_torch.reid.aflink import PostLinker
    from yolov7_tracker_tpu_torch.trackers.aflink_post import (
        gsi_interpolation, link_tracks,
    )

    rows = np.asarray([[fid, tid, *t] for fid, ids, tlwhs, _ in results
                       for tid, t in zip(ids, tlwhs)], float)
    linker = PostLinker()
    linker.load_state_dict(random_reid_state_dict(linker, seed=0))
    card = linker.to(dev).eval()
    cpu = copy.deepcopy(card).cpu()
    out = {}
    for thr in (0.5, 0.95):
        t0 = time.time()
        on_card = link_tracks(rows, card, thr=thr)
        card_s = time.time() - t0
        on_cpu = link_tracks(rows, cpu, thr=thr)
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError(f"AFLink at {thr}: card ids != CPU ids")
        smooth = gsi_interpolation(on_card)
        if not np.array_equal(smooth, gsi_interpolation(on_cpu)) or \
                not np.isfinite(smooth).all():
            raise AssertionError(f"GSI after AFLink at {thr}: card != CPU")
        out[str(thr)] = {"ids_before": int(len(np.unique(rows[:, 1]))),
                         "ids_after": int(len(np.unique(on_card[:, 1]))),
                         "rows": int(len(rows)), "gsi_rows": int(len(smooth)),
                         "link_s_card": card_s}
    log(f"AFLink + GSI on strongsort's {len(rows)} rows, seeded PostLinker: "
        f"card == CPU; {out}")
    return out


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


# ---------------------------------------------------------------------------
# phase 8: scoring and the detection-file seam through cli.track.main, and
# --detect_per_frame on the full-width path
# ---------------------------------------------------------------------------

def pedestrian_tracks(rng, n_frames, hw, n_peds=(40, 60), crossings=5):
    """Constant-velocity pedestrians in a (h, w) frame: rows of (x0, y0,
    vx, vy, w, h, first frame, last frame, class), x0/y0 the box's top
    left at its first frame. Widths 30-90 px at aspect 0.41, velocities up
    to 3 px a frame; pairs of pedestrians 2k, 2k+1 (k < crossings) walk
    through one point at one frame from opposite sides. Then the MOT17
    distractors: two people on a vehicle (class 2) and a static person
    (class 7)."""
    h_img, w_img = hw
    n = int(rng.integers(n_peds[0], n_peds[1] + 1))
    tracks = []
    for _ in range(n):
        w = rng.uniform(30, 90)
        h = w / 0.41
        first = int(rng.integers(1, n_frames // 2))
        last = int(rng.integers(first + n_frames // 4, n_frames + 1))
        vx, vy = rng.uniform(-3, 3, 2)
        tracks.append([rng.uniform(0, w_img - w), rng.uniform(0, h_img - h),
                       vx, vy, w, h, first, last, 1])
    for k in range(crossings):
        a, b = tracks[2 * k], tracks[2 * k + 1]
        b[6:8] = a[6:8]
        meet = int(rng.integers(a[6], a[7] + 1))
        mx, my = rng.uniform(100, w_img - 200), rng.uniform(100, h_img - 300)
        b[2], b[3] = -a[2], a[3] * 0.5
        for t in (a, b):
            t[0] = mx - t[2] * (meet - t[6])
            t[1] = my - t[3] * (meet - t[6])
    for cls, v in ((2, 2.5), (2, -2.0), (7, 0.0)):
        w = rng.uniform(40, 80)
        tracks.append([rng.uniform(200, w_img - 300),
                       rng.uniform(100, h_img - 300), v, 0.0, w, w / 0.41,
                       1, n_frames, cls])
    return tracks


def write_mot_dataset(root, n_seqs=3, n_frames=200, hw=(1080, 1920),
                      seed=0, n_peds=(40, 60)):
    """A seeded MOT17-layout dataset under ``root``: train/<seq>/ with
    seqinfo.ini, gt/gt.txt (frame,id,x,y,w,h,1,class,visibility 1; a row
    while the box's centre is in the frame) and img1/ of empty
    NNNNNN.jpg placeholders (never decoded: they give the frame count);
    dets/<seq>.txt, a detector's output made from the gt (every row,
    distractors too, 10% missed, 2 px jitter, scores U(0.5, 0.95), plus 5
    false positives a frame at U(0.1, 0.45) for ByteTrack's low-score
    stage); configs/smoke_mot17.yaml pointing TRACK_EVAL at the gt.
    Returns (config dir, detections dir, {seq: frames})."""
    import configparser

    import yaml

    from yolov7_tracker_tpu_torch.data.detections import save_mot_detections

    rng = np.random.default_rng(seed)
    h_img, w_img = hw
    seqs = {}
    for s in range(n_seqs):
        seq = f"SMOKE-{s + 1:02d}"
        seq_dir = os.path.join(root, "train", seq)
        os.makedirs(os.path.join(seq_dir, "img1"), exist_ok=True)
        os.makedirs(os.path.join(seq_dir, "gt"), exist_ok=True)
        for f in range(1, n_frames + 1):
            open(os.path.join(seq_dir, "img1", f"{f:06d}.jpg"), "w").close()
        gt_rows, dets = [], {}
        for tid, (x0, y0, vx, vy, w, h, first, last, cls) in enumerate(
                pedestrian_tracks(rng, n_frames, hw, n_peds), start=1):
            for f in range(int(first), int(last) + 1):
                x, y = x0 + vx * (f - first), y0 + vy * (f - first)
                if not (0 <= x + w / 2 < w_img and 0 <= y + h / 2 < h_img):
                    continue
                gt_rows.append((f, f"{f},{tid},{x:.2f},{y:.2f},{w:.2f},"
                                   f"{h:.2f},1,{cls},1.0"))
                if rng.uniform() < 0.1:
                    continue
                jx, jy, jw, jh = rng.normal(0, 2.0, 4)
                dets.setdefault(f, []).append(
                    [x + jx, y + jy, x + jx + w + jw, y + jy + h + jh,
                     rng.uniform(0.5, 0.95), 0])
        for f in range(1, n_frames + 1):
            for _ in range(5):
                w = rng.uniform(30, 90)
                x, y = rng.uniform(0, w_img - w), rng.uniform(0, h_img - 220)
                dets.setdefault(f, []).append(
                    [x, y, x + w, y + w / 0.41, rng.uniform(0.1, 0.45), 0])
        with open(os.path.join(seq_dir, "gt", "gt.txt"), "w") as fh:
            fh.write("\n".join(r for _, r in sorted(
                gt_rows, key=lambda r: r[0])) + "\n")
        save_mot_detections(os.path.join(root, "dets", f"{seq}.txt"),
                            {f: np.asarray(v) for f, v in dets.items()})
        ini = configparser.ConfigParser()
        ini["Sequence"] = {"name": seq, "imDir": "img1", "frameRate": "30",
                           "seqLength": str(n_frames), "imWidth": str(w_img),
                           "imHeight": str(h_img), "imExt": ".jpg"}
        with open(os.path.join(seq_dir, "seqinfo.ini"), "w") as fh:
            ini.write(fh)
        seqs[seq] = n_frames
    cfg_dir = os.path.join(root, "configs")
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, f"{SCORE_DATASET}.yaml"), "w") as fh:
        yaml.safe_dump({
            "DATASET_ROOT": root,
            "CATEGORY_NAMES": ["pedestrian"],
            "TRACK_EVAL": {
                "GT_FOLDER": os.path.join(root, "train"),
                "GT_LOC_FORMAT": "{gt_folder}/{seq}/gt/gt.txt",
                # lengths from each sequence's seqinfo.ini
                "SEQ_INFO": {seq: None for seq in seqs}}}, fh)
    return cfg_dir, os.path.join(root, "dets"), seqs


def no_sync_after_first(step):
    """``step`` with every call but the first under no_sync_step; the
    first makes the solver's per-device constants (a host-to-device copy,
    which waits)."""
    calls = []

    def checked(*args, **kw):
        if not calls:
            calls.append(1)
            return step(*args, **kw)
        return no_sync_step(step, *args, **kw)

    return checked


@contextlib.contextmanager
def steps_without_sync():
    """Every tracker step and predict-only step of a TrackingPipeline
    built inside the block, but the first of each, runs under
    torch.cuda.set_sync_debug_mode("error") (no_sync_after_first): a host
    sync inside a step raises."""
    from yolov7_tracker_tpu_torch import pipeline

    build, build_predict = pipeline.build_tracker, pipeline.build_predict_only

    def no_sync_build(cfg, device="cpu"):
        step, cfg = build(cfg, device)
        return no_sync_after_first(step), cfg

    pipeline.build_tracker = no_sync_build
    pipeline.build_predict_only = lambda cfg: no_sync_after_first(
        build_predict(cfg))
    try:
        yield
    finally:
        pipeline.build_tracker, pipeline.build_predict_only = (
            build, build_predict)


@contextlib.contextmanager
def recording(obj, name, kept, sync=False):
    """obj.name wrapped for the block: each call's (seconds, result,
    positional arguments) is appended to ``kept``; with ``sync`` the clock
    waits for the card."""
    import torch

    fn = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        kept.append((time.time() - t0, out, args))
        return out

    setattr(obj, name, timed)
    try:
        yield
    finally:
        setattr(obj, name, fn)


def tables_equal(a, b):
    """Two score tables ({class: {seq: {metric: value}}}) equal in every
    number."""
    if a.keys() != b.keys():
        return False
    for c in a:
        if a[c].keys() != b[c].keys():
            return False
        for seq in a[c]:
            ra, rb = a[c][seq], b[c][seq]
            if not isinstance(ra, dict):       # the class-averaged row
                ra, rb = {seq: ra}, {seq: rb}
            if ra.keys() != rb.keys() or not all(
                    np.array_equal(np.asarray(ra[k], np.float64),
                                   np.asarray(rb[k], np.float64),
                                   equal_nan=True) for k in ra):
                return False
    return True


def read_tree(folder, ext=(".txt", ".csv")):
    """{file name: bytes} of a results folder."""
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.endswith(ext):
            with open(os.path.join(folder, name), "rb") as fh:
                out[name] = fh.read()
    return out


def scoring_phase(dev):
    """Phase 8a: the seeded MOT17-layout dataset tracked from its
    detection files and scored, through cli.track.main (--detections,
    --track_eval true, the CLI's capacity 256 / det_capacity 300), for
    bytetrack and sort, once on the card and once with --device cpu: the
    MOT txts and CSVs byte for byte and the score tables number for number
    equal; cli.evaluate.main on the card's folder writes the table track
    printed. Returns {tracker: record} and {tracker: K2 launches}."""
    import torch

    from yolov7_tracker_tpu_torch.cli import evaluate, track
    from yolov7_tracker_tpu_torch.eval import evaluator
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.pipeline import TrackingPipeline

    root = os.path.join(OUT_DIR, "mot17_smoke")
    shutil.rmtree(root, ignore_errors=True)    # a dataset of an older run
    cfg_dir, det_dir, seqs = write_mot_dataset(
        root, SCORE_SEQS, SCORE_FRAMES, SCORE_HW)
    n_frames = sum(seqs.values())
    with open(os.path.join(root, "train", next(iter(seqs)), "gt",
                           "gt.txt")) as fh:
        gt_rows = sum(1 for _ in fh)
    log(f"phase 8a: {len(seqs)} MOT17-layout sequences of {SCORE_FRAMES} "
        f"frames at {SCORE_HW[1]}x{SCORE_HW[0]} under {root} "
        f"({gt_rows} gt rows in the first)")
    records, launches = {}, {}
    for tracker in ("bytetrack", "sort"):
        runs = {}
        for device in ("cuda", "cpu"):
            argv = ["--dataset", SCORE_DATASET, "--config_dir", cfg_dir,
                    "--split", "train", "--tracker", tracker,
                    "--model", "yolov7-tiny", "--detections", det_dir,
                    "--track_eval", "true", "--device", device,
                    "--output_dir", os.path.join(root, f"{tracker}_{device}")]
            seq_runs, scored = [], []
            torch.cuda.synchronize()
            auction.LAUNCHES = 0
            with steps_without_sync(), \
                    recording(TrackingPipeline, "run_sequence_detections",
                              seq_runs, sync=True), \
                    recording(track, "evaluate_run", scored):
                folder = track.main(argv)
            runs[device] = {
                "folder": folder, "launches": auction.LAUNCHES,
                "track_s": sum(t for t, _, _ in seq_runs),
                "score_s": scored[0][0], "table": scored[0][1],
                "files": read_tree(folder), "pipe": seq_runs[0][2][0],
                "dets": seq_runs[0][2][1]}
        card, cpu = runs["cuda"], runs["cpu"]
        if card["launches"] != 2 * n_frames or cpu["launches"] != 0:
            raise AssertionError(
                f"{tracker}: K2 launches {card['launches']} on the card, "
                f"{cpu['launches']} on the CPU, for {n_frames} frames")
        differ = sorted(k for k in card["files"].keys() | cpu["files"]
                        if card["files"].get(k) != cpu["files"].get(k))
        if differ or len(card["files"]) != len(seqs) + 1:
            raise AssertionError(
                f"{tracker}: files of the card's run {sorted(card['files'])}"
                f", differing from the CPU's: {differ}")
        if not tables_equal(card["table"], cpu["table"]):
            raise AssertionError(f"{tracker}: card and CPU score tables "
                                 "differ")
        eval_out = os.path.join(root, f"{tracker}_evaluate")
        rc = evaluate.main(["--benchmark", "MOT17", "--gt_folder",
                            os.path.join(root, "train"), "--trackers_folder",
                            card["folder"], "--output_folder", eval_out])
        with open(os.path.join(eval_out, "summary.json")) as fh:
            summary = json.load(fh)
        want = {"pedestrian": evaluator.summarize(
            card["table"]["pedestrian"]["COMBINED_SEQ"])}
        if rc != 0 or summary != want:
            raise AssertionError(f"{tracker}: cli.evaluate's summary.json "
                                 f"{summary} != track's table {want}")
        head = want["pedestrian"]
        rows = sum(v.count(b"\n") for k, v in card["files"].items()
                   if k.endswith(".txt"))
        parts = detections_breakdown(card["pipe"], card["dets"])
        records[tracker] = {
            "HOTA": head["HOTA"], "MOTA": head["MOTA"], "IDF1": head["IDF1"],
            "IDSW": head["IDSW"], "frames": n_frames, "mot_rows": rows,
            "ms_per_frame": card["track_s"] / n_frames * 1e3,
            "cpu_ms_per_frame": cpu["track_s"] / n_frames * 1e3,
            "scoring_s": card["score_s"], "cpu_scoring_s": cpu["score_s"],
            "k2_launches": card["launches"], "frame_parts_ms": parts,
            "card_vs_cpu": "MOT txts and CSV byte-equal, tables equal",
            "evaluate_cli": "summary.json == track's table"}
        launches[tracker] = card["launches"]
        log(f"{tracker} from detection files on {card_line()}: HOTA "
            f"{head['HOTA'] * 100:.3f} MOTA {head['MOTA'] * 100:.3f} IDF1 "
            f"{head['IDF1'] * 100:.3f} IDSW {head['IDSW']:.0f}; tracking "
            f"{records[tracker]['ms_per_frame']:.3f} ms/frame on the card "
            f"({records[tracker]['cpu_ms_per_frame']:.3f} on the CPU) over "
            f"{n_frames} frames, {card['launches']} K2 launches; scoring "
            f"{card['score_s']:.2f} s; {rows} MOT rows, card == CPU byte "
            "for byte, cli.evaluate == track's table")
    return records, launches


def detections_breakdown(pipe, dets):
    """One frame of the detections path on the card, each part timed alone
    with CUDA events on the slab halfway through the sequence: the rows'
    H2D (make_det_slab), the tracker step, and the packed D2H."""
    from yolov7_tracker_tpu_torch.trackers import slab as S

    def det_of(f):
        rows = dets.get(f, np.zeros((0, 6), np.float32))
        return S.make_det_slab(pipe.tcfg, rows[:, :4], rows[:, 4],
                               rows[:, 5], np.ones(len(rows), bool),
                               pipe.device)

    half = max(dets) // 2
    slab = pipe.init_tracker()
    for f in range(1, half):
        slab, out = pipe.step(slab, det_of(f))
    det = det_of(half)
    packed = S.FrameOutput(*(x[None] for x in out))
    parts = {
        "rows_h2d": cuda_ms(lambda: det_of(half), 20),
        "step": cuda_ms(lambda: pipe.step(slab, det), 20),
        "pack_d2h": cuda_ms(lambda: pipe.unpack_output(
            pipe.pack_output(packed)), 20)}
    log(f"{pipe.tcfg.tracker}, a frame of the detections path on "
        f"{card_line()} ({int(det.valid.sum())} rows, "
        f"{int(out.valid.sum())} tracks out): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in parts.items()))
    return parts


def detect_every_phase(sd, dev):
    """Phase 8b: --detect_per_frame on phase 3's path (yolov7-w6 @1088,
    batch 8, ByteTrack 128 / 300) over phase 3's 16 frames at k = 1 (the
    reference for the times), 2 and 3: every step, the predict-only ones
    too, but each first, with no host sync; K2 launches on detected
    frames only (2 each); at k > 1 a run resumed from the state saved
    after frame 7 (mid-cadence) equal to the uninterrupted run, and the
    predict-only step timed alone; a CPU replay of the card's detections
    and cadence with the same ids and boxes within 1e-2. Returns
    ({k: record}, {k: K2 launches})."""
    import torch

    from yolov7_tracker_tpu_torch.data import writer
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import (
        build_predict_only, build_tracker)

    frames = offline_frames()
    n = len(frames)
    records, launches = {}, {}
    for k in (1,) + DETECT_EVERY:
        with steps_without_sync():
            pipe = tracker_pipeline(sd, dev, dict(tracker="bytetrack"),
                                    dict(detect_per_frame=k))
        pipe.run_sequence(iter(frames[:8]))         # warm-up, not counted
        kept = []                # the detected frames' inputs, in order
        step = pipe.step

        def recording_step(slab, det, **kw):
            kept.append(S.DetSlab(*(x.clone() for x in det)))  # no sync
            return step(slab, det, **kw)

        pipe.step = recording_step
        torch.cuda.synchronize()
        auction.LAUNCHES = 0
        t0 = time.time()
        results, _ = pipe.run_sequence_stateful(iter(frames))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launched = auction.LAUNCHES
        pipe.step = step
        detected = list(range(0, n, k))
        if len(kept) != len(detected) or launched != 2 * len(detected):
            raise AssertionError(
                f"detect_per_frame={k}: {len(kept)} detected frames, "
                f"{launched} K2 launches, for {len(detected)} frames of "
                "the cadence")
        dets = dict(zip(detected, kept))
        if [r[0] for r in results] != list(range(1, n + 1)):
            raise AssertionError(f"detect_per_frame={k}: frame ids "
                                 f"{[r[0] for r in results]}")
        if k > 1:
            # resumed from the state saved after frame 7 (mid-cadence;
            # each detector batch is one frame here, as in one run)
            path = os.path.join(OUT_DIR, f"detect_every_{k}_state.npz")
            first, mid = pipe.run_sequence_stateful(iter(frames[:7]))
            pipe.save_tracker_state(mid, path)
            second, _ = pipe.run_sequence_stateful(
                iter(frames[7:]), initial_slab=pipe.load_tracker_state(path))
            whole = writer.save_results(OUT_DIR, f"detect_every_{k}",
                                        results)
            resumed = writer.save_results(
                OUT_DIR, f"detect_every_{k}_resumed", first + second)
            if read_file(whole) != read_file(resumed):
                raise AssertionError(f"detect_per_frame={k}: the resumed "
                                     "run's MOT txt differs from one run's")
        # CPU replay: the card's detections on detected frames, the
        # predict-only step between
        cpu_step, cfg = build_tracker(pipe.tcfg, "cpu")
        predict = build_predict_only(cfg)
        slab = S.init_slab(cfg, "cpu")
        for f in range(n):
            if f in dets:
                slab, out = cpu_step(slab, S.DetSlab(*(x.cpu()
                                                       for x in dets[f])))
            else:
                slab, out = predict(slab)
            _, ids, tlwhs, _ = results[f]
            v = out.valid.numpy()
            if out.track_id.numpy()[v].tolist() != ids or not np.allclose(
                    out.tlwh.numpy()[v], np.asarray(tlwhs).reshape(-1, 4),
                    atol=1e-2):
                raise AssertionError(f"detect_per_frame={k}: CPU replay "
                                     f"differs at frame {f}")
        tracks = [len(r[1]) for r in results]
        if k > 1:
            predict_ms = cuda_ms(lambda: pipe.predict_only(mid), 20)
        records[str(k)] = {
            "ms_per_frame": wall / n * 1e3, "frames": n,
            "detected_frames": len(detected), "k2_launches": launched,
            "tracks_per_frame_mean": float(np.mean(tracks)),
            "cpu_replay": "same ids, boxes 1e-2"}
        if k > 1:
            records[str(k)]["resumed_after_frame_7"] = \
                "MOT txt equal to one run"
            records[str(k)]["predict_only_ms"] = predict_ms
            log(f"detect_per_frame={k}: the predict-only step alone on the "
                f"slab after frame 7 ({int(mid.occupied.sum())} tracks): "
                f"{predict_ms:.3f} ms (CUDA events)")
        launches[str(k)] = launched
        log(f"detect_per_frame={k} on {card_line()}: {wall / n * 1e3:.2f} "
            f"ms/frame over {n} frames ({len(detected)} detected), "
            f"{launched} K2 launches, tracks/frame mean "
            f"{np.mean(tracks):.1f}; no host sync in any step; "
            f"{'resumed after frame 7 == one run; ' if k > 1 else ''}"
            "CPU replay: same ids, boxes 1e-2")
    return records, launches


def read_file(path):
    with open(path, "rb") as fh:
        return fh.read()


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
    trackers, k2_by_tracker, strongsort_rows = trackers_phase(sd, dev)
    reid_path = seeded_osnet(sd, dev)
    trackers["serving_reid"], k3_serve_reid, k2_serve_reid = \
        serving_reid_phase(sd, dev, reid_path)
    trackers["step_frame_reid"], k1_step_reid, k2_step_reid = \
        step_frame_reid_phase(sd, dev, reid_path)
    trackers["deepmot_s8"], k3_deepmot, k2_deepmot = \
        deepmot_streams_phase(sd, dev)
    trackers["dhn"] = dhn_timings(dev)
    trackers["aflink_gsi"] = aflink_phase(strongsort_rows, dev)
    t8 = time.time()
    trackers["scoring"], k2_scoring = scoring_phase(dev)
    t8b = time.time()
    trackers["detect_per_frame"], k2_detect_every = detect_every_phase(sd,
                                                                       dev)
    log(f"phase 8a {t8b - t8:.1f} s, phase 8b {time.time() - t8b:.1f} s")

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
              "launches_trackers": k2_by_tracker,
              "launches_serving_reid": k2_serve_reid,
              "launches_step_frame_reid": k2_step_reid,
              "launches_deepmot_s8": k2_deepmot,
              "launches_scoring": k2_scoring,
              "launches_detect_per_frame": k2_detect_every,
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
              "launches": k1_launches,
              "launches_step_frame_reid": k1_step_reid,
              "max_abs_err": float(worst_sq),
              "library_ms": None, **on_step,
              "seeded_problem": t_k1}
    rec_k3 = {"name": "auction_k3_square_batched", "route": "cuda",
              "source": SOURCE_SQUARE, "replaces": REPLACES_K3,
              "launches": k3_launches,
              "launches_serving_reid": k3_serve_reid,
              "launches_deepmot_s8": k3_deepmot,
              "max_abs_err": float(worst_sq),
              "library_ms": None, **on_tick,
              "seeded_batches": {str(b): t for b, t in t_k3.items()}}
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"trackers": trackers}))
    print(json.dumps({"kernels": [rec_k1, record, rec_k3]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
