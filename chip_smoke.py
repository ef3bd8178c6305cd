#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (yolov7_tracker_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build   -- nvcc builds csrc/auction.cu (K2, the private-dummy
                auction) for sm_90a from the checkout.
  2. kernel  -- the K2 kernel against its plain PyTorch version on the
                card: >= 32 seeded (128, 300) problems (association-shaped
                and dense U[0,1], random masks) plus batch-2 launches at
                the stage-2/3 thresholds, exact equality of r2c/c2r, and a
                few association problems against scipy.
  3. main    -- yolov7-w6 at full width (nc=80, 1088 px, bf16, BN folded,
                seeded weights with sharpened heads) -> NMS -> ByteTrack
                (capacity 128, det_capacity 300) over 32 synthetic
                1080x1920 frames through TrackingPipeline.run_sequence,
                with the K2 launch count reset just before and read just
                after (2 per frame). The main path's own auction problems
                are then re-solved by the kernel and the plain version,
                the tracker is replayed on the CPU from the same
                detections, and a small detector input is checked
                against a float32 CPU reference.
It prints the kernel JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}. It exits non-zero, printing no result, if
there is no CUDA device or if any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
REPLACES = "yolov7_tracker_tpu/ops/pallas_auction.py:412"
SOURCE = "yolov7_tracker_tpu_torch/csrc/auction.cu"
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


def compare(auction, problems, dev):
    """Kernel vs plain version on each (cost, rm, cm, thresh); returns the
    max |difference| over r2c and c2r (0 means bit-identical)."""
    import torch

    worst = 0
    for cost, rm, cm, th in problems:
        args = (cost.to(dev), rm.to(dev), cm.to(dev), th.to(dev))
        kr, kc = auction.masked_assignment_auction_cuda(
            *args, n_phases=2, phase_factor=4.0 ** 2.5)
        pr, pc = auction.masked_assignment_auction_torch(
            *args, n_phases=2, phase_factor=4.0 ** 2.5)
        torch.cuda.synchronize()
        worst = max(worst, int((kr.long() - pr.long()).abs().max()),
                    int((kc.long() - pc.long()).abs().max()))
    return worst


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
    log(f"32 single problems (128, 300): max |kernel - plain| = {worst} "
        f"({time.time() - t0:.1f} s)")
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
    if worst != 0:
        raise AssertionError(f"kernel differs from its plain version: {worst}")

    for cost, rm, cm, th in problems[:16:2]:
        r2c, _ = auction.masked_assignment_auction_cuda(
            cost.to(dev), rm.to(dev), cm.to(dev), th.to(dev), n_phases=2,
            phase_factor=4.0 ** 2.5)
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
    return worst


def time_kernel(auction, problem, dev):
    """(kernel ms, plain ms, sweeps, bound_ms, bound_by) for one main-path
    problem (cost, rm, cm, thresh) on the card."""
    import torch

    cost, rm, cm, th = (t.to(dev) for t in problem)
    b = rm.shape[0] if rm.dim() == 2 else 1
    kw = dict(n_phases=2, phase_factor=4.0 ** 2.5)
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    auction.masked_assignment_auction_cuda(cost, rm, cm, th, sweeps=sweeps,
                                           **kw)
    k_ms = cuda_ms(lambda: auction.masked_assignment_auction_cuda(
        cost, rm, cm, th, **kw), 50)
    p_ms = cuda_ms(lambda: auction.masked_assignment_auction_torch(
        cost, rm, cm, th, **kw), 3)
    n, m = cost.shape[-2:]
    # each input read once, each output written once
    nbytes = cost.numel() * 4 + b * (n + m) + b * 4 + b * (n + m) * 4
    # per sweep every row makes one pass over its m + n columns: one
    # subtract and one max/compare per element
    ops = int(sweeps.sum()) * n * (m + n) * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (k_ms, p_ms, sweeps.tolist(), max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def main_phase(dev):
    import torch

    from yolov7_tracker_tpu_torch.data import writer
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import (random_state_dict,
                                                      sharpen_heads)
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import bytetrack
    from yolov7_tracker_tpu_torch.trackers import slab as S

    spec = zoo.get_spec("yolov7-w6", nc=80)
    sd = random_state_dict(spec, seed=0)
    sharpen_heads(sd, spec)
    pcfg = PipelineConfig(model="yolov7-w6", nc=80, img_size=1088,
                          detector_batch=8, dtype="bfloat16", fuse=True)
    tcfg = S.TrackerConfig(tracker="bytetrack", conf_thresh=0.5,
                           capacity=128, det_capacity=300)
    pipe = TrackingPipeline(pcfg, tcfg, state_dict=sd, spec=spec, device=dev)

    rng = np.random.default_rng(0)
    f0 = rng.integers(0, 255, (8, 1080, 1920, 3), np.uint8)
    f1 = np.roll(f0, 8, axis=2)       # an 8-px shift: the scene persists
    frames = [f for k in range(2) for f in (f0, f1)[k % 2]] * 2   # 32

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # float32 comparisons below run in full float32 (the bf16 main path
    # does not use these paths)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from yolov7_tracker_tpu_torch.ops import auction

    dev = torch.device("cuda")
    t0 = time.time()
    auction.load_library()
    log(f"built {SOURCE} for sm_90a in {auction.BUILD_SECONDS:.1f} s")
    for line in auction.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    worst = kernel_phase(dev)
    launches, solves = main_phase(dev)
    detector_reference_check(dev)
    record = {"name": "auction_k2_private_dummy", "route": "cuda",
              "source": SOURCE, "replaces": REPLACES, "launches": launches,
              "max_abs_err": float(worst), "library_ms": None}
    # the last frame's two solves, as the main path gave them
    stage1, stage23 = solves[-2], solves[-1]
    k1, p1, s1, b1, by1 = time_kernel(auction, stage1, dev)
    k2, p2, s2, b2, by2 = time_kernel(auction, stage23, dev)
    log(f"K2 timings on {card_line()}")
    log(f"K2 stage 1 (B=1, {tuple(stage1[0].shape)}): kernel {k1:.4f} ms, "
        f"plain {p1:.3f} ms, sweeps {s1}, bound {b1:.6f} ms ({by1})")
    log(f"K2 stages 2+3 (B=2): kernel {k2:.4f} ms, plain {p2:.3f} ms, "
        f"sweeps {s2}, bound {b2:.6f} ms ({by2})")
    record.update(ms=k1, plain_ms=p1, bound_ms=b1, bound_by=by1,
                  sweeps=s1, ms_b2=k2, plain_ms_b2=p2, bound_ms_b2=b2,
                  sweeps_b2=s2)
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
