#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (yolov7_tracker_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build   -- nvcc builds csrc/auction.cu (K4, the XLA twin's form of
                the private-dummy auction, the trackers' solver
                ops/assignment.solve_assignment, with its cascade entry,
                deepsort's matching cascade in one launch; and K2, the
                Pallas kernel's form, which no path runs),
                csrc/auction_square.cu (K1 and K3, the square
                lapjv-extended auction) and the profiling build of each
                (-DAUCTION_PROFILE; K4's and K2's, K1/K3's) and
                csrc/deepsort_cnn.cu (K5, the DeepSORT CNN with its BN
                folded) and csrc/nms.cu (K6, NMS's greedy keep set) for
                sm_90a from the checkout, side by side.
  2. kernels -- each kernel against its plain PyTorch version on the card
                at the tracker's shape (128, 300), exact equality of
                r2c/c2r and of every problem's sweep count. K4 and K2,
                each on every problem below, K4 also against scipy (the
                association problems, and the twelve dense host cases of
                tests/test_torch_auction.py within K4_HOST_GAP): >= 32
                seeded problems (association-shaped and dense U[0,1],
                random masks) plus batch-2 launches at the stage-2/3
                thresholds, a few association problems against scipy, and
                problems that stress the sweep: every row bidding on equal
                costs, 256 x 300 (weights not staged), 7 x 5, 300 x 128
                (never settles), 127 x 301 (no 16-byte loads), everything
                masked out, max_iters hit, a phase that ends on an
                unchanged state,
                5 phases at factor 4, a (B, N, M) cost with B thresholds,
                and B = 264. K4's cascade entry against its plain
                version (r2c, c2r, every level's sweeps) on seeded
                DeepSORT-shaped cascades of 30 levels, a level 0 that takes
                every column, a batch of 4 with a threshold each, the
                unstaged (256, 300) and scalar-staged (127, 301) shapes,
                and no row. K1: seeded association-shaped and dense
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
                with the K4 and K2 launch counts reset just before and
                read just after (2 K4 per frame, no K2; one K6 launch a
                detector batch and no host_syncs.nms, as every phase
                below that counts launches over detector batches checks,
                nms_through_k6; torch.profiler's kernels held against the
                solvers' and K6's counts, launch_witness). K6 itself
                (k6_phase, before this phase): bit for bit its plain
                version on seeded batches and on w6's raw levels, and
                timed at the cells' shapes. The same run is
                timed with K2 (before K4) and K4 as the solver in turns
                K2, K4, K4, K2 (its first 8 frames). The main path's
                own auction problems are then re-solved by K4 and K2 and
                their plain versions,
                the tracker is replayed on the CPU from the same
                detections, and a small detector input is checked
                against a float32 CPU reference.
  4. serving -- cli/serve.py on the same detector: 8 synthetic 1080x1920
                cameras, 16 ticks with state checkpoints, then a second
                call that resumes from them for 8 more. 8 result files
                with rows for 24 consecutive frames and ids that continue
                across the resume; one K3 and one K4 launch per tick (the
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
                K4 launches (reset just before the run, read just after)
                equal to its solves a frame x 16 (deepsort: 2 K4 and one
                launch of K4's cascade entry a frame), no K2 launch
                (strongsort also timed with K2, before K4, and K4 as the
                solver in turns); deepsort's CNN as K5, 18 launches a
                frame (none for the others), and K5 alone (k5_phase): at
                N = 1, 7, 300, 613 and 2400 against its plain version
                and the module within K5_REL_TOL, timed at 300 beside
                its bound, the plain version and cuDNN (library_ms,
                which the port never calls); every tracker step under
                torch.cuda.set_sync_debug_mode("error") (a host sync inside
                a step fails the phase), for botsort and strongsort also
                without the GMC's warp; a CPU replay of the tracker step on
                the detections, features and warps the card gave (K4's
                plain version) with the same ids and boxes; ms/frame. Also
                each ReID model on 16 crops through the pipeline's
                reid_forward on the card against the CPU (relative 1e-3), ECC
                on two frames of the pan (the 8-px shift within 0.5 px),
                strongsort's frame split into crops, ReID forward, ECC and
                tracker step, and deepsort's cascade: its last frame's
                cascade captured on the CPU, the cascade entry held against
                its plain version on it and timed (CUDA graph, and through
                solve_cascade), a step profiled (launches a step), and the
                run's steps replayed on the card with the cascade in one
                launch and as the per-level K4 loop, in turns, the two MOT
                txts byte for byte (cascade_forms).
                deepmot runs here twice at its
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
                uninterrupted 24-tick run byte for byte (one K3 and two K4
                launches a tick); the same through step_frame for 8
                frames (one K1 and two K4 a frame); deepmot with the GRU
                DHN through process_multistream at S = 8 for 8 ticks (one
                K3 and one K4 a tick, the DHN on the last tick's compacted
                costs card against CPU). Each of these three keeps its
                last tick's or frame's stage-1 and stage-2/3 problems
                (path_solves) and re-solves them by the plain versions:
                K1/K3 and K4 bit for bit, and K2 against its own plain
                version on K4's problems. Then each DHN head alone on a 128 x 48
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
                the score tables equal, 2 K4 launches a frame on the card,
                every step but a run's first (it makes the solver's
                constants) with no host sync; cli.evaluate.main on the
                card's folder writes the table track printed (HOTA, MOTA,
                IDF1, ms/frame and a frame's parts, scoring seconds).
                (b) --detect_per_frame k = 1, 2, 3 on phase 3's path and
                frames: K4 only on detected frames, no host sync in any
                step (the predict-only ones too), a run resumed from the
                state saved after frame 7 equal to one run, the
                predict-only step timed alone, a CPU replay with the same
                ids.
  9. zoo     -- one model of each other detector family, at full width
                (nc=80, the published depth and width multiples): yolov7
                (RepConv, IDetect), yolov7-e6e (DownC, Shortcut, four levels),
                yolov5l (C3, SPPF, Detect), yolov8l (C2f, DetectV8 through
                the decoded-path NMS), yolov4-csp (Bottleneck, CSP B/C,
                SPPCSPC) and yolov3-spp (SPP, Bottleneck n > 1); seeded
                weights, BN statistics set from the frames and the head
                outputs standardised to a per-model spread and boost
                (ZOO_RUNS), 1280 px (the CLI's default), batch 8, bf16, BN
                and RepConv folded, through offline ByteTrack (128 / 300,
                conf_thresh 0.5) on phase 3's 16 frames: K4 twice a frame,
                NMS survivors on every frame within ZOO_SURVIVORS (below
                max_det), ms/frame and a
                frame's parts (letterbox, detector, NMS, step; CUDA
                events), the detector in float32 (TF32 off) on the card
                against the CPU and fused against unfused (ZOO_REL_TOL, on
                each part of the output alone; bf16 must land above it),
                and a CPU replay of the tracker with the same ids.
 10. train   -- training and the detector test (no kernel of the port:
                training reaches none; convs are cuDNN, SimOTA is torch
                ops). (a) two train steps of yolov7-w6 at full width
                (nc=80, 320 px, batch 2) from one seeded TrainState on the
                card and on the CPU: at ni 495 the accumulation carries,
                at 496 it applies (SGD + EMA). The network runs in float64
                (in float32 the two devices' raw preds part by more than
                1e-4, which flips the odd steep match), SimOTA and the loss
                terms on its preds cast to float32 as always. After each
                step: the same SimOTA assignments, lead and aux (a
                difference only at a printed near-tie), loss parts within
                1e-4 relative, parameters, BN statistics, EMA, momentum
                and gradient sum within 1e-4 of each tensor's largest
                value; the carry leaves a gradient sum, the apply moves
                every group. The float32 steps (TF32 off) are reported
                beside them, their SimOTA on the card's preds equal to the
                CPU's, the card's applying step under
                torch.cuda.set_sync_debug_mode("error"). (b)
                cli/train.train_loop on yolov7-w6 at 1280 px, batch 8, bf16,
                nominal batch 64, data/hyp.scratch.p6.yaml, 12 batches of a
                seeded in-memory dataset (MemoryDataset: 5-60 rectangles an
                image) from ni 500 (accumulate 4, then 5): every loss
                finite, optimizer steps where the accumulate schedule says
                and carried sums between, step ms (median of steps 4-12),
                imgs/s, peak memory, the step's parts by CUDA events
                (forward, the two SimOTA assignments, the loss terms,
                backward, optimizer + EMA), launches a step (profiler) and
                FLOPs (FlopCounterMode) as a share of the bf16 peak. (c)
                (a)'s configuration through the loop's checkpointing under
                torch.use_deterministic_algorithms: preempt_after 3 writes
                step_3/ and preempted.json, _find_latest_ckpt picks it, it
                reloads bit for bit, and two resumed steps equal steps 4-5
                of an uninterrupted run bit for bit (within 1e-4 where an
                op has no deterministic form, named). (d) cli/test's
                evaluate_map on (b)'s EMA weights and its starting weights
                at 640 px over 16 seeded images labelled from the latter's
                detections: float32 on the card (time, the NMS's ms and
                host syncs a batch), and card against CPU in float64:
                detections per image equal, mAPs within 1e-4. (e)
                yolov7-tiny (IDetect, SimOTA, hyp.scratch.tiny) at 640 px,
                batch 32, 6 batches: step ms and imgs/s. Prints the train
                JSON line.
 11. train2  -- the rest of training (no new kernel: none of it reaches
                Pallas in JAX). (a) yolov7's zoo rows with an IBin head
                (nc=80) through phase 9's run: seeded weights calibrated on
                the frames (standardize_heads scores objectness and class
                after the bins), 1280 px, batch 8, bf16, folded, offline
                ByteTrack (128 / 300) on phase 3's 16 frames through the
                decoded-path NMS: K4 twice a frame, NMS survivors within
                ZOO_SURVIVORS, ms/frame and its parts, the detector in
                float32 card vs CPU and fused vs unfused per raw part (xy,
                w bins, h bins, objectness, class; bf16 above the
                tolerance), the decoded output card vs CPU (a bin may
                differ only at a near tie, IBIN_TIE; the scores within
                IBIN_SCORE_TOL, bf16's above it), a CPU replay with the
                same ids. (b) the IBin yolov7 in training mode at 320 px,
                batch 2, its network in float64 on the card and the CPU,
                through compute_loss_bin_ota on its preds cast to float32
                and backward: the same SimOTA assignments, loss parts
                within 1e-4 relative, every gradient within 1e-4 of its
                largest, the preds rounded to bf16 above that; and at
                640 px, batch 16, bf16 autocast, forward + loss + backward
                (median of 6 after 2) by parts (CUDA events), peak memory
                and the host syncs in the loss, beside the IDetect yolov7
                through compute_loss_ota. (c) rank_sort_loss, alrp_loss and
                ap_loss at N = 8,400 with 15% positives, forward +
                backward, card vs CPU within 1e-5 of the largest value and
                gradient, ms and peak memory. (d) train_dhn for the GRU at
                hidden 256 and for Sinkhorn (size 16, pad_train, batch 8,
                200 steps): the first step card vs CPU in float64 (1e-6),
                ms a step split into problem generation on the host, H2D
                and the device step, eval_dhn, the msgpack written and
                reloaded by load_dhn, and deepmot (128 x 48) on phase 3's
                frames with it (K4 twice a frame). Prints the train2 JSON
                line.
 12. models  -- the last model-side modules (no new kernel: none of this
                JAX code reaches Pallas). (a) int8 serving: phase 3's w6
                (1088 px, batch 8) fused and quantized (models/quant.py),
                calibrated as cli/track.py --quant int8 does on the first
                4 frames, through offline ByteTrack (128 / 300) on phase
                3's 16 frames: the int8 tree re-made on the host equals
                the card's buffers bit for bit, the CPU's calibration
                within float32 noise; K4 twice a frame, the path's last
                two problems re-solved by the plain version; ms/frame and
                its parts beside the bf16 w6's; the int8 detector on one
                frame card vs CPU (float32 input) within ZOO_REL_TOL of
                each raw part; a CPU replay with the same ids; int8 vs
                bf16 correlation and confidence difference. (b) TTA
                (forward_tta) on the w6 at 1280 px, batch 8, bf16, then
                NMS; (c) two seeded yolov7 through ensemble_apply in each
                mode, then NMS; both float32 card vs CPU on one frame
                within ZOO_REL_TOL of each decoded part. (d) torch.export
                of the fused bf16 w6 (1280 px, batch 8), saved and
                loaded: program vs eager within 1e-6 of each part, export
                s, flops and memory (export_compiled_stats). (e) the JAX
                package's tail test cfgs (TAIL_CFGS) at 640 px, batch 8:
                card vs CPU and fused vs unfused, float32, ZOO_REL_TOL;
                bf16 ms. (f) cli/detect.py's loop on 16 frames, yolov7 at
                640 px, float32: card vs CPU the same counts and classes,
                boxes as detect_check says. Prints the models JSON line.
 13. parallel -- the parallel layer (no new kernel; K3 and K4 run on every
                rank of (a)), each path at world 1 through NCCL (this
                process) and at world 2 with both ranks on the one card
                through gloo (spawned; gloo copies card tensors through
                the host, so these runs are not under
                set_sync_debug_mode("error"), and their times are a
                correctness check's, not a scaling result). (a) ByteTrack
                (128 / 300) sharded over the ranks on S = 8 streams of w6
                detections (phase 3's frames, stream s offset by 2 s
                frames): slabs and outputs bit for bit one process's
                track_scan_multi, K3 and K4 once a frame on every rank
                (counts set to 0 just before the run, read just after),
                each rank's last stage-1 and stages-2+3 problems equal to
                the plain versions'; ms a frame. (b) w6 (nc=80) at 1088 px
                height-sharded on 1080x1920 frames: in float32 the raw
                levels within PAR_LEVEL_TOL of each part's largest against
                the unsharded model, the same NMS counts as detect_batch;
                bf16 ms a frame beside detect_batch's. (c) w6 at 320 px in
                float64, global batch 2, two steps (carry, apply): world 2
                within PAR_TRAIN_TOL of world 1 (parameters, BN
                statistics, EMA, momentum), the ranks bit for bit equal;
                then bf16 at 1280 px, global batch 8: ms a step (median of
                steps 4-12) and peak memory a rank. Prints the parallel
                JSON line.
Through phases 3-13 every "K4 launch" is a call of the trackers' solver
on the card; the counts of each path go into K4's record, deepsort's
cascade launches (phase 6) into the cascade entry's, and K2's record
holds K2's launches on the main path (none). Then K4 and K2 on the
offline path's last stage-1 and stage-2/3 problems and on the last tick's
2S problems, K1 on step_frame's last problem and K3 on the last tick's are
timed (ms, us per sweep, bound), K4, K2, K1 and K3 profiled (where a
solve's cycles go, by the profiling builds, which no path uses), and the
problems are written to chiprun_out/chip_smoke/k2_problems.pt and
square_problems.pt (deepsort's last cascade to cascade_problems.pt).
It prints the trackers JSON line, the train JSON line, the train2 JSON
line, the models JSON line, the parallel JSON line, the kernel JSON line,
the card's name and power limit, and last
{"ok": true, "device": {...}}. It exits non-zero, printing no result, if
there is no CUDA device or if any phase fails. It imports nothing of JAX.

    python3 chip_smoke.py --square-only [--problems square_problems.pt]

is a short run for work on K1/K3 alone: build, phase 2 for K1/K3, and,
given the file a full run wrote, the timing and profile on the paths'
problems. It prints no result line.

    python3 chip_smoke.py --k2-only [--problems k2_problems.pt]
        [--cascade-problems cascade_problems.pt]

is its twin for work on the private-dummy kernels: it builds, checks,
times and profiles K4 and K2, and checks K4's cascade entry (and times it
on deepsort's cascade, given the file).

    python3 chip_smoke.py --k5-only

builds csrc/deepsort_cnn.cu and runs k5_phase alone (K5's record on one
JSON line, no result line).

    python3 chip_smoke.py --k6-only

builds csrc/nms.cu and runs k6_phase alone (K6, NMS's greedy keep set:
checked bit for bit against the plain version and timed at the cells'
shapes; its record on one JSON line, no result line).

    python3 chip_smoke.py --train-only

runs phase 10 alone and prints its JSON line, no result line.

    python3 chip_smoke.py --train2-only

builds K4 (csrc/auction.cu) and runs phase 11 alone, and prints its JSON line, no result
line.

    python3 chip_smoke.py --models-only

builds K4 (csrc/auction.cu) and runs phase 12 alone, and prints its JSON line, no result
line.

    python3 chip_smoke.py --parallel-only

builds K4 and K3 and runs phase 13 alone (phase 3's w6 built for it), and
prints its JSON line, no result line.
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
# K4 is not a Pallas kernel: it replaces the XLA twin that the JAX
# package's solve_assignment runs on its chip (ops/assignment.py:75)
REPLACES_K4 = "yolov7_tracker_tpu/ops/assignment.py:311"
# K4's cascade entry replaces the lax.scan of JAX's matching_cascade
REPLACES_CASCADE = "yolov7_tracker_tpu/trackers/appearance.py:66"
REPLACES_K1 = "yolov7_tracker_tpu/ops/pallas_auction.py:196"
REPLACES_K3 = "yolov7_tracker_tpu/ops/pallas_auction.py:631"
SOURCE_SQUARE = "yolov7_tracker_tpu_torch/csrc/auction_square.cu"
# K5, the DeepSORT CNN folded (ops/deepsort_cnn.py), replaces no TPU kernel:
# the JAX package runs the network as plain XLA
SOURCE_K5 = "yolov7_tracker_tpu_torch/csrc/deepsort_cnn.cu"
REPLACES_K5 = "none: yolov7_tracker_tpu/reid/deepsort_cnn.py is plain XLA"
K5_NS = (1, 7, 300, 613, 2400)   # crops: one, a few, a frame's 300 slots, a
#                                  ragged edge, a tick of 8 streams
K5_TIMED_N = 300
K5_REL_TOL = 1e-5             # K5 against the plain version and the module
K5_LAUNCHES = 18              # the stem, 16 convolutions, the head
# K6, NMS's greedy keep set (ops/nms.py), replaces no TPU kernel: the JAX
# package's greedy_suppress is a lax.while_loop
SOURCE_K6 = "yolov7_tracker_tpu_torch/csrc/nms.cu"
REPLACES_K6 = "none: yolov7_tracker_tpu/ops/nms.py:34 is a lax.while_loop"
# the cells' NMS (perfbench/configs/yolov7-w6.bytetrack.json): a batch of 8,
# the top 2048 candidates, max_det 300, IoU 0.45, 10 classes, 1280 px
K6_CELL = dict(b=8, k=2048, max_det=300, iou_thres=0.45, nc=10, img=1280)
# the candidates' bytes K6 reads (score, order, off box, box, class) and a
# row's it writes
K6_BYTES_IN, K6_BYTES_OUT = 4 + 8 + 16 + 16 + 4, 6 * 4
# std gain of the random conv kernels below the heads. At 1.0 (and still at
# 1.4) w6's signal dies out on its way through ~100 SiLU layers and every
# frame gets the same boxes, so every camera would hand the tracker one and
# the same problem; from 1.8 on every score saturates at 1.0. At 1.6 the
# boxes follow the image.
DETECTOR_GAIN = 1.6
SQUARE_PHASES = 5             # ops/assignment.DEFAULT_PHASES, the tracker's
# the eps schedule of the tracker's solver (ops/assignment.solve_assignment,
# K4), at which K2 is held as well
K2_STEEP = dict(n_phases=2, phase_factor=4.0 ** 2.5)
# weight K4 may leave against scipy's optimum on the twelve dense host
# cases (tests/test_torch_auction.py holds its plain version to the same)
K4_HOST_GAP = 6e-3
# the two private-dummy kernels: (the name in ops/auction.py's functions,
# how chip_smoke names it)
PRIVATE_DUMMY = {"k4": ("twin", "K4"), "k2": ("auction", "K2")}
# weight a K1 solve of the seeded (128, 300) problems may leave against
# scipy's optimum: twice the most measured there (0.025)
SCIPY_GAP_LIMIT = 0.05
N_STREAMS = 8
SERVE_TICKS = (16, 8)         # first call, resumed call
# phase 6: (name, TrackerConfig fields, PipelineConfig fields, K4 solves a
# frame); deepsort's cascade solves all of its max_time_lost (30) levels in
# one launch of K4's cascade entry (CASCADES_PER_FRAME), its stages 2 and 3
# are the 2 K4.
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
    ("deepsort", dict(tracker="deepsort"), dict(reid="deepsort_cnn"), 2),
    ("strongsort", dict(tracker="strongsort"),
     dict(reid="osnet_x1_0", reid_capacity=0, gmc_method="ecc"), 3),
    ("bytetrack_osnet", dict(tracker="bytetrack", feature_dim=512),
     dict(reid="osnet_x1_0"), 2),
    # deepmot at its registered capacities (128 x 48): the DHN on the
    # compacted 128 x 48 cost, then K4 for stage 1 and for stages 2+3
    ("deepmot_gru_h32", dict(tracker="deepmot", det_capacity=48,
                             dhn_weights=DHN_GRU, dhn_hidden=32), {}, 2),
    ("deepmot_sinkhorn", dict(tracker="deepmot", det_capacity=48,
                              dhn_weights=DHN_SINKHORN, dhn_arch="sinkhorn"),
     {}, 2),
)
CASCADES_PER_FRAME = {"deepsort": 1}
# phase 6: the trackers also timed with K2 and K4 as the solver in turns,
# as phase 3 is, each turn on the first TURN_FRAMES frames of the run
# (deepsort's cascade does not go through the solver: its one launch is
# timed against the per-level K4 loop instead, cascade_forms)
K2_BEFORE = ("strongsort",)
TURN_FRAMES = 8
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
# phase 9: (zoo name, head spread, head boost). Through a seeded deep
# body the image's signal dies out below some conv gain and blows up above
# it; for yolov7, yolov5l and yolov4-csp no gain sits between (the scores
# are the same in every cell, or chaotic). So the BN statistics are set
# from phase 3's first 8 frames, each layer's output scaled to
# ZOO_BN_SCALE (calibrate_detector_bn), and each head output channel is
# standardised over the same frames to std `spread` around its prior +
# `boost` (standardize_heads). The pairs keep NMS well below max_det on
# every frame; DetectV8 runs a smaller spread, as its scores are held to
# ZOO_REL_TOL absolutely.
ZOO_RUNS = (
    ("yolov7", 14.0, -34.0),
    ("yolov7-e6e", 14.0, -35.0),
    ("yolov5l", 14.0, -34.0),
    ("yolov8l", 10.0, -32.0),
    ("yolov4-csp", 14.0, -34.0),
    ("yolov3-spp", 14.0, -34.0),
)
ZOO_BN_SCALE = 0.15
ZOO_IMG = 1280                # cli/track.py's default --img_size
# NMS survivors on every frame of the run: below max_det (300), so that
# no frame's NMS sits at its cap
ZOO_SURVIVORS = (10, 280)
# detector card vs CPU and fused vs unfused, float32 with TF32 off: the
# worst over the output's parts (output_parts) of max |difference| over
# max(1, max |part|). The same forward in bf16 must land above it.
ZOO_REL_TOL = 1e-4


def log(msg):
    keep(f"[chip_smoke] {msg}")


def keep(line):
    """Print a line of the run's output and append it to OUT_DIR/
    chip_smoke.log, so the whole output is kept where only its end is
    shown."""
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as f:
        f.write(line + "\n")


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
# phase 2: the K4 and K2 kernels against their plain versions
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


def kernel_both(auction, kernel, cost, rm, cm, th, dev, **kw):
    """K2 or K4 (``kernel`` "k2" / "k4") and its plain version on one problem
    or batch on the card: the max |difference| over r2c, c2r and every
    problem's sweep count (0 means bit-identical), the kernel's r2c and its
    sweeps per problem."""
    import torch

    fn = PRIVATE_DUMMY[kernel][0]
    kw = {**K2_STEEP, **kw}
    b = rm.shape[0] if rm.dim() == 2 else 1
    ks = torch.zeros(b, dtype=torch.int32, device=dev)
    ps = torch.zeros(b, dtype=torch.int32, device=dev)
    kr, kc = getattr(auction, f"masked_assignment_{fn}_cuda")(
        cost, rm, cm, th, sweeps=ks, **kw)
    pr, pc = getattr(auction, f"masked_assignment_{fn}_torch")(
        cost, rm, cm, th, sweeps=ps, **kw)
    torch.cuda.synchronize()
    worst = max(int((kr.long() - pr.long()).abs().max()),
                int((kc.long() - pc.long()).abs().max()),
                int((ks - ps).abs().max()))
    return worst, kr, ks.tolist()


def compare(auction, problems, dev):
    """K4 and K2, each against its plain version, on each (cost, rm, cm,
    thresh) at the tracker's schedule; returns the max |difference| over
    r2c, c2r and the sweep counts of both (0 means bit-identical)."""
    return max(kernel_both(auction, kernel, cost.to(dev), rm.to(dev),
                           cm.to(dev), th.to(dev) if hasattr(th, "to")
                           else th, dev)[0]
               for cost, rm, cm, th in problems for kernel in PRIVATE_DUMMY)


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
    log(f"32 single problems (128, 300), K4 and K2: max |kernel - plain| "
        f"(r2c, c2r, sweeps) = {worst} ({time.time() - t0:.1f} s)")
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
        for kernel, (_, label) in PRIVATE_DUMMY.items():
            d, r2c, sw = kernel_both(auction, kernel, cost, rm, cm, th, dev,
                                     **extra)
            worst = max(worst, d)
            log(f"{label} stress, {name}: max |kernel - plain| (r2c, c2r, "
                f"sweeps) = {d}; sweeps "
                f"{sw if len(sw) <= 8 else (min(sw), max(sw))}, "
                f"pairs {int((r2c >= 0).sum())}")
    log(f"K4 and K2 stress problems: {time.time() - t0:.1f} s")
    if worst != 0:
        raise AssertionError(f"kernel differs from its plain version: {worst}")

    for kernel, (fn, label) in PRIVATE_DUMMY.items():
        for cost, rm, cm, th in problems[:16:2]:
            r2c, _ = getattr(auction, f"masked_assignment_{fn}_cuda")(
                cost.to(dev), rm.to(dev), cm.to(dev), th.to(dev), **K2_STEEP)
            got, want, gap = scipy_pairs(cost.numpy(), rm.numpy(),
                                         cm.numpy(), float(th), r2c)
            if got != want or abs(gap) > 1e-3:
                raise AssertionError(
                    f"{label} vs scipy: {len(got)} vs {len(want)} pairs, "
                    f"weight left {gap}")
        log(f"8 association problems: {label} == scipy (same pairs, "
            "weight 1e-3)")
    gaps = []
    for k in range(12):
        cost, rm, cm, th = dense_host_case(k)
        r2c, _ = auction.masked_assignment_twin_cuda(
            *(torch.from_numpy(x).to(dev) for x in (cost, rm, cm)), th,
            **K2_STEEP)
        got, want, gap = scipy_pairs(cost, rm, cm, th, r2c)
        gaps.append(gap)
        if len(got) != len(want) or gap > K4_HOST_GAP:
            raise AssertionError(
                f"K4 vs scipy on dense host case {k}: {len(got)} vs "
                f"{len(want)} pairs, weight left {gap}")
    log(f"12 dense host cases: K4 within {max(gaps):.2e} of scipy (limit "
        f"{K4_HOST_GAP})")

    # the three ways the kernels hold the weights, timed on seeded problems
    log(f"K4 and K2 on seeded problems, on {card_line()}")
    for name, (n, m, kind) in {
            "staged, 16-byte loads": (128, 300, "assoc"),
            "read through L2": (256, 300, "assoc"),
            "staged, scalar loads": (127, 301, "dense")}.items():
        cost, rm, cm = (torch.from_numpy(x).to(dev)
                        for x in seeded_problem(rng, n, m, kind))
        for kernel, (fn, label) in PRIVATE_DUMMY.items():
            sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
            getattr(auction, f"masked_assignment_{fn}_cuda")(
                cost, rm, cm, 0.9, sweeps=sweeps, **K2_STEEP)
            ms = graph_ms(getattr(auction, f"prepared_{fn}")(
                cost, rm, cm, 0.9, **K2_STEEP))
            log(f"{label} ({n}, {m}) {kind}, weights {name}: kernel "
                f"{ms:.4f} ms, {int(sweeps)} sweeps, "
                f"{ms * 1e3 / int(sweeps):.3f} us/sweep")
    return max(worst, cascade_stress(auction, rng, dev))


def k4_batch_timings(dev):
    """K4 at B = 2 and B = 16, the sizes of the stages 2+3 launches of an
    offline frame and of a serving tick, on seeded association problems
    of the tracker's shape (128, 300) that have rows (the paths' own
    stages 2+3 problems have none where stage 1 matched every track), at
    the stages' thresholds 0.5 and 0.7 in turn. Returns {"b2": record,
    "b16": record} as time_kernel gives them."""
    import torch

    from yolov7_tracker_tpu_torch.ops import auction

    rng = np.random.default_rng(14)
    out = {}
    for b in (2, 16):
        cost, rm, cm = (torch.from_numpy(np.stack(x)) for x in zip(
            *(seeded_problem(rng) for _ in range(b))))
        t = time_kernel(auction, (cost, rm, cm,
                                  torch.tensor([0.5, 0.7] * (b // 2))), dev)
        log(f"K4 seeded B={b} (128, 300) assoc with {int(rm.sum())} rows "
            f"on {card_line()}: kernel {t['ms']:.4f} ms, sweeps "
            f"{t['sweeps']}, {t['us_per_sweep']:.3f} us/sweep of the "
            f"slowest, through the wrapper {t['wrapper_ms']:.4f} ms a call, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
        out[f"b{b}"] = t
    return out


def scipy_pairs(cost, rm, cm, thresh, r2c):
    """(pairs of r2c, scipy's pairs, weight r2c leaves against scipy's
    optimum) of one problem in numpy."""
    from yolov7_tracker_tpu_torch.ops.assignment import linear_assignment_host

    r2c = np.asarray(r2c.cpu() if hasattr(r2c, "cpu") else r2c)
    big = np.where(rm[:, None] & cm[None, :], cost, 1e9)
    m0, _, _ = linear_assignment_host(big, thresh)
    got = {(i, int(j)) for i, j in enumerate(r2c) if j >= 0}
    want = {(int(a), int(b)) for a, b in m0}
    gap = (sum(thresh - float(cost[i, j]) for i, j in want)
           - sum(thresh - float(cost[i, j]) for i, j in got))
    return got, want, gap


def time_kernel(auction, problem, dev, kernel="k4"):
    """K4 or K2 (``kernel``): kernel ms (launches that follow each other in
    a CUDA graph, no host work between them), ms per call of the wrapper
    (which its host work bounds when the kernel is shorter), plain ms,
    per-problem sweeps, us per sweep of the slowest problem and the bound
    for one main-path problem (cost, rm, cm, thresh) on the card."""
    import torch

    fn = PRIVATE_DUMMY[kernel][0]
    cuda = getattr(auction, f"masked_assignment_{fn}_cuda")
    plain = getattr(auction, f"masked_assignment_{fn}_torch")
    cost, rm, cm, th = (t.to(dev) for t in problem)
    b = rm.shape[0] if rm.dim() == 2 else 1
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    cuda(cost, rm, cm, th, sweeps=sweeps, **K2_STEEP)
    k_ms = graph_ms(getattr(auction, f"prepared_{fn}")(cost, rm, cm, th,
                                                       **K2_STEEP))
    w_ms = cuda_ms(lambda: cuda(cost, rm, cm, th, **K2_STEEP), 50)
    p_ms = cuda_ms(lambda: plain(cost, rm, cm, th, **K2_STEEP), 3)
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


def k2_profile_line(auction, name, problem, dev, kernel="k2"):
    """Log where the cycles of a K2 or K4 (``kernel``) solve go, by the
    profiling build
    (clock64() sums on lane 0 of each warp): of a batch the problem with
    the most cycles, and of its warps the one with the most cycles outside
    the barriers (the block's warps meet at every barrier, so any warp's
    parts add up to the solve). Also times the profiling build against the
    timed one. Returns the cycles by part."""
    import torch

    fn = PRIVATE_DUMMY[kernel][0]
    prepared = getattr(auction, f"prepared_{fn}")
    cost, rm, cm, th = (t.to(dev) for t in problem)
    b = rm.shape[0] if rm.dim() == 2 else 1
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    *_, cycles = getattr(auction, "profile_twin" if kernel == "k4" else
                         "profile_auction")(cost, rm, cm, th, sweeps=sweeps,
                                            **K2_STEEP)
    prof_ms = graph_ms(prepared(cost, rm, cm, th,
                                profile=torch.zeros_like(cycles),
                                **K2_STEEP))
    timed_ms = graph_ms(prepared(cost, rm, cm, th, **K2_STEEP))
    parts = auction.profile_parts()
    timed = [k for k, part in enumerate(parts) if not part.endswith("count")]
    counts = [k for k, part in enumerate(parts) if part.endswith("count")]
    work = [k for k in timed if "barrier" not in parts[k]]
    slow = int(cycles[:, 0, timed].sum(dim=1).argmax())
    warp = int(cycles[slow][:, work].sum(dim=1).argmax())
    cyc = {parts[k]: int(cycles[slow, warp, k]) for k in timed}
    cyc.update({parts[k]: int(cycles[slow, :, k].sum()) for k in counts})
    total = max(sum(cyc[parts[k]] for k in timed), 1)
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
    """K4 and K2 on the problems the paths gave K4 last ({name: (cost, rm,
    cm, thresh)}): time, sweeps and bound of each, then K2's profiling
    build's shares. Returns {"k4": {name: record}, "k2": {name: record}}."""
    log(f"K4 and K2 timings on {card_line()}")
    out = {}
    for kernel, (_, label) in PRIVATE_DUMMY.items():
        out[kernel] = {}
        for name, problem in problems.items():
            t = time_kernel(auction, problem, dev, kernel)
            b = len(t["sweeps"])
            log(f"{label} {name} (B={b}, {tuple(problem[0].shape[-2:])}): "
                f"kernel {t['ms']:.4f} ms, sweeps {t['sweeps']}, "
                f"{t['us_per_sweep']:.3f} us/sweep"
                f"{' of the slowest' if b > 1 else ''}, through the wrapper "
                f"{t['wrapper_ms']:.4f} ms a call, plain "
                f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.6f} ms "
                f"({t['bound_by']})")
            out[kernel][name] = t
    for kernel, (_, label) in PRIVATE_DUMMY.items():
        for name, problem in problems.items():
            out[kernel][name]["profile_cycles"] = k2_profile_line(
                auction, f"{label} {name}", problem, dev, kernel)
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
    torch.cuda.synchronize()
    with graph_calls() as steps, counting() as counts:
        t0 = time.time()
        results, slab = pipe.run_sequence_stateful(iter(frames))
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches, k2_launches = counts["launches.k4"], counts["launches.k2"]
    del pipe.detect_batch
    # the auction problems: each frame's step run again eagerly on the
    # inputs its graph had (the step's values are the graph's, bit for
    # bit), its solver recorded
    bytetrack.solve_assignment = recording_solve
    try:
        rerun_eagerly(steps)
    finally:
        bytetrack.solve_assignment = solve

    n = len(frames)
    if launches != 2 * n or k2_launches != 0 or len(steps) != n:
        raise AssertionError(f"{launches} K4 and {k2_launches} K2 launches "
                             f"and {len(steps)} graphed steps for {n} "
                             "frames")
    nms_through_k6(counts, "main path", -(-n // pipe.pcfg.detector_batch))
    launch_witness("main path", lambda: pipe.run_sequence_stateful(
        iter(frames[:TURN_FRAMES])))
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
        f"{wall / n * 1e3:.2f} ms/frame; {launches} K4 launches; NMS "
        f"survivors/frame {counts.float().mean():.1f}; tracks/frame "
        f"min {min(tracks)} mean {np.mean(tracks):.1f} max {max(tracks)}; "
        f"{rows} MOT rows -> {path}")

    breakdown(pipe, f1, dets[-1], dev)
    turns = solver_turns(lambda: pipe.run_sequence_stateful(
        iter(frames[:TURN_FRAMES])), TURN_FRAMES, pipe.step)
    log(f"the same run in turns K2 (before K4), K4, K4, K2: ms/frame K2 "
        f"{turns['k2']}, K4 {turns['k4']}")

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
    return launches, k2_launches, solves, {"k4_ms_per_frame": wall / n * 1e3,
                                           "solver_turns": turns}


@contextlib.contextmanager
def k2_as_solver():
    """ops/assignment.solve_assignment solves by K2 (the form the port ran
    before K4) while the block runs: for timing the paths before and after
    the switch in one call."""
    from yolov7_tracker_tpu_torch.ops import assignment, auction

    twin = assignment.masked_assignment_twin

    def k2(cost, rm, cm, th, **kw):
        return auction.masked_assignment_auction(cost, rm, cm, th, **kw)

    assignment.masked_assignment_twin = k2
    try:
        yield
    finally:
        assignment.masked_assignment_twin = twin


def solver_turns(run, n_frames, step):
    """ms a frame of ``run()`` (n_frames frames) with K2 and with K4 as the
    solver, in turns K2, K4, K4, K2 (both kernels launched before, in
    phase 2); host wall time around each synchronized run. The tracker
    step ``run`` calls (``step``) is captured anew in each turn, with
    that turn's solver in its graphs, by an untimed ``run()`` first, and
    its graphs are dropped after the last. Returns {"k2": [ms, ms], "k4":
    [ms, ms]}."""
    import torch

    out = {"k2": [], "k4": []}
    for kernel in ("k2", "k4", "k4", "k2"):
        with (k2_as_solver() if kernel == "k2"
              else contextlib.nullcontext()):
            drop_graphs(step)
            run()
            torch.cuda.synchronize()
            t0 = time.time()
            run()
            torch.cuda.synchronize()
        out[kernel].append((time.time() - t0) / n_frames * 1e3)
    drop_graphs(step)
    return out


def breakdown(pipe, frames_u8, batch_dets, dev):
    """Where one batch of 8 frames spends its time, each stage timed
    alone with CUDA events (the NMS and tracker stages include their host
    syncs and launch gaps)."""
    import torch

    from yolov7_tracker_tpu_torch.data import letterbox

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
        t_nms = cuda_ms(lambda: pipe.nms(raw), 2)
    boxes, score, cls, counts = batch_dets
    slabs = [pipe.dets_to_slab(boxes[b], score[b], cls[b], counts[b])
             for b in range(boxes.shape[0])]
    t_track = cuda_ms(lambda: pipe.track_frames(pipe.init_tracker(), slabs),
                      2)
    b = frames.shape[0]
    log(f"per-frame breakdown on {card_line()} (batch {b}): "
        f"H2D {t_h2d / b:.2f} ms, "
        f"letterbox {t_pre / b:.2f} ms, {pipe.spec.name} forward "
        f"{t_model / b:.2f} ms, NMS {t_nms / b:.2f} ms, ByteTrack step "
        f"{t_track / b:.2f} ms")
    return {"h2d_ms": t_h2d / b, "letterbox_ms": t_pre / b,
            "detector_ms": t_model / b, "nms_ms": t_nms / b,
            "step_ms": t_track / b}


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
    stage-1 solves; returns (K3 launches, K4 launches, last stage-1
    problem, last stage-2/3 problem)."""
    import torch

    from yolov7_tracker_tpu_torch import pipeline as pipeline_mod
    from yolov7_tracker_tpu_torch.cli import serve
    from yolov7_tracker_tpu_torch.ops import auction_square as square
    from yolov7_tracker_tpu_torch.trackers import bytetrack, registry

    total = sum(SERVE_TICKS)
    streams = [f"synth://{total}x1080x1920?seed={k + 1}&shift=8"
               for k in range(N_STREAMS)]
    last = {}                   # the newest problem handed to each solver
    stamps = []                 # (start, end) of every tick, synchronized
    solve1, solve23 = registry.masked_assignment, \
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
    registry.masked_assignment = recording("stage1", solve1)
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
                with counting() as got:
                    results, preempted = serve.main(argv)
                    torch.cuda.synchronize()
                counts.append((got["launches.k3"], got["launches.k4"],
                               got["launches.k1"]))
                nms_through_k6(got, f"serve, {ticks} ticks")
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
        registry.masked_assignment = solve1
        bytetrack.solve_assignment = solve23
        pipeline_mod.TrackingPipeline.process_multistream = tick_fn

    for (k3, k4, k1), ticks in zip(counts, SERVE_TICKS):
        if (k3, k4, k1) != (ticks, ticks, 0):
            raise AssertionError(
                f"serve: {k3} K3, {k4} K4, {k1} K1 launches in {ticks} ticks")
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
        f"call (K3, K4, K1) {counts}; process_multistream "
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
        t_nms = cuda_ms(lambda: pipe.nms(raw), 2)
    dets = pipe.dets_to_slab(*pipe.detect_batch(frames_u8))
    t_step = cuda_ms(lambda: pipe.step(stacked, dets,
                                       solve_stage1=masked_assignment), 3)
    t_one = cuda_ms(lambda: pipe.step(
        slabs[0], S.DetSlab(*(x[0] for x in dets))), 3)
    c1, r1, m1, th1 = last["stage1"]
    c2, r2, m2, th2 = last["stage23"]
    t_k3 = cuda_ms(lambda: square.masked_assignment_square_cuda(
        c1, r1, m1, th1, n_phases=SQUARE_PHASES), 10)
    t_k2 = graph_ms(auction.prepared_twin(c2.contiguous(), r2, m2, th2,
                                          **K2_STEEP))
    n = frames.shape[0]
    log(f"per-tick breakdown on {card_line()} ({n} streams): stack frames "
        f"on the host {t_stack:.2f} ms, H2D {t_h2d:.2f} ms, letterbox "
        f"{t_pre:.2f} ms, w6 forward {t_model:.2f} ms, NMS {t_nms:.2f} ms, "
        f"stacked ByteTrack step {t_step:.2f} ms (of which K3 B={n} "
        f"{t_k3:.4f} ms and K4 B={2 * n} {t_k2:.4f} ms); the same step on "
        f"one stream alone (K4 for every stage) {t_one:.2f} ms, so "
        f"{t_step / n:.2f} against {t_one:.2f} ms of tracker per frame")


# ---------------------------------------------------------------------------
# phase 5: step_frame, the one-stream streaming mode
# ---------------------------------------------------------------------------

def step_frame_phase(pipe, dev):
    """8 frames of one camera through step_frame (K1 once per frame) and
    through a one-stream process_multistream (K3, B = 1): the same slab.
    Returns (K1 launches, the last stage-1 problem)."""
    import torch

    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
    from yolov7_tracker_tpu_torch.ops import auction_square as square
    from yolov7_tracker_tpu_torch.trackers import registry

    frames = list(SynthFrames("synth://8x1080x1920?seed=11&shift=8"))
    last = {}
    solve1 = registry.masked_assignment

    def recording(cost, rm, cm, th, *args, **kw):
        last["stage1"] = (cost.float().clone(), rm.clone(), cm.clone(), th)
        return solve1(cost, rm, cm, th, *args, **kw)

    registry.masked_assignment = recording
    try:
        slab = pipe.init_tracker()
        per_frame = []
        with counting() as got:
            for f in frames:
                torch.cuda.synchronize()
                t0 = time.time()
                slab, out = pipe.step_frame(slab, f)
                torch.cuda.synchronize()
                per_frame.append((time.time() - t0) * 1e3)
        k1, k3 = got["launches.k1"], got["launches.k3"]
    finally:
        registry.masked_assignment = solve1
    if (k1, k3) != (len(frames), 0):
        raise AssertionError(f"step_frame: {k1} K1 and {k3} K3 launches for "
                             f"{len(frames)} frames")
    nms_through_k6(got, "step_frame", len(frames))
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
    pipe.fold_reid()                 # K5 reads the folded statistics


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


def dhn_inputs(calls):
    """deepmot's DHN input and output (the compacted cost and its scores,
    clones on the card, no sync) in each kept graph call (graph_calls):
    the call run again eagerly with a DHN that keeps them. Returns the
    list, a pair a call (None where the steps have no DHN)."""
    kept = []
    for g, args in calls:
        dhn = g.kwargs.get("dhn")
        if dhn is None:
            return None

        def record(comp, dhn=dhn):
            out = dhn(comp)
            kept.append((comp.clone(), out.clone()))
            return out

        rerun_eagerly([(g, args)], dhn=record)
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
    gave its DHN (``kept``, dhn_inputs) through dhn_scores_check. 1 - DHN
    is a dense cost, on which a score difference of 1e-7 can move K4's
    matching: the frames where the compacted stage-1 problem pairs
    otherwise on the CPU's scores than on the card's (K4's plain version,
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
    """Step the tracker on the CPU (K4's plain version) through the
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
    batch); check its K4 launches and its CPU replay. Returns (record,
    pipe, the detections the step got, the results)."""
    import torch

    from yolov7_tracker_tpu_torch.trackers import slab as S

    pipe = tracker_pipeline(sd, dev, tracker_kw, pipe_kw)
    if pipe.reid_model is not None:
        calibrate_reid(pipe, frames[0])
    pipe.run_sequence(iter(frames[:8]))        # warm-up, not counted
    if pipe.gmc is not None:
        pipe.gmc.set_state({})                 # start as a new sequence
    dets, slabs = [], []
    step = pipe.step

    def recording_step(slab, det, **kw):
        dets.append(S.DetSlab(*(x.clone() for x in det)))  # no host sync
        slabs.append(S.TrackSlab(*(x.clone() for x in slab)))
        return no_sync_step(step, slab, det, **kw)

    pipe.step = recording_step
    torch.cuda.synchronize()
    with graph_calls() as calls, counting() as got:
        t0 = time.time()
        results, slab = pipe.run_sequence_stateful(iter(frames))
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches, cascades = got["launches.k4"], got["launches.k4_cascade"]
    pipe.step = step
    # deepmot: each frame's DHN inputs and scores, its step run again
    # eagerly on the inputs its graph had
    dhn_kept = dhn_inputs(calls)
    n = len(frames)
    per_cascade = CASCADES_PER_FRAME.get(name, 0)
    # the DeepSORT CNN is K5, one forward a frame; OSNet is no kernel
    per_k5 = K5_LAUNCHES if pipe.pcfg.reid == "deepsort_cnn" else 0
    if (launches != per_frame * n or got["launches.k2"] != 0
            or cascades != per_cascade * n
            or got["launches.k5"] != per_k5 * n):
        raise AssertionError(f"{name}: {launches} K4, {cascades} cascade, "
                             f"{got['launches.k5']} K5 and "
                             f"{got['launches.k2']} K2 launches in {n} "
                             f"frames, expected {per_frame} K4, "
                             f"{per_cascade} cascade and {per_k5} K5 a "
                             "frame")
    nms_through_k6(got, name, -(-n // pipe.pcfg.detector_batch))
    tracks = [len(ids) for _, ids, _, _ in results]
    if len(results) != n or max(tracks) < 1 or int(slab.frame) != n:
        raise AssertionError(f"{name}: tracks per frame {tracks}")
    if len(calls) != n:
        raise AssertionError(f"{name}: {len(calls)} graphed steps in {n} "
                             "frames")
    if not all(bool(torch.isfinite(d.feature).all()) for d in dets):
        raise AssertionError(f"{name}: non-finite ReID features")

    def run():
        if pipe.gmc is not None:
            pipe.gmc.set_state({})
        pipe.run_sequence_stateful(iter(frames[:TURN_FRAMES]))

    launch_witness(name, run)
    t0 = time.time()
    dhn_report = replay_on_cpu(pipe, dets, slabs, results, name, dhn_kept)
    replay_s = time.time() - t0
    if pipe.gmc is not None:
        without_gmc(pipe, dets)
    turns = None
    if name in K2_BEFORE:
        turns = solver_turns(run, TURN_FRAMES, pipe.step)
        log(f"{name} in turns K2 (before K4), K4, K4, K2: ms/frame K2 "
            f"{turns['k2']}, K4 {turns['k4']}")
    warps = torch.stack([d.warp.to(dev) for d in dets])
    rec = {"ms_per_frame": wall / n * 1e3, "solver_turns": turns,
           "k4_launches": launches, "cascade_launches": cascades,
           "k5_launches": got["launches.k5"],
           "k4_per_frame": per_frame, "tracks_per_frame_mean":
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
        f"frames, {launches} K4 launches ({per_frame} a frame), {cascades} "
        f"of K4's cascade entry, tracks/frame "
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
    capture its inputs (kept in OUT_DIR/cascade_problems.pt for
    --k2-only): K4's cascade entry held against its plain version on them
    and timed (cascade_check), and a deepsort step of the last frame on
    the card profiled (its launches a step)."""
    import torch

    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.trackers import appearance
    from yolov7_tracker_tpu_torch.trackers import slab as S

    cascades = []
    cascade = appearance.matching_cascade

    def capture_cascade(cost, slab, rm, cm, th, depth, **kw):
        cascades.append((cost.clone(), rm.clone(), cm.clone(),
                         slab.time_since_update.clone(), th, depth))
        return cascade(cost, slab, rm, cm, th, depth, **kw)

    slab = S.init_slab(pipe.tcfg, "cpu")
    for d in dets[:-1]:
        slab, _ = pipe.step(slab, S.DetSlab(*(x.cpu() for x in d)))
    appearance.matching_cascade = capture_cascade
    try:
        pipe.step(slab, S.DetSlab(*(x.cpu() for x in dets[-1])))
    finally:
        appearance.matching_cascade = cascade
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.save({"cascade": cascades[-1]},
               os.path.join(OUT_DIR, "cascade_problems.pt"))
    rec = cascade_check(auction, cascades[-1], dev)
    _, rm, _, tsu, _, depth = cascades[-1]
    rows = [int((rm & (tsu == 1 + lvl)).sum()) for lvl in range(depth)]
    card_slab = S.init_slab(pipe.tcfg, dev)
    for d in dets[:-1]:
        card_slab, _ = pipe.step(card_slab, d)
    log("deepsort step of the last frame on the card:")
    step_ops = profile_ops(lambda: pipe.step(card_slab, dets[-1]))
    rec.update({"rows_per_level": rows, "step_profile": step_ops})
    log(f"deepsort cascade on {card_line()}: {depth} levels, rows {rows}; "
        f"launches a step {step_ops.get('launches')}")
    return rec


def cascade_check(auction, cascade, dev, name="deepsort's last frame"):
    """K4's cascade entry against its plain version on one captured cascade
    (cost, row_mask, col_mask, time_since_update, thresh, depth): max
    |difference| over r2c, c2r and each level's sweeps (raises unless 0),
    then the kernel's ms from a CUDA graph, ms a call through
    solve_cascade, the plain version's ms and the bound. Returns a
    record."""
    from yolov7_tracker_tpu_torch.ops import assignment

    cost, rm, cm, tsu, th, depth = to_card(cascade, dev)
    cost = cost.float().contiguous()
    d, r2c, sweeps = cascade_both(auction, cost, rm, cm, tsu, th, depth, dev)
    if d != 0:
        raise AssertionError(f"K4's cascade entry differs from its plain "
                             f"version on {name}: {d}")
    ms = graph_ms(auction.prepared_twin_cascade(cost, rm, cm, tsu, th, depth,
                                                **K2_STEEP))
    wrapper_ms = cuda_ms(lambda: assignment.solve_cascade(
        cost, rm, cm, tsu, th, depth), 20)
    plain_ms = cuda_ms(
        lambda: assignment.masked_assignment_twin_cascade_torch(
            cost, rm, cm, tsu, th, depth, **K2_STEEP), 1)
    n, m = cost.shape[-2:]
    b = rm.shape[0] if rm.dim() == 2 else 1
    # the cost, masks, ages and thresholds read once, r2c, c2r and the
    # sweeps written once; the operations of level 0 (as time_kernel
    # counts them: every row a pass over its m + n columns a sweep)
    nbytes = (cost.numel() * 4 + b * (n + m) + b * n * 4 + b * 4
              + b * (n + m) * 4 + b * depth * 4)
    ops = int(sweeps[:, 0].sum()) * n * (m + n) * 2 if depth else 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    rec = {"max_abs_err": float(d), "ms": ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "sweeps_per_level": sweeps.tolist(),
           "pairs": int((r2c >= 0).sum())}
    log(f"K4's cascade entry on {name} ({tuple(cost.shape)}, {depth} "
        f"levels): == plain (r2c, c2r, sweeps per level); {ms:.4f} ms from a "
        f"CUDA graph, {wrapper_ms:.4f} ms through solve_cascade, plain "
        f"{plain_ms:.2f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']}); sweeps by level {sweeps.tolist()}")
    return rec


def cascade_both(auction, cost, rm, cm, tsu, th, depth, dev, **kw):
    """K4's cascade entry and its plain version on one cascade or a batch
    of them on the card: the max |difference| over r2c, c2r and every
    level's sweeps (0 means bit-identical), the kernel's r2c and its sweeps
    (B, depth)."""
    import torch

    from yolov7_tracker_tpu_torch.ops import assignment

    kw = {**K2_STEEP, **kw}
    b = rm.shape[0] if rm.dim() == 2 else 1
    ks = torch.zeros((b, depth), dtype=torch.int32, device=dev)
    ps = torch.zeros((b, depth), dtype=torch.int32, device=dev)
    kr, kc = auction.masked_assignment_twin_cascade_cuda(
        cost, rm, cm, tsu, th, depth, sweeps=ks, **kw)
    pr, pc = assignment.masked_assignment_twin_cascade_torch(
        cost, rm, cm, tsu, th, depth, sweeps=ps, **kw)
    torch.cuda.synchronize()
    worst = max(int((kr.long() - pr.long()).abs().max()),
                int((kc.long() - pc.long()).abs().max()),
                int((ks - ps).abs().max()) if depth else 0)
    return worst, kr, ks


def cascade_problem(rng, n=128, m=300, depth=30, kind="deepsort"):
    """One seeded (cost, row_mask, col_mask, time_since_update) cascade,
    numpy (tests/test_torch_auction.py and tests/test_torch_cuda.py use it
    too). 'deepsort' is DeepSORT's gated appearance cost (the cosine
    distance of 128-d embeddings, tracks sharing a component, each det a
    track's embedding plus noise; above 0.15 set to 1e5), 'dense' U[0, 1]
    costs. Most tracks are at age 1 and the rest at even ages up to past
    the last level, so every odd level above 1 has no row."""
    if kind == "deepsort":
        def unit(x):
            return x / np.linalg.norm(x, axis=-1, keepdims=True)

        base = unit(rng.normal(size=128))
        tracks = unit(0.8 * base + unit(rng.normal(size=(n, 128))))
        dets = unit(tracks[rng.permutation(max(n, m))[:m] % n]
                    + rng.normal(0, 0.04, (m, 128)))
        cost = (1.0 - tracks @ dets.T).astype(np.float32)
        cost = np.where(cost > 0.15, np.float32(1e5), cost)
    else:
        cost = rng.random((n, m)).astype(np.float32)
    ages = np.where(rng.random(n) < 0.7, 1,
                    2 * rng.integers(1, depth // 2 + 2, n))
    return (cost, rng.random(n) < 0.85, rng.random(m) < 0.85,
            ages.astype(np.int32))


def cascade_stress(auction, rng, dev):
    """K4's cascade entry against its plain version on seeded cascades
    that stress it: DeepSORT-shaped (128, 300) over 30 levels, a level 0
    that takes every column, a batch with a threshold for each problem,
    the unstaged (256, 300) and scalar-staged (127, 301) ways of holding
    the weights, and no row at all. Returns the max |difference| (raises
    unless 0)."""
    import torch

    def on_card(*xs):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in xs)

    cases = []
    for k in range(4):
        cases.append((f"DeepSORT-shaped {k}", *on_card(*cascade_problem(
            rng, kind="deepsort")), 0.9, 30))
    cost, rm, cm, tsu = cascade_problem(rng, 128, 64, kind="dense")
    cost[:100] *= np.float32(0.01)
    tsu[:100], rm[:100], cm[:] = 1, True, True
    cases.append(("level 0 takes every column", *on_card(cost, rm, cm, tsu),
                  0.9, 30))
    probs = [cascade_problem(rng, kind="deepsort" if k % 2 else "dense")
             for k in range(4)]
    cases.append(("B = 4, a threshold each",
                  *on_card(*(np.stack(x) for x in zip(*probs))),
                  torch.tensor([0.5, 0.7, 0.8, 0.9]), 30))
    for n, m in ((256, 300), (127, 301)):
        cases.append((f"({n}, {m}) dense", *on_card(*cascade_problem(
            rng, n, m, 8, "dense")), 0.7, 8))
    cost, rm, cm, tsu = cascade_problem(rng)
    cases.append(("no row", *on_card(cost, np.zeros_like(rm), cm, tsu), 0.9,
                  30))
    worst = 0
    t0 = time.time()
    for name, cost, rm, cm, tsu, th, depth in cases:
        th = th.to(dev) if torch.is_tensor(th) else th
        d, r2c, sweeps = cascade_both(auction, cost, rm, cm, tsu, th, depth,
                                      dev)
        worst = max(worst, d)
        log(f"K4 cascade stress, {name}: max |kernel - plain| (r2c, c2r, "
            f"sweeps by level) = {d}; pairs {int((r2c >= 0).sum())}, sweeps "
            f"{int(sweeps.sum())} over {sweeps.numel()} levels")
    log(f"K4 cascade stress problems: {time.time() - t0:.1f} s")
    if worst != 0:
        raise AssertionError(f"K4's cascade entry differs from its plain "
                             f"version: {worst}")
    return worst


def cascade_forms(pipe, dets, results, dev):
    """deepsort's steps on the card, replayed from the run's detections
    with the cascade in one launch (the path) and as the per-level K4 loop
    (solve_stage1=solve_assignment), in turns one launch, loop, loop, one
    launch: the MOT txt of the two forms byte for byte, the one-launch
    replay's ids the run's, the launches of each form (2 K4 + 1 cascade
    against 32 K4 a frame) and ms a frame of each turn (host clock,
    synchronized; the tracker step alone). Returns a record."""
    import torch

    from yolov7_tracker_tpu_torch.data import writer
    from yolov7_tracker_tpu_torch.ops import assignment
    from yolov7_tracker_tpu_torch.trackers import slab as S

    forms = {"one_launch": {},
             "loop": {"solve_stage1": assignment.solve_assignment}}
    ms, text, launches = {k: [] for k in forms}, {}, {}
    for form in ("one_launch", "loop", "loop", "one_launch"):
        slab = S.init_slab(pipe.tcfg, dev)
        rows, outs = [], []
        torch.cuda.synchronize()
        with counting() as got:
            t0 = time.time()
            for det in dets:
                slab, out = pipe.step(slab, det, **forms[form])
                outs.append(out)
            torch.cuda.synchronize()
        ms[form].append((time.time() - t0) / len(dets) * 1e3)
        if form in text:
            continue
        launches[form] = (got["launches.k4"], got["launches.k4_cascade"])
        for k, out in enumerate(outs):
            v = out.valid.cpu().numpy()
            rows.append((k + 1, out.track_id.cpu().numpy()[v].tolist(),
                         list(out.tlwh.cpu().numpy()[v]),
                         out.cls.cpu().numpy()[v].astype(int).tolist()))
            if form == "one_launch" and rows[-1][1] != results[k][1]:
                raise AssertionError(f"deepsort replay on the card differs "
                                     f"from its run at frame {k}")
        path = writer.save_results(os.path.join(OUT_DIR, f"deepsort_{form}"),
                                   "synthetic", rows)
        with open(path, "rb") as f:
            text[form] = f.read()
    n = len(dets)
    if text["one_launch"] != text["loop"]:
        raise AssertionError("deepsort's MOT txt differs between the "
                             "one-launch cascade and the per-level K4 loop")
    if launches != {"one_launch": (2 * n, n), "loop": (32 * n, 0)}:
        raise AssertionError(f"deepsort replay launches (K4, cascade): "
                             f"{launches}")
    rec = {"mot_txt_equal": True, "mot_bytes": len(text["loop"]),
           "launches": {k: list(v) for k, v in launches.items()},
           "ms_per_frame": ms}
    log(f"deepsort replayed on {card_line()} from the run's {n} frames of "
        f"detections: MOT txt byte-equal ({len(text['loop'])} bytes) between "
        f"the one-launch cascade and the per-level K4 loop; launches (K4, "
        f"cascade) {launches}; tracker step ms a frame in turns one launch "
        f"{ms['one_launch']}, loop {ms['loop']}")
    return rec


def trackers_phase(sd, dev):
    """Phase 6, under PyTorch's default TF32 flags (main() turns TF32 off
    for the earlier phases). Returns the trackers JSON record, K4's
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
            rec["k5"] = k5_phase(dev)
            rec["cascade"] = cascade_timing(pipe, dets, dev)
            rec["cascade_forms"] = cascade_forms(pipe, dets, results, dev)
        out[name] = rec
        launches[name] = rec["k4_launches"]
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
def path_solves(k4_kept):
    """The problems the last tracker step of the block handed K1/K3 (the
    last one) and K4 (the last ``k4_kept``): the block's steps replay their
    graphs, and as the block closes the last one runs again eagerly on its
    inputs (graph_calls, rerun_eagerly), its solves kept as clones on the
    card. Yields {"square": [...], "k4": [...]}, filled as the block
    closes, each entry (cost, row_mask, col_mask, thresh, solver
    keywords)."""
    import torch

    from yolov7_tracker_tpu_torch.ops import assignment

    names = {"square": "masked_assignment_square",
             "k4": "masked_assignment_twin"}
    solvers = {k: getattr(assignment, v) for k, v in names.items()}
    kept = {"square": collections.deque(maxlen=1),
            "k4": collections.deque(maxlen=k4_kept)}

    def keeping(key):
        def solve(cost, rm, cm, th, **kw):
            kept[key].append((cost.clone(), rm.clone(), cm.clone(),
                              th.clone() if torch.is_tensor(th) else th, kw))
            return solvers[key](cost, rm, cm, th, **kw)
        return solve

    with graph_calls(1) as calls:
        yield kept
    for key, name in names.items():
        setattr(assignment, name, keeping(key))
    try:
        rerun_eagerly(calls)
    finally:
        for key, name in names.items():
            setattr(assignment, name, solvers[key])


def path_solves_check(kept, name, dev):
    """The problems path_solves kept, re-solved by the plain versions on the
    card: K1/K3 by square_check, K4 by kernel_both, and K2 against its own
    plain version on K4's problems. Raises unless each is bit for bit its
    kernel's; returns the max |difference| (0)."""
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.ops import auction_square as square

    if not kept["square"] or not kept["k4"]:
        raise AssertionError(f"{name}: no solve was kept")
    sq = max(square_check(square, c, rm, cm, th, dev, **kw)[0]
             for c, rm, cm, th, kw in kept["square"])
    k4 = max(kernel_both(auction, kernel, c, rm, cm, th, dev, **kw)[0]
             for c, rm, cm, th, kw in kept["k4"] for kernel in PRIVATE_DUMMY)
    shapes = [tuple(p[0].shape) for p in (*kept["square"], *kept["k4"])]
    log(f"{name}: the last stage-1 and stage-2/3 problems {shapes} "
        f"re-solved: max |K1/K3 - plain| (r2c, c2r, sweeps per phase, "
        f"cells) = {sq}, max |K4 - plain|, |K2 - plain| (r2c, c2r, sweeps) "
        f"= {k4}")
    if sq or k4:
        raise AssertionError(f"{name}: a kernel differs from its plain "
                             "version on the path's own problems")
    return max(sq, k4)


def serve_streams(total):
    return [f"synth://{total}x1080x1920?seed={k + 1}&shift=8"
            for k in range(N_STREAMS)]


def serving_reid_phase(sd, dev, reid_path):
    """strongsort with OSNet x1_0 through cli.serve.main on 8 cameras:
    16 ticks with state files, then 8 resumed from them, and one
    uninterrupted 24-tick run; the two runs' MOT files must be equal byte
    for byte. One K3 (stage 1) and two K4 launches (stages 2 and 3) a
    tick; the last tick's three problems re-solved by the plain versions.
    Returns (record, K3 launches, K4 launches)."""
    import torch

    from yolov7_tracker_tpu_torch import pipeline as pipeline_mod
    from yolov7_tracker_tpu_torch.cli import serve

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
        # kept: the last tick's solves (K3, then K4 for stages 2 and 3)
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
                with counting() as got:
                    results, preempted = serve.main(argv)
                    torch.cuda.synchronize()
                counts.append((got["launches.k3"], got["launches.k4"],
                               got["launches.k1"]))
                nms_through_k6(got, f"serve with ReID, {ticks} ticks")
                if preempted or [len(r) for r in results] != \
                        [ticks] * N_STREAMS:
                    raise AssertionError(
                        f"serve with ReID: {[len(r) for r in results]} "
                        f"frames per stream for {ticks} ticks")
            with np.load(os.path.join(state_dir, "stream_00.npz")) as z:
                feat = z["feature"][z["occupied"]]
    finally:
        pipeline_mod.TrackingPipeline.process_multistream = tick_fn

    for (k3, k4, k1), (ticks, _, _) in zip(counts, runs):
        if (k3, k4, k1) != (ticks, 2 * ticks, 0):
            raise AssertionError(f"serve with ReID: {k3} K3, {k4} K4, {k1} "
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
        f"byte for byte ({rows} MOT rows); launches per call (K3, K4, K1) "
        f"{counts}; process_multistream median {tick_ms:.2f} ms/tick = "
        f"{tick_ms / N_STREAMS:.2f} ms/frame")
    k3 = sum(c[0] for c in counts[:2])
    k4 = sum(c[1] for c in counts[:2])
    return rec, k3, k4


def step_frame_reid_phase(sd, dev, reid_path):
    """strongsort with OSNet x1_0 through step_frame, 8 frames of one
    camera: one K1 and two K4 launches a frame, the last frame's three
    problems re-solved by the plain versions. Returns (record, K1
    launches, K4 launches)."""
    import torch

    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
    from yolov7_tracker_tpu_torch.reid import resolve_reid

    name, reid_sd = resolve_reid("strongsort", reid_path)
    pipe = tracker_pipeline(sd, dev, dict(tracker="strongsort"),
                            dict(reid=name, reid_capacity=128),
                            reid_state_dict=reid_sd)
    frames = list(SynthFrames("synth://8x1080x1920?seed=11&shift=8"))
    pipe.step_frame(pipe.init_tracker(), frames[0])     # warm-up
    torch.cuda.synchronize()
    slab, per_frame = pipe.init_tracker(), []
    with path_solves(2) as kept, counting() as got:
        for f in frames:        # kept: the last frame's K1, K4, K4
            torch.cuda.synchronize()
            t0 = time.time()
            slab, out = pipe.step_frame(slab, f)
            torch.cuda.synchronize()
            per_frame.append((time.time() - t0) * 1e3)
    k1, k4, k3 = got["launches.k1"], got["launches.k4"], got["launches.k3"]
    n = len(frames)
    if (k1, k4, k3) != (n, 2 * n, 0):
        raise AssertionError(f"step_frame with ReID: {k1} K1, {k4} K4, {k3} "
                             f"K3 launches in {n} frames")
    nms_through_k6(got, "step_frame with ReID", n)
    if not int(out.valid.sum()) or not bool(slab.feature.abs().max() > 0):
        raise AssertionError("step_frame with ReID: no tracks or features")
    worst = path_solves_check(kept, "step_frame with ReID", dev)
    launch_witness("step_frame with ReID",
                   lambda: pipe.step_frame(slab, frames[0]))
    rec = {"ms_per_frame_median": float(np.median(per_frame)),
           "ms_per_frame": per_frame, "k1_launches": k1, "k4_launches": k4,
           "tracks_last_frame": int(out.valid.sum()),
           "last_frame_kernels_vs_plain_max_abs_diff": worst}
    log(f"step_frame with ReID on {card_line()}: strongsort + OSNet x1_0, "
        f"{n} frames, {k1} K1 and {k4} K4 launches, ms/frame "
        f"{[round(t, 2) for t in per_frame]}, median "
        f"{rec['ms_per_frame_median']:.2f}")
    return rec, k1, k4


def deepmot_streams_phase(sd, dev):
    """deepmot with the trained GRU h32 DHN through process_multistream on
    the 8 serving cameras for 8 ticks: the DHN batched over the streams,
    stage 1 by K3, stages 2+3 by one K4 launch. The last tick's two
    problems are re-solved by the plain versions and its DHN run again on
    the CPU on the same compacted costs. Returns (record, K3
    launches, K4 launches)."""
    import copy

    import torch

    from yolov7_tracker_tpu_torch.data.sequence import SynthFrames

    pipe = tracker_pipeline(sd, dev, dict(
        tracker="deepmot", det_capacity=48, dhn_weights=DHN_GRU,
        dhn_hidden=32), {})
    ticks = 8
    cams = [list(SynthFrames(s)) for s in serve_streams(ticks)]
    frames = [np.stack(f) for f in zip(*cams)]
    pipe.process_multistream(pipe.init_multistream(N_STREAMS), frames[0])
    torch.cuda.synchronize()
    cpu_dhn = copy.deepcopy(pipe.step.keywords["dhn"]).cpu()
    slabs, per_tick, tracks = pipe.init_multistream(N_STREAMS), [], []
    # kept: the last tick's K3 and K4, and its step's inputs
    with graph_calls(1) as calls, path_solves(1) as kept, \
            counting() as got:
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.time()
            slabs, outs = pipe.process_multistream(slabs, f)
            torch.cuda.synchronize()
            per_tick.append((time.time() - t0) * 1e3)
            tracks.append(outs.valid.sum(dim=1).tolist())
            if not bool(torch.isfinite(outs.tlwh[outs.valid]).all()):
                raise AssertionError(f"deepmot at S = {N_STREAMS}: boxes")
    k3, k4, k1 = got["launches.k3"], got["launches.k4"], got["launches.k1"]
    if (k3, k4, k1) != (ticks, ticks, 0):
        raise AssertionError(f"deepmot at S = {N_STREAMS}: {k3} K3, {k4} K4, "
                             f"{k1} K1 launches in {ticks} ticks")
    nms_through_k6(got, f"deepmot at S = {N_STREAMS}", ticks)
    if min(map(sum, zip(*tracks))) < 1:        # every stream tracked
        raise AssertionError(f"deepmot at S = {N_STREAMS}: tracks {tracks}")
    worst = path_solves_check(kept, f"deepmot at S = {N_STREAMS}", dev)
    launch_witness(f"deepmot at S = {N_STREAMS}", lambda: [
        pipe.process_multistream(slabs, f) for f in frames[:2]])
    # the batched DHN on the last tick's S compacted costs, card vs CPU:
    # the last tick's step run again eagerly with a DHN that keeps them
    dhn_kept = dhn_inputs(calls)
    diff, _ = dhn_scores_check(cpu_dhn, *dhn_kept[-1])
    log(f"deepmot at S = {N_STREAMS}: the DHN on the last tick's "
        f"{tuple(dhn_kept[-1][0].shape)} compacted costs, card vs CPU: max "
        f"|score difference| {diff:.2e} (tolerance {DHN_SCORE_TOL})")
    rec = {"ms_per_tick_median": float(np.median(per_tick[1:])),
           "ms_per_tick": per_tick, "k3_launches": k3, "k4_launches": k4,
           "tracks_per_tick": tracks, "dhn": "gru h32",
           "last_tick_kernels_vs_plain_max_abs_diff": worst,
           "last_tick_dhn_card_vs_cpu_max_abs_diff": diff}
    log(f"deepmot (GRU h32) at S = {N_STREAMS} on {card_line()}: {ticks} "
        f"ticks, {k3} K3 and {k4} K4 launches, ms/tick "
        f"{[round(t, 2) for t in per_tick]}, median of ticks 2.. "
        f"{rec['ms_per_tick_median']:.2f}; tracks a tick by stream {tracks}")
    return rec, k3, k4


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
def graph_calls(n=None):
    """Keep the last ``n`` (None: every) calls that the tracker steps'
    CUDA graphs (trackers/graphed.py) replay while the block runs, each
    the graph and the inputs it was handed (the caller's own tensors,
    which no later replay overwrites). Yields the deque they go to. A
    graph runs its step's Python only when it is captured: what the step
    hands its solvers or its DHN in a kept call is seen by running the
    call again eagerly (rerun_eagerly)."""
    from yolov7_tracker_tpu_torch.trackers import graphed

    call = graphed._Graph.__call__
    calls = collections.deque(maxlen=n)

    def keeping(g, args):
        calls.append((g, args))
        return call(g, args)

    graphed._Graph.__call__ = keeping
    try:
        yield calls
    finally:
        graphed._Graph.__call__ = call


def rerun_eagerly(calls, **options):
    """Each kept call (graph_calls) run again by its graph's step, eagerly,
    on the inputs it was handed, ``options`` over the graph's own: the
    values are the replay's bit for bit, and the step's Python runs, so a
    solver or a DHN swapped in sees the call."""
    for g, args in calls:
        g.step(*args, **{**g.kwargs, **options})


def drop_graphs(step):
    """Drop the CUDA graphs of ``step`` (built by build_tracker): the next
    calls capture it anew, with the solvers then in place."""
    step.func.__wrapped__.graphs.clear()


# the solver kernels and K6 (NMS) by name in the device trace, under
# their counters
TRACED_KERNELS = {"launches.k1": "auction_square_kernel",
                  "launches.k3": "auction_square_batched_kernel",
                  "launches.k2": "auction_kernel",
                  "launches.k4": "twin_kernel",
                  "launches.k4_cascade": "twin_cascade_kernel",
                  "launches.k6": "k6_kernel"}


def launch_witness(name, block):
    """``block()`` under torch.profiler, its tracker steps replayed from
    graphs captured before it: the solver kernels and K6 the card ran,
    counted by name in the device trace, against the launches the tracer
    counted (a graph credits the counts of its capture on each replay).
    Raises unless they are equal, some solver ran and no step ran but by a
    replay; returns the counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with counting() as got, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        block()
        torch.cuda.synchronize()
    ran = {k: 0 for k in TRACED_KERNELS}
    for e in prof.key_averages():
        for k, kernel in TRACED_KERNELS.items():
            if kernel in e.key:
                ran[k] += e.count
    credited = {k: got[k] for k in TRACED_KERNELS}
    replays = got["tracker.graph_replays"]
    solved = sum(v for k, v in ran.items() if k != "launches.k6")
    if (ran != credited or not solved or not replays
            or got["tracker.graph_captures"] or got["tracker.graph_eager"]):
        raise AssertionError(
            f"{name}: kernels in the device trace {ran}, counted "
            f"{credited}; {replays} replays, "
            f"{got['tracker.graph_captures']} captures, "
            f"{got['tracker.graph_eager']} eager steps")
    log(f"{name}: {replays} graphed steps, solver kernels and K6 in the "
        f"device trace {ran} == counted")
    return ran


@contextlib.contextmanager
def counting():
    """The tracer's counters of the block (utils/trace.py records inside
    it): a Counter, filled as the block closes, of the kernels' launches
    (``launches.k1`` ... ``launches.k6``), the host syncs and, as
    ``spans.<name>``, how often each span closed; what the tracer kept is
    dropped before and after."""
    from yolov7_tracker_tpu_torch.utils import trace

    got = collections.Counter()
    trace.reset()
    try:
        with trace.recording():
            yield got
        got.update(trace.counters())
        got.update({f"spans.{k}": v["count"]
                    for k, v in trace.totals().items()})
    finally:
        trace.reset()


def nms_through_k6(got, name, batches=None):
    """Raises unless every NMS call of a counting() block (a ``nms`` span,
    one a detector batch) launched K6 once, some call ran, no
    host_syncs.nms was counted and, where ``batches`` is given, the block
    ran that many detector batches."""
    calls = got["spans.nms"]
    if (not calls or got["launches.k6"] != calls or got["host_syncs.nms"]
            or batches not in (None, calls)):
        raise AssertionError(
            f"{name}: {got['launches.k6']} K6 launches and "
            f"{got['host_syncs.nms']} host_syncs.nms in {calls} NMS calls"
            + ("" if batches is None else f", {batches} detector batches"))


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
    printed. Returns {tracker: record} and {tracker: K4 launches}."""
    import torch

    from yolov7_tracker_tpu_torch.cli import evaluate, track
    from yolov7_tracker_tpu_torch.eval import evaluator
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
            with steps_without_sync(), counting() as got, \
                    recording(TrackingPipeline, "run_sequence_detections",
                              seq_runs, sync=True), \
                    recording(track, "evaluate_run", scored):
                folder = track.main(argv)
            runs[device] = {
                "folder": folder, "launches": got["launches.k4"],
                "track_s": sum(t for t, _, _ in seq_runs),
                "score_s": scored[0][0], "table": scored[0][1],
                "files": read_tree(folder), "pipe": seq_runs[0][2][0],
                "dets": seq_runs[0][2][1]}
        card, cpu = runs["cuda"], runs["cpu"]
        if card["launches"] != 2 * n_frames or cpu["launches"] != 0:
            raise AssertionError(
                f"{tracker}: K4 launches {card['launches']} on the card, "
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
            "k4_launches": card["launches"], "frame_parts_ms": parts,
            "card_vs_cpu": "MOT txts and CSV byte-equal, tables equal",
            "evaluate_cli": "summary.json == track's table"}
        launches[tracker] = card["launches"]
        log(f"{tracker} from detection files on {card_line()}: HOTA "
            f"{head['HOTA'] * 100:.3f} MOTA {head['MOTA'] * 100:.3f} IDF1 "
            f"{head['IDF1'] * 100:.3f} IDSW {head['IDSW']:.0f}; tracking "
            f"{records[tracker]['ms_per_frame']:.3f} ms/frame on the card "
            f"({records[tracker]['cpu_ms_per_frame']:.3f} on the CPU) over "
            f"{n_frames} frames, {card['launches']} K4 launches; scoring "
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
    too, but each first, with no host sync; K4 launches on detected
    frames only (2 each); at k > 1 a run resumed from the state saved
    after frame 7 (mid-cadence) equal to the uninterrupted run, and the
    predict-only step timed alone; a CPU replay of the card's detections
    and cadence with the same ids and boxes within 1e-2. Returns
    ({k: record}, {k: K4 launches})."""
    import torch

    from yolov7_tracker_tpu_torch.data import writer
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
        with counting() as got:
            t0 = time.time()
            results, _ = pipe.run_sequence_stateful(iter(frames))
            torch.cuda.synchronize()
            wall = time.time() - t0
        launched = got["launches.k4"]
        pipe.step = step
        nms_through_k6(got, f"detect_per_frame={k}")
        detected = list(range(0, n, k))
        if len(kept) != len(detected) or launched != 2 * len(detected):
            raise AssertionError(
                f"detect_per_frame={k}: {len(kept)} detected frames, "
                f"{launched} K4 launches, for {len(detected)} frames of "
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
            "detected_frames": len(detected), "k4_launches": launched,
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
            f"{launched} K4 launches, tracks/frame mean "
            f"{np.mean(tracks):.1f}; no host sync in any step; "
            f"{'resumed after frame 7 == one run; ' if k > 1 else ''}"
            "CPU replay: same ids, boxes 1e-2")
    return records, launches


# ---------------------------------------------------------------------------
# phase 9: the rest of the detector zoo at full width
# ---------------------------------------------------------------------------

def zoo_phase(dev):
    """Phase 9: one model of each new kind (ZOO_RUNS) at full width (nc=80,
    the published multiples), 1280 px (cli/track.py's default), batch 8,
    bf16, BN and RepConv folded, through offline ByteTrack (128 / 300,
    conf_thresh 0.5) on phase 3's 16 frames. Returns ({name: record},
    {name: K4 launches})."""
    import torch

    frames = offline_frames()
    records, launches = {}, {}
    for name, spread, boost in ZOO_RUNS:
        t0 = time.time()
        records[name] = zoo_run(name, spread, boost, frames, dev)
        records[name]["phase_s"] = time.time() - t0
        launches[name] = records[name]["k4_launches"]
        torch.cuda.empty_cache()
    return records, launches


def zoo_run(name, spread, boost, frames, dev, spec=None, keep=None,
            weights=None):
    """One zoo model (or ``spec``, a model built from its rows), its
    seeded weights (random_state_dict, or ``weights``) calibrated on the
    first 8 frames
    (calibrate_detector_bn, standardize_heads), through
    run_sequence_stateful (after a warm-up batch): K4 launches, NMS
    survivors of every frame in ZOO_SURVIVORS, the parts of a frame, the
    detector on the card against the CPU and fused against
    unfused (zoo_detector_checks; ``keep``: a dict that gets its float32
    outputs), and the CPU replay of the tracker."""
    import torch

    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import random_state_dict
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as S

    spec = spec if spec is not None else zoo.get_spec(name, nc=80)
    sd = weights if weights is not None else random_state_dict(spec, seed=0)
    pipe = TrackingPipeline(
        PipelineConfig(model=name, nc=80, img_size=ZOO_IMG, detector_batch=8,
                       dtype="bfloat16", fuse=True),
        S.TrackerConfig(tracker="bytetrack", conf_thresh=0.5, capacity=128,
                        det_capacity=300),
        state_dict=sd, spec=spec, device=dev)
    img = letterboxed(pipe, frames[:8], dev)
    sd = calibrate_detector_bn(spec, sd, img, ZOO_BN_SCALE)
    sd = standardize_heads(spec, sd, img, spread, boost)
    pipe.model.load_state_dict(fuse_state_dict(sd))
    del img
    t0 = time.time()
    pipe.run_sequence(iter(frames[:8]))        # warm-up, not counted
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    batches, dets, slabs = [], [], []
    detect, step = pipe.detect_batch, pipe.step

    def recording_detect(frames_u8):
        out = detect(frames_u8)
        batches.append(tuple(t.clone() for t in out))
        return out

    def recording_step(slab, det, **kw):
        dets.append(S.DetSlab(*(x.clone() for x in det)))
        slabs.append(S.TrackSlab(*(x.clone() for x in slab)))
        return step(slab, det, **kw)

    pipe.detect_batch, pipe.step = recording_detect, recording_step
    torch.cuda.synchronize()
    with counting() as got:
        t0 = time.time()
        results, slab = pipe.run_sequence_stateful(iter(frames))
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = got["launches.k4"]
    del pipe.detect_batch
    pipe.step = step
    n = len(frames)
    if launches != 2 * n:
        raise AssertionError(f"{name}: {launches} K4 launches in {n} frames")
    nms_through_k6(got, name, len(batches))
    counts = torch.cat([b[3] for b in batches]).float().cpu()
    boxes = torch.cat([b[0] for b in batches])
    tracks = [len(r[1]) for r in results]
    lo, hi = ZOO_SURVIVORS
    if not (lo <= float(counts.min()) and float(counts.max()) <= hi
            and max(tracks) >= 1 and bool(torch.isfinite(boxes).all())):
        raise AssertionError(
            f"{name}: NMS survivors a frame {counts.tolist()}, tracks a "
            f"frame {tracks}, best score a frame "
            f"{[round(float(b[1][:, 0].max()), 3) for b in batches]}")
    parts = breakdown(pipe, np.stack(frames[8:]), batches[-1], dev)
    # where a batch's detector + NMS time goes (does the DFL decode or the
    # decoded-path NMS show?)
    log(f"{name}: torch.profiler over detect_batch of 8 frames")
    profile = profile_ops(lambda: pipe.detect_batch(np.stack(frames[8:])))
    checks = zoo_detector_checks(pipe, sd, frames[0], dev, keep)
    t0 = time.time()
    replay_on_cpu(pipe, dets, slabs, results, name)
    replay_s = time.time() - t0
    n_params = sum(p.numel() for p in pipe.model.parameters())
    rec = {"ms_per_frame": wall / n * 1e3, "frames": n,
           "img_size": ZOO_IMG, "canvas_hw": list(pipe._geometry(
               tuple(frames[0].shape[:2]))[0]),
           "head": spec.head_kind, "fused_params": n_params,
           "bn_scale": ZOO_BN_SCALE, "head_spread": spread,
           "head_boost": boost, "warm_up_s": warm_s,
           "nms_survivors_per_frame": float(counts.mean()),
           "nms_survivors_range": [float(counts.min()),
                                   float(counts.max())],
           "k4_launches": launches,
           "tracks_per_frame_mean": float(np.mean(tracks)),
           "tracks_per_frame_max": max(tracks), "ids": int(slab.next_id),
           **parts, **checks, "profile_detect_batch": profile,
           "cpu_replay": "same ids, boxes 1e-2",
           "cpu_replay_s": replay_s}
    log(f"{name} ({spec.head_kind}, {n_params:,} fused parameters, BN "
        f"scale {ZOO_BN_SCALE}, head spread {spread}, head boost {boost}) "
        f"on {card_line()}: "
        f"{wall / n * 1e3:.2f} ms/frame over {n} frames at {ZOO_IMG} px "
        f"(canvas {rec['canvas_hw']}), {launches} K4 launches, NMS "
        f"survivors/frame {float(counts.mean()):.1f} (min "
        f"{float(counts.min()):.0f}, max {float(counts.max()):.0f}), "
        f"tracks/frame mean {np.mean(tracks):.1f} max {max(tracks)}, "
        f"{int(slab.next_id)} ids; float32 card vs CPU "
        f"{checks['card_vs_cpu']:.2e}, fused vs unfused "
        f"{checks['fused_vs_unfused']:.2e} (relative to each part, "
        f"tolerance {ZOO_REL_TOL}; bf16 vs CPU {checks['bf16_vs_cpu']:.2e}, "
        f"largest part {checks['largest_part']:.4g}); CPU replay "
        f"({replay_s:.1f} s): same "
        "ids, boxes within 1e-2")
    return rec


def letterboxed(pipe, frames, dev):
    """``frames`` (uint8 HWC) letterboxed on ``dev`` as ``pipe`` does:
    (B, H, W, 3) in [0, 1], float32."""
    import torch

    from yolov7_tracker_tpu_torch.data import letterbox

    src_hw = tuple(frames[0].shape[:2])
    out_hw, unpad_hw = pipe._geometry(src_hw)
    img, _ = letterbox.device_preprocess(
        torch.from_numpy(np.stack(frames)).to(dev), src_hw, out_hw,
        unpad_hw=unpad_hw)
    return img.float()


def calibrate_detector_bn(spec, sd, img, scale):
    """``sd`` (unfused) with every BatchNorm's running statistics set to
    those of its input on ``img`` (letterboxed frames) and its weight to
    ``scale``, as calibrate_bn does for ReID: one float32 forward in
    training mode on ``img``'s device. Each layer's output then has std
    ``scale`` on these frames, whatever the depth; at a small scale SiLU
    is near linear and the body neither loses the image nor turns
    chaotic."""
    import torch

    from yolov7_tracker_tpu_torch.models.yolo import YoloV7

    model = YoloV7(spec, fused=False)
    model.load_state_dict(sd)
    model = model.to(img.device).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None        # a cumulative mean: this batch's
            m.weight.data.fill_(scale)
    with torch.no_grad():
        model(img)
    return {k: v.cpu() for k, v in model.eval().state_dict().items()}


def standardize_heads(spec, sd, img, spread, boost):
    """``sd`` (unfused) with each head output conv rescaled so that, on
    ``img`` (letterboxed frames), each of its channels has std ``spread``
    (1 for the box channels) around its prior bias, raised by ``boost``
    on the objectness and class channels. The scores then spread over the
    cells as the image does, and ``boost`` sets how many boxes pass the
    NMS threshold. IBin's scored channels are its objectness and class
    logits after the bins."""
    import torch

    from yolov7_tracker_tpu_torch.models.yolo import YoloV7, obj_index

    model = YoloV7(spec, fused=False)
    model.load_state_dict(sd)
    model = model.to(img.device).eval()
    stats = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: stats.__setitem__(
            n, (o.float().mean((0, 2, 3)), o.float().std((0, 2, 3)))))
        for n, m in model.named_children()
        if n.startswith(("head_m_", "head_cv")) and isinstance(
            m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(img)
    for h in hooks:
        h.remove()
    out = dict(sd)
    for n, (mean, std) in stats.items():
        mean, std = mean.cpu(), std.cpu().clamp_min(1e-12)
        w, b = sd[f"{n}.weight"], sd[f"{n}.bias"]
        if n.startswith("head_m_"):
            scored = (torch.arange(b.numel()) % spec.no) >= obj_index(spec)
        else:
            scored = torch.full_like(b, n.startswith("head_cv3_"), dtype=bool)
        a = torch.where(scored, spread, 1.0) / std
        out[f"{n}.weight"] = w * a[:, None, None, None]
        out[f"{n}.bias"] = a * (b - mean) + b + boost * scored
    return out


def output_parts(out, spec, hw):
    """A detector's output cut into parts of one scale each, every level
    alone: an anchor head's raw xy, wh, objectness and class logits
    (IBin's: xy, the w residual and bins, the h residual and bins,
    objectness, class); DetectV8's decoded box columns (pixels) and class
    scores (0 to 1)."""
    if spec.head_kind == "IBin":
        from yolov7_tracker_tpu_torch.models.yolo import obj_index

        o = obj_index(spec)
        n_bin = (o - 2) // 2
        return [p for lvl in out for p in (
            lvl[..., :2], lvl[..., 2:2 + n_bin], lvl[..., 2 + n_bin:o],
            lvl[..., o:o + 1], lvl[..., o + 1:])]
    if spec.head_kind == "DetectV8":
        sizes = [(hw[0] // s) * (hw[1] // s) for s in spec.strides]
        return [p for lvl in out[0].split(sizes, dim=1)
                for p in (lvl[..., :4], lvl[..., 5:])]
    return [p for lvl in out for p in (lvl[..., :2], lvl[..., 2:4],
                                       lvl[..., 4:5], lvl[..., 5:])]


def parts_rel(a, b):
    """The worst over matching parts of max |a - b| over max(1, max |b|)."""
    return max(float((x.float() - y.float()).abs().max())
               / max(1.0, float(y.float().abs().max()))
               for x, y in zip(a, b))


def zoo_detector_checks(pipe, sd, frame, dev, keep=None):
    """One letterboxed frame through the detector in float32 (TF32 off):
    the fused model on the card against the same on the CPU, and the fused
    against the unfused model on the card; and the fused model in bf16 on
    the card against the CPU. Each difference is the worst over the
    output's parts (output_parts) of max |a - b| over max(1, max |b|): the
    float32 ones must stay within ZOO_REL_TOL and the bf16 one must not,
    so that the check tells the two apart. ``keep``: a dict that gets each
    run's float32 outputs on the CPU, by key (card, cpu, unfused, bf16)."""
    import torch

    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import YoloV7

    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("the detector checks need TF32 off")
    img = letterboxed(pipe, [frame], "cpu")
    out_hw = tuple(img.shape[1:3])
    fused_sd = fuse_state_dict(sd)
    outs = {}
    t = {}
    for key, d, state, fused, dtype in (
            ("card", dev, fused_sd, True, torch.float32),
            ("cpu", "cpu", fused_sd, True, torch.float32),
            ("unfused", dev, sd, False, torch.float32),
            ("bf16", dev, fused_sd, True, torch.bfloat16)):
        model = YoloV7(pipe.spec, fused=fused)
        model.load_state_dict(state)
        model = model.to(d, dtype).eval()
        t0 = time.time()
        with torch.no_grad():
            out = model(img.to(d, dtype))
        out = [o.float().cpu() for o in (out if isinstance(out, list)
                                         else [out])]
        if keep is not None:
            keep[key] = out
        outs[key] = output_parts(out, pipe.spec, out_hw)
        t[key] = time.time() - t0
        del model

    res = {"card_vs_cpu": parts_rel(outs["card"], outs["cpu"]),
           "fused_vs_unfused": parts_rel(outs["card"], outs["unfused"]),
           "bf16_vs_cpu": parts_rel(outs["bf16"], outs["cpu"]),
           "largest_part": max(float(o.abs().max()) for o in outs["cpu"]),
           "cpu_forward_s": t["cpu"]}
    finite = all(bool(torch.isfinite(o).all()) for o in outs["card"])
    if not (finite and res["card_vs_cpu"] <= ZOO_REL_TOL
            and res["fused_vs_unfused"] <= ZOO_REL_TOL
            and res["bf16_vs_cpu"] > ZOO_REL_TOL):
        raise AssertionError(f"{pipe.spec.name}: detector checks {res}, "
                             f"finite {finite}")
    return res


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


# ---------------------------------------------------------------------------
# phase 10: training (parallel/train_step, cli/train.train_loop) and the
# detector test (cli/test.evaluate_map)
# ---------------------------------------------------------------------------

TRAIN_PARITY_IMG = 320        # (a), (c): yolov7-w6 at full width, batch 2
# (a)'s two steps run at ni = 495 and 496, inside the warmup, where every
# group's LR is above 0 (at ni = 0 only the biases move) and accumulate is
# 16 (batch 2, nominal 64): 495 carries the gradient sum, 496 applies it
TRAIN_PARITY_NI = 495
TRAIN_REL_TOL = 1e-4          # (a): of each tensor's largest |value|
NEAR_TIE = 1e-6               # (a): a SimOTA difference is allowed within
TRAIN_IMG = 1280              # (b): train_aux.py's size for w6
TRAIN_BATCH = 8
TRAIN_BATCHES = 12
# (b) starts at ni = 500 of the warmup, where accumulate (batch 8, nominal
# 64) is 4, then 5: the loop carries the gradient sum over most steps
TRAIN_START_NI = 500
TEST_IMG = 640                # (d)
TEST_IMAGES = 16
TEST_REL_TOL = 1e-4           # (d): map50, map, mp, mr card against CPU
TINY_IMG, TINY_BATCH, TINY_BATCHES = 640, 32, 6     # (e)
# (b): each lead head output channel's std on the first batch
# (standardize_heads), around its prior
TRAIN_HEAD_SPREAD = 4.0
TRAIN_BN_SCALE = 1.0          # (b): calibrate_detector_bn's BN weight
BF16_PEAK = 989e12            # H100 SXM dense bf16 (NVIDIA datasheet)


class MemoryDataset:
    """A seeded in-memory detection dataset: n uint8 BGR images (size x
    size) of blocky noise with 5-60 filled rectangles each, their labels
    [cls, cx, cy, w, h] normalised and padded to max_labels. It exposes
    what cli/train.train_loop and cli/test.evaluate_map read: ``batches``
    (in order: the data is seeded already), ``labels`` and ``len``."""

    def __init__(self, n, size, nc=80, seed=0, max_labels=128):
        rng = np.random.default_rng(seed)
        cell = 16
        self.imgs = np.repeat(np.repeat(rng.integers(
            0, 255, (n, size // cell, size // cell, 3), np.uint8), cell, 1),
            cell, 2)
        self.targets = np.zeros((n, max_labels, 5), np.float32)
        self.masks = np.zeros((n, max_labels), bool)
        self.labels = []
        for i in range(n):
            k = int(rng.integers(5, 61))
            wh = rng.uniform(0.02, 0.3, (k, 2))
            xy = rng.uniform(0, 1, (k, 2)) * (1 - wh)
            lab = np.concatenate([rng.integers(0, nc, (k, 1)), xy + wh / 2,
                                  wh], axis=1).astype(np.float32)
            for (x, y), (w, h) in zip((xy * size).astype(int),
                                      (wh * size).astype(int)):
                self.imgs[i, y:y + h, x:x + w] = rng.integers(0, 255, 3)
            self.labels.append(lab)
            self.targets[i, :k] = lab[:max_labels]
            self.masks[i, :k] = True

    def __len__(self):
        return len(self.imgs)

    def batches(self, batch_size, shuffle=True, epochs=1):
        for _ in range(epochs):
            for k in range(0, len(self) - batch_size + 1, batch_size):
                yield (self.imgs[k:k + batch_size],
                       self.targets[k:k + batch_size],
                       self.masks[k:k + batch_size])


class SkipBatches:
    """``data`` whose batches start after the first ``skip``: a resumed
    run's dataset that goes on where the preempted one stopped."""

    def __init__(self, data, skip):
        self.data, self.skip, self.labels = data, skip, data.labels

    def __len__(self):
        return len(self.data)

    def batches(self, batch_size, shuffle=True, epochs=1):
        it = self.data.batches(batch_size, shuffle, epochs)
        for _ in range(self.skip):
            next(it)
        yield from it


def train_opts(model, img, batch, ckpt_dir, hyp, *extra):
    """cli/train.py's parsed options for train_loop, on the card."""
    from yolov7_tracker_tpu_torch.cli import train as train_cli

    return train_cli.parse_args(
        ["--model", model, "--data", "unused.yaml", "--img", str(img),
         "--batch", str(batch), "--epochs", "1", "--eval_every", "0",
         "--ckpt_dir", ckpt_dir, "--hyp", hyp, "--device", "cuda",
         *extra])


@contextlib.contextmanager
def train_instruments(around=None, weights=None, start_step=0):
    """For the block, every step that parallel/train_step.make_train_step
    makes is timed on the host clock between two synchronizes, and CUDA
    events time its parts: the forward, each SimOTA assignment, the loss
    (its assignments included) and the optimizer + EMA; the backward is
    the gap between the loss's end and the optimizer's start, or the
    step's end where the accumulation carries. ``around`` maps a step's
    index to a context-manager factory it runs under (FlopCounterMode, the
    profiler); ``weights`` (a state_dict) seeds make_train_state, whose
    state starts at ni = ``start_step``. Yields {"steps": [per-step
    record], "state": the live TrainState}."""
    import torch

    from yolov7_tracker_tpu_torch.models import yolo
    from yolov7_tracker_tpu_torch.parallel import train_step as ts
    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    out = {"steps": [], "state": None}
    events = []
    patched = [(yolo.YoloV7, "forward", "forward"),
               (loss_mod, "simota_assign", "simota"),
               (ts, "compute_loss_aux_ota", "loss"),
               (ts, "compute_loss_ota", "loss"),
               (ts, "compute_loss", "loss"),
               (ts, "_apply_update", "optimizer_ema")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]

    def evented(part, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = fn(*args, **kw)
            e.record()
            events.append((part, s, e))
            return r
        return wrapped

    for (obj, name, part), (_, _, fn) in zip(patched, saved):
        setattr(obj, name, evented(part, fn))
    make, make_state = ts.make_train_step, ts.make_train_state

    def seeded_state(spec, opt_cfg=ts.OptConfig(), seed=0, device=None,
                     state_dict=None, mesh=None):
        state = make_state(spec, opt_cfg, seed, device,
                           state_dict if state_dict is not None else weights,
                           mesh=mesh)
        state.step = start_step
        return state

    def make_timed(*args, **kw):
        step = make(*args, **kw)

        def timed(state, *batch):
            out["state"] = state
            i = len(out["steps"])
            ctx = (around or {}).get(i, contextlib.nullcontext)()
            events.clear()
            updates = state.ema_count
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.time()
            with ctx as hook:
                metrics = step(state, *batch)
            end.record()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
            parts = collections.defaultdict(float)
            loss_end, opt_start = None, end
            for part, s, e in events:
                parts[part] += s.elapsed_time(e)
                if part == "loss":
                    loss_end = e
                elif part == "optimizer_ema":
                    opt_start = s
            parts["backward"] = loss_end.elapsed_time(opt_start)
            parts["loss_terms"] = parts["loss"] - parts["simota"]
            out["steps"].append({
                "ms": wall, "parts": dict(parts), "hook": hook,
                "metrics": {k: float(v) for k, v in metrics.items()},
                "ni": state.step - 1, "updates": state.ema_count,
                "applied": state.ema_count > updates})
            return metrics
        return timed

    ts.make_train_step = make_timed
    ts.make_train_state = seeded_state
    try:
        yield out
    finally:
        ts.make_train_step, ts.make_train_state = make, make_state
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def parity_weights(spec, seed=0):
    """Seeded w6 weights for (a): random_state_dict with each BatchNorm's
    affine terms and running statistics drawn around identity, so that a
    BN bias is no zero tensor whose update alone sets its scale."""
    import torch

    from yolov7_tracker_tpu_torch.models.yolo import random_state_dict

    sd = random_state_dict(spec, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if v.dim() != 1 or k.endswith("implicit") or k.startswith("head"):
            continue
        if k.endswith("running_var") or k.endswith(".weight"):
            v.copy_(torch.empty(v.shape).uniform_(0.8, 1.2, generator=g))
        elif k.endswith("running_mean") or k.endswith(".bias"):
            v.copy_(0.05 * torch.randn(v.shape, generator=g))
    return sd


def to_input(batch, dev):
    """A dataset batch as the loop feeds it: BGR uint8 -> RGB [0, 1]."""
    import torch

    imgs, tgts, masks = batch
    x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
    return (x.flip(-1).float() / 255.0, torch.from_numpy(tgts).to(dev),
            torch.from_numpy(masks).to(dev))


def state_rel_diff(a, b, sections=("model", "ema")):
    """The worst |a - b| over each float tensor of two TrainState
    state_dicts, as a share of the tensor's largest |value| in b; and its
    name."""
    worst, name = 0.0, ""
    for sec in sections:
        for k, v in b[sec].items():
            if not v.is_floating_point():
                continue
            w = a[sec][k].to(v.device)
            err = (w - v).abs().max().item()
            scale = v.abs().max().item()
            r = err / scale if scale else (0.0 if err == 0 else float("inf"))
            if r > worst:
                worst, name = r, f"{sec}/{k}"
    return worst, name


@contextlib.contextmanager
def keeping_calls(obj, name, kept):
    """obj.name wrapped for the block: each call's (args, kwargs, result)
    is appended to ``kept``."""
    fn = getattr(obj, name)

    def kept_call(*args, **kw):
        out = fn(*args, **kw)
        kept.append((args, kw, out))
        return out

    setattr(obj, name, kept_call)
    try:
        yield
    finally:
        setattr(obj, name, fn)


def assignment_check(card, cpu, name, phase="10a"):
    """SimOTA assignments of one step on the card against the CPU's:
    the matched slots and their targets. A difference counts only at a
    near-tie of the CPU's costs (two costs of the slot within NEAR_TIE
    relative, or its target's top-k IoU sum within NEAR_TIE of an
    integer); each is printed. Returns (slots that differ, of them not at
    a near-tie)."""
    import torch

    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    (_, _, a_out), (b_args, b_kw, b_out) = card, cpu
    ma, mb = a_out["matched"].cpu(), b_out["matched"]
    ga, gb = a_out["matched_gt"].cpu(), b_out["matched_gt"]
    diff = (ma != mb) | (ma & mb & (ga != gb))
    n = int(diff.sum())
    if not n:
        return 0, 0
    cost, top_sum, _, _ = loss_mod.simota_costs(*b_args, **b_kw)
    bsz, t_cap = cost.shape[:2]
    d = diff.reshape(bsz, t_cap, -1)

    def close(x, y):
        return abs(x - y) <= NEAR_TIE * max(abs(x), abs(y))

    far = 0
    for b, t, c in zip(*torch.nonzero(d, as_tuple=True)):
        row = torch.sort(cost[b, t]).values
        k = max(int(top_sum[b, t]), 1)
        two = torch.sort(cost[b, :, c]).values[:2]
        tie = (close(float(two[0]), float(two[1]))
               or close(float(row[k - 1]), float(row[min(k, row.numel() - 1)]))
               or abs(float(top_sum[b, t]) - round(float(top_sum[b, t])))
               <= NEAR_TIE)
        far += not tie
        log(f"phase {phase}: {name} SimOTA slot (image {int(b)}, target "
            f"{int(t)}, slot {int(c)}) differs; near-tie: {tie} (top-k sum "
            f"{float(top_sum[b, t]):.7f}; the row's k-th and next cost "
            f"{float(row[k - 1]):.7f} "
            f"{float(row[min(k, row.numel() - 1)]):.7f}"
            f"; the slot's two lowest {float(two[0]):.7f} "
            f"{float(two[1]):.7f})")
    return n, far


def on_host(call):
    """A kept call's (args, kwargs, result) with its tensors on the CPU."""
    import torch

    def host(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    args, kw, out = call
    return (tuple(host(a) for a in args), {k: host(v) for k, v in kw.items()},
            {k: host(v) for k, v in out.items()})


def float64_state(state):
    """A TrainState converted in place to float64: parameters (the same
    Parameter objects, so the optimizer keeps them), BN statistics, EMA,
    momentum buffers and gradient sum."""
    import torch

    state.model.double()
    for n, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        st["momentum_buffer"] = st["momentum_buffer"].double()
        state.ema[n] = state.ema[n].double()
        if p.grad is not None:
            g = p.grad.double()
            p.grad = None
            p.grad = g
    return state


def parity_steps(spec, sd, cfg, inputs, device, dtype, sync_check=False):
    """Train steps of ``spec`` from ``sd`` on ``device`` in ``dtype``, one
    for each of ``inputs`` (host tensors), from ni = TRAIN_PARITY_NI.
    Yields (state, losses, kept SimOTA calls, seconds) after each step;
    with ``sync_check`` every step but the first runs under
    torch.cuda.set_sync_debug_mode("error")."""
    import torch

    from yolov7_tracker_tpu_torch.parallel import train_step as ts
    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    state = ts.make_train_state(spec, cfg, device=device, state_dict=sd)
    if dtype == torch.float64:
        float64_state(state)
    state.step = TRAIN_PARITY_NI
    step = ts.make_train_step(spec, img_size=TRAIN_PARITY_IMG, opt_cfg=cfg)
    for i, (x, t, m) in enumerate(inputs):
        kept = []
        x, t, m = x.to(device, dtype), t.to(device), m.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if sync_check and i
                                           else "default")
        t0 = time.time()
        try:
            with keeping_calls(loss_mod, "simota_assign", kept):
                metrics = step(state, x, t, m)
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        yield (state, {k: float(v) for k, v in metrics.items()},
               [on_host(k) for k in kept], time.time() - t0)


def moved_params(state, sd):
    """Per optimizer group: (parameters that differ from ``sd``, all)."""
    import torch

    names = {id(p): n for n, p in state.model.named_parameters()}
    return {g["name"]: (sum(not torch.equal(p.detach().cpu(),
                                            sd[names[id(p)]].to(p.dtype))
                            for p in g["params"]), len(g["params"]))
            for g in state.optimizer.param_groups}


def train_parity(dev):
    """(a): two train steps of yolov7-w6 at full width, 320 px, batch 2,
    from one seeded TrainState and two batches made on the host, on the
    card and on the CPU: at ni = TRAIN_PARITY_NI the accumulation carries
    (the gradient sum is left in .grad), at the next ni it applies (SGD +
    Nesterov in the three groups, every group's LR above 0, then the EMA).
    In float32 (TF32 off) the raw training-mode preds of the two devices
    part by more than 1e-4 of the largest (each is reported against the
    CPU's float64 preds), which flips the odd SimOTA match whose -log IoU is
    steep; so the equalities run the network (forward, backward,
    parameters, BN statistics, EMA, momentum, gradient sum) in float64 on
    both, with SimOTA and the loss terms on the preds cast to float32 as the
    step always does. After each step: the same SimOTA assignments, lead
    and aux (a difference only at a printed near-tie); loss parts within
    TRAIN_REL_TOL relative; parameters, BN statistics, EMA, momentum and
    gradient sum each within TRAIN_REL_TOL of the tensor's largest value.
    The carry step must leave ema_count 0 and a gradient sum; the applying
    step ema_count 1, the sum zeroed and parameters of every group moved.
    The float32 steps are the control and are reported: their raw preds,
    losses and state against the CPU's, their assignment differences, and
    SimOTA on the card's own preds equal to the CPU's SimOTA on them. The
    float32 card's applying step runs under
    torch.cuda.set_sync_debug_mode("error")."""
    import torch

    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.parallel import train_step as ts
    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    spec = zoo.get_spec("yolov7-w6", nc=80)
    sd = parity_weights(spec)
    cfg = ts.OptConfig(batch_size=2)
    ni = TRAIN_PARITY_NI
    acc = [ts.accumulate_schedule(cfg, n) for n in (ni, ni + 1)]
    assert ni % acc[0] != 0 and (ni + 1) % acc[1] == 0, acc
    data = MemoryDataset(4, TRAIN_PARITY_IMG, seed=1)
    cpu = torch.device("cpu")
    # made on the host: the card divides by 255 through a reciprocal
    inputs = [to_input(b, cpu) for b in data.batches(2)]
    sections = ("model", "ema", "momentum", "grad_acc")
    rec = {"ni": [ni, ni + 1], "accumulate": acc}
    truth = []                       # the CPU's float64 preds (lead), a step
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        runs = zip(parity_steps(spec, sd, cfg, inputs, dev, dtype,
                                sync_check=dtype == torch.float32),
                   parity_steps(spec, sd, cfg, inputs, cpu, dtype))
        for i, ((cs, cm, ck, card_s), (ps, pm, pk, cpu_s)) in enumerate(runs):
            kind = "apply" if i else "carry"
            assert len(ck) == len(pk) == 2          # lead and aux
            fwd = float((ck[0][0][0] - pk[0][0][0]).abs().max()
                        / pk[0][0][0].abs().max())
            if len(truth) == i:
                truth.append(pk[0][0][0])

            def off(x):
                return float((x - truth[i]).abs().max()
                             / truth[i].abs().max())

            tag = f"{name} {kind}"
            diffs = [assignment_check(a, b, f"{tag} {nm}") for a, b, nm in
                     zip(ck, pk, ("lead", "aux"))]
            # SimOTA on the card's own preds, again on the CPU
            same_in = [assignment_check(a, (a[0], a[1], loss_mod.simota_assign(
                *a[0], **a[1])), f"{tag} {nm} (the card's preds)")
                for a, nm in zip(ck, ("lead", "aux"))]
            loss_rel = max(abs(cm[k] - v) / abs(v) for k, v in pm.items())
            csd, psd = cs.state_dict(), ps.state_dict()
            worst = {sec: state_rel_diff(csd, psd, (sec,))
                     for sec in sections}
            grad_max = max(float(g.abs().max())
                           for g in psd["grad_acc"].values())
            moved = moved_params(ps, sd)
            r = rec.setdefault(name, {})[kind] = {
                "loss_card": cm, "loss_cpu": pm, "loss_worst_rel": loss_rel,
                "raw_preds_rel": fwd, "card_vs_cpu_float64": off(ck[0][0][0]),
                "cpu_vs_cpu_float64": off(pk[0][0][0]),
                "matched_slots": [int(k[2]["matched"].sum()) for k in pk],
                "assignment_differences": diffs,
                "assignment_differences_on_card_preds": same_in,
                "worst_rel": {sec: w for sec, (w, _) in worst.items()},
                "worst_at": {sec: at for sec, (_, at) in worst.items()},
                "ema_count": [cs.ema_count, ps.ema_count],
                "grad_acc_max": grad_max, "moved_params": moved,
                "card_step_s": card_s, "cpu_step_s": cpu_s}
            log(f"phase 10a: w6 {kind} step (ni {ni + i}) card vs CPU, "
                f"{name}: raw preds {fwd:.2e} of the largest (card "
                f"{r['card_vs_cpu_float64']:.2e}, CPU "
                f"{r['cpu_vs_cpu_float64']:.2e} off the CPU's float64); "
                f"losses {cm} / {pm} ({loss_rel:.2e}); matched slots "
                f"{r['matched_slots']}; assignment differences (slots, not "
                f"at a near-tie) {diffs}, on the card's preds {same_in}; "
                f"worst of the tensor's max "
                + ", ".join(f"{sec} {w:.2e} ({at})"
                            for sec, (w, at) in worst.items())
                + f"; ema_count {r['ema_count']}, gradient sum max "
                f"{grad_max:.3g}, parameters moved (of all) {moved}")
            assert all(far == 0 for _, far in same_in), same_in
            if dtype == torch.float32:
                continue
            assert all(far == 0 for _, far in diffs), diffs
            assert loss_rel <= TRAIN_REL_TOL, (cm, pm)
            for sec, (w, at) in worst.items():
                assert w <= TRAIN_REL_TOL, (kind, sec, w, at)
            assert cs.ema_count == ps.ema_count == i, r["ema_count"]
            assert (grad_max > 0) == (kind == "carry"), grad_max
            if kind == "apply":
                assert all(n for n, _ in moved.values()), moved
    rec["apply_step_without_sync"] = True
    log("phase 10a: the float32 card's applying step made no host sync")
    return rec


def train_full(dev):
    """(b): cli/train.train_loop on yolov7-w6 at full width, 1280 px,
    nc = 80, batch 8, bf16 autocast, nominal batch 64, hyp.scratch.p6, 12
    batches of a seeded in-memory dataset, from seeded weights calibrated
    on its first batch (calibrate_detector_bn, standardize_heads) and a
    state at ni = TRAIN_START_NI, so that the optimizer steps on the ni
    that JAX's accumulate schedule names and the gradient sum carries in
    between. Returns (record, the EMA variables with the live BN statistics
    and the starting weights, on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from yolov7_tracker_tpu_torch.cli import train as train_cli
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import random_state_dict
    from yolov7_tracker_tpu_torch.parallel import train_step as ts

    spec = zoo.get_spec("yolov7-w6", nc=80)
    t0 = time.time()
    data = MemoryDataset(TRAIN_BATCH * TRAIN_BATCHES, TRAIN_IMG, seed=2)
    data_s = time.time() - t0
    # seeded weights calibrated on the first batch as phase 9 does, so that
    # the BN running statistics fit the data from the start and the EMA
    # model scored in (d) sees what it trained on
    x = to_input(next(data.batches(TRAIN_BATCH)), dev)[0]
    sd = calibrate_detector_bn(spec, random_state_dict(spec, seed=0), x,
                               TRAIN_BN_SCALE)
    sd = standardize_heads(spec, sd, x, TRAIN_HEAD_SPREAD, 0.0)
    del x
    around = {1: lambda: FlopCounterMode(display=False),
              2: lambda: profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    opts = train_opts("yolov7-w6", TRAIN_IMG, TRAIN_BATCH, ckpt_dir,
                      "data/hyp.scratch.p6.yaml")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with train_instruments(around, weights=sd,
                               start_step=TRAIN_START_NI) as ins:
            t0 = time.time()
            train_cli.train_loop(opts, {"nc": 80}, data, {"requested": False})
            loop_s = time.time() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    steps, state = ins["steps"], ins["state"]
    assert len(steps) == TRAIN_BATCHES, len(steps)
    for s in steps:
        assert all(np.isfinite(v) for v in s["metrics"].values()), s
    cfg = ts.OptConfig(epochs=1, steps_per_epoch=TRAIN_BATCHES,
                       batch_size=TRAIN_BATCH)
    nis = range(TRAIN_START_NI, TRAIN_START_NI + TRAIN_BATCHES)
    accumulate = [ts.accumulate_schedule(cfg, ni) for ni in nis]
    applies = [ni for ni, a in zip(nis, accumulate) if ni % a == 0]
    assert [s["ni"] for s in steps] == list(nis)
    assert [s["ni"] for s in steps if s["applied"]] == applies, steps
    assert [s["updates"] for s in steps] == [
        sum(1 for a in applies if a <= ni) for ni in nis]
    assert 1 < len(applies) < TRAIN_BATCHES, applies
    timed = steps[3:]
    kinds = {"carry": [s for s in timed if not s["applied"]],
             "apply": [s for s in timed if s["applied"]]}
    assert all(kinds.values()), applies
    ms = float(np.median([s["ms"] for s in timed]))
    kind_ms = {k: float(np.median([s["ms"] for s in v]))
               for k, v in kinds.items()}
    parts = {k: {p: float(np.median([s["parts"].get(p, 0.0) for s in v]))
                 for p in ("forward", "simota", "loss_terms", "backward",
                           "optimizer_ema")}
             for k, v in kinds.items()}
    flops = float(steps[1]["hook"].get_total_flops())
    prof = steps[2]["hook"].key_averages()
    launches = sum(e.count for e in prof if "LaunchKernel" in e.key)
    # the profiled step's kernel time (kernel entries only: an op's own
    # entry repeats its kernels' time) against the median carry step's
    # wall time: how far the host's launches hold the card back
    device_ms = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in prof
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    rec = {"model": "yolov7-w6", "img": TRAIN_IMG, "batch": TRAIN_BATCH,
           "dtype": "bfloat16", "step_ms": ms,
           "imgs_per_s": TRAIN_BATCH / ms * 1e3, "step_ms_by_kind": kind_ms,
           "step_ms_all": [s["ms"] for s in steps],
           "parts_ms": parts, "peak_bytes": int(peak),
           "profiled_step": "carry", "launches_per_step": launches,
           "flops_per_step": flops, "profiled_step_device_ms": device_ms,
           "device_busy_share": device_ms / kind_ms["carry"],
           "tflops": flops / ms * 1e-9,
           "bf16_peak_share": flops / (ms * 1e-3) / BF16_PEAK,
           "ni": list(nis), "accumulate": accumulate,
           "updates": steps[-1]["updates"], "applied_at": applies,
           "loss_first_last": [steps[0]["metrics"]["loss"],
                               steps[-1]["metrics"]["loss"]],
           "data_s": data_s, "loop_s": loop_s}
    log(f"phase 10b: w6 @{TRAIN_IMG} batch {TRAIN_BATCH} bf16, ni "
        f"{TRAIN_START_NI}-{nis[-1]} (accumulate {accumulate}): {ms:.1f} "
        f"ms/step (median of steps 4-{TRAIN_BATCHES}; carry "
        f"{kind_ms['carry']:.1f}, apply {kind_ms['apply']:.1f}), "
        f"{rec['imgs_per_s']:.1f} imgs/s, peak {peak / 2**30:.2f} GiB, parts "
        f"{parts}, {launches} launches a carry step, {device_ms:.1f} ms of "
        f"kernels in it (busy {rec['device_busy_share']:.2f}), "
        f"{flops / 1e12:.2f} TFLOP a step = {rec['tflops']:.1f} TFLOP/s = "
        f"{rec['bf16_peak_share']:.3f} of the bf16 peak; optimizer steps at "
        f"ni {applies}")
    variables = {"start": {k: v.cpu() for k, v in sd.items()},
                 "ema": {k: v.detach().cpu().clone()
                         for k, v in state.ema_variables().items()}}
    del ins, state
    torch.cuda.empty_cache()
    return rec, variables


def preempt_resume(dev):
    """(c): (a)'s configuration through train_loop's checkpointing, bf16
    as the loop runs it, under torch.use_deterministic_algorithms: run A
    stops at preempt_after = 5; run B at 3, which writes step_3/ and
    preempted.json; _find_latest_ckpt with the fingerprint picks it; the
    loaded TrainState equals B's bit for bit; run C resumes from it over
    batches 4-5 and stops at 5: its step_5 state and its two steps'
    losses equal A's bit for bit (or within TRAIN_REL_TOL where an op
    refuses deterministic mode, named)."""
    import warnings

    import torch

    from yolov7_tracker_tpu_torch.cli import train as train_cli
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.parallel import train_step as ts
    from yolov7_tracker_tpu_torch.utils import checkpoint

    spec = zoo.get_spec("yolov7-w6", nc=80)
    sd = parity_weights(spec)
    data = MemoryDataset(10, TRAIN_PARITY_IMG, seed=5)
    dirs = {k: tempfile.mkdtemp(prefix=f"chip_smoke_{k}_") for k in "ABC"}
    fingerprint = {"model": "yolov7-w6", "img": TRAIN_PARITY_IMG, "nc": 80}

    def run(k, stop_at, dataset, *resume):
        opts = train_opts("yolov7-w6", TRAIN_PARITY_IMG, 2, dirs[k],
                          "data/hyp.scratch.p6.yaml", "--preempt_after",
                          str(stop_at), *resume)
        with train_instruments(weights=sd) as ins:
            run_dir = train_cli.train_loop(opts, {"nc": 80}, dataset,
                                           {"requested": False})
        pre = json.load(open(os.path.join(run_dir, "preempted.json")))
        assert pre["step"] == stop_at, pre
        assert os.path.isfile(os.path.join(run_dir, f"step_{stop_at}",
                                           "meta.json"))
        return run_dir, ins["steps"], ins["state"].state_dict()

    sections = ("model", "ema", "momentum", "grad_acc")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_a, steps_a, _ = run("A", 5, data)
            run_b, _, saved_b = run("B", 3, data)
            latest = train_cli._find_latest_ckpt(dirs["B"], fingerprint)
            assert latest == os.path.join(run_b, "step_3"), latest
            loaded = checkpoint.load_train_state(latest, ts.make_train_state(
                spec, ts.OptConfig(batch_size=2), device=dev)).state_dict()
            reload_worst, reload_at = state_rel_diff(loaded, saved_b,
                                                     sections)
            assert reload_worst == 0.0, (reload_worst, reload_at)
            assert (loaded["step"], loaded["ema_count"]) == (
                saved_b["step"], saved_b["ema_count"])
            run_c, steps_c, _ = run("C", 5, SkipBatches(data, 3),
                                    "--resume", latest)
        refused = sorted({str(w.message).split(" does not have")[0]
                          for w in caught
                          if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    a_state = torch.load(os.path.join(run_a, "step_5", "state.pt"),
                         weights_only=True)
    c_state = torch.load(os.path.join(run_c, "step_5", "state.pt"),
                         weights_only=True)
    worst, where = state_rel_diff(c_state, a_state, sections)
    a_loss = [s["metrics"] for s in steps_a[3:5]]
    c_loss = [s["metrics"] for s in steps_c]
    assert (a_state["step"], c_state["step"]) == (5, 5)
    if refused:
        log(f"phase 10c: ops without a deterministic implementation: "
            f"{refused}; steps 4-5 held to {TRAIN_REL_TOL}")
        assert worst <= TRAIN_REL_TOL, (worst, where)
        for a, c in zip(a_loss, c_loss):
            for key, v in a.items():
                assert abs(c[key] - v) <= TRAIN_REL_TOL * abs(v), (key, a, c)
    else:
        assert worst == 0.0, (worst, where)
        assert c_loss == a_loss, (c_loss, a_loss)
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    rec = {"preempted_at": 3, "resumed_steps": len(c_loss),
           "bit_exact": not refused, "nondeterministic_ops": refused,
           "worst_rel": worst, "losses_4_5": c_loss}
    log(f"phase 10c: preempted at step 3, picked by --resume auto, reloaded "
        f"bit for bit; steps 4-5 after the resume against an uninterrupted "
        f"run: worst {worst:.2e} ({'bit for bit' if not refused else where})")
    return rec


def label_from_detections(val, spec, variables, dev, per_image=6):
    """Relabel ``val`` (a MemoryDataset) with the detector's own top
    detections on it that lie inside the image and are at least 4 px a
    side (jittered by 1% of the image, one in three given the next class)
    plus two boxes it did not find, so that its mAP there is neither 0 nor
    1."""
    from yolov7_tracker_tpu_torch.cli.test import evaluate_map
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    kept = []
    with recording(nms_mod, "nms", kept):
        evaluate_map(spec, variables, val, img=TEST_IMG, batch=8,
                     device=dev)
    dets = np.concatenate([k[1][0].cpu().numpy() for k in kept])
    rng = np.random.default_rng(6)
    size = val.imgs.shape[1]
    val.targets[:] = 0
    val.masks[:] = False
    val.labels = []
    for i, d in enumerate(dets):
        wh = d[:, 2:4] - d[:, 0:2]
        inside = (d[:, :2] >= 0).all(1) & (d[:, 2:4] <= size).all(1)
        d = d[inside & (wh >= 4).all(1) & (d[:, 4] > 0)][:per_image]
        cls = np.where(np.arange(len(d)) % 3 == 0, (d[:, 5] + 1) % spec.nc,
                       d[:, 5])
        wh = (d[:, 2:4] - d[:, 0:2]) / size
        cxy = (d[:, 0:2] + d[:, 2:4]) / 2 / size + rng.normal(
            0, 0.01, (len(d), 2))
        lab = np.concatenate([cls[:, None], cxy, wh], 1)
        lab = np.concatenate([lab, [[1, 0.1, 0.1, 0.1, 0.1],
                                    [2, 0.9, 0.85, 0.15, 0.2]]])
        val.labels.append(lab.astype(np.float32))
        val.targets[i, :len(lab)] = lab
        val.masks[i, :len(lab)] = True


def scored(spec, weights, val, device, dtype, sync):
    """evaluate_map at TEST_IMG with the CLI's defaults on ``device`` in
    ``dtype``: (result, detections per image, (seconds, result,
    arguments) of each NMS call, seconds)."""
    from yolov7_tracker_tpu_torch.cli.test import evaluate_map
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    kept = []
    t0 = time.time()
    with recording(nms_mod, "nms", kept, sync=sync):
        res = evaluate_map(spec, weights, val, img=TEST_IMG, batch=8,
                           device=device, dtype=dtype)
    counts = np.concatenate([k[1][1].cpu().numpy() for k in kept])
    return res, counts, kept, time.time() - t0


def detector_test(variables, dev):
    """(d): cli/test.evaluate_map at 640 px over 16 seeded in-memory val
    images, the CLI's defaults (conf 0.001, iou 0.65, multi_label, top_k
    8192), of (b)'s EMA weights with the live BN statistics and of (b)'s
    calibrated starting weights, whose own detections label the val set
    (label_from_detections). After 12 steps at the warmup's bias LR the
    EMA model's running statistics trail its weights and its scores
    saturate; the starting weights give a mAP between 0 and 1. On the
    card in float32 (TF32 off): the time, and the NMS's ms and host syncs
    per batch. Card against CPU: in float32 the decoded rows of the two
    devices part (each is reported against the CPU's float64 rows), which
    reorders close scores, so the equalities run in float64 on both:
    detections per image equal, map50 / map / mp / mr within
    TEST_REL_TOL. The float32 CPU score of the starting weights is
    reported beside the card's."""
    import torch

    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    spec = zoo.get_spec("yolov7-w6", nc=80)
    val = MemoryDataset(TEST_IMAGES, TEST_IMG, seed=3)
    label_from_detections(val, spec, variables["start"], dev)
    keys = ("map50", "map", "mp", "mr")
    rec = {"img": TEST_IMG, "images": TEST_IMAGES}
    for weights in ("ema", "start"):
        w = variables[weights]
        card32, n32, kept, secs = scored(spec, w, val, dev, torch.float32,
                                         True)
        pred = kept[-1][2][0]
        prof = profile_ops(lambda: nms_mod.nms(pred, 0.001, 0.65,
                                               multi_label=True, top_k=8192))
        card64, n_card, _, _ = scored(spec, w, val, dev, torch.float64,
                                      False)
        cpu64, n_cpu, kept64, cpu_s = scored(spec, w, val, "cpu",
                                             torch.float64, False)
        truth = kept64[-1][2][0]

        def off(x):
            return float((x.cpu() - truth).abs().max() / truth.abs().max())

        assert np.array_equal(n_card, n_cpu), (n_card, n_cpu)
        for k in keys:
            a, b = card64[k], cpu64[k]
            assert abs(a - b) <= TEST_REL_TOL * max(abs(b), 1.0), (k, a, b)
        r = rec[weights] = {
            "card_float32": {k: card32[k] for k in keys},
            "card_float64": {k: card64[k] for k in keys},
            "cpu_float64": {k: cpu64[k] for k in keys},
            "dets_per_image": n_card.tolist(),
            "dets_per_image_float32": n32.tolist(),
            "decoded_card_float32_vs_cpu_float64": off(pred),
            "evaluate_map_s_card": secs, "evaluate_map_s_cpu64": cpu_s,
            "nms_ms_per_batch": [k[0] * 1e3 for k in kept],
            "nms_host_syncs_per_batch": prof.get("syncs"),
            "nms_profile_wall_ms": prof.get("wall_ms")}
        if weights == "start":
            cpu32, _, kept32, _ = scored(spec, w, val, "cpu", torch.float32,
                                         False)
            r["cpu_float32"] = {k: cpu32[k] for k in keys}
            r["decoded_cpu_float32_vs_cpu_float64"] = off(kept32[-1][2][0])
        log(f"phase 10d: evaluate_map w6 @{TEST_IMG}, {weights} weights: "
            f"float64 card {r['card_float64']} == CPU {r['cpu_float64']}, "
            f"detections per image {r['dets_per_image']}; float32 card "
            f"{r['card_float32']}"
            + (f", CPU {r['cpu_float32']}" if "cpu_float32" in r else "")
            + f" (decoded rows off the CPU's float64: card "
            f"{r['decoded_card_float32_vs_cpu_float64']:.2e}"
            + (f", CPU {r['decoded_cpu_float32_vs_cpu_float64']:.2e}"
               if "cpu_float32" in r else "") + ")"
            + f"; {secs:.2f} s on the card, NMS {r['nms_ms_per_batch']} ms "
            f"a batch with {r['nms_host_syncs_per_batch']} host syncs")
    assert 0 < rec["start"]["card_float64"]["map"] < 1, rec["start"]
    return rec


def train_tiny(dev):
    """(e): the CLI's default model, yolov7-tiny (IDetect, SimOTA,
    hyp.scratch.tiny), at 640 px, batch 32, bf16, 6 batches of the
    in-memory dataset through train_loop."""
    from yolov7_tracker_tpu_torch.cli import train as train_cli

    data = MemoryDataset(TINY_BATCH * TINY_BATCHES, TINY_IMG, seed=4)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tiny_")
    opts = train_opts("yolov7-tiny", TINY_IMG, TINY_BATCH, ckpt_dir,
                      "data/hyp.scratch.tiny.yaml")
    try:
        with train_instruments() as ins:
            train_cli.train_loop(opts, {"nc": 80}, data,
                                 {"requested": False})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps = ins["steps"]
    assert len(steps) == TINY_BATCHES
    assert all(np.isfinite(s["metrics"]["loss"]) for s in steps)
    ms = float(np.median([s["ms"] for s in steps[1:]]))
    parts = {k: float(np.median([s["parts"].get(k, 0.0) for s in steps[1:]]))
             for k in ("forward", "simota", "loss_terms", "backward",
                       "optimizer_ema")}
    rec = {"model": "yolov7-tiny", "img": TINY_IMG, "batch": TINY_BATCH,
           "step_ms": ms, "imgs_per_s": TINY_BATCH / ms * 1e3,
           "parts_ms": parts, "step_ms_all": [s["ms"] for s in steps]}
    log(f"phase 10e: yolov7-tiny @{TINY_IMG} batch {TINY_BATCH} bf16: "
        f"{ms:.1f} ms/step (median of steps 2-{TINY_BATCHES}), "
        f"{rec['imgs_per_s']:.1f} imgs/s, parts {parts}")
    return rec


def train_phase(dev):
    """Phase 10: (a) train-step parity card vs CPU, (b) the trainer at full
    width, (c) preempt and resume, (d) the detector test, (e) the CLI's
    default model. Returns its record."""
    import torch

    t0 = time.time()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = {"parity": train_parity(dev)}
        torch.cuda.empty_cache()
        rec["w6"], variables = train_full(dev)
        rec["preempt_resume"] = preempt_resume(dev)
        torch.cuda.empty_cache()
        rec["test"] = detector_test(variables, dev)
        torch.cuda.empty_cache()
        rec["tiny"] = train_tiny(dev)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["phase_s"] = time.time() - t0
    log(f"phase 10 {rec['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 11: the rest of training (the IBin head and its SigmoidBin loss,
# the rank losses, the DHN trainer)
# ---------------------------------------------------------------------------

# (a): the zoo's yolov7 rows with the head kind IBin, calibrated as phase
# 9 calibrates yolov7 (its spread and boost)
IBIN_RUN = ("yolov7", 14.0, -34.0)
# (a): a decoded w or h may take another bin on the card than on the CPU
# only where the CPU's two best sigmoided bin values lie this close
IBIN_TIE = 1e-4
# (a): decoded objectness and class scores (0 to 1), card vs CPU, absolute
IBIN_SCORE_TOL = 1e-3
BIN_PARITY_IMG, BIN_PARITY_BATCH = 320, 2     # (b) card vs CPU (float64 net)
BIN_REL_TOL = 1e-4            # (b): loss parts relative, gradients of the max
BIN_TIME_IMG, BIN_TIME_BATCH = 640, 16        # (b) timing, bf16 autocast
BIN_TIME_WARMUP, BIN_TIME_STEPS = 2, 6
RANK_N = 80 * 80 + 40 * 40 + 20 * 20          # (c): a 640 px image's anchors
RANK_POS = 0.15
RANK_TOL = 1e-5               # (c): of the largest value and gradient
# (d): (arch, hidden): the GRU at the reference's width, and Sinkhorn
DHN_TRAIN_RUNS = (("gru", 256), ("sinkhorn", 256))
DHN_TRAIN_SIZE, DHN_TRAIN_BATCH, DHN_TRAIN_STEPS = 16, 8, 200
DHN_PARITY_TOL = 1e-6         # (d): first step card vs CPU, float64


def ibin_spec(nc=80):
    """yolov7's rows with the last row's head kind set to IBin (how the
    reference's IBin models are made from an IDetect cfg), through
    parse_yaml_cfg."""
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg

    rows = zoo.yolov7_rows()
    f, n, _, args = rows[-1]
    rows[-1] = [f, n, "IBin", args]
    return parse_yaml_cfg({"nc": nc, "depth_multiple": 1.0,
                           "width_multiple": 1.0, "anchors": zoo.ANCHORS_P5,
                           "backbone": rows, "head": []},
                          name="yolov7", nc=nc)


def event_ms(fn):
    """fn() timed by CUDA events around it; returns (result, ms)."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def ibin_decode_check(spec, card_raw, cpu_raw, bf16_raw):
    """IBin's decoded output (models/yolo.decode_levels) of the float32
    fused detector on the card against the CPU's: xy within ZOO_REL_TOL of
    max(1, its largest), w and h too where both took the same bin; where
    the bins differ the CPU's two best sigmoided bin values must lie within
    IBIN_TIE (a near tie). The objectness and class scores (0 to 1) must
    differ by at most IBIN_SCORE_TOL, and the bf16 detector's (the
    control) by more."""
    import torch

    from yolov7_tracker_tpu_torch.models.yolo import decode_levels, obj_index

    a, b, c = (decode_levels(r, spec) for r in (card_raw, cpu_raw, bf16_raw))
    n_bin = (obj_index(spec) - 2) // 2
    flat = [torch.cat([r.reshape(r.shape[0], -1, spec.no) for r in raw], 1)
            for raw in (card_raw, cpu_raw)]
    same = torch.ones(a.shape[:2], dtype=torch.bool)
    flips, far = 0, 0
    for k in (0, 1):
        bins = slice(3 + k * n_bin, 2 + (k + 1) * n_bin)
        ia, ib = (torch.sigmoid(f[..., bins]).argmax(-1) for f in flat)
        top2 = torch.sigmoid(flat[1][..., bins].double()).topk(2).values
        gap = top2[..., 0] - top2[..., 1]
        differ = ia != ib
        flips += int(differ.sum())
        far += int((differ & (gap > IBIN_TIE)).sum())
        same &= ~differ

    def rel(x, y):
        return float((x - y).abs().max()) / max(1.0, float(y.abs().max()))

    def diff(x, y):
        return float((x - y).abs().max())

    res = {"xy": rel(a[..., :2], b[..., :2]),
           "wh_same_bins": rel(a[..., 2:4][same], b[..., 2:4][same]),
           "obj": diff(a[..., 4], b[..., 4]),
           "cls": diff(a[..., 5:], b[..., 5:]),
           "obj_bf16": diff(c[..., 4], b[..., 4]),
           "cls_bf16": diff(c[..., 5:], b[..., 5:]),
           "score_tol": IBIN_SCORE_TOL,
           "bin_flips": flips, "bin_flips_not_near_tie": far,
           "decodes": 2 * same.numel()}
    if not (max(res["xy"], res["wh_same_bins"]) <= ZOO_REL_TOL and far == 0
            and max(res["obj"], res["cls"]) <= IBIN_SCORE_TOL
            and max(res["obj_bf16"], res["cls_bf16"]) > IBIN_SCORE_TOL):
        raise AssertionError(f"IBin decode card vs CPU: {res}")
    return res


def ibin_weights(spec):
    """Seeded weights of an IBin model (random_state_dict) with IDetect's
    bias prior at IBin's objectness and class slots (init_head_biases
    leaves IBin without one, as JAX does), so that phase 9's spread and
    boost spread its scores as they spread the IDetect yolov7's."""
    import math

    from yolov7_tracker_tpu_torch.models.yolo import (obj_index,
                                                      random_state_dict)

    sd = random_state_dict(spec, seed=0)
    o = obj_index(spec)
    for i, s in enumerate(spec.strides):
        b = sd[f"head_m_{i}.bias"].view(spec.na, spec.no)
        b[:, o] += math.log(8.0 / (640.0 / float(s)) ** 2)
        b[:, o + 1:] += math.log(0.6 / (spec.nc - 0.99))
    return sd


def ibin_tracking(dev):
    """(a): an IBin-headed yolov7 at full width (ibin_weights) through
    phase 9's run."""
    import torch

    name, spread, boost = IBIN_RUN
    spec = ibin_spec()
    sd = ibin_weights(spec)
    keep = {}
    t0 = time.time()
    rec = zoo_run(name, spread, boost, offline_frames(), dev, spec=spec,
                  keep=keep, weights=sd)
    rec["decode_card_vs_cpu"] = ibin_decode_check(
        spec, keep["card"], keep["cpu"], keep["bf16"])
    rec["phase_s"] = time.time() - t0
    log(f"phase 11a: IBin yolov7 decoded output, float32 card vs CPU "
        f"{rec['decode_card_vs_cpu']}")
    torch.cuda.empty_cache()
    return rec


def bin_loss_parity(dev):
    """(b), parity: the IBin yolov7 at full width, 320 px, batch 2, in
    training mode, its network (forward and backward) in float64 on the
    card and on the CPU from one seeded state and inputs made on the host;
    compute_loss_bin_ota runs on its preds cast to float32 (as the train
    steps do), so SimOTA and the loss terms run in float32. Checked: the
    same SimOTA assignments (a difference only at a printed near-tie), the
    loss parts within BIN_REL_TOL relative and every parameter's gradient
    within BIN_REL_TOL of its tensor's largest. The control is the card's
    run with its preds rounded to bf16 before the loss: it must land above
    BIN_REL_TOL in the loss parts or the gradients."""
    import torch

    from yolov7_tracker_tpu_torch.models.yolo import YoloV7
    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    spec = ibin_spec()
    sd = parity_weights(spec)
    data = MemoryDataset(BIN_PARITY_BATCH, BIN_PARITY_IMG, seed=5)
    x, t, m = to_input(next(data.batches(BIN_PARITY_BATCH)),
                       torch.device("cpu"))
    runs = {}
    for key, device, stage in (("card", dev, torch.float32),
                               ("cpu", torch.device("cpu"), torch.float32),
                               ("bf16_loss", dev, torch.bfloat16)):
        model = YoloV7(spec, fused=False)
        model.load_state_dict(sd)
        model = model.to(device, torch.float64).train()
        kept = []
        t0 = time.time()
        with keeping_calls(loss_mod, "simota_assign", kept):
            preds = model(x.to(device, torch.float64), training=True)
            loss, parts = loss_mod.compute_loss_bin_ota(
                [p.to(stage).float() for p in preds], t.to(device),
                m.to(device), spec, BIN_PARITY_IMG)
        loss.backward()
        runs[key] = {"parts": {k: float(v.detach())
                               for k, v in parts.items()},
                     "kept": [on_host(k) for k in kept],
                     "grads": {n: p.grad.cpu()
                               for n, p in model.named_parameters()},
                     "s": time.time() - t0}
        del model, preds, loss
    cpu = runs["cpu"]

    def against_cpu(run):
        loss_rel = max(abs(run["parts"][k] - v) / abs(v)
                       for k, v in cpu["parts"].items())
        worst, at = 0.0, ""
        for n, g in cpu["grads"].items():
            scale = float(g.abs().max())
            r = (float((run["grads"][n] - g).abs().max()) / scale
                 if scale else 0.0)
            if r > worst:
                worst, at = r, n
        return loss_rel, worst, at

    card = runs["card"]
    diffs = assignment_check(card["kept"][0], cpu["kept"][0], "IBin lead",
                             phase="11b")
    loss_rel, worst, at = against_cpu(card)
    ctl_loss, ctl_grad, ctl_at = against_cpu(runs["bf16_loss"])
    n_zero = sum(not bool(g.abs().max() > 0) for g in cpu["grads"].values())
    rec = {"img": BIN_PARITY_IMG, "batch": BIN_PARITY_BATCH,
           "loss_card": card["parts"], "loss_cpu": cpu["parts"],
           "loss_worst_rel": loss_rel, "grad_worst_rel": worst,
           "grad_worst_at": at, "params": len(cpu["grads"]),
           "params_without_gradient": n_zero,
           "matched_slots": int(cpu["kept"][0][2]["matched"].sum()),
           "assignment_differences": diffs,
           "control_bf16_loss": {"loss_worst_rel": ctl_loss,
                                 "grad_worst_rel": ctl_grad,
                                 "grad_worst_at": ctl_at},
           "card_s": card["s"], "cpu_s": cpu["s"]}
    log(f"phase 11b: IBin yolov7 @{BIN_PARITY_IMG} batch {BIN_PARITY_BATCH}, "
        f"float64 network, float32 loss stage, card vs CPU: losses "
        f"{card['parts']} / {cpu['parts']} ({loss_rel:.2e}); "
        f"{rec['matched_slots']} matched slots, assignment differences "
        f"(slots, not at a near-tie) {diffs}; gradients {worst:.2e} of the "
        f"tensor's max ({at}), {n_zero} of {len(cpu['grads'])} parameters "
        f"without gradient; control (preds rounded to bf16 before the "
        f"loss): losses {ctl_loss:.2e}, gradients {ctl_grad:.2e} ({ctl_at})")
    assert diffs[1] == 0, diffs
    assert loss_rel <= BIN_REL_TOL, (card["parts"], cpu["parts"])
    assert worst <= BIN_REL_TOL, (worst, at)
    assert max(ctl_loss, ctl_grad) > BIN_REL_TOL, rec["control_bf16_loss"]
    assert rec["matched_slots"] > 0
    return rec


def loss_step_timing(spec, loss_fn, dev):
    """Forward (training mode, bf16 autocast) + ``loss_fn`` + backward of
    ``spec`` at BIN_TIME_IMG, batch BIN_TIME_BATCH, on one seeded batch:
    the median of BIN_TIME_STEPS after BIN_TIME_WARMUP, its parts by CUDA
    events (forward, SimOTA, the loss terms, backward), the peak memory,
    and the host syncs inside the loss (set_sync_debug_mode("warn")'s
    warnings, counted on the last step)."""
    import warnings

    import torch

    from yolov7_tracker_tpu_torch.models.yolo import YoloV7, random_state_dict
    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    model = YoloV7(spec, fused=False)
    model.load_state_dict(random_state_dict(spec, seed=0))
    model = model.to(dev).train()
    data = MemoryDataset(BIN_TIME_BATCH, BIN_TIME_IMG, seed=6)
    x, t, m = to_input(next(data.batches(BIN_TIME_BATCH)), dev)
    simota = loss_mod.simota_assign
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(BIN_TIME_WARMUP + BIN_TIME_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        sim = []

        def timed_simota(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = simota(*a, **kw)
            e.record()
            sim.append((s, e))
            return out

        last = i == BIN_TIME_WARMUP + BIN_TIME_STEPS - 1
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.time()
        ev[0].record()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            preds = model(x, training=True)
        ev[1].record()
        loss_mod.simota_assign = timed_simota
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if last:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    loss, parts = loss_fn([p.float() for p in preds], t, m,
                                          spec, BIN_TIME_IMG)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        finally:
            loss_mod.simota_assign = simota
        ev[2].record()
        loss.backward()
        ev[3].record()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        s_ms = sum(s.elapsed_time(e) for s, e in sim)
        steps.append({"ms": wall, "forward": ev[0].elapsed_time(ev[1]),
                      "simota": s_ms,
                      "loss_terms": ev[1].elapsed_time(ev[2]) - s_ms,
                      "backward": ev[2].elapsed_time(ev[3]),
                      "loss": float(loss)})
        if last:
            syncs = sum("synchroniz" in str(w.message) for w in caught)
        del preds, loss, parts
    timed = steps[BIN_TIME_WARMUP:]
    rec = {k: float(np.median([s[k] for s in timed]))
           for k in ("ms", "forward", "simota", "loss_terms", "backward")}
    rec.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               loss_syncs=syncs, losses=[s["loss"] for s in steps],
               ms_all=[s["ms"] for s in steps])
    assert all(np.isfinite(s["loss"]) for s in steps), rec["losses"]
    del model
    torch.cuda.empty_cache()
    return rec


def bin_loss_timing(dev):
    """(b), timing: the IBin yolov7 through compute_loss_bin_ota and, beside
    it, the IDetect yolov7 through compute_loss_ota (loss_step_timing)."""
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    rec = {"img": BIN_TIME_IMG, "batch": BIN_TIME_BATCH}
    for key, head, spec, fn in (
            ("ibin_bin_ota", "IBin", ibin_spec(),
             loss_mod.compute_loss_bin_ota),
            ("idetect_ota", "IDetect", zoo.get_spec("yolov7", nc=80),
             loss_mod.compute_loss_ota)):
        rec[key] = loss_step_timing(spec, fn, dev)
        log(f"phase 11b: yolov7 ({head}) @{BIN_TIME_IMG} batch "
            f"{BIN_TIME_BATCH}, bf16 autocast, forward + {fn.__name__} + "
            f"backward on {card_line()}: {rec[key]['ms']:.1f} ms (median of "
            f"{BIN_TIME_STEPS}), forward {rec[key]['forward']:.1f}, SimOTA "
            f"{rec[key]['simota']:.1f}, loss terms "
            f"{rec[key]['loss_terms']:.1f}, backward "
            f"{rec[key]['backward']:.1f} ms; peak "
            f"{rec[key]['peak_gib']:.2f} GiB; {rec[key]['loss_syncs']} host "
            f"syncs in the loss")
    return rec


def rank_inputs(loss, seed=0):
    """(c): seeded (RANK_N,) float32 logits, targets with about RANK_POS
    positives (RankSort: IoUs in (0.5, 1]; aLRP and AP: 1), valid, and
    aLRP's regression losses."""
    import torch

    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, RANK_N).astype(np.float32)
    pos = rng.uniform(0, 1, RANK_N) < RANK_POS
    t = np.zeros(RANK_N, np.float32)
    t[pos] = (rng.uniform(0.5, 1.0, pos.sum()) if loss == "rank_sort"
              else 1.0)
    valid = rng.uniform(0, 1, RANK_N) < 0.95
    reg = rng.uniform(0, 1, RANK_N).astype(np.float32)
    return [torch.from_numpy(v) for v in (logits, t, valid, reg)]


def rank_loss_run(loss, inputs):
    """Forward + backward of one rank loss on its inputs' device:
    (outputs, the logits' gradient)."""
    from yolov7_tracker_tpu_torch.train import rank_losses as rl

    logits, t, valid, reg = inputs
    logits = logits.detach().clone().requires_grad_(True)
    if loss == "rank_sort":
        out = rl.rank_sort_loss(logits, t, valid)
    elif loss == "alrp":
        out = rl.alrp_loss(logits, t, reg, valid)
    else:
        out = (rl.ap_loss(logits, t, valid),)
    out[0].backward()
    return [o.detach() for o in out], logits.grad


def rank_losses_phase(dev):
    """(c): RankSort, aLRP and AP at N = RANK_N with about RANK_POS
    positives: forward + backward on the card against the CPU (float32,
    within RANK_TOL of the largest value and gradient), ms by CUDA events
    (median of 5 after a warm-up), the peak memory of one call."""
    import torch

    rec = {"n": RANK_N}
    for loss in ("rank_sort", "alrp", "ap"):
        inputs = rank_inputs(loss)
        cpu_out, cpu_g = rank_loss_run(loss, inputs)
        inputs = [v.to(dev) for v in inputs]
        rank_loss_run(loss, inputs)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(5):
            (out, g), ms = event_ms(lambda: rank_loss_run(loss, inputs))
            times.append(ms)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        val_err = max(float((a.cpu() - b).abs().max())
                      / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(out, cpu_out))
        g_err = float((g.cpu() - cpu_g).abs().max()) / float(
            cpu_g.abs().max())
        rec[loss] = {"ms": float(np.median(times)), "ms_all": times,
                     "peak_gib": peak, "value_rel": val_err,
                     "grad_rel": g_err,
                     "positives": int((inputs[1] > 0).sum().cpu()),
                     "values": [float(o.flatten()[0]) for o in cpu_out]}
        log(f"phase 11c: {loss} at N = {RANK_N} on {card_line()}: "
            f"forward + backward {rec[loss]['ms']:.2f} ms (median of 5), "
            f"peak {peak:.2f} GiB above the inputs; card vs CPU values "
            f"{val_err:.2e}, gradients {g_err:.2e} of the largest")
        assert val_err <= RANK_TOL and g_err <= RANK_TOL, rec[loss]
    return rec


@contextlib.contextmanager
def dhn_train_instruments():
    """For the block, train/dhn_train's loop is timed by parts: problem
    generation (sample_batch, host clock), the batch's H2D (batch_to) and
    the device step (train_step), both by CUDA events. Yields the lists
    of each step's ms and its loss (device tensors)."""
    import torch

    from yolov7_tracker_tpu_torch.train import dhn_train as dt

    out = {"gen": [], "h2d": [], "step": [], "loss": []}
    saved = dt.sample_batch, dt.batch_to, dt.train_step
    events = []

    def sample_batch(*a, **kw):
        t0 = time.perf_counter()
        r = saved[0](*a, **kw)
        out["gen"].append((time.perf_counter() - t0) * 1e3)
        return r

    def evented(key, fn):
        def wrapped(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = fn(*a, **kw)
            e.record()
            events.append((key, s, e))
            if key == "step":
                out["loss"].append(r)
            return r
        return wrapped

    dt.sample_batch = sample_batch
    dt.batch_to = evented("h2d", saved[1])
    dt.train_step = evented("step", saved[2])
    try:
        yield out
    finally:
        dt.sample_batch, dt.batch_to, dt.train_step = saved
        torch.cuda.synchronize()
        for key, s, e in events:
            out[key].append(s.elapsed_time(e))


def dhn_first_step_parity(arch, hidden, dev):
    """(d): the first train step of the seeded DHN on the card against the
    CPU in float64: the loss within DHN_PARITY_TOL relative and every
    gradient within DHN_PARITY_TOL of its tensor's largest."""
    import torch

    from yolov7_tracker_tpu_torch.reid.dhn import build_dhn
    from yolov7_tracker_tpu_torch.train import dhn_train as dt

    sd = dt.init_dhn(build_dhn(arch, hidden), seed=0).state_dict()
    d, y = dt.sample_batch(np.random.default_rng(0), DHN_TRAIN_SIZE,
                           DHN_TRAIN_SIZE, True, DHN_TRAIN_BATCH)
    runs = []
    for device in (dev, torch.device("cpu")):
        model, opt = dt.build_trainer(arch, hidden, device=device,
                                      state_dict=sd)
        model.double()
        dd, yy = (v.double() for v in dt.batch_to(device, d, y))
        loss = dt.train_step(model, opt, dd, yy)
        runs.append((float(loss), {n: p.grad.cpu()
                                   for n, p in model.named_parameters()}))
    (lc, gc), (lp, gp) = runs
    worst, at = 0.0, ""
    for n, g in gp.items():
        scale = float(g.abs().max())
        r = float((gc[n] - g).abs().max()) / scale if scale else 0.0
        if r > worst:
            worst, at = r, n
    rec = {"loss_card": lc, "loss_cpu": lp,
           "loss_rel": abs(lc - lp) / abs(lp), "grad_worst_rel": worst,
           "grad_worst_at": at}
    assert rec["loss_rel"] <= DHN_PARITY_TOL and worst <= DHN_PARITY_TOL, rec
    return rec


def dhn_deepmot_run(sd, dev, frames, path, arch, hidden):
    """The trained DHN file through deepmot (128 x 48) on phase 3's
    detector and frames: K4 twice a frame (reset just before the run, read
    just after), tracks on the frames."""
    import torch


    pipe = tracker_pipeline(sd, dev, dict(
        tracker="deepmot", det_capacity=48, dhn_weights=path,
        dhn_hidden=hidden, dhn_arch=arch), {})
    pipe.run_sequence(iter(frames[:8]))        # warm-up, not counted
    torch.cuda.synchronize()
    with counting() as got:
        t0 = time.time()
        results, slab = pipe.run_sequence_stateful(iter(frames))
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = got["launches.k4"]
    n = len(frames)
    tracks = [len(ids) for _, ids, _, _ in results]
    nms_through_k6(got, f"deepmot with the trained {arch} DHN",
                   -(-n // pipe.pcfg.detector_batch))
    if launches != 2 * n or max(tracks) < 1:
        raise AssertionError(f"deepmot with the trained {arch} DHN: "
                             f"{launches} K4 launches in {n} frames, tracks "
                             f"a frame {tracks}")
    return {"ms_per_frame": wall / n * 1e3, "k4_launches": launches,
            "tracks_per_frame_mean": float(np.mean(tracks)),
            "ids": int(slab.next_id)}


def dhn_train_phase(sd, dev):
    """(d): train_dhn on the card for each of DHN_TRAIN_RUNS (size 16,
    pad_train, batch 8, DHN_TRAIN_STEPS steps): the first step card
    against CPU in float64, ms a step by parts, eval_dhn on the result,
    the msgpack written and reloaded by load_dhn, and deepmot on it.
    Returns (record, {arch: K4 launches})."""
    import torch

    from yolov7_tracker_tpu_torch.reid.dhn import load_dhn
    from yolov7_tracker_tpu_torch.train import dhn_train as dt

    frames = offline_frames()
    rec, launches = {}, {}
    for arch, hidden in DHN_TRAIN_RUNS:
        name = f"{arch}_h{hidden}" if arch == "gru" else arch
        r = {"parity_first_step": dhn_first_step_parity(arch, hidden, dev)}
        torch.cuda.synchronize()
        t0 = time.time()
        with dhn_train_instruments() as ins:
            model = dt.train_dhn(DHN_TRAIN_STEPS, DHN_TRAIN_SIZE,
                                 DHN_TRAIN_SIZE, hidden=hidden, arch=arch,
                                 pad_train=True, batch=DHN_TRAIN_BATCH,
                                 log_every=0, device=dev)
            torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        losses = [float(v) for v in ins["loss"]]
        r.update(steps=DHN_TRAIN_STEPS, ms_per_step=wall / DHN_TRAIN_STEPS,
                 gen_ms=float(np.median(ins["gen"])),
                 h2d_ms=float(np.median(ins["h2d"])),
                 device_step_ms=float(np.median(ins["step"])),
                 loss_first=losses[0], loss_last=losses[-1],
                 loss_last10_mean=float(np.mean(losses[-10:])))
        assert all(np.isfinite(losses)) and r["loss_last10_mean"] < losses[0]
        t0 = time.time()
        r["eval"] = dt.eval_dhn(model, h=DHN_TRAIN_SIZE, w=DHN_TRAIN_SIZE,
                                pad_to=(DHN_TRAIN_SIZE, DHN_TRAIN_SIZE))
        r["eval_s"] = time.time() - t0
        os.makedirs(OUT_DIR, exist_ok=True)
        path = dt.save_dhn(os.path.join(OUT_DIR, f"dhn_trained_{name}"
                                                 ".msgpack"), model, arch)
        loaded = load_dhn(path, arch, hidden, dev)
        want = model.state_dict()
        assert all(torch.equal(v, want[k])
                   for k, v in loaded.state_dict().items())
        if arch == "gru":
            hh = [v for k, v in want.items() if "bias_hh" in k]
            assert not any(v[:2 * hidden].any() for v in hh)
        r["file_bytes"] = os.path.getsize(path)
        r["deepmot"] = dhn_deepmot_run(sd, dev, frames, path, arch, hidden)
        launches[name] = r["deepmot"]["k4_launches"]
        log(f"phase 11d: train_dhn {name} (size {DHN_TRAIN_SIZE}, pad_train, "
            f"batch {DHN_TRAIN_BATCH}) on {card_line()}: "
            f"{r['ms_per_step']:.2f} ms a step over {DHN_TRAIN_STEPS} steps "
            f"(medians: problems on the host {r['gen_ms']:.2f}, H2D "
            f"{r['h2d_ms']:.3f}, device step {r['device_step_ms']:.2f} ms); "
            f"loss {losses[0]:.4f} -> {r['loss_last10_mean']:.4f}; first "
            f"step card vs CPU float64 {r['parity_first_step']}; eval "
            f"{r['eval']}; {path} ({r['file_bytes']} bytes) reloaded; "
            f"deepmot 128 x 48 on it: {r['deepmot']}")
        rec[name] = r
        del model, loaded
        torch.cuda.empty_cache()
    return rec, launches


def train2_phase(dev, sd=None):
    """Phase 11: (a) the IBin head on the tracking path, (b) the bin loss,
    (c) the rank losses, (d) the DHN trainer. ``sd``: phase 3's detector
    weights (built here when not given). Returns (record, {path: K4
    launches})."""
    import torch

    t0 = time.time()
    if sd is None:
        sd, pipe = build_w6(dev)
        del pipe
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = {"ibin": ibin_tracking(dev)}
        rec["bin_loss_parity"] = bin_loss_parity(dev)
        torch.cuda.empty_cache()
        rec["bin_loss_timing"] = bin_loss_timing(dev)
        rec["rank_losses"] = rank_losses_phase(dev)
        torch.cuda.empty_cache()
        rec["dhn_train"], dhn_launches = dhn_train_phase(sd, dev)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["phase_s"] = time.time() - t0
    log(f"phase 11 {rec['phase_s']:.1f} s")
    return rec, {"ibin": rec["ibin"]["k4_launches"], **dhn_launches}


# ---------------------------------------------------------------------------
# phase 12: the last model-side modules -- int8 serving (models/quant.py,
# PipelineConfig.quant), TTA and ensembles, torch.export, the zoo's tail
# blocks and cli/detect.py's detection loop
# ---------------------------------------------------------------------------

INT8_FRAMES_CALIB = 4         # cli/track.py --quant int8's calibration
MODELS_IMG = 1280             # (b)-(d)
# (c): each member is phase 3's recipe (random_state_dict at
# DETECTOR_GAIN, sharpen_heads), as (b)'s w6. With phase 9's calibrated
# heads (spread 14) the decoded scores, compared absolutely (their largest
# is 1), carry the heads' gain on the body's float32 noise: 1.09e-4 card
# vs CPU on an H100, where the raw logits part by 1e-5.
DETECT_RUN = (14.0, -34.0)    # (f): ZOO_RUNS' yolov7 spread and boost
EXPORT_REL_TOL = 1e-6         # (d): exported program vs eager, each part
TAIL_IMG = 640                # (e)
DETECT_IMG = 640              # (f)
# (e): the JAX package's own test cfgs of the tail (tests/
# test_blocks_extended.py EXT_CFG, SWIN_CFG, OREPA_CFG, ROBUST_CFG), as
# rows; Foldcut on the channel axis as the JAX package runs it
TAIL_ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]]
TAIL_CFGS = {
    "ghost": (8, TAIL_ANCHORS, [
        [-1, 1, "Focus", [16, 3]], [-1, 1, "DWConv", [24, 3, 2]],
        [-1, 1, "GhostConv", [32, 1, 1]], [-1, 1, "Ghost", [32, 3, 1]],
        [-1, 2, "GhostCSPA", [32]], [-1, 1, "Conv", [48, 3, 2]],
        [-1, 2, "RepResCSPA", [48]], [-1, 1, "Contract", [2]],
        [-1, 1, "Conv", [64, 1, 1]], [-1, 2, "RepResCSPC", [64]],
        [-1, 1, "Expand", [2]], [-1, 1, "Conv", [32, 1, 1]],
        [-1, 1, "GhostSPPCSPC", [32]], [-1, 2, "GhostCSPB", [32]],
        [-2, 1, "Conv", [32, 1, 1]], [[-1, -2], 1, "Concat", [1]],
        [-1, 1, "RepResCSPB", [48]],
        [[16, 9], 1, "Detect", ["nc", "anchors"]]]),
    "swin": (4, TAIL_ANCHORS[:1], [
        [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
        [-1, 2, "STCSPA", [64]], [-1, 1, "Conv", [64, 3, 2]],
        [-1, 2, "ST2CSPC", [64]],
        [-1, 1, "SwinTransformerBlock", [64, 2, 2]],
        [-1, 1, "SwinTransformer2Block", [64, 2, 1]],
        [-1, 2, "STCSPB", [64]], [[7], 1, "Detect", ["nc", "anchors"]]]),
    "orepa": (4, TAIL_ANCHORS[:1], [
        [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "RepConv_OREPA", [32, 3, 1]],
        [-1, 1, "RepConv_OREPA", [64, 3, 2]], [-1, 1, "Conv", [64, 1, 1]],
        [[3], 1, "Detect", ["nc", "anchors"]]]),
    "robust": (4, TAIL_ANCHORS[:1], [
        [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "RobustConv", [32, 7, 1]],
        [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "RobustConv2", [32, 5, 2]],
        [[-1, -2], 1, "Chuncat", [1]], [-1, 1, "Foldcut", [1]],
        [-1, 1, "Conv", [64, 1, 1]], [[6], 1, "Detect", ["nc", "anchors"]]]),
}


def decoded_parts(y):
    """Decoded predictions (B, N, no) cut into xy, wh, objectness and
    class-score parts."""
    return [y[..., :2], y[..., 2:4], y[..., 4:5], y[..., 5:]]


def canvas_of(frames, size, spec, dev):
    """``frames`` letterboxed as TrackingPipeline does at img_size
    ``size``: (B, H, W, 3) float32 in [0, 1] on ``dev``."""
    import torch

    from yolov7_tracker_tpu_torch.data import letterbox

    src_hw = tuple(frames[0].shape[:2])
    _, (uw, uh), (dw, dh) = letterbox.letterbox_params(
        src_hw, (size, size), stride=max(spec.strides))
    out_hw = (uh + int(round(dh - 0.1)) + int(round(dh + 0.1)),
              uw + int(round(dw - 0.1)) + int(round(dw + 0.1)))
    img, _ = letterbox.device_preprocess(
        torch.from_numpy(np.stack(frames)).to(dev), src_hw, out_hw,
        unpad_hw=(uh, uw))
    return img.float()


def eval_model(spec, sd, dev, dtype, fused=True):
    """YoloV7 with ``sd`` loaded, on ``dev`` in ``dtype``, eval mode."""
    import torch

    from yolov7_tracker_tpu_torch.models.yolo import YoloV7

    model = YoloV7(spec, fused=fused)
    model.load_state_dict(sd)
    model = model.to(dev, dtype).eval()
    if torch.device(dev).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def int8_serving(dev, sd, pipe):
    """12a: phase 3's w6 (1088 px, batch 8) fused and quantized, calibrated
    on the first 4 frames as cli/track.py --quant int8 does, through
    offline ByteTrack (128 / 300) on phase 3's 16 frames."""
    import dataclasses

    import torch

    from yolov7_tracker_tpu_torch.cli.track import calibration_frames
    from yolov7_tracker_tpu_torch.models import quant
    from yolov7_tracker_tpu_torch.models.blocks import QuantConv
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import YoloV7, decoded
    from yolov7_tracker_tpu_torch.ops import auction
    from yolov7_tracker_tpu_torch.pipeline import TrackingPipeline
    from yolov7_tracker_tpu_torch.trackers import bytetrack
    from yolov7_tracker_tpu_torch.trackers import slab as S

    spec = pipe.spec
    frames = offline_frames()
    calib = calibration_frames(iter(frames), pipe.pcfg.img_size,
                               INT8_FRAMES_CALIB)
    t0 = time.time()
    qpipe = TrackingPipeline(
        dataclasses.replace(pipe.pcfg, quant="int8"),
        S.TrackerConfig(tracker="bytetrack", conf_thresh=0.5, capacity=128,
                        det_capacity=300),
        state_dict=sd, spec=spec, device=dev, quant_calib=calib)
    torch.cuda.synchronize()
    quantize_s = time.time() - t0
    # the int8 tree: the card's calibration again, then quantize_state_dict
    # on the host, equals the pipeline's buffers bit for bit; the CPU's
    # calibration of the same frames lands within float32 noise
    fused = fuse_state_dict(sd)
    absmax_card = quant.calibrate(spec, fused, calib, dev)
    t0 = time.time()
    absmax_cpu = quant.calibrate(spec, fused, calib, "cpu")
    cpu_calib_s = time.time() - t0
    tree = quant.quantize_state_dict(spec, fused, absmax=absmax_card)
    held = {k: v.cpu() for k, v in qpipe.model.state_dict().items()}
    unequal = [k for k, v in tree.items() if not torch.equal(held[k], v)]
    absmax_rel = max(abs(absmax_cpu[k] - v) / max(v, 1e-12)
                     for k, v in absmax_card.items())
    n_quant = sum(isinstance(m, QuantConv) for m in qpipe.model.modules())
    if unequal or sorted(absmax_card) != sorted(absmax_cpu):
        raise AssertionError(f"12a: int8 tree differs from the pipeline's "
                             f"in {unequal[:5]}")
    log(f"12a: {n_quant} convs quantized in {quantize_s:.1f} s (card "
        f"calibration on {INT8_FRAMES_CALIB} frames included); the int8 "
        f"tree re-made on the host equals the card's buffers bit for bit; "
        f"absmax CPU vs card max relative {absmax_rel:.2e} (CPU "
        f"calibration {cpu_calib_s:.1f} s)")

    t0 = time.time()
    qpipe.run_sequence(iter(frames[:8]))        # warm-up, not counted
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    batches, dets, slabs, solves = [], [], [], []
    detect, step = qpipe.detect_batch, qpipe.step
    solve = bytetrack.solve_assignment

    def recording_detect(frames_u8):
        out = detect(frames_u8)
        batches.append(tuple(t.clone() for t in out))
        return out

    def recording_step(slab, det, **kw):
        dets.append(S.DetSlab(*(x.clone() for x in det)))
        slabs.append(S.TrackSlab(*(x.clone() for x in slab)))
        return step(slab, det, **kw)

    def recording_solve(cost, rm, cm, th):
        solves.append((cost.float().clone(), rm.clone(), cm.clone(),
                       torch.as_tensor(th, dtype=torch.float32,
                                       device=cost.device).clone()))
        return solve(cost, rm, cm, th)

    qpipe.detect_batch, qpipe.step = recording_detect, recording_step
    torch.cuda.synchronize()
    t0 = time.time()
    with graph_calls(1) as calls, counting() as got:
        results, slab = qpipe.run_sequence_stateful(iter(frames))
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = got["launches.k4"]
    del qpipe.detect_batch
    qpipe.step = step
    # the last frame's problems: its step run again eagerly on the inputs
    # its graph had, the solver recorded
    bytetrack.solve_assignment = recording_solve
    try:
        rerun_eagerly(calls)
    finally:
        bytetrack.solve_assignment = solve
    n = len(frames)
    nms_through_k6(got, "12a", len(batches))
    counts = torch.cat([b[3] for b in batches]).float().cpu()
    tracks = [len(r[1]) for r in results]
    if launches != 2 * n or max(tracks) < 1 or not bool(torch.isfinite(
            torch.cat([b[0] for b in batches])).all()):
        raise AssertionError(f"12a: {launches} K4 launches in {n} frames, "
                             f"tracks a frame {tracks}")
    worst = compare(auction, solves[-2:], dev)
    if worst != 0:
        raise AssertionError("12a: K4 differs from its plain version on "
                             "the int8 path's last problems")
    f1 = np.stack(frames[8:])
    parts_q = breakdown(qpipe, f1, batches[-1], dev)
    parts_b = breakdown(pipe, f1, batches[-1], dev)

    # the int8 detector, card against CPU on the same letterboxed frame
    # (float32 input): each raw part within ZOO_REL_TOL of its largest
    img = letterboxed(qpipe, frames[:1], "cpu")
    cpu_model = YoloV7(spec, fused="int8")
    cpu_model.load_state_dict(held)
    cpu_model.eval()
    with torch.no_grad():
        card_out = [o.float().cpu() for o in qpipe.model(img.to(dev))]
        t0 = time.time()
        cpu_out = cpu_model(img)
        cpu_fwd_s = time.time() - t0
    hw = tuple(img.shape[1:3])
    card_vs_cpu = parts_rel(output_parts(card_out, spec, hw),
                            output_parts(cpu_out, spec, hw))
    if not card_vs_cpu <= ZOO_REL_TOL:
        q_flips(qpipe.model, cpu_model, img, dev)
        raise AssertionError(f"12a: int8 detector card vs CPU "
                             f"{card_vs_cpu:.3e} > {ZOO_REL_TOL}")
    t0 = time.time()
    replay_on_cpu(qpipe, dets, slabs, results, "int8")
    replay_s = time.time() - t0
    # int8 against the bf16 detector on phase 3's second batch
    img8 = letterboxed(qpipe, frames[8:], dev).to(torch.bfloat16)
    with torch.no_grad():
        y_q = decoded(qpipe.model, img8).double().cpu().numpy()
        y_b = decoded(pipe.model, img8).double().cpu().numpy()
    corr = float(np.corrcoef(y_q.ravel(), y_b.ravel())[0, 1])
    conf_diff = float(np.abs(y_q[..., 4] - y_b[..., 4]).max())
    rec = {"ms_per_frame": wall / n * 1e3, "frames": n,
           "img_size": pipe.pcfg.img_size, "quantized_convs": n_quant,
           "quantize_s": quantize_s, "warm_up_s": warm_s,
           "absmax_cpu_vs_card_rel": absmax_rel, "k4_launches": launches,
           "k4_path_max_abs_err": float(worst),
           "nms_survivors_per_frame": float(counts.mean()),
           "tracks_per_frame_mean": float(np.mean(tracks)),
           "ids": int(slab.next_id), "int8": parts_q, "bf16": parts_b,
           "card_vs_cpu": card_vs_cpu, "cpu_forward_s": cpu_fwd_s,
           "cpu_replay": "same ids, boxes 1e-2", "cpu_replay_s": replay_s,
           "int8_vs_bf16_corr": corr, "int8_vs_bf16_conf_max_abs": conf_diff}
    log(f"12a int8 w6 on {card_line()}: {wall / n * 1e3:.2f} ms/frame over "
        f"{n} frames, {launches} K4 launches (last two problems == plain), "
        f"NMS survivors/frame {float(counts.mean()):.1f}, tracks/frame "
        f"mean {np.mean(tracks):.1f}; detector {parts_q['detector_ms']:.2f}"
        f" ms/frame (bf16 {parts_b['detector_ms']:.2f}), NMS "
        f"{parts_q['nms_ms']:.2f} (bf16 {parts_b['nms_ms']:.2f}), step "
        f"{parts_q['step_ms']:.2f}; card vs CPU {card_vs_cpu:.2e} (float32 "
        f"input, tolerance {ZOO_REL_TOL}); CPU replay same ids; int8 vs "
        f"bf16 correlation {corr:.5f}, confidence max |diff| {conf_diff:.4f}")
    del qpipe, cpu_model
    return rec


def q_flips(card_model, cpu_model, img, dev):
    """Where the int8 model's card and CPU runs part: each QuantConv's
    quantized input on both, in the order the forward reaches them; logs
    the first convs with a different q (how many elements, the largest
    input difference) and whether the card's accumulation of the CPU's q
    equals the CPU's."""
    import torch

    from yolov7_tracker_tpu_torch.models.blocks import (QuantConv,
                                                        quant_accumulate)

    seen = {}

    def keep(model, key):
        hooks = []
        for name, m in model.named_modules():
            if isinstance(m, QuantConv):
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, args, name=name: seen.setdefault(
                        name, {}).__setitem__(
                        key, (args[0].float().cpu(),
                              mod.quantize(args[0]).cpu()))))
        return hooks

    hooks = keep(card_model, "card") + keep(cpu_model, "cpu")
    with torch.no_grad():
        card_model(img.to(dev))
        cpu_model(img)
    for h in hooks:
        h.remove()
    cpu_mods = dict(cpu_model.named_modules())
    shown = 0
    for name, runs in seen.items():
        (x1, q1), (x2, q2) = runs["card"], runs["cpu"]
        flips = int((q1 != q2).sum())
        if flips and shown < 4:
            m = cpu_mods[name]
            acc_card = quant_accumulate(q2.to(dev), m.weight.to(dev),
                                        m.stride, m.padding, m.groups).cpu()
            acc_cpu = quant_accumulate(q2, m.weight, m.stride, m.padding,
                                       m.groups)
            log(f"12a: {name}: q differs in {flips} of {q1.numel()} "
                f"elements, input max |card - CPU| "
                f"{float((x1 - x2).abs().max()):.3g}; the card's "
                f"accumulation of the CPU's q equals the CPU's: "
                f"{bool(torch.equal(acc_card, acc_cpu))}")
            shown += 1
    log(f"12a: {sum(int((r['card'][1] != r['cpu'][1]).any()) for r in seen.values())} "
        f"of {len(seen)} QuantConvs see a different q")


def tta_check(dev, sd, frames):
    """12b: forward_tta on the fused w6 at MODELS_IMG, batch 8, bf16, then
    NMS; one frame in float32 card against CPU, each part within
    ZOO_REL_TOL. Returns (record, the bf16 model, the canvas)."""
    import torch

    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.tta import forward_tta
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    spec = zoo.get_spec("yolov7-w6", nc=80)
    fused = fuse_state_dict(sd)
    img = canvas_of(frames, MODELS_IMG, spec, dev)
    model = eval_model(spec, fused, dev, torch.bfloat16)
    x = img.to(torch.bfloat16)
    with torch.no_grad():
        pred = forward_tta(model, x)
        dets, counts = nms_mod.nms(pred.float(), 0.01, 0.45, max_det=300)
        t_tta = cuda_ms(lambda: forward_tta(model, x), 3)
        t_nms = cuda_ms(lambda: nms_mod.nms(pred.float(), 0.01, 0.45,
                                            max_det=300), 2)
        outs = {}
        for d in (dev, "cpu"):
            m32 = eval_model(spec, fused, d, torch.float32)
            outs[d] = forward_tta(m32, img[:1].to(d)).cpu()
            del m32
    rel = parts_rel(decoded_parts(outs[dev]), decoded_parts(outs["cpu"]))
    b = img.shape[0]
    if not (rel <= ZOO_REL_TOL and bool(torch.isfinite(pred).all())):
        raise AssertionError(f"12b: TTA card vs CPU {rel:.3e}")
    rec = {"ms_per_frame": t_tta / b, "nms_ms_per_frame": t_nms / b,
           "candidates": int(pred.shape[1]), "canvas_hw": list(img.shape[1:3]),
           "nms_survivors_per_frame": float(counts.float().mean()),
           "card_vs_cpu": rel}
    log(f"12b TTA (w6, 3 scales x flips, {MODELS_IMG} px, batch {b}, "
        f"bf16) on {card_line()}: {t_tta / b:.2f} ms/frame, "
        f"{pred.shape[1]} candidates, NMS {t_nms / b:.2f} ms/frame "
        f"({float(counts.float().mean()):.1f} survivors); float32 card vs "
        f"CPU {rel:.2e}")
    return rec, model, img


def ensembles_check(dev, frames):
    """12c: two seeded yolov7 (nc 80, phase 3's recipe) at MODELS_IMG,
    batch 8, bf16, through ensemble_apply in each mode, then NMS; float32
    card against CPU on one frame."""
    import torch

    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import (ensemble_apply,
                                                      random_state_dict,
                                                      sharpen_heads)
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    spec = zoo.get_spec("yolov7", nc=80)
    img = canvas_of(frames, MODELS_IMG, spec, dev)
    weights = []
    for seed in (0, 1):
        sd = random_state_dict(spec, seed=seed, gain=DETECTOR_GAIN)
        sharpen_heads(sd, spec, seed=seed + 1)
        weights.append(fuse_state_dict(sd))
    members = [eval_model(spec, w, dev, torch.bfloat16) for w in weights]
    x = img.to(torch.bfloat16)
    rec = {}
    with torch.no_grad():
        for mode in ("nms", "mean", "max"):
            pred = ensemble_apply(members, x, mode)
            _, counts = nms_mod.nms(pred.float(), 0.01, 0.45, max_det=300)
            t = cuda_ms(lambda: ensemble_apply(members, x, mode), 3)
            t_nms = cuda_ms(lambda: nms_mod.nms(pred.float(), 0.01, 0.45,
                                                max_det=300), 2)
            rec[mode] = {"ms_per_frame": t / img.shape[0],
                         "nms_ms_per_frame": t_nms / img.shape[0],
                         "candidates": int(pred.shape[1]),
                         "nms_survivors_per_frame": float(
                             counts.float().mean())}
        for d in (dev, "cpu"):
            m32 = [eval_model(spec, w, d, torch.float32) for w in weights]
            for mode in rec:
                rec[mode][d if d == "cpu" else "card"] = ensemble_apply(
                    m32, img[:1].to(d), mode).cpu()
            del m32
    for mode, r in rec.items():
        r["card_vs_cpu"] = parts_rel(decoded_parts(r.pop("card")),
                                     decoded_parts(r.pop("cpu")))
        if not r["card_vs_cpu"] <= ZOO_REL_TOL:
            raise AssertionError(f"12c: ensemble {mode} card vs CPU "
                                 f"{r['card_vs_cpu']:.3e}")
    log(f"12c ensembles (2 x yolov7, {MODELS_IMG} px, batch "
        f"{img.shape[0]}, bf16) on {card_line()}: " + ", ".join(
            f"{m} {r['ms_per_frame']:.2f} ms/frame + NMS "
            f"{r['nms_ms_per_frame']:.2f} ({r['nms_survivors_per_frame']:.1f}"
            f" survivors), card vs CPU {r['card_vs_cpu']:.2e}"
            for m, r in rec.items()))
    del members
    return rec


def export_check(model, img):
    """12d: torch.export of the fused bf16 w6 at MODELS_IMG, batch 8,
    saved and loaded back; the program against the eager module on the
    card, each decoded part within EXPORT_REL_TOL; the stats."""
    import torch

    from yolov7_tracker_tpu_torch.models import export
    from yolov7_tracker_tpu_torch.models.yolo import decoded

    x = img.to(torch.bfloat16)
    hw = tuple(img.shape[1:3])
    tmp = tempfile.mkdtemp(prefix="export_")
    try:
        t0 = time.time()
        path = export.export_program(model, hw, os.path.join(tmp, "w6.pt2"),
                                     batch=x.shape[0], dtype=torch.bfloat16)
        export_s = time.time() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.time()
        program = export.load_program(path)
        load_s = time.time() - t0
        with torch.no_grad():
            got = program(x)
            want = decoded(model, x)
            t_prog = cuda_ms(lambda: program(x), 3)
            t_eager = cuda_ms(lambda: decoded(model, x), 3)
        stats = export.export_compiled_stats(model, hw, x.shape[0],
                                             torch.bfloat16)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = float((got.float() - want.float()).abs().max())
    rel = parts_rel(decoded_parts(got), decoded_parts(want))
    if not rel <= EXPORT_REL_TOL:
        raise AssertionError(f"12d: exported program vs eager {rel:.3e}")
    rec = {"export_s": export_s, "load_s": load_s, "file_mb": size_mb,
           "max_abs_diff": diff, "rel": rel,
           "program_ms_per_frame": t_prog / x.shape[0],
           "eager_ms_per_frame": t_eager / x.shape[0], **stats}
    log(f"12d export (fused w6, {MODELS_IMG} px, batch {x.shape[0]}, bf16) "
        f"on {card_line()}: torch.export + save {export_s:.1f} s "
        f"({size_mb:.0f} MB), load {load_s:.1f} s; program vs eager max "
        f"|diff| {diff:.3g} (relative {rel:.2e}); program "
        f"{t_prog / x.shape[0]:.2f} ms/frame, eager "
        f"{t_eager / x.shape[0]:.2f}; flops {stats['flops']:.4g}, "
        f"memory {stats['memory_mb']:.1f} MB")
    return rec


def tail_check(dev, frames):
    """12e: the JAX package's tail test cfgs at TAIL_IMG, batch 8, seeded
    weights: float32 (TF32 off) card against CPU and fused against
    unfused on the card, each raw part within ZOO_REL_TOL; the fused bf16
    forward timed."""
    import torch

    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
    from yolov7_tracker_tpu_torch.models.yolo import random_state_dict

    rec = {}
    for name, (nc, anchors, rows) in TAIL_CFGS.items():
        spec = parse_yaml_cfg({"nc": nc, "depth_multiple": 1.0,
                               "width_multiple": 1.0, "anchors": anchors,
                               "backbone": rows, "head": []}, name=name)
        img = canvas_of(frames, TAIL_IMG, spec, "cpu")
        sd = random_state_dict(spec, seed=0)
        fused = fuse_state_dict(sd)
        hw = tuple(img.shape[1:3])
        outs = {}
        t0 = time.time()
        with torch.no_grad():
            for key, d, state, f in (("card", dev, fused, True),
                                     ("cpu", "cpu", fused, True),
                                     ("unfused", dev, sd, False)):
                out = eval_model(spec, state, d, torch.float32, f)(
                    img.to(d))
                outs[key] = output_parts([o.cpu() for o in out], spec, hw)
            m16 = eval_model(spec, fused, dev, torch.bfloat16)
            x16 = img.to(dev, torch.bfloat16)
            t16 = cuda_ms(lambda: m16(x16), 3)
        r = {"card_vs_cpu": parts_rel(outs["card"], outs["cpu"]),
             "fused_vs_unfused": parts_rel(outs["card"], outs["unfused"]),
             "largest_part": max(float(p.abs().max()) for p in outs["cpu"]),
             "bf16_ms_per_frame": t16 / img.shape[0],
             "check_s": time.time() - t0}
        rec[name] = r
        if not (r["card_vs_cpu"] <= ZOO_REL_TOL
                and r["fused_vs_unfused"] <= ZOO_REL_TOL
                and all(bool(torch.isfinite(p).all()) for p in outs["card"])):
            raise AssertionError(f"12e: {name} {r}")
    log(f"12e tail cfgs ({TAIL_IMG} px, batch {len(frames)}) on "
        f"{card_line()}: " + ", ".join(
            f"{n} card vs CPU {r['card_vs_cpu']:.2e}, fused vs unfused "
            f"{r['fused_vs_unfused']:.2e}, bf16 {r['bf16_ms_per_frame']:.2f} "
            f"ms/frame" for n, r in rec.items()))
    return rec


def detect_check(dev, frames):
    """12f: cli/detect.py's loop (detect_images) on 16 in-memory 1080x1920
    frames with yolov7 (nc 80) at DETECT_IMG, float32, its seeded weights
    calibrated on the frames as in phase 9 (DETECT_RUN) and read from a
    file as --weights takes it: the card against --device cpu, the same
    counts and classes, the boxes before the loop rounds them to whole
    pixels (post_process_v7's round) within ZOO_REL_TOL of the frame's
    largest coordinate, as phase 9 holds a detector's parts, and the
    rounded boxes equal but where a coordinate sits that close to a half
    pixel. (1e-3 px would ask 5e-7 of a 1920 px frame, below the float32
    noise of yolov7's body: an H100 read 7.9e-3 px against the CPU.)"""
    import torch

    from yolov7_tracker_tpu_torch.cli import detect
    from yolov7_tracker_tpu_torch.data import letterbox
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import random_state_dict

    spec = zoo.get_spec("yolov7", nc=80)
    img = canvas_of(frames[:8], DETECT_IMG, spec, dev)
    weights = standardize_heads(
        spec, calibrate_detector_bn(spec, random_state_dict(spec, seed=0),
                                    img, ZOO_BN_SCALE), img, *DETECT_RUN)
    del img
    tmp = tempfile.mkdtemp(prefix="detect_")
    try:
        path = os.path.join(tmp, "yolov7.pt")
        torch.save(weights, path)
        runs, secs, unrounded = {}, {}, {}
        scale = letterbox.scale_coords_device

        def keeping(coords, img1_hw, img0_hw, do_round=True):
            kept.append(scale(coords, img1_hw, img0_hw, do_round=False))
            return scale(coords, img1_hw, img0_hw, do_round)

        for d in (str(dev), "cpu"):
            pipe = detect.build_pipeline(detect.parse_args([
                "--source", tmp, "--model", "yolov7", "--weights", path,
                "--img_size", str(DETECT_IMG), "--dtype", "float32",
                "--device", d]))
            list(detect.detect_images(pipe, frames[:1]))     # warm-up
            kept = []
            letterbox.scale_coords_device = keeping
            try:
                t0 = time.time()
                runs[d] = list(detect.detect_images(pipe, frames))
                secs[d] = time.time() - t0
            finally:
                letterbox.scale_coords_device = scale
            unrounded[d] = [k[0].cpu().numpy() for k in kept]
            del pipe
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from scipy.optimize import linear_sum_assignment

    worst, worst_rel, at_ties, reordered = 0.0, 0.0, 0, 0
    for k, ((b1, s1, c1, n1), (b2, s2, c2, n2)) in enumerate(
            zip(runs[str(dev)], runs["cpu"])):
        if n1 != n2 or sorted(c1) != sorted(c2):
            raise AssertionError(f"12f: card {n1} detections, CPU {n2}")
        u1, u2 = unrounded[str(dev)][k][:n1], unrounded["cpu"][k][:n1]
        # NMS lists by score: two boxes whose scores tie within float32
        # noise may come in either order, so pair the card's with the
        # CPU's (same class, nearest box)
        dist = np.abs(u1[:, None] - u2[None]).max(-1) + 1e9 * (
            c1[:, None] != c2[None])
        rows, cols = linear_sum_assignment(dist)
        reordered += int((rows != cols).sum())
        tol = ZOO_REL_TOL * max(1.0, float(np.abs(u2).max(initial=0.0)))
        far = float(dist[rows, cols].max(initial=0.0))
        worst = max(worst, far)
        worst_rel = max(worst_rel, far * ZOO_REL_TOL / tol)
        off = b1[rows] != b2[cols]
        at_ties += int(off.sum())
        frac = np.abs(u2[cols][off] - np.floor(u2[cols][off]))
        if far > tol or (np.abs(frac - 0.5) > tol).any():
            raise AssertionError(
                f"12f: frame {k}: boxes {far:.3g} px apart, or rounded "
                f"apart away from a half pixel: card {b1[rows][off.any(1)].tolist()} "
                f"{u1[rows][off.any(1)].tolist()}, CPU "
                f"{b2[cols][off.any(1)].tolist()} "
                f"{u2[cols][off.any(1)].tolist()}")
    counts = [r[3] for r in runs[str(dev)]]
    if sum(counts) == 0:
        raise AssertionError("12f: no detection in any frame")
    rec = {"frames": len(frames), "img_size": DETECT_IMG,
           "detections": counts, "box_max_abs_px": worst,
           "box_max_rel": worst_rel,
           "rounded_at_half_pixel": at_ties,
           "listed_in_another_order": reordered,
           "ms_per_frame": secs[str(dev)] / len(frames) * 1e3,
           "cpu_ms_per_frame": secs["cpu"] / len(frames) * 1e3}
    log(f"12f detection loop (yolov7, {DETECT_IMG} px, float32, one image "
        f"a call) on {card_line()}: {rec['ms_per_frame']:.2f} ms/frame "
        f"(CPU {rec['cpu_ms_per_frame']:.0f}), detections/frame "
        f"{np.mean(counts):.1f}; card vs CPU same counts and classes, "
        f"boxes within {worst:.3g} px ({worst_rel:.2e} of the frame's "
        f"largest coordinate) before rounding, {at_ties} rounded "
        f"coordinates a pixel apart at a half pixel, {reordered} "
        f"detections listed in another order (a score tie)")
    return rec


def models_phase(dev, sd=None, pipe=None):
    """Phase 12: (a) int8 serving, (b) TTA, (d) export, (c) ensembles,
    (e) the tail cfgs, (f) the detection loop. ``sd``, ``pipe``: phase
    3's weights and bf16 pipeline (built here when not given). Float32
    checks run with TF32 off. Returns (record, {path: K4 launches})."""
    import torch

    t0 = time.time()
    if pipe is None:
        sd, pipe = build_w6(dev)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = offline_frames()
    rec, times = {}, {}

    def timed(key, fn):
        t1 = time.time()
        out = fn()
        times[key] = time.time() - t1
        torch.cuda.empty_cache()
        return out

    try:
        rec["int8"] = timed("int8", lambda: int8_serving(dev, sd, pipe))
        rec["tta"], model, img = timed(
            "tta", lambda: tta_check(dev, sd, frames[8:]))
        rec["export"] = timed("export", lambda: export_check(model, img))
        del model, img
        rec["ensembles"] = timed("ensembles",
                                 lambda: ensembles_check(dev, frames[8:]))
        rec["tail"] = timed("tail", lambda: tail_check(dev, frames[8:]))
        rec["detect"] = timed("detect", lambda: detect_check(dev, frames))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["part_s"] = times
    rec["phase_s"] = time.time() - t0
    log(f"phase 12 {rec['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items()) + ")")
    return rec, {"int8": rec["int8"]["k4_launches"]}

# ---------------------------------------------------------------------------
# phase 13: the parallel layer (parallel/{mesh,tracking,spatial}.py and the
# data-parallel train step)
# ---------------------------------------------------------------------------

PAR_STREAMS = 8               # (a): ByteTrack streams over the ranks
PAR_FRAMES = 16
PAR_LEVEL_TOL = 1e-4          # (b): float32 raw levels, of each part's largest
PAR_TIMED_FRAMES = 8          # (b): bf16 frames timed after 2 warm-ups
PAR_TRAIN_TOL = 1e-6          # (c): float64, of each tensor's largest
PAR_TIMED_BATCH = 8           # (c): the global batch of the bf16 steps
PAR_TIMED_STEPS = 12
PAR_IMG = 1088                # (b): phase 3's letterbox size
# the two runs of each path: both ranks on the one card (gloo), one rank
# (NCCL)
PAR_WORLDS = (("world2_gloo", ["cuda:0", "cuda:0"]),
              ("world1_nccl", ["cuda:0"]))


def par_streams(pipe, frames):
    """(a)'s input: phase 3's 16 frames through the w6 detector, stream s
    taking frame (t + 2 s) % 16 at step t, as (T, S, 300, ...) numpy
    arrays of DetSlab's fields."""
    import torch

    dets = []
    for k in range(0, len(frames), 8):
        boxes, score, cls, counts = pipe.detect_batch(np.stack(frames[k:k + 8]))
        dets += [pipe.dets_to_slab(boxes[b], score[b], cls[b], counts[b])
                 for b in range(boxes.shape[0])]
    n = len(dets)
    order = [[(t + 2 * s) % n for s in range(PAR_STREAMS)]
             for t in range(PAR_FRAMES)]
    fields = []
    for f in range(5):
        x = torch.stack([torch.stack([dets[i][f] for i in row])
                         for row in order])
        fields.append(x.cpu().numpy())
    warp = np.broadcast_to(np.eye(2, 3, dtype=np.float32),
                           (PAR_FRAMES, PAR_STREAMS, 2, 3)).copy()
    return tuple(fields) + (warp,)


def par_dets(dets, dev):
    import torch

    from yolov7_tracker_tpu_torch.trackers import slab as S

    return S.DetSlab(*(torch.as_tensor(x, device=dev) for x in dets))


def state_digest(state, dev):
    """An exact digest of a TrainState's parameters, BN statistics, EMA,
    momentum and gradient sum: each tensor's bits as integers, weighted by
    position and summed (wrapping); two replicas are bit for bit equal
    where their digests are (and, but for a collision, only there)."""
    import torch

    sd = state.state_dict()
    tensors = [t for sec in ("model", "ema", "momentum", "grad_acc")
               for t in (sd[sec] or {}).values() if t.is_floating_point()]
    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(
            {8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()]
        ).reshape(-1).long()
        w = torch.arange(bits.numel(), device=bits.device) % 1009 + 1
        out.append((bits * w).sum())
    return torch.stack(out).to(dev)


def par_track(mesh, inp):
    """(a) on this rank: the sharded ByteTrack scan (128 / 300) once to
    warm up, then with the K3 / K4 counts set to 0 just before and read
    just after, timed, and this rank's last stage-1 and stages-2+3
    problems re-solved by the plain versions."""
    import torch

    from yolov7_tracker_tpu_torch.parallel import mesh as M
    from yolov7_tracker_tpu_torch.parallel.tracking import (
        make_sharded_tracker, stack_slabs)
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

    dev = mesh.device
    step, cfg = build_tracker(S.TrackerConfig(
        tracker="bytetrack", conf_thresh=0.5, capacity=128,
        det_capacity=300), dev)
    dets = par_dets(inp["dets"], dev)
    tracker = make_sharded_tracker(step, mesh)
    slabs0 = stack_slabs(cfg, PAR_STREAMS, dev)
    tracker(slabs0, dets)
    torch.cuda.synchronize()
    with path_solves(1) as kept, counting() as got:
        t0 = time.time()
        slabs, outs = tracker(slabs0, dets)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3 / PAR_FRAMES
    launches = torch.tensor([[got["launches.k3"], got["launches.k4"]]],
                            device=dev)
    path_solves_check(kept, f"13a {mesh.backend} rank {mesh.rank}", dev)
    return {"ms_per_frame": ms,
            "launches": M.gather_tensor(mesh, launches).tolist(),
            "slabs": [x.cpu() for x in slabs],
            "outs": [x.cpu() for x in outs]}


def par_pipe(sd, dtype, dev):
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as S

    return TrackingPipeline(
        PipelineConfig(model="yolov7-w6", nc=80, img_size=PAR_IMG,
                       detector_batch=1, dtype=dtype, fuse=True),
        S.TrackerConfig(tracker="bytetrack", capacity=128, det_capacity=300),
        state_dict=sd, spec=zoo.get_spec("yolov7-w6", nc=80), device=dev)


def par_spatial(mesh, inp):
    """(b) on this rank: w6 (1088 px) height-sharded; in float32 the raw
    levels of one frame and its detections, in bf16 ms a frame (median of
    PAR_TIMED_FRAMES after 2 warm-ups)."""
    import torch

    from yolov7_tracker_tpu_torch.parallel.spatial import (
        make_spatial_detector)

    dev = mesh.device
    sd = torch.load(inp["w6"], weights_only=True)
    frames = inp["frames"]
    pipe = par_pipe(sd, "float32", dev)
    with torch.no_grad():
        raw = make_spatial_detector(pipe.model, mesh)(
            letterboxed(pipe, frames[:1], dev))
    counts = pipe.detect_batch_spatial(frames[:1], mesh)[3]
    del pipe
    pipe = par_pipe(sd, "bfloat16", dev)
    times = []
    for k in range(PAR_TIMED_FRAMES + 2):
        torch.cuda.synchronize()
        t0 = time.time()
        pipe.detect_batch_spatial(frames[k % len(frames)][None], mesh)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return {"raw": [r.cpu() for r in raw], "counts": counts.tolist(),
            "bf16_ms_per_frame": float(np.median(times[2:]))}


def par_train(mesh, inp, parity_out):
    """(c) on this rank: two float64 steps of w6 at TRAIN_PARITY_IMG px
    (global batch 2) from ni = TRAIN_PARITY_NI (carry, apply), the final
    state's digest gathered from every rank, rank 0's state written to
    ``parity_out``; then bf16 steps at TRAIN_IMG px on the global batch of
    PAR_TIMED_BATCH: ms a step (median of steps 4-12), peak memory."""
    import torch

    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.parallel import mesh as M
    from yolov7_tracker_tpu_torch.parallel import train_step as ts

    dev = mesh.device
    spec = zoo.get_spec("yolov7-w6", nc=80)
    sd = torch.load(inp["parity"], weights_only=True)
    cfg = ts.OptConfig(batch_size=2)
    state = float64_state(ts.make_train_state(spec, cfg, state_dict=sd,
                                              mesh=mesh))
    state.step = TRAIN_PARITY_NI
    step = ts.make_train_step(spec, img_size=TRAIN_PARITY_IMG, opt_cfg=cfg,
                              mesh=mesh)
    losses = []
    for x, t, m in inp["parity_batches"]:
        x, t, m = M.shard_batch(mesh, (x, t, m))
        metrics = step(state, x.to(dev, torch.float64), t.to(dev), m.to(dev))
        losses.append({k: float(v) for k, v in metrics.items()})
    digests = M.gather_tensor(mesh, state_digest(state, dev)[None])
    if mesh.rank == 0:
        want = state.state_dict()
        torch.save({sec: {k: v.cpu() for k, v in want[sec].items()}
                    for sec in ("model", "ema", "momentum")}, parity_out)
    ema_count = state.ema_count
    del state, step
    torch.cuda.empty_cache()

    data = MemoryDataset(3 * PAR_TIMED_BATCH, TRAIN_IMG, seed=2)
    batches = [to_input(b, torch.device("cpu"))
               for b in data.batches(PAR_TIMED_BATCH)]
    cfg = ts.OptConfig(batch_size=PAR_TIMED_BATCH, epochs=1,
                       steps_per_epoch=PAR_TIMED_STEPS)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = ts.make_train_state(spec, cfg, state_dict=sd, mesh=mesh)
    state.step = TRAIN_START_NI
    step = ts.make_train_step(spec, img_size=TRAIN_IMG, opt_cfg=cfg,
                              compute_dtype="bfloat16", mesh=mesh)
    times = []
    for i in range(PAR_TIMED_STEPS):
        x, t, m = (v.to(dev) for v in M.shard_batch(mesh, batches[i % 3]))
        torch.cuda.synchronize()
        t0 = time.time()
        metrics = step(state, x, t, m)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    peak = torch.cuda.max_memory_allocated(dev) - base
    del state, step
    torch.cuda.empty_cache()
    return {"parity_losses": losses, "ema_count": ema_count,
            "digests": digests.tolist(),
            "bf16_ms_per_step": float(np.median(times[3:])),
            "bf16_steps_ms": times,
            "peak_gib_per_rank": M.gather_tensor(
                mesh, torch.tensor([peak / 2 ** 30], device=dev)).tolist()}


def parallel_rank(mesh, path, parity_out):
    """Phase 13 on one rank of a world: (a), (b), (c) in turn. Returns the
    rank's record (rank 0's comes back to the launcher)."""
    import torch

    inp = torch.load(path, weights_only=False)
    t0 = time.time()
    rec = {"world": mesh.size, "backend": mesh.backend,
           "track": par_track(mesh, inp)}
    t1 = time.time()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        rec["spatial"] = par_spatial(mesh, inp)
    t2 = time.time()
    rec["train"] = par_train(mesh, inp, parity_out)
    rec["seconds"] = {"a": t1 - t0, "b": t2 - t1, "c": time.time() - t2}
    return rec


def levels_rel(got, want):
    """The worst |got - want| over the raw levels' parts (xy, wh,
    objectness, class), each as a share of the part's largest |value|."""
    worst = 0.0
    for a, b in zip(got, want):
        a = a.to(b.device).float()
        for sl in (slice(0, 2), slice(2, 4), slice(4, 5), slice(5, None)):
            pb = b[..., sl].float()
            worst = max(worst, float((a[..., sl] - pb).abs().max()
                                     / pb.abs().max()))
    return worst


def parallel_phase(dev, sd, pipe):
    """Phase 13: the parallel layer on the one card, each path twice: at
    world 1 through NCCL (this process) and at world 2 with both ranks on
    the card through gloo (spawned; gloo copies card tensors through the
    host, so these runs are not under set_sync_debug_mode("error"), and
    their times are a correctness check's, not a scaling result).
    (a) ByteTrack (128 / 300) sharded over the ranks, S = 8 streams of w6
    detections: outputs and slabs bit for bit one process's
    track_scan_multi, K3 and K4 once a frame on every rank, each rank's
    last problems equal to the plain versions'. (b) w6 at 1088 px on
    1080x1920 frames height-sharded: in float32 the raw levels within
    PAR_LEVEL_TOL of each part's largest against the unsharded model and
    the same NMS counts as detect_batch; bf16 ms a frame beside
    detect_batch's. (c) data-parallel training: w6 at TRAIN_PARITY_IMG px
    in float64, world 2 against world 1 on the same global batch of 2
    after two steps (carry, apply) within PAR_TRAIN_TOL of each tensor's
    largest value (parameters, BN statistics, EMA, momentum), the ranks'
    states bit for bit equal (state_digest); then bf16 at TRAIN_IMG px on
    a global batch of PAR_TIMED_BATCH: ms a step and peak memory a rank.
    Returns (record, {"k3": launches, "k4": launches} by world)."""
    import torch

    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.parallel import mesh as M

    t0 = time.time()
    frames = offline_frames()
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        dets = par_streams(pipe, frames)
        spec = zoo.get_spec("yolov7-w6", nc=80)
        torch.save(sd, os.path.join(root, "w6.pt"))
        torch.save(parity_weights(spec), os.path.join(root, "parity.pt"))
        data = MemoryDataset(4, TRAIN_PARITY_IMG, seed=1)
        inp = {"dets": dets, "frames": np.stack(frames[:4]),
               "w6": os.path.join(root, "w6.pt"),
               "parity": os.path.join(root, "parity.pt"),
               "parity_batches": [to_input(b, torch.device("cpu"))
                                  for b in data.batches(2)]}
        path = os.path.join(root, "inputs.pt")
        torch.save(inp, path)
        runs = {}
        for name, devices in PAR_WORLDS:
            out = os.path.join(root, f"{name}_parity.pt")
            t1 = time.time()
            runs[name] = M.launch(parallel_rank, len(devices), devices, path,
                                  out)
            runs[name]["launch_seconds"] = time.time() - t1
            log(f"13 {name}: {runs[name]['seconds']}, launch "
                f"{runs[name]['launch_seconds']:.1f} s")

        # (a) against one process's scan on the card (a warm-up, then the
        # timed run)
        pipe.track_scan_multi(pipe.init_multistream(PAR_STREAMS),
                              par_dets(dets, dev))
        torch.cuda.synchronize()
        t1 = time.time()
        slabs, outs = pipe.track_scan_multi(
            pipe.init_multistream(PAR_STREAMS), par_dets(dets, dev))
        torch.cuda.synchronize()
        one_ms = (time.time() - t1) * 1e3 / PAR_FRAMES
        rec = {"a_one_process_ms_per_frame": one_ms}
        for name, r in runs.items():
            for a, b in zip(r["track"]["slabs"] + r["track"]["outs"],
                            list(slabs) + list(outs)):
                if not torch.equal(a.to(dev), b):
                    raise AssertionError(f"13a {name}: the sharded scan "
                                         "differs from track_scan_multi")
            n = r["world"]
            want = [[PAR_FRAMES, PAR_FRAMES]] * n
            if r["track"]["launches"] != want:
                raise AssertionError(f"13a {name}: K3 / K4 launches "
                                     f"{r['track']['launches']}, want {want}")
            rec[f"a_{name}_ms_per_frame"] = r["track"]["ms_per_frame"]
        valid = int(outs.valid.sum())
        assert valid > 0, "13a: no track on the streams"
        rec["a_valid_outputs"] = valid

        # (b) against the unsharded model and detect_batch
        p32 = par_pipe(sd, "float32", dev)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=False):
            want = p32.model(letterboxed(p32, frames[:1], dev))
            counts = p32.detect_batch(np.stack(frames[:1]))[3].tolist()
        del p32
        for name, r in runs.items():
            err = levels_rel(r["spatial"]["raw"], want)
            rec[f"b_{name}_level_rel_err"] = err
            rec[f"b_{name}_bf16_ms_per_frame"] = r["spatial"][
                "bf16_ms_per_frame"]
            if err > PAR_LEVEL_TOL or r["spatial"]["counts"] != counts:
                raise AssertionError(
                    f"13b {name}: levels {err} (tolerance {PAR_LEVEL_TOL}), "
                    f"counts {r['spatial']['counts']} vs {counts}")
        rec["b_counts"] = counts
        times = []
        for k in range(PAR_TIMED_FRAMES + 2):
            torch.cuda.synchronize()
            t1 = time.time()
            pipe.detect_batch(frames[k % 4][None])
            torch.cuda.synchronize()
            times.append((time.time() - t1) * 1e3)
        rec["b_detect_batch_bf16_ms_per_frame"] = float(np.median(times[2:]))

        # (c) world 2 against world 1
        w1 = torch.load(os.path.join(root, "world1_nccl_parity.pt"),
                        weights_only=True)
        w2 = torch.load(os.path.join(root, "world2_gloo_parity.pt"),
                        weights_only=True)
        err, where = state_rel_diff(w2, w1, ("model", "ema", "momentum"))
        rec["c_float64_world2_vs_world1_rel_err"] = err
        rec["c_worst_tensor"] = where
        if err > PAR_TRAIN_TOL:
            raise AssertionError(f"13c: world 2 parts from world 1 by {err} "
                                 f"at {where}")
        for name, r in runs.items():
            t = r["train"]
            digests = t["digests"]
            if any(d != digests[0] for d in digests):
                raise AssertionError(f"13c {name}: the replicas differ")
            if t["ema_count"] != 1:
                raise AssertionError(f"13c {name}: ema_count {t['ema_count']}")
            rec[f"c_{name}_losses"] = t["parity_losses"]
            rec[f"c_{name}_bf16_ms_per_step"] = t["bf16_ms_per_step"]
            rec[f"c_{name}_peak_gib_per_rank"] = t["peak_gib_per_rank"]
        for k in runs["world1_nccl"]["train"]["parity_losses"][-1]:
            a = runs["world2_gloo"]["train"]["parity_losses"][-1][k]
            b = runs["world1_nccl"]["train"]["parity_losses"][-1][k]
            if abs(a - b) > TRAIN_REL_TOL * abs(b):
                raise AssertionError(f"13c: loss {k} {a} vs {b}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.time() - t0
    rec["card"] = card_line()
    log(f"phase 13: {json.dumps(rec)}")
    launches = {name: {"k3": [x[0] for x in r["track"]["launches"]],
                       "k4": [x[1] for x in r["track"]["launches"]]}
                for name, r in runs.items()}
    return rec, launches


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


def k2_only(dev, problems_file, cascade_file):
    """The short run behind --k2-only: build csrc/auction.cu (K2, K4 and
    K4's cascade entry) and its profiling build, hold them against their
    plain versions (seeded and stress problems, K4 against scipy), time K4
    at B = 2 and 16 on seeded problems with rows, and, given the
    k2_problems.pt that a full run wrote, time and profile K4
    and K2 on those problems of the paths; given its cascade_problems.pt,
    hold and time the cascade entry on deepsort's captured cascade."""
    import torch

    from yolov7_tracker_tpu_torch.ops import auction

    build_kernels([(auction, SOURCE, ()), (auction, SOURCE, (True,))])
    kernel_phase(dev)
    k4_batch_timings(dev)
    if problems_file:
        saved = torch.load(problems_file)
        k2_path_timings(auction, {name: to_card(problem, dev)
                                  for name, problem in saved.items()}, dev)
    if cascade_file:
        cascade_check(auction, torch.load(cascade_file)["cascade"], dev)
    log("k2-only run done (not the smoke run: no result line)")
    return 0


def k5_layers():
    """The names of K5's launches, in order."""
    return (["stem"] + [f"layer{i}.{b}.conv{c}" for i in range(1, 5)
                        for b in range(2) for c in (1, 2)] + ["head"])


def k5_flops(folded, n):
    """Multiply-adds x 2 of each of K5's launches on n 128 x 64 crops (the
    head's few operations as 0), from the folded weights' shapes."""
    h, w = 64, 32
    out = [2 * n * 128 * 64 * folded.stem_weight.numel()]
    for conv in folded.convs:
        h, w = (h - 1) // conv.stride + 1, (w - 1) // conv.stride + 1
        out.append(2 * n * h * w * conv.weight.numel())
    return out + [0]


def k5_launch_ms(k5, folded, crops, reps=5):
    """ms of each of K5's launches on ``crops``: a CUDA event recorded as
    each launch is checked (ops/deepsort_cnn._check), the mean of reps
    forwards after a warm-up."""
    import torch

    plain_check = k5._check
    events = []

    def timed_check(err, what):
        plain_check(err, what)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append(ev)

    k5.forward_cuda(folded, crops)
    torch.cuda.synchronize()
    k5._check = timed_check
    try:
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            events.append([start])
            k5.forward_cuda(folded, crops)
    finally:
        k5._check = plain_check
    torch.cuda.synchronize()
    per = np.array([[a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
                    for evs in events])
    return per.mean(axis=0).tolist()


def k5_phase(dev):
    """K5 (csrc/deepsort_cnn.cu) on the DeepSORT CNN with seeded weights and
    BN statistics far from identity: 18 launches a forward, each N of K5_NS
    against the plain version (ops/deepsort_cnn.forward_plain, cuDNN in
    float32) and the module's eager forward (float32_exact) within
    K5_REL_TOL of the largest |value|; then, at K5_TIMED_N crops, its time
    beside its bound (the convolutions' operations over 67 TFLOP/s), the
    plain version's and cuDNN's float32 forward of the module (library_ms,
    the yardstick only: the port never calls it), and each launch's time.
    Returns the kernel record."""
    import torch

    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5
    from yolov7_tracker_tpu_torch.reid import (build_reid, float32_exact,
                                               random_reid_state_dict)

    model = build_reid("deepsort_cnn")[0]
    sd = random_reid_state_dict(model, seed=11)
    rng = np.random.default_rng(11)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0.0, 1.0, v.shape)
                                     .astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.05, 4.0, v.shape)
                                     .astype(np.float32))
    model.load_state_dict(sd)
    model = model.to(dev).eval()
    folded = k5.fold(model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    worst, launches, crops = 0.0, {}, None
    for n in K5_NS:
        crops = torch.randn((n, 128, 64, 3), generator=gen, device=dev)
        with counting() as got:
            kern = k5.forward_cuda(folded, crops)
            torch.cuda.synchronize()
        launches[n] = got["launches.k5"]
        with torch.no_grad(), float32_exact():
            plain = k5.forward_plain(folded, crops)
            eager = model(crops.permute(0, 3, 1, 2))
        scale = float(eager.abs().max())
        rel_plain = float((kern - plain).abs().max()) / scale
        rel_eager = float((kern - eager).abs().max()) / scale
        worst = max(worst, rel_plain, rel_eager)
        if (launches[n] != K5_LAUNCHES or not rel_plain <= K5_REL_TOL
                or not rel_eager <= K5_REL_TOL
                or not bool(torch.isfinite(kern).all())):
            raise AssertionError(
                f"K5 at N = {n}: {launches[n]} launches (expected "
                f"{K5_LAUNCHES}), relative to the plain version "
                f"{rel_plain:.2e}, to the module {rel_eager:.2e} (tolerance "
                f"{K5_REL_TOL})")
        log(f"K5 at N = {n}: {launches[n]} launches; max |diff| / max "
            f"|value| {rel_plain:.2e} against the plain version, "
            f"{rel_eager:.2e} against the module (tolerance {K5_REL_TOL})")
    crops = torch.randn((K5_TIMED_N, 128, 64, 3), generator=gen, device=dev)
    x = crops.permute(0, 3, 1, 2)
    t_k5 = cuda_ms(lambda: k5.forward_cuda(folded, crops), 20)
    with torch.no_grad(), float32_exact():
        t_plain = cuda_ms(lambda: k5.forward_plain(folded, crops), 5)
        t_lib = cuda_ms(lambda: model(x), 5)
    flops = k5_flops(folded, K5_TIMED_N)
    bound = sum(flops) / FP32_OPS_PER_S * 1e3
    per = k5_launch_ms(k5, folded, crops)
    layers = {name: {"ms": ms, "bound_ms": f / FP32_OPS_PER_S * 1e3,
                     "tflop_per_s": f / ms / 1e9 if ms > 0 else None}
              for name, ms, f in zip(k5_layers(), per, flops)}
    rec = {"name": "deepsort_cnn_k5", "route": "cuda", "source": SOURCE_K5,
           "replaces": REPLACES_K5, "launches_by_n": launches,
           "max_rel_err": worst, "n": K5_TIMED_N, "ms": t_k5,
           "bound_ms": bound, "bound_by": "operations",
           "share_of_bound": bound / t_k5, "gflop": sum(flops) / 1e9,
           "plain_ms": t_plain, "library_ms": t_lib, "layers": layers,
           "card": card_line()}
    log(f"K5 at N = {K5_TIMED_N} on {rec['card']}: {t_k5:.3f} ms, bound "
        f"{bound:.3f} ms ({sum(flops) / 1e9:.1f} GFLOP over 67 TFLOP/s: "
        f"{100 * bound / t_k5:.1f}%), plain {t_plain:.3f} ms, cuDNN float32 "
        f"(library_ms) {t_lib:.3f} ms")
    for name, v in layers.items():
        log(f"K5 {name}: {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms")
    return rec


def k5_only(dev):
    """The short run behind --k5-only: build csrc/deepsort_cnn.cu and run
    k5_phase."""
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5

    build_kernels([(k5, SOURCE_K5, ())])
    print(json.dumps({"kernels": [k5_phase(dev)]}))
    log("k5-only run done (not the smoke run: no result line)")
    return 0


def k6_problem(rng, b, k, nc, iou_thres, dev, box_px=(24, 48)):
    """A seeded batch for ops/nms.suppress on the cells' canvas (768 x
    1280): boxes box_px wide and tall (the cells' detection load), every
    score over the threshold, every fifth tied to the one before it."""
    import torch

    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    xy = rng.uniform(0, [1280 - box_px[0], 768 - box_px[1]], (b, k, 2))
    sel = np.concatenate([xy, xy + box_px], -1).astype(np.float32)
    score = rng.uniform(0.01, 1, (b, k)).astype(np.float32)
    score[:, 1::5] = score[:, 0::5][:, :score[:, 1::5].shape[1]]
    cls = rng.integers(0, nc, (b, k)).astype(np.float32)
    sel, cls = torch.from_numpy(sel).to(dev), torch.from_numpy(cls).to(dev)
    return (sel, sel + cls[..., None] * nms_mod.MAX_WH,
            torch.from_numpy(score).to(dev), cls)


def k6_check(args, kw, name):
    """K6 against the plain version on one batch, bit for bit; one launch
    and no host sync (sync debug mode 'error'). Returns the counts."""
    import torch

    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    want = nms_mod.suppress_plain(*args, **kw)
    torch.cuda.synchronize()
    with counting() as got:
        torch.cuda.set_sync_debug_mode("error")
        try:
            dets, counts = nms_mod.suppress_cuda(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    if (got["launches.k6"] != 1 or not torch.equal(counts, want[1])
            or not torch.equal(dets, want[0])):
        raise AssertionError(
            f"K6 on {name}: {got['launches.k6']} launches (expected 1), "
            f"counts {counts.tolist()} against the plain version's "
            f"{want[1].tolist()}, rows equal: {torch.equal(dets, want[0])}")
    log(f"K6 on {name}: bit for bit the plain version, kept "
        f"{counts.tolist()}, one launch, no host sync")
    return counts


def k6_kernel_ms(args, kw):
    """ms of K6's launch alone on pre-sorted candidates (graph_ms: no host
    work between launches)."""
    import torch

    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    sel, off, score, cls = (t.contiguous() for t in args)
    b, k = score.shape
    vals, order = nms_mod.sorted_top_k(score, k)
    dets = torch.empty((b, kw["max_det"], 6), device=score.device)
    counts = torch.empty((b,), dtype=torch.int64, device=score.device)
    return graph_ms(lambda: nms_mod._launch_k6(
        sel, off, cls, vals, order, kw["iou_thres"], dets, counts))


def library_nms_ms(args, kw):
    """torchvision.ops.batched_nms over the batch's live candidates (one
    index a class of an image), the yardstick only: the port never calls
    it; None where torchvision is not installed."""
    try:
        from torchvision.ops import batched_nms
    except ImportError:
        return None
    import torch

    sel, _, score, cls = args
    live = score > 0
    groups = cls.long() + 4096 * torch.arange(score.shape[0],
                                              device=score.device)[:, None]
    boxes, scores, idxs = sel[live], score[live], groups[live]
    return cuda_ms(lambda: batched_nms(boxes, scores, idxs,
                                       kw["iou_thres"]), 20)


def k6_phase(dev):
    """K6 (csrc/nms.cu) at the cells' shapes (K6_CELL): on seeded batches
    (class-aware, agnostic, cli/test.py's 8192 candidates at IoU 0.65)
    and on yolov7-w6's raw levels of 8 frames at the cells' configuration
    (seeded, head-sharpened weights) through pipe.nms, bit for bit the
    plain version, one launch a batch and no host sync; detect_batch
    launches K6 once and counts no host_syncs.nms. Then, on the w6
    candidates: the kernel's time (graph_ms) beside its bound (its bytes
    over 3.35 TB/s), with the stable sort (graph_ms), through the wrapper
    (cuda_ms: host work included), the whole pipe.nms with K6 and with the
    plain version, the plain version alone, and torchvision's batched_nms
    (library_ms, the yardstick only). Returns the kernel record."""
    import torch

    from yolov7_tracker_tpu_torch.data import letterbox
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import (random_state_dict,
                                                      sharpen_heads)
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as S

    c = K6_CELL
    kw = dict(max_det=c["max_det"], iou_thres=c["iou_thres"])
    rng = np.random.default_rng(12)
    seeded = {}
    for name, b, k, iou, agnostic in (
            ("seeded, the cells' shapes", c["b"], c["k"], c["iou_thres"],
             False),
            ("seeded, agnostic", c["b"], c["k"], c["iou_thres"], True),
            ("seeded, cli/test.py's 8192 at IoU 0.65", 2, 8192, 0.65,
             False)):
        args = list(k6_problem(rng, b, k, c["nc"], iou, dev))
        if agnostic:
            args[1] = args[0]
        seeded[name] = k6_check(args, dict(max_det=c["max_det"],
                                           iou_thres=iou), name).tolist()

    spec = zoo.get_spec("yolov7-w6", nc=c["nc"])
    sd = random_state_dict(spec, seed=0, gain=DETECTOR_GAIN)
    sharpen_heads(sd, spec)
    pipe = TrackingPipeline(
        PipelineConfig(model="yolov7-w6", nc=c["nc"], img_size=c["img"],
                       detector_batch=c["b"], dtype="bfloat16",
                       conf_thres=0.01, iou_thres=c["iou_thres"],
                       max_det=c["max_det"], nms_top_k=c["k"]),
        S.TrackerConfig(tracker="bytetrack", capacity=256, det_capacity=300),
        state_dict=sd, spec=spec, device=dev)
    frames_u8 = np.stack(offline_frames()[:c["b"]])
    frames = torch.from_numpy(frames_u8).to(dev)
    src_hw = tuple(frames.shape[1:3])
    out_hw, unpad_hw = pipe._geometry(src_hw)
    with torch.no_grad():
        imgs, _ = letterbox.device_preprocess(
            frames, src_hw, out_hw, unpad_hw=unpad_hw, dtype=pipe.dtype)
        raw = pipe.model(imgs)
    kept = []
    plain_suppress = nms_mod.suppress

    def recorded(*a, **k):
        kept.append(a)
        return plain_suppress(*a, **k)

    nms_mod.suppress = recorded
    try:
        with counting() as got:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                dets, counts = pipe.nms(raw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    finally:
        nms_mod.suppress = plain_suppress
    args = kept[-1]
    want = nms_mod.suppress_plain(*args, **kw)
    if (got["launches.k6"] != 1 or got["host_syncs.nms"]
            or not torch.equal(counts, want[1])
            or not torch.equal(dets, want[0])):
        raise AssertionError(
            f"K6 through pipe.nms on w6: {got['launches.k6']} launches, "
            f"{got['host_syncs.nms']} host syncs, counts {counts.tolist()} "
            f"against {want[1].tolist()}")
    with counting() as got:
        pipe.detect_batch(frames_u8)
        torch.cuda.synchronize()
    if got["launches.k6"] != 1 or got["host_syncs.nms"]:
        raise AssertionError(
            f"detect_batch: {got['launches.k6']} K6 launches (expected 1), "
            f"{got['host_syncs.nms']} host_syncs.nms (expected 0)")
    log(f"K6 through pipe.nms on w6's raw levels: bit for bit the plain "
        f"version, kept {counts.tolist()}, one launch, no host sync; "
        f"detect_batch: one K6 launch, no host_syncs.nms")

    b, k = args[2].shape
    bound = (b * k * K6_BYTES_IN + b * c["max_det"] * K6_BYTES_OUT
             + 8 * b) / HBM_BYTES_PER_S * 1e3
    t_kernel = k6_kernel_ms(args, kw)
    t_sorted = graph_ms(lambda: nms_mod.suppress_cuda(*args, **kw))
    t_sort = graph_ms(lambda: nms_mod.sorted_top_k(args[2], k))
    t_wrapper = cuda_ms(lambda: nms_mod.suppress_cuda(*args, **kw), 50)
    t_plain = cuda_ms(lambda: nms_mod.suppress_plain(*args, **kw), 3)
    with torch.no_grad():
        t_nms = cuda_ms(lambda: pipe.nms(raw), 20)
        nms_mod.suppress = nms_mod.suppress_plain
        try:
            t_nms_plain = cuda_ms(lambda: pipe.nms(raw), 3)
        finally:
            nms_mod.suppress = plain_suppress
    t_lib = library_nms_ms(args, kw)
    rec = {"name": "nms_k6", "route": "cuda", "source": SOURCE_K6,
           "replaces": REPLACES_K6, "launches_a_batch": 1,
           "b": b, "k": k, "max_det": c["max_det"],
           "kept_w6": counts.tolist(), "kept_seeded": seeded,
           "ms": t_kernel, "bound_ms": bound, "bound_by": "bytes",
           "share_of_bound": bound / t_kernel,
           "with_sort_ms": t_sorted, "sort_ms": t_sort,
           "wrapper_ms": t_wrapper, "plain_ms": t_plain,
           "nms_ms_a_batch": t_nms, "nms_plain_ms_a_batch": t_nms_plain,
           "library_ms": t_lib, "card": card_line()}
    log(f"K6 at B = {b}, K = {k}, max_det {c['max_det']} on {rec['card']}: "
        f"{t_kernel * 1e3:.1f} us (bound {bound * 1e3:.3f} us, bytes), "
        f"with the sort {t_sorted * 1e3:.1f} us (sort {t_sort * 1e3:.1f}), "
        f"through the wrapper {t_wrapper * 1e3:.1f} us; plain version "
        f"{t_plain:.2f} ms; pipe.nms {t_nms:.3f} ms a batch (plain "
        f"{t_nms_plain:.2f} ms); torchvision batched_nms (library_ms) "
        f"{t_lib}")
    return rec


def k6_only(dev):
    """The short run behind --k6-only: build csrc/nms.cu and run
    k6_phase."""
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    build_kernels([(nms_mod, SOURCE_K6, ())])
    print(json.dumps({"kernels": [k6_phase(dev)]}))
    log("k6-only run done (not the smoke run: no result line)")
    return 0


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--square-only", action="store_true",
                    help="only build, check, time and profile K1/K3")
    ap.add_argument("--k2-only", action="store_true",
                    help="only build, check, time and profile K4 and K2, "
                         "and check K4's cascade entry")
    ap.add_argument("--k5-only", action="store_true",
                    help="only build, check and time K5, the DeepSORT CNN")
    ap.add_argument("--k6-only", action="store_true",
                    help="only build, check and time K6, NMS's keep set")
    ap.add_argument("--train-only", action="store_true",
                    help="only phase 10 (training and the detector test)")
    ap.add_argument("--train2-only", action="store_true",
                    help="only phase 11 (the IBin head and its loss, the "
                         "rank losses, the DHN trainer)")
    ap.add_argument("--models-only", action="store_true",
                    help="only phase 12 (int8 serving, TTA, ensembles, "
                         "export, the zoo's tail, the detection loop)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="only phase 13 (sharded tracking, height-sharded "
                         "detection, data-parallel training)")
    ap.add_argument("--problems", default="",
                    help="with --square-only or --k2-only: the "
                         "square_problems.pt or k2_problems.pt written by a "
                         "full run (the paths' own last problems)")
    ap.add_argument("--cascade-problems", default="",
                    help="with --k2-only: the cascade_problems.pt written by "
                         "a full run (deepsort's last cascade)")
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
        return k2_only(dev, args.problems, args.cascade_problems)
    if args.k5_only:
        return k5_only(dev)
    if args.k6_only:
        return k6_only(dev)
    if args.train_only:
        print(json.dumps({"train": train_phase(dev)}))
        log("train-only run done (not the smoke run: no result line)")
        return 0
    if args.train2_only:
        build_kernels([(auction, SOURCE, ())])
        train2, k4_train2 = train2_phase(dev)
        print(json.dumps({"train2": train2, "k4_launches": k4_train2}))
        log("train2-only run done (not the smoke run: no result line)")
        return 0
    if args.models_only:
        build_kernels([(auction, SOURCE, ())])
        models, k4_models = models_phase(dev)
        print(json.dumps({"models": models, "k4_launches": k4_models}))
        log("models-only run done (not the smoke run: no result line)")
        return 0
    if args.parallel_only:
        # built here, before any rank starts: every rank loads these
        build_kernels([(auction, SOURCE, ()), (square, SOURCE_SQUARE, ())])
        sd, pipe = build_w6(dev)
        parallel, launches_par = parallel_phase(dev, sd, pipe)
        print(json.dumps({"parallel": parallel, "launches": launches_par}))
        log("parallel-only run done (not the smoke run: no result line)")
        return 0
    t0 = time.time()
    if os.path.isfile(os.path.join(OUT_DIR, "chip_smoke.log")):
        os.remove(os.path.join(OUT_DIR, "chip_smoke.log"))
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    build_kernels([(auction, SOURCE, ()), (square, SOURCE_SQUARE, ()),
                   (auction, SOURCE, (True,)),
                   (square, SOURCE_SQUARE, (True,)), (k5, SOURCE_K5, ()),
                   (nms_mod, SOURCE_K6, ())])

    worst = kernel_phase(dev)
    k4_seeded = k4_batch_timings(dev)
    worst_sq, t_k1, t_k3 = square_phase(dev)
    rec_k6 = k6_phase(dev)
    sd, pipe = build_w6(dev)
    launches, k2_launches, solves, main_ms = main_phase(pipe, dev)
    k3_launches, k4_serving, serve_last = serving_phase(sd, pipe, dev)
    k1_launches, step_last = step_frame_phase(pipe, dev)
    detector_reference_check(dev)
    trackers, k4_by_tracker, strongsort_rows = trackers_phase(sd, dev)
    reid_path = seeded_osnet(sd, dev)
    trackers["serving_reid"], k3_serve_reid, k4_serve_reid = \
        serving_reid_phase(sd, dev, reid_path)
    trackers["step_frame_reid"], k1_step_reid, k4_step_reid = \
        step_frame_reid_phase(sd, dev, reid_path)
    trackers["deepmot_s8"], k3_deepmot, k4_deepmot = \
        deepmot_streams_phase(sd, dev)
    trackers["dhn"] = dhn_timings(dev)
    trackers["aflink_gsi"] = aflink_phase(strongsort_rows, dev)
    t8 = time.time()
    trackers["scoring"], k4_scoring = scoring_phase(dev)
    t8b = time.time()
    trackers["detect_per_frame"], k4_detect_every = detect_every_phase(sd,
                                                                       dev)
    t9 = time.time()
    log(f"phase 8a {t8b - t8:.1f} s, phase 8b {t9 - t8b:.1f} s")
    trackers["zoo"], k4_zoo = zoo_phase(dev)
    log(f"phase 9 {time.time() - t9:.1f} s")
    train = train_phase(dev)
    train2, k4_train2 = train2_phase(dev, sd)
    models, k4_models = models_phase(dev, sd, pipe)
    t13 = time.time()
    parallel, launches_par = parallel_phase(dev, sd, pipe)
    log(f"phase 13 {time.time() - t13:.1f} s")

    # K4 (and K2) on the last frame's two solves, as the main path gave
    # them, and on the serving path's stages 2+3: one launch of B = 2 S
    # problems
    c23, r23, m23, th23 = serve_last["stage23"]
    k2_problems = {
        "stage 1 offline": solves[-2],
        "stages 2+3 offline": solves[-1],
        "stages 2+3 of a serving tick": (
            c23.contiguous(), r23, m23,
            torch.as_tensor(th23, dtype=torch.float32).repeat(
                r23.shape[0] // 2))}
    on_path = k2_path_timings(auction, k2_problems, dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.save({name: to_host(problem)
                for name, problem in k2_problems.items()},
               os.path.join(OUT_DIR, "k2_problems.pt"))
    t1, t2, t16 = on_path["k4"].values()
    rec_k4 = {"name": "auction_k4_xla_twin", "route": "cuda",
              "source": SOURCE, "replaces": REPLACES_K4,
              "launches": launches,
              "launches_serving": k4_serving,
              "launches_trackers": k4_by_tracker,
              "launches_serving_reid": k4_serve_reid,
              "launches_step_frame_reid": k4_step_reid,
              "launches_deepmot_s8": k4_deepmot,
              "launches_scoring": k4_scoring,
              "launches_detect_per_frame": k4_detect_every,
              "launches_zoo": k4_zoo,
              "launches_train2": k4_train2,
              "launches_models": k4_models,
              "launches_parallel": {w: v["k4"]
                                    for w, v in launches_par.items()},
              "max_abs_err": float(worst), "library_ms": None, **t1,
              **{f"{k}_b2": v for k, v in t2.items()},
              **{f"{k}_serving": v for k, v in t16.items()},
              "seeded_with_rows": k4_seeded,
              "offline_bytetrack": main_ms,
              "trackers_solver_turns": {
                  k: trackers[k]["solver_turns"] for k in K2_BEFORE}}
    # K4's cascade entry: deepsort's stage 1 in phase 6, timed on its last
    # frame's cascade (cascade_timing)
    casc = trackers["deepsort"]["cascade"]
    rec_cascade = {"name": "auction_k4_cascade", "route": "cuda",
                   "source": SOURCE, "replaces": REPLACES_CASCADE,
                   "launches": trackers["deepsort"]["cascade_launches"],
                   "library_ms": None,
                   **{k: v for k, v in casc.items() if k != "step_profile"},
                   "launches_a_step": casc["step_profile"].get("launches"),
                   "forms": trackers["deepsort"]["cascade_forms"]}
    t1, t2, t16 = on_path["k2"].values()
    # K2 is on no path (as in JAX): it is held against its plain version on
    # the seeded and stress problems and on every problem the paths gave K4
    record = {"name": "auction_k2_private_dummy", "route": "cuda",
              "source": SOURCE, "replaces": REPLACES,
              "launches": k2_launches,
              "on_path": "none: held on the problems the paths gave K4",
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
              "launches_parallel": {w: v["k3"]
                                    for w, v in launches_par.items()},
              "max_abs_err": float(worst_sq),
              "library_ms": None, **on_tick,
              "seeded_batches": {str(b): t for b, t in t_k3.items()}}
    # K5: the DeepSORT CNN of phase 6 (timed and checked there, k5_phase)
    rec_k5 = {**trackers["deepsort"].pop("k5"), "launches_trackers": {
        k: v["k5_launches"] for k, v in trackers.items()
        if isinstance(v, dict) and "k5_launches" in v}}
    log(f"total {time.time() - t0:.1f} s")
    for line in ({"trackers": trackers}, {"train": train}, {"train2": train2},
                 {"models": models}, {"parallel": parallel},
                 {"kernels": [rec_k1, record, rec_k3, rec_k4,
                              rec_cascade, rec_k5, rec_k6]}):
        keep(json.dumps(line))
    keep(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
