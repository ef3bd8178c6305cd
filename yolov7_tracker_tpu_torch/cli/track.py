"""Dataset tracking CLI on the PyTorch port (port of
yolov7_tracker_tpu/cli/track.py).

Usage:
    python -m yolov7_tracker_tpu_torch.cli.track --dataset mot17 \
        --tracker strongsort --reid_model_path osnet_x0_25.pth \
        --gmc ecc [--aflink linker.msgpack] [--gsi] [--device cpu]
    python -m yolov7_tracker_tpu_torch.cli.track --dataset mot17 \
        --tracker bytetrack --detections dets/   # MOT det txts, no detector
    python -m yolov7_tracker_tpu_torch.cli.track --dataset mot17 \
        --tracker deepmot --dhn_path weights/dhn_h32.msgpack \
        --dhn_hidden 32
    python -m yolov7_tracker_tpu_torch.cli.track --dataset mot17 \
        --quant int8                 # W8A8 detector, calibrated on frames

Per sequence: frames -> device letterbox -> YOLOv7 -> NMS (-> ReID crops
and CNN, GMC warp) -> the tracker's slab step (deepmot: the DHN on the
device) -> (AFLink, GSI on the result rows) -> MOT txt. With
--detections <dir> the tracker reads <dir>/<seq>.txt (MOT det rows,
data/detections.py) instead of running the detector; with
--detect_per_frame k it detects on every k-th frame and runs the
predict-only step between. Then, when the dataset's config has a
TRACK_EVAL section and --track_eval is true (the default), the run is
scored (eval/, HOTA, CLEAR, Identity and Count) and the table printed;
``cli.evaluate`` scores a results folder on its own. Runs on the GPU
unless --device says otherwise. Dataset configs come from the package's
configs/ (the JAX package's copies), then ./config_files and
./tracker/config_files. --model takes any zoo name (yolov7, the e6 / d6 /
e6e / w6 family, yolov5n-x, yolov8n-x, yolov3(-spp), yolov4-csp,
yolor-csp ...) or a reference cfg yaml built from the ported blocks.
--model_path is a Flax variables file (.msgpack or .npz, the JAX CLI's
checkpoints), a reference checkpoint (a state_dict in the reference's
names, or a pickled one with --trust_model_path) or a torch state_dict in
the port's module names. --gmc defaults to orb for botsort and ecc for
strongsort, as in the JAX CLI; orb needs OpenCV on the host, so on a
machine without it pass --gmc ecc or --gmc none. --profile PATH runs the
tracking loop under torch.profiler (CPU and, on a card, CUDA) and writes
its Chrome trace to PATH with the program's own spans (utils/trace.py:
pipeline, detector, nms, tracker, tracker.solve, ...) on a row of their
own, in the file's time base: the spans over the card's kernels in one
timeline.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import yaml


def parse_args(argv=None):
    p = argparse.ArgumentParser("torch tracker")
    p.add_argument("--dataset", type=str, default="visdrone")
    p.add_argument("--data_format", type=str, default="origin",
                   choices=["origin", "yolo"])
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--split_txt", type=str, default="",
                   help="image-list txt for --data_format yolo")
    p.add_argument("--tracker", type=str, default="sort",
                   choices=["sort", "bytetrack", "c_bioutracker", "uavmot",
                            "botsort", "deepsort", "strongsort", "deepmot"])
    p.add_argument("--model", type=str, default="yolov7-w6",
                   help="zoo model name or reference cfg yaml path")
    p.add_argument("--model_path", type=str, default="",
                   help="detector weights: a Flax variables file "
                        "(.msgpack/.npz), a reference checkpoint (.pt: a "
                        "state_dict in the reference's names or a pickled "
                        "{'model'|'ema': module}) or an unfused torch "
                        "state_dict in the port's names (default: seeded "
                        "random weights)")
    p.add_argument("--trust_model_path", action="store_true",
                   help="unpickle a --model_path that holds a full "
                        "reference checkpoint (runs code from the file; the "
                        "reference repository must be on PYTHONPATH)")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--img_size", type=int, default=1280)
    p.add_argument("--reid_model_path", type=str, default="",
                   help="torch ReID checkpoint: the DeepSORT CNN's ckpt.t7 "
                        "for deepsort, else a torchreid OSNet (width from "
                        "the file name, default osnet_x0_25)")
    p.add_argument("--reid_capacity", type=int, default=0,
                   help="embed only the top-K score-ordered dets per frame "
                        "(0 = all det_capacity)")
    p.add_argument("--dhn_path", type=str, default="",
                   help="DeepMOT: trained DHN weights (Flax msgpack, e.g. "
                        "weights/dhn_h32.msgpack); without them deepmot "
                        "matches on the raw centre + IoU cost")
    p.add_argument("--conf_thresh", type=float, default=0.2)
    p.add_argument("--nms_thresh", type=float, default=0.7,
                   help="accepted for the reference's surface; unused, as "
                        "in the JAX CLI")
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--track_buffer", type=int, default=30)
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--dhn_hidden", type=int, default=256)
    p.add_argument("--dhn_arch", type=str, default="gru",
                   choices=["gru", "sinkhorn"],
                   help="DHN architecture: 'gru' (the reference's Munkrs) "
                        "or 'sinkhorn' (reid/dhn.py SinkhornDHN)")
    p.add_argument("--gmc", type=str, default="",
                   choices=["", "orb", "ecc", "none"],
                   help="camera-motion compensation (defaults: botsort orb, "
                        "strongsort ecc; orb needs OpenCV)")
    p.add_argument("--detect_per_frame", type=int, default=1,
                   help="detect on every k-th frame; the others run the "
                        "tracker's predict-only step")
    p.add_argument("--kalman_format", type=str, default="default")
    p.add_argument("--min_area", type=float, default=150)
    p.add_argument("--save_images", action="store_true",
                   help="accepted for the reference's surface; unused, as "
                        "in the JAX CLI (cli.track_demo saves overlays)")
    p.add_argument("--save_videos", action="store_true",
                   help="accepted for the reference's surface; unused, as "
                        "in the JAX CLI")
    p.add_argument("--track_eval", type=lambda s: s.lower() != "false",
                   default=True,
                   help="score the run against the config's TRACK_EVAL gt")
    p.add_argument("--quant", type=str, default="none",
                   choices=("none", "int8"),
                   help="int8: W8A8 static-PTQ detector (models/quant.py), "
                        "calibrated on the first 4 frames of the first "
                        "sequence")
    p.add_argument("--detector_batch", type=int, default=8)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--capacity", type=int, default=256)
    p.add_argument("--det_capacity", type=int, default=300)
    p.add_argument("--config_dir", type=str,
                   default=os.path.join(os.path.dirname(__file__), "..",
                                        "configs"))
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--aflink", type=str, default="",
                   help="PostLinker weights (Flax msgpack): AFLink offline "
                        "fragment linking on the result rows")
    p.add_argument("--gsi", action="store_true",
                   help="Gaussian-smoothed interpolation of the result "
                        "rows (StrongSORT++ GSI)")
    p.add_argument("--detections", type=str, default="",
                   help="directory of per-sequence MOT-format detection "
                        "txts (<seq>.txt: frame,id,x,y,w,h,score[,cls]); "
                        "tracks from these instead of running the detector")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, which must exist)")
    p.add_argument("--profile", type=str, default="",
                   help="write a Chrome trace of the tracking loop here: "
                        "torch.profiler's events with the program's spans "
                        "on a row of their own")
    return p.parse_args(argv)


def load_dataset_config(opts):
    """The dataset's yaml from --config_dir, else a reference-format config
    in ./config_files or ./tracker/config_files."""
    for base in (opts.config_dir, "./config_files",
                 "./tracker/config_files"):
        path = os.path.join(base, f"{opts.dataset}.yaml")
        if os.path.isfile(path):
            with open(path) as f:
                return yaml.safe_load(f)
    raise FileNotFoundError(f"no dataset config for {opts.dataset!r}")


def post_process(results, linker, gsi: bool):
    """AFLink (``linker``: a PostLinker) and / or GSI on one sequence's
    results [(frame, ids, tlwhs, clses)], as the JAX CLI applies them:
    the rows are relinked and smoothed, then regrouped onto the original
    frames; a frame keeps its own classes, cut to its new row count."""
    from ..trackers.aflink_post import gsi_interpolation, link_tracks

    rows = [[fid, tid, t[0], t[1], t[2], t[3]]
            for fid, ids, tlwhs, _ in results
            for tid, t in zip(ids, tlwhs)]
    if not rows:
        return results
    rows = np.asarray(rows, float)
    if linker is not None:
        rows = link_tracks(rows, linker)
    if gsi:
        rows = gsi_interpolation(rows)
    by_frame = {}
    for r in rows:
        by_frame.setdefault(int(r[0]), []).append(r)
    return [(fid,
             [int(r[1]) for r in by_frame.get(fid, [])],
             [r[2:6] for r in by_frame.get(fid, [])],
             [c for c, _ in zip(clses, by_frame.get(fid, []))])
            for fid, ids, tlwhs, clses in results]


def evaluate_run(dataset, track_eval_cfg, folder):
    """Score a results folder as the JAX CLI does: the config's
    TRACK_EVAL gt (SEQ_INFO lengths, missing ones from seqinfo.ini),
    VisDrone or MOT17 preprocessing by the dataset's name; the CSVs go
    into ``folder``. Prints the table and returns it."""
    from ..eval import evaluator
    from ..eval.data import seq_length_from_seqinfo

    te = track_eval_cfg
    seq_lengths = {}
    for s, n in (te.get("SEQ_INFO") or {}).items():
        if n is None:
            n = seq_length_from_seqinfo(
                os.path.join(te["GT_FOLDER"], s)) or 0
        seq_lengths[s] = int(n)
    benchmark = "VisDrone" if "visdrone" in dataset.lower() else "MOT17"
    table = evaluator.evaluate_benchmark(
        te["GT_FOLDER"], folder, seq_lengths, benchmark=benchmark,
        gt_loc_format=te.get("GT_LOC_FORMAT", "{gt_folder}/{seq}/gt/gt.txt"),
        output_folder=folder)
    print(evaluator.render_table(
        table, [c for c in table if c != "cls_comb_cls_av"]))
    return table


def calibration_frames(frames, img_size: int, n: int = 4):
    """The int8 calibration batch of the JAX CLI (cli/track.py:187-206):
    the first ``n`` frames (uint8 BGR, as read) over 255, resized to a
    square ``img_size`` with jax.image.resize's antialiased bilinear
    (data/letterbox.resize_linear); None when no frame comes."""
    import torch

    from ..data.letterbox import resize_linear

    first = []
    for frame in frames:
        first.append(frame)
        if len(first) >= n:
            break
    if not first:
        return None
    arr = torch.from_numpy(np.stack(first)).float() / 255.0
    return [resize_linear(arr, img_size, img_size, antialias=True)]


def profiled(device):
    """torch.profiler over the CPU and, on a card, CUDA; the tracer
    (utils/trace.py) records while it collects."""
    from torch.profiler import ProfilerActivity, profile

    from ..utils import trace

    trace.reset()
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def write_profile(prof, path: str) -> None:
    """The profiler's Chrome trace at ``path`` with the tracer's spans
    appended as complete events on a row of their own, in the file's time
    base (``baseTimeNanoseconds``; Unix ns, the spans' clock)."""
    from ..utils import trace

    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # a process id of their own, past every numeric one the file has
    pid = 1 + max([e["pid"] for e in doc["traceEvents"]
                   if isinstance(e.get("pid"), int)], default=0)
    events = trace.chrome_events(int(doc.get("baseTimeNanoseconds", 0)),
                                 pid=pid)
    doc["traceEvents"] += events + [{"name": "process_name", "ph": "M",
                                     "pid": pid,
                                     "args": {"name": "program spans"}}]
    with open(path, "w") as f:
        json.dump(doc, f)
    print(f"profile: {path} ({len(events)} program spans)")


def main(argv=None):
    opts = parse_args(argv)
    cfgs = load_dataset_config(opts)
    from .. import resolve_device

    device = resolve_device(opts.device)     # no card: raise before reading

    from ..data import sequence as seqmod
    from ..data import writer
    from ..models import zoo
    from ..models.convert import load_detector_weights
    from ..models.spec import load_yaml_file
    from ..pipeline import PipelineConfig, TrackingPipeline
    from ..reid import resolve_reid
    from ..trackers.slab import TrackerConfig

    gmc = opts.gmc or {"botsort": "orb", "strongsort": "ecc"}.get(
        opts.tracker, "none")
    reid, reid_state_dict = resolve_reid(opts.tracker, opts.reid_model_path)
    pcfg = PipelineConfig(
        model=opts.model, nc=opts.nc, img_size=opts.img_size,
        conf_thres=0.01, iou_thres=0.45, detector_batch=opts.detector_batch,
        dtype=opts.dtype, gmc_method=gmc, reid=reid,
        reid_capacity=opts.reid_capacity,
        detect_per_frame=opts.detect_per_frame, quant=opts.quant)
    tcfg = TrackerConfig(
        tracker=opts.tracker, kalman_format=opts.kalman_format,
        conf_thresh=opts.conf_thresh, iou_thresh=opts.iou_thresh,
        track_buffer=opts.track_buffer, capacity=opts.capacity,
        det_capacity=opts.det_capacity, gamma=opts.gamma,
        min_area=opts.min_area, dhn_weights=opts.dhn_path,
        dhn_hidden=opts.dhn_hidden, dhn_arch=opts.dhn_arch,
        # a ReID model gives bytetrack and botsort 512-d features too;
        # deepsort and strongsort resolve their own
        feature_dim=512 if reid != "none" else 0)
    if opts.model.endswith((".yaml", ".yml")):
        spec = load_yaml_file(opts.model, nc=opts.nc)
    else:
        spec = zoo.get_spec(opts.model, nc=opts.nc)
    state_dict = (load_detector_weights(opts.model_path, spec,
                                        opts.trust_model_path)
                  if opts.model_path else None)
    seqs = seqmod.discover_sequences(
        cfgs.get("DATASET_ROOT", "."), split=opts.split,
        seqs=[s for s in (cfgs.get("CERTAIN_SEQS") or []) if s] or None,
        ignore_seqs=[s for s in (cfgs.get("IGNORE_SEQS") or []) if s],
        data_format=opts.data_format, split_txt=opts.split_txt or None)
    quant_calib = None
    if opts.quant == "int8" and seqs:
        quant_calib = calibration_frames(seqmod.iter_frames(seqs[0]),
                                         opts.img_size)
    pipe = TrackingPipeline(pcfg, tcfg, state_dict=state_dict, spec=spec,
                            device=device,
                            reid_state_dict=reid_state_dict,
                            quant_calib=quant_calib)
    linker = None
    if opts.aflink:
        from ..reid.aflink import load_postlinker

        linker = load_postlinker(opts.aflink, pipe.device)

    folder = os.path.join(
        opts.output_dir, f"{opts.tracker}_{time.strftime('%Y%m%d_%H%M%S')}")
    seq_fps = []
    prof = profiled(device) if opts.profile else contextlib.nullcontext()
    with prof:
        for seq in seqs:
            t0 = time.time()
            if opts.detections:
                from ..data.detections import load_mot_detections

                det_path = os.path.join(opts.detections, f"{seq.name}.txt")
                if not os.path.isfile(det_path):
                    print(f"{seq.name}: no detections at {det_path}, skipping")
                    continue
                results = pipe.run_sequence_detections(
                    load_mot_detections(det_path), len(seq))
            else:
                results = pipe.run_sequence(seqmod.iter_frames(seq))
            fps = len(seq) / max(time.time() - t0, 1e-9)
            seq_fps.append(fps)
            print(f"{seq.name}: {len(seq)} frames, {fps:.1f} fps "
                  f"on {pipe.device}")
            if linker is not None or opts.gsi:
                results = post_process(results, linker, opts.gsi)
            writer.save_results(folder, seq.name, results)
    if opts.profile:
        write_profile(prof, opts.profile)
    if seq_fps:
        print(f"mean fps: {np.mean(seq_fps):.2f}")
    if opts.track_eval and cfgs.get("TRACK_EVAL"):
        evaluate_run(opts.dataset, cfgs["TRACK_EVAL"], folder)
    return folder


if __name__ == "__main__":
    main()
