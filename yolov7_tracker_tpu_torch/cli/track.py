"""Dataset tracking CLI on the PyTorch port (port of
yolov7_tracker_tpu/cli/track.py, image-dir sequences and ByteTrack).

Usage:
    python -m yolov7_tracker_tpu_torch.cli.track --dataset mot17 \
        --tracker bytetrack --track_eval false [--device cpu]

Per sequence: frames -> device letterbox -> YOLOv7 -> NMS -> ByteTrack
-> MOT txt. Runs on the GPU unless --device says otherwise. Scoring with
TrackEval is not ported yet: --track_eval must be false.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import yaml


def parse_args(argv=None):
    p = argparse.ArgumentParser("torch tracker")
    p.add_argument("--dataset", type=str, default="visdrone")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--tracker", type=str, default="bytetrack",
                   choices=["bytetrack"])
    p.add_argument("--model", type=str, default="yolov7-w6",
                   help="zoo model name or reference cfg yaml path")
    p.add_argument("--model_path", type=str, default="",
                   help="unfused detector state_dict saved with torch.save "
                        "(default: seeded random weights)")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--img_size", type=int, default=1280)
    p.add_argument("--conf_thresh", type=float, default=0.2)
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--track_buffer", type=int, default=30)
    p.add_argument("--kalman_format", type=str, default="default")
    p.add_argument("--min_area", type=float, default=150)
    p.add_argument("--track_eval", type=lambda s: s.lower() != "false",
                   default=True)
    p.add_argument("--detector_batch", type=int, default=8)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--capacity", type=int, default=256)
    p.add_argument("--det_capacity", type=int, default=300)
    p.add_argument("--config_dir", type=str, default="./config_files")
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


def load_dataset_config(opts):
    for base in (opts.config_dir, "./config_files"):
        path = os.path.join(base, f"{opts.dataset}.yaml")
        if os.path.isfile(path):
            with open(path) as f:
                return yaml.safe_load(f)
    raise FileNotFoundError(f"no dataset config for {opts.dataset!r}")


def main(argv=None):
    opts = parse_args(argv)
    if opts.track_eval:
        raise SystemExit(
            "TrackEval scoring is not ported yet; pass --track_eval false")
    cfgs = load_dataset_config(opts)

    import torch

    from ..data import sequence as seqmod
    from ..data import writer
    from ..models import zoo
    from ..models.spec import load_yaml_file
    from ..pipeline import PipelineConfig, TrackingPipeline
    from ..trackers.slab import TrackerConfig

    pcfg = PipelineConfig(
        model=opts.model, nc=opts.nc, img_size=opts.img_size,
        conf_thres=0.01, iou_thres=0.45, detector_batch=opts.detector_batch,
        dtype=opts.dtype)
    tcfg = TrackerConfig(
        tracker=opts.tracker, kalman_format=opts.kalman_format,
        conf_thresh=opts.conf_thresh, iou_thresh=opts.iou_thresh,
        track_buffer=opts.track_buffer, capacity=opts.capacity,
        det_capacity=opts.det_capacity, min_area=opts.min_area)
    if opts.model.endswith((".yaml", ".yml")):
        spec = load_yaml_file(opts.model, nc=opts.nc)
    else:
        spec = zoo.get_spec(opts.model, nc=opts.nc)
    state_dict = (torch.load(opts.model_path, map_location="cpu")
                  if opts.model_path else None)
    pipe = TrackingPipeline(pcfg, tcfg, state_dict=state_dict, spec=spec,
                            device=opts.device)

    seqs = seqmod.discover_sequences(
        cfgs.get("DATASET_ROOT", "."), split=opts.split,
        seqs=[s for s in (cfgs.get("CERTAIN_SEQS") or []) if s] or None,
        ignore_seqs=[s for s in (cfgs.get("IGNORE_SEQS") or []) if s])
    folder = os.path.join(
        opts.output_dir, f"{opts.tracker}_{time.strftime('%Y%m%d_%H%M%S')}")
    seq_fps = []
    for seq in seqs:
        t0 = time.time()
        results = pipe.run_sequence(seqmod.iter_frames(seq))
        fps = len(seq) / max(time.time() - t0, 1e-9)
        seq_fps.append(fps)
        print(f"{seq.name}: {len(seq)} frames, {fps:.1f} fps "
              f"on {pipe.device}")
        writer.save_results(folder, seq.name, results)
    if seq_fps:
        print(f"mean fps: {np.mean(seq_fps):.2f}")
    return folder


if __name__ == "__main__":
    main()
