"""Image-folder detection CLI on the PyTorch port (port of
yolov7_tracker_tpu/cli/detect.py; the reference's detect.py surface).

Usage:
    python -m yolov7_tracker_tpu_torch.cli.detect --source images/ \
        --model yolov7 --weights best.msgpack --save_dir out/ [--device cpu]

Each image goes through ``TrackingPipeline.detect_batch`` alone (device
letterbox, the detector, NMS, boxes in image pixels); the boxes are drawn
on a copy, written to --save_dir under the image's name, and one line per
image is printed. ``--spatial_devices N`` (N > 1) height-shards each
frame's forward over N ranks (``detect_batch_spatial``,
parallel/spatial.py): the CLI starts them (NCCL, one card a rank; gloo
with ``--device cpu``), every rank reads the same files, and rank 0
writes the overlays and prints. --weights is what cli/track.py's --model_path takes: a
Flax variables file (.msgpack / .npz), a reference checkpoint or a torch
state_dict (seeded random weights when empty). Runs on the card unless
--device says otherwise. ``detect_images`` is the detection loop without
the file reading and drawing (which need OpenCV); ``apply_classifier`` is
the reference's second-stage classifier filter.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Iterator, Tuple

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("torch yolov7 detect")
    p.add_argument("--source", type=str, required=True,
                   help="an image file or a directory of images")
    p.add_argument("--model", type=str, default="yolov7-tiny")
    p.add_argument("--weights", type=str, default="",
                   help="detector weights (.msgpack/.npz Flax variables, a "
                        "reference .pt state_dict or a port state_dict); "
                        "empty: seeded random weights")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--save_dir", type=str, default="./detect_result")
    p.add_argument("--spatial_devices", type=int, default=0,
                   help="height-shard each frame's forward over this many "
                        "ranks (when cards outnumber streams; "
                        "parallel/spatial.py). 0/1 = one device")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


def build_pipeline(opts, device=None):
    """The pipeline of the CLI's options (on ``device`` when given):
    detector_batch 1, the default tracker config (unused)."""
    from ..models import zoo
    from ..models.convert import load_detector_weights
    from ..pipeline import PipelineConfig, TrackingPipeline
    from ..trackers.slab import TrackerConfig

    spec = zoo.get_spec(opts.model, nc=opts.nc)
    state_dict = (load_detector_weights(opts.weights, spec)
                  if opts.weights else None)
    pcfg = PipelineConfig(model=opts.model, nc=opts.nc,
                          img_size=opts.img_size, conf_thres=opts.conf,
                          iou_thres=opts.iou, detector_batch=1,
                          dtype=opts.dtype)
    return TrackingPipeline(pcfg, TrackerConfig(), state_dict=state_dict,
                            spec=spec, device=device or opts.device)


def detect_images(pipe, images: Iterable[np.ndarray], mesh=None
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      int]]:
    """The CLI's detection loop: each (H, W, 3) uint8 BGR image alone
    through ``pipe.detect_batch`` (``detect_batch_spatial`` over ``mesh``
    when given) -> (boxes (n, 4) tlbr in image pixels, scores (n,),
    classes (n,) int, n) on the host."""
    for img in images:
        boxes, scores, cls, counts = (
            pipe.detect_batch(img[None]) if mesh is None
            else pipe.detect_batch_spatial(img[None], mesh))
        n = int(counts[0])
        yield (boxes[0, :n].cpu().numpy(), scores[0, :n].cpu().numpy(),
               cls[0, :n].cpu().numpy().astype(int), n)


def draw(img: np.ndarray, boxes, scores, cls) -> np.ndarray:
    """A copy of ``img`` with each box and its 'class:score' label."""
    import cv2

    from ..data.writer import get_color

    out = img.copy()
    for i in range(len(boxes)):
        x1, y1, x2, y2 = map(int, boxes[i])
        cv2.rectangle(out, (x1, y1), (x2, y2), get_color(int(cls[i]) + 1), 2)
        cv2.putText(out, f"{cls[i]}:{scores[i]:.2f}", (x1, y1 - 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 164, 0), 1)
    return out


def main(argv=None):
    opts = parse_args(argv)
    if opts.spatial_devices > 1:
        from .. import resolve_device
        from ..parallel.mesh import launch

        dev = resolve_device(opts.device)
        return launch(_detect_files, opts.spatial_devices, dev.type, opts)
    return _detect_files(None, opts)


def _detect_files(mesh, opts):
    """The CLI's files, on one device or, with ``mesh``, as one rank of
    the height-sharded mode (rank 0 writes and prints)."""
    import cv2

    pipe = build_pipeline(opts, None if mesh is None else mesh.device)
    lead = mesh is None or mesh.rank == 0
    if lead:
        os.makedirs(opts.save_dir, exist_ok=True)
        if mesh is not None:
            print(f"spatial mode: height-sharding over {mesh.size} ranks "
                  f"({mesh.backend})")
    files = (sorted(os.path.join(opts.source, f)
                    for f in os.listdir(opts.source)
                    if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
             if os.path.isdir(opts.source) else [opts.source])
    for path in files:
        img = cv2.imread(path)
        (b, s, c, n), = detect_images(pipe, [img], mesh)
        if lead:
            dst = os.path.join(opts.save_dir, os.path.basename(path))
            cv2.imwrite(dst, draw(img, b, s, c))
            print(f"{path}: {n} detections -> {dst}")


def apply_classifier(dets: np.ndarray, frame: np.ndarray,
                     classify_fn) -> np.ndarray:
    """Second-stage classifier filter (utils/general.py:745-777): crop each
    detection (x1, y1, x2, y2, score, cls rows) as a square of side
    1.3 x its longer side + 30 px about its centre, clipped to the frame,
    resize it to 224 with cv2, and keep the detections whose class
    ``classify_fn`` ((K, 224, 224, 3) float RGB in [0, 1] -> (K,) class
    ids) agrees with."""
    import cv2

    if len(dets) == 0:
        return dets
    h, w = frame.shape[:2]
    cx = (dets[:, 0] + dets[:, 2]) / 2
    cy = (dets[:, 1] + dets[:, 3]) / 2
    side = np.maximum(dets[:, 2] - dets[:, 0],
                      dets[:, 3] - dets[:, 1]) * 1.3 + 30
    crops = []
    for k in range(len(dets)):
        x1 = int(max(cx[k] - side[k] / 2, 0))
        y1 = int(max(cy[k] - side[k] / 2, 0))
        x2 = int(min(cx[k] + side[k] / 2, w))
        y2 = int(min(cy[k] + side[k] / 2, h))
        cut = frame[y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)]
        im = cv2.resize(cut, (224, 224))[:, :, ::-1].astype(np.float32)
        crops.append(im / 255.0)
    pred2 = np.asarray(classify_fn(np.stack(crops)))
    return dets[dets[:, 5].astype(int) == pred2.astype(int)]


if __name__ == "__main__":
    main()
