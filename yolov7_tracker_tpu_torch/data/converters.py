"""Dataset -> YOLO-format converters (reference tools/convert_*.py): the
port's own copy of yolov7_tracker_tpu/data/converters.py, host code that
reads each sequence's first frame with OpenCV.

Each converter writes per-frame label txts (cls cx cy w h, normalized)
plus train/test image-list txts:

- VisDrone2019-MOT (tools/convert_VisDrone_to_yolov2.py semantics:
  category remap 1..10 -> 0..9, ignored(0)/other(11) rows dropped,
  optional car-only filter, optional half-split of train sequences);
- MOT17/MOT-challenge (tools/convert_MOT17_to_yolo.py: visibility >=
  0.75 filter, coordinate clamp, pedestrian class only);
- UAVDT (tools/convert_UAVDT_to_yolo.py: single car class).
"""

from __future__ import annotations

import configparser
import os
from collections import defaultdict
from typing import Dict, List, Tuple


def _write_labels(per_frame: Dict[int, List[Tuple[int, float, float, float, float]]],
                  label_dir: str, name_fmt: str = "{:07d}.txt"):
    os.makedirs(label_dir, exist_ok=True)
    for fid, rows in per_frame.items():
        with open(os.path.join(label_dir, name_fmt.format(fid)), "w") as f:
            for cls, cx, cy, w, h in rows:
                f.write(f"{cls} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}\n")


def _clamp_norm(x1, y1, bw, bh, w, h):
    x1 = max(x1, 0.0)
    y1 = max(y1, 0.0)
    bw = min(bw, w - x1)
    bh = min(bh, h - y1)
    return (x1 + bw / 2) / w, (y1 + bh / 2) / h, bw / w, bh / h


def convert_visdrone(root: str, split: str = "VisDrone2019-MOT-train",
                     car_only: bool = False,
                     half: bool = False) -> List[str]:
    """VisDrone MOT annotations -> YOLO labels. Returns image list."""
    import cv2

    seq_dir = os.path.join(root, split, "sequences")
    ann_dir = os.path.join(root, split, "annotations")
    out_images = []
    certain = {4} if car_only else set(range(1, 11))
    for seq in sorted(os.listdir(ann_dir)):
        name = os.path.splitext(seq)[0]
        frames_dir = os.path.join(seq_dir, name)
        first = cv2.imread(os.path.join(frames_dir, "0000001.jpg"))
        if first is None:
            continue
        h, w = first.shape[:2]
        per_frame = defaultdict(list)
        with open(os.path.join(ann_dir, seq)) as f:
            for line in f:
                p = line.strip().split(",")
                fid, _, x, y, bw, bh, score, cat = (
                    int(p[0]), int(p[1]), float(p[2]), float(p[3]),
                    float(p[4]), float(p[5]), int(p[6]), int(p[7]),
                )
                if score == 0 or cat not in certain:
                    continue
                cls = 0 if car_only else cat - 1
                per_frame[fid].append(
                    (cls,) + _clamp_norm(x, y, bw, bh, w, h)
                )
        label_dir = os.path.join(root, split, "labels", name)
        _write_labels(per_frame, label_dir)
        n_frames = len(os.listdir(frames_dir))
        frame_ids = range(1, n_frames + 1)
        if half:
            frame_ids = range(1, n_frames // 2 + 1)
        out_images += [
            os.path.join(frames_dir, f"{i:07d}.jpg") for i in frame_ids
        ]
    return out_images


def convert_mot(root: str, split: str = "train",
                vis_thresh: float = 0.75) -> List[str]:
    """MOT-challenge gt -> YOLO labels (pedestrian class 0 only;
    visibility filter per the reference converter)."""
    import cv2

    base = os.path.join(root, split)
    out_images = []
    for seq in sorted(os.listdir(base)):
        seq_dir = os.path.join(base, seq)
        gt_path = os.path.join(seq_dir, "gt", "gt.txt")
        if not os.path.isfile(gt_path):
            continue
        ini = configparser.ConfigParser()
        ini.read(os.path.join(seq_dir, "seqinfo.ini"))
        w = int(ini["Sequence"]["imWidth"])
        h = int(ini["Sequence"]["imHeight"])
        img_dir = os.path.join(seq_dir, ini["Sequence"].get("imDir", "img1"))
        per_frame = defaultdict(list)
        with open(gt_path) as f:
            for line in f:
                p = line.strip().split(",")
                fid, _, x, y, bw, bh = (int(p[0]), int(p[1]), float(p[2]),
                                        float(p[3]), float(p[4]), float(p[5]))
                mark, cls = int(p[6]), int(p[7])
                vis = float(p[8]) if len(p) > 8 else 1.0
                if mark == 0 or cls != 1 or vis < vis_thresh:
                    continue
                per_frame[fid].append((0,) + _clamp_norm(x, y, bw, bh, w, h))
        _write_labels(per_frame, os.path.join(seq_dir, "labels"),
                      name_fmt="{:06d}.txt")
        out_images += sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.endswith(".jpg")
        )
    return out_images


def convert_uavdt(root: str) -> List[str]:
    """UAVDT (UAV-benchmark-M) gt -> YOLO labels, single 'car' class."""
    import cv2

    base = os.path.join(root, "UAV-benchmark-M")
    out_images = []
    for seq in sorted(os.listdir(base)):
        seq_dir = os.path.join(base, seq)
        gt_path = os.path.join(seq_dir, "gt", "gt_whole.txt")
        if not os.path.isfile(gt_path):
            gt_path = os.path.join(root, "GT", f"{seq}_gt_whole.txt")
        if not os.path.isfile(gt_path):
            continue
        first = None
        img_dir = seq_dir
        for cand in (os.path.join(seq_dir, "img1"), seq_dir):
            fs = [f for f in os.listdir(cand) if f.endswith(".jpg")] \
                if os.path.isdir(cand) else []
            if fs:
                img_dir = cand
                first = cv2.imread(os.path.join(cand, sorted(fs)[0]))
                break
        if first is None:
            continue
        h, w = first.shape[:2]
        per_frame = defaultdict(list)
        with open(gt_path) as f:
            for line in f:
                p = line.strip().split(",")
                fid, x, y, bw, bh = (int(p[0]), float(p[2]), float(p[3]),
                                     float(p[4]), float(p[5]))
                per_frame[fid].append((0,) + _clamp_norm(x, y, bw, bh, w, h))
        _write_labels(per_frame, os.path.join(seq_dir, "labels"))
        out_images += sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.endswith(".jpg")
        )
    return out_images


def write_split(images: List[str], out_txt: str):
    os.makedirs(os.path.dirname(os.path.abspath(out_txt)), exist_ok=True)
    with open(out_txt, "w") as f:
        f.write("\n".join(images) + "\n")
    return out_txt
