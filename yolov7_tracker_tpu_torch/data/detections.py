"""External detection sources — the pluggable-detector seam (port of
yolov7_tracker_tpu/data/detections.py, numpy).

The reference swaps detectors by cloning the track loop per backend
(tracker/track_yolov5.py:28 DetectMultiBackend, track_yolov8.py:27
ultralytics YOLO). Here the seam is data, not code, at two levels:

1. **Detector protocol** — any callable
   ``frames_u8 (B, H, W, 3) -> (boxes (B, D, 4) tlbr in source pixels,
   score (B, D), cls (B, D), counts (B,))`` drops into
   ``TrackingPipeline`` (the zoo's models give this through
   ``detect_batch``).
2. **Detection files** — results of ANY external detector, one txt per
   sequence in the MOT det format ``frame,id,x,y,w,h,score[,cls]``
   (x, y = top-left, matching gt.txt/det.txt conventions and our
   writer). ``load_mot_detections`` parses them;
   ``TrackingPipeline.run_sequence_detections`` feeds the tracker steps
   directly — no detector in the loop.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def load_mot_detections(path: str) -> Dict[int, np.ndarray]:
    """Parse a MOT-format detection txt into {frame: (N, 6) float32}
    rows [x1, y1, x2, y2, score, cls] (tlbr in source-image pixels —
    the det_results layout every tracker consumes,
    tracker/basetrack.py:368)."""
    by_frame: Dict[int, list] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = [float(x) for x in line.replace(" ", ",").split(",")
                     if x != ""]
            frame = int(parts[0])
            x, y, w, h = parts[2:6]
            score = parts[6] if len(parts) > 6 else 1.0
            cls = parts[7] if len(parts) > 7 else 0.0
            by_frame.setdefault(frame, []).append(
                [x, y, x + w, y + h, score, cls]
            )
    return {
        k: np.asarray(v, np.float32) for k, v in sorted(by_frame.items())
    }


def save_mot_detections(path: str, by_frame: Dict[int, np.ndarray]):
    """Inverse of load_mot_detections (id column written as -1)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for frame in sorted(by_frame):
            for x1, y1, x2, y2, score, cls in np.asarray(by_frame[frame]):
                f.write(
                    f"{int(frame)},-1,{x1:.2f},{y1:.2f},"
                    f"{x2 - x1:.2f},{y2 - y1:.2f},{score:.6f},{int(cls)}\n"
                )
