"""Image-directory sequences (the image-dir part of
yolov7_tracker_tpu/data/sequence.py).

'origin' layout: data_root/images/<split>/<seq>/(img1/)frames, or the
VisDrone layouts. Frames decode on the host with cv2 (BGR uint8), in
order; the letterbox and normalisation happen on the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class SequenceSpec:
    name: str
    frame_paths: List[str]

    def __len__(self):
        return len(self.frame_paths)


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def discover_sequences(data_root: str, split: str = "test",
                       seqs: Optional[Sequence[str]] = None,
                       ignore_seqs: Sequence[str] = ()) -> List[SequenceSpec]:
    """Find image-directory sequences like tracker/track.py:95-111."""
    candidates = [
        os.path.join(data_root, "images", split),
        os.path.join(data_root, split, "sequences"),
        os.path.join(data_root, f"VisDrone2019-MOT-{split}", "sequences"),
        os.path.join(data_root, split),
    ]
    base = next((c for c in candidates if os.path.isdir(c)), None)
    if base is None:
        raise FileNotFoundError(
            f"no sequence dir under {data_root!r} for split {split!r}")
    out = []
    for name in (seqs if seqs else sorted(os.listdir(base))):
        if name in ignore_seqs:
            continue
        seq_dir = os.path.join(base, name)
        if os.path.isdir(os.path.join(seq_dir, "img1")):
            seq_dir = os.path.join(seq_dir, "img1")
        frames = sorted(os.path.join(seq_dir, f) for f in os.listdir(seq_dir)
                        if f.lower().endswith(IMG_EXTS))
        if frames:
            out.append(SequenceSpec(name, frames))
    return out


def iter_frames(spec: SequenceSpec) -> Iterator[np.ndarray]:
    """Yield the sequence's frames as HWC uint8 BGR arrays."""
    import cv2

    for path in spec.frame_paths:
        img = cv2.imread(path)
        if img is None:
            raise OSError(f"cannot read frame {path}")
        yield img
