"""Frame sources (port of yolov7_tracker_tpu/data/sequence.py).

'origin' layout: data_root/images/<split>/<seq>/(img1/)frames, or the
VisDrone layouts; 'yolo' layout: a split txt of image paths, grouped by
their directory's name (the reference's tracker_dataloader.py:39-53).
Frames decode on the host with cv2 (BGR uint8), in order; the letterbox
and normalisation happen on the device. ``VideoFrames`` reads a video
file and ``StreamFrames`` a webcam or an RTSP/HTTP stream, both through
cv2.VideoCapture; cv2 is imported only when a frame source needs it, so
importing the port needs no OpenCV. ``SynthFrames`` is a deterministic
synthetic camera (``synth://`` specs) that needs neither cv2 nor files.
"""

from __future__ import annotations

import os
import re
import time
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

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
                       ignore_seqs: Sequence[str] = (), *,
                       data_format: str = "origin",
                       split_txt: Optional[str] = None
                       ) -> List[SequenceSpec]:
    """Find sequences like tracker/track.py:95-111.

    'origin': image directories (see the module docstring).
    'yolo'  : the image paths listed in ``split_txt`` (relative ones under
              ``data_root``), grouped by the name of their directory.
    """
    if data_format == "yolo":
        if not split_txt:
            raise ValueError("data_format 'yolo' needs the split txt path")
        by_seq = {}
        with open(split_txt) as f:
            for line in f:
                p = line.strip()
                if not p:
                    continue
                seq = os.path.basename(os.path.dirname(p))
                if seq in ignore_seqs or (seqs and seq not in seqs):
                    continue
                by_seq.setdefault(seq, []).append(
                    p if os.path.isabs(p) else os.path.join(data_root, p))
        return [SequenceSpec(name, sorted(by_seq[name]))
                for name in sorted(by_seq)]
    if data_format != "origin":
        raise ValueError(f"unknown data_format {data_format!r}")
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


def iter_frames(spec: SequenceSpec,
                on_error: str = "raise") -> Iterator[np.ndarray]:
    """Yield the sequence's frames as HWC uint8 BGR arrays. An unreadable
    image raises (dataset runs, where a missing frame must not silently
    shift the numbering) or, with ``on_error="skip"``, warns and is left
    out (long-running serving, where one truncated camera dump must not
    end the stream)."""
    import cv2

    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip': {on_error!r}")
    for path in spec.frame_paths:
        img = cv2.imread(path)
        if img is None:
            if on_error == "skip":
                warnings.warn(f"skipping unreadable frame {path}")
                continue
            raise OSError(f"cannot read frame {path}")
        yield img


def image_dir_frames(folder: str, on_error: str = "raise"):
    """The images of one directory, in name order, as a frame iterator."""
    paths = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if f.lower().endswith(IMG_EXTS))
    return iter_frames(SequenceSpec(os.path.basename(folder), paths),
                       on_error=on_error)


def _capture(source, what):
    import cv2

    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise OSError(f"cannot open {what} {source!r}")
    return cap, cap.get(cv2.CAP_PROP_FPS) or 30


class VideoFrames:
    """Video-file frame source (the reference's track_demo.py:95-106): the
    file's frames in order, HWC uint8 BGR."""

    def __init__(self, path: str):
        self.cap, self.fps = _capture(path, "video")

    def __iter__(self):
        while True:
            ok, frame = self.cap.read()
            if not ok:
                return
            yield frame


class StreamFrames:
    """Live webcam / RTSP / HTTP stream source (the reference's
    LoadWebcam/LoadStreams, utils/datasets.py:140-356): an unbounded frame
    iterator over cv2.VideoCapture (a source of digits is a webcam id).
    ``skip`` frames are grabbed and dropped before each one read, for
    real-time pacing; ``max_frames`` > 0 stops after that many. Pair it
    with TrackingPipeline.step_frame; ``release`` frees the capture."""

    def __init__(self, source, skip: int = 0, max_frames: int = 0):
        src = int(source) if str(source).isdigit() else source
        self.cap, self.fps = _capture(src, "stream")
        self.skip = skip
        self.max_frames = max_frames

    def __iter__(self):
        n = 0
        while True:
            for _ in range(self.skip):
                self.cap.grab()
            ok, frame = self.cap.read()
            if not ok:
                return
            yield frame
            n += 1
            if self.max_frames and n >= self.max_frames:
                return

    def release(self):
        self.cap.release()


class SynthFrames:
    """Deterministic synthetic camera for soak and fault testing.

    Spec string: ``synth://<n>x<h>x<w>[?seed=K&shift=PX&stall=F:SEC,...]``
      n          frames to emit
      h, w       frame size (HWC uint8 BGR)
      seed       RNG seed for the base scene (default 0)
      shift      horizontal pixels the scene moves per frame (default 2)
      stall      injected hiccups: at frame F the reader sleeps SEC
                 seconds before yielding (comma-separated list)

    The scene is a fixed noise background plus bright blocks that
    translate ``shift`` px/frame, so a sharpened detector yields stable
    boxes that re-associate frame to frame; replaying the same spec
    reproduces the identical frame sequence (resume fast-forward safe),
    and the same spec gives the same frames in the JAX package.
    """

    def __init__(self, spec: str):
        u = urlparse(spec)
        m = re.fullmatch(r"(\d+)x(\d+)x(\d+)", u.netloc + u.path)
        if u.scheme != "synth" or not m:
            raise ValueError(f"bad synth spec {spec!r} (want synth://NxHxW)")
        self.n, self.h, self.w = (int(g) for g in m.groups())
        q = parse_qs(u.query)
        self.seed = int(q.get("seed", ["0"])[0])
        self.shift = int(q.get("shift", ["2"])[0])
        self.stalls = {}
        for part in q.get("stall", [""])[0].split(","):
            if part:
                f, sec = part.split(":")
                self.stalls[int(f)] = float(sec)
        rng = np.random.default_rng(self.seed)
        base = rng.integers(0, 96, (self.h, self.w, 3), np.uint8)
        for _ in range(6):  # bright trackable blocks
            y = int(rng.integers(0, max(1, self.h - 24)))
            x = int(rng.integers(0, max(1, self.w - 24)))
            base[y:y + 24, x:x + 24] = rng.integers(200, 255, 3)
        self.base = base
        self.fps = 30

    def __iter__(self):
        for i in range(self.n):
            sec = self.stalls.get(i)
            if sec:
                time.sleep(sec)
            yield np.roll(self.base, (i * self.shift) % self.w, axis=1)
