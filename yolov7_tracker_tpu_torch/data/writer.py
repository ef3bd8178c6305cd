"""Result writers: MOT-challenge txt (drop-in TrackEval compatible) and
overlay plotting (reference save_results/plot_img/save_videos,
tracker/track.py:247-328)."""

from __future__ import annotations

import os
from typing import Iterable, List, Tuple

import numpy as np

# results row: (frame_id, ids, tlwhs, clses)
FrameResult = Tuple[int, List[int], List[np.ndarray], List[int]]


def frame_row(frame_id: int, out, *index) -> FrameResult:
    """One frame's results row from an unpacked FrameOutput (numpy
    leaves): the valid slots' ids, tlwhs and classes. ``index``: the
    frame's position in an output with leading axes; none for one frame."""
    v = out.valid[index]
    return (frame_id, out.track_id[index][v].tolist(),
            list(out.tlwh[index][v]), out.cls[index][v].astype(int).tolist())


def last_written_frame(folder: str, seq_name: str) -> int:
    """Largest frame id already present in a results txt (0 if absent) —
    lets an interrupted run resume with ``save_results(..., append=True)``
    without duplicating or clobbering frames it already emitted."""
    path = os.path.join(folder, seq_name + ".txt")
    if not os.path.isfile(path):
        return 0
    last = 0
    with open(path) as f:
        for line in f:
            head = line.split(",", 1)[0]
            if head:
                last = max(last, int(float(head)))
    return last


def save_results(folder: str, seq_name: str, results: Iterable[FrameResult],
                 data_type: str = "mot17", append: bool = False) -> str:
    """Byte-compatible with the reference txt format (track.py:247-273):
    mot17: ``frame,id,x,y,w,h,1.0,-1,-1,-1``; default: ``...,cls``.
    ``append=True`` extends an existing file (resume-after-preemption)
    instead of overwriting it."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, seq_name + ".txt")
    with open(path, "a" if append else "w") as f:
        for frame_id, ids, tlwhs, clses in results:
            for tid, tlwh, cls in zip(ids, tlwhs, clses):
                if data_type == "default":
                    f.write(
                        f"{frame_id},{tid},{tlwh[0]:.2f},{tlwh[1]:.2f},"
                        f"{tlwh[2]:.2f},{tlwh[3]:.2f},{int(cls)}\n"
                    )
                else:
                    f.write(
                        f"{frame_id},{tid},{tlwh[0]:.2f},{tlwh[1]:.2f},"
                        f"{tlwh[2]:.2f},{tlwh[3]:.2f},1.0,-1,-1,-1\n"
                    )
    return path


def get_color(idx: int):
    """Deterministic id color (track.py:332-339)."""
    idx = idx * 3
    return ((37 * idx) % 255, (17 * idx) % 255, (29 * idx) % 255)


def plot_frame(img: np.ndarray, frame_id: int, ids, tlwhs, save_dir=None):
    """Draw track boxes + ids (track.py:275-301)."""
    import cv2

    out = np.ascontiguousarray(img.copy())
    for tid, tlwh in zip(ids, tlwhs):
        x, y, w, h = map(int, tlwh[:4])
        cv2.rectangle(out, (x, y), (x + w, y + h), get_color(int(tid)), 2)
        cv2.putText(out, str(int(tid)), (x, y - 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 164, 0), 2)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        cv2.imwrite(os.path.join(save_dir, f"{frame_id:05d}.jpg"), out)
    return out


def save_video(image_dir: str, out_path: str, fps: int = 15):
    """Stitch saved frames into a video (track.py:304-328)."""
    import cv2

    frames = sorted(
        f for f in os.listdir(image_dir) if f.endswith((".jpg", ".png"))
    )
    if not frames:
        return None
    first = cv2.imread(os.path.join(image_dir, frames[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        vw.write(cv2.imread(os.path.join(image_dir, f)))
    vw.release()
    return out_path
