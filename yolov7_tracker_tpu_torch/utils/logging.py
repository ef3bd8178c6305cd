"""Training/tracking observability (port of
yolov7_tracker_tpu/utils/logging.py, a copy but for profile_trace, which
traces with torch.profiler).

The reference logs through TensorBoard scalars + optional W&B artifacts
(train.py:433-439, utils/wandb_logging/). Zero-egress equivalent: a
JSONL metrics stream (one object per step/epoch, trivially greppable and
plottable) plus matplotlib summaries. TensorBoard event writing is used
when the `tensorboardX`/`tensorboard` packages happen to be present.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._tb = None
        try:  # optional TensorBoard
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
        except Exception:
            pass

    def log(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        rec.update({
            (f"{prefix}/{k}" if prefix else k): float(v)
            for k, v in scalars.items()
        })
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def log_event(self, record: Dict):
        """Non-scalar JSONL record (artifact refs, lineage events) —
        distinguishable from metric rows by the 'event' marker."""
        rec = {"event": True, "time": time.time()}
        rec.update(record)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._tb is not None:
            self._tb.close()


def plot_results(jsonl_path: str, out_png: Optional[str] = None):
    """results.png analogue (utils/plots.py plot_results)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [json.loads(l) for l in open(jsonl_path)]
    rows = [r for r in rows if not r.get("event")]  # skip artifact events
    keys = sorted({k for r in rows for k in r} - {"step", "time"})
    if not keys:
        return None
    n = len(keys)
    fig, axes = plt.subplots(
        (n + 3) // 4, min(n, 4), figsize=(4 * min(n, 4), 3 * ((n + 3) // 4))
    )
    axes = list(getattr(axes, "flat", [axes]))
    for ax, k in zip(axes, keys):
        xs = [r["step"] for r in rows if k in r]
        ys = [r[k] for r in rows if k in r]
        ax.plot(xs, ys, ".-", markersize=2)
        ax.set_title(k, fontsize=9)
    fig.tight_layout()
    out_png = out_png or jsonl_path.replace(".jsonl", ".png")
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_pr_curve(px, py, ap, out_png: str, names=()):
    """PR-curve figure (utils/plots.py plot_pr_curve analogue)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(1, 1, figsize=(9, 6))
    py = np.stack(py, axis=1)
    for i, y in enumerate(py.T):
        label = f"{names[i] if i < len(names) else i} {ap[i, 0]:.3f}"
        ax.plot(px, y, linewidth=1, label=label)
    ax.plot(px, py.mean(1), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.legend(fontsize=7)
    fig.savefig(out_png, dpi=200)
    plt.close(fig)
    return out_png


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager: a torch.profiler trace of the block (host ops and,
    where a card is present, its kernels), written as a Chrome trace to
    ``log_dir``/trace.json; replaces the reference's thop/TracedModel
    profiling (utils/torch_utils.py:96)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def plot_confusion_matrix(matrix, out_png: str, names=()):
    """Confusion-matrix heatmap (utils/metrics.py ConfusionMatrix.plot
    analogue, without the seaborn dependency)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    m = np.asarray(matrix, float)
    norm = m / np.maximum(m.sum(0, keepdims=True), 1e-9)
    fig, ax = plt.subplots(1, 1, figsize=(8, 7))
    im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
    n = m.shape[0]
    labels = [str(names[i]) if i < len(names) else str(i)
              for i in range(n - 1)] + ["background"]
    ax.set_xticks(range(n)); ax.set_xticklabels(labels, rotation=90,
                                                fontsize=6)
    ax.set_yticks(range(n)); ax.set_yticklabels(labels, fontsize=6)
    ax.set_xlabel("True"); ax.set_ylabel("Predicted")
    fig.colorbar(im)
    fig.savefig(out_png, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_png


def plot_train_batch(imgs, targets, masks, fname: str, names=(),
                     max_subplots: int = 16, thickness: int = 2):
    """Train-batch mosaic with label boxes (utils/plots.py plot_images,
    called for the first batches at train.py:388-391).

    imgs: (B, H, W, 3) uint8 BGR or float [0, 1];
    targets: (B, L, 5) [cls, cx, cy, w, h] normalized; masks: (B, L).
    """
    import math

    import cv2
    import numpy as np

    imgs = np.asarray(imgs)
    if imgs.dtype != np.uint8:
        imgs = (imgs * 255).clip(0, 255).astype(np.uint8)
    bs = min(imgs.shape[0], max_subplots)
    h, w = imgs.shape[1:3]
    ns = int(math.ceil(bs ** 0.5))
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    targets = np.asarray(targets)
    masks = np.asarray(masks)
    for i in range(bs):
        r, c = divmod(i, ns)
        tile = imgs[i].copy()
        for t in range(targets.shape[1]):
            if not masks[i, t]:
                continue
            cls_id, cx, cy, bw, bh = targets[i, t]
            x1 = int((cx - bw / 2) * w)
            y1 = int((cy - bh / 2) * h)
            x2 = int((cx + bw / 2) * w)
            y2 = int((cy + bh / 2) * h)
            color = [int(x) for x in np.random.default_rng(
                int(cls_id) + 7).integers(60, 255, 3)]
            cv2.rectangle(tile, (x1, y1), (x2, y2), color, thickness)
            label = (names[int(cls_id)] if int(cls_id) < len(names)
                     else str(int(cls_id)))
            cv2.putText(tile, label, (x1, max(y1 - 3, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
        mosaic[r * h:(r + 1) * h, c * w:(c + 1) * w] = tile
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    cv2.imwrite(fname, mosaic)
    return fname
