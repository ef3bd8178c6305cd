"""Tracker-comparison scatter plots (trackeval/plotting.py:7-204).

Reads per-tracker summary CSVs written by the evaluator
(`{cls}_summary.csv`, COMBINED row), scatters each tracker on metric
pairs with iso-contours of the combined metric and the pareto-optimal
front — the reference's plot_compare_trackers surface.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def geometric_mean(x, y):
    return np.sqrt(x * y)


def jaccard(x, y):
    x, y = x / 100.0, y / 100.0
    return 100.0 * (x * y) / np.maximum(x + y - x * y, 1e-12)


def multiplication(x, y):
    return x * y / 100.0


# (x_label, y_label, contour_label, contour_fn) — trackeval
# get_default_plots_list, restricted to fields our evaluator emits
DEFAULT_PLOTS: List[Tuple[str, str, Optional[str], Optional[str]]] = [
    ("AssA", "DetA", "HOTA", "geometric_mean"),
    ("AssPr", "AssRe", "HOTA", "jaccard"),
    ("DetPr", "DetRe", "HOTA", "jaccard"),
    ("HOTA", "LocA", None, None),
    ("MOTA", "IDF1", None, None),
]
BG_FNS = {"geometric_mean": geometric_mean, "jaccard": jaccard,
          "multiplication": multiplication}


def load_tracker_summary(path: str, seq: str = "COMBINED_SEQ"
                         ) -> Dict[str, float]:
    """Read one summary CSV; prefer the combined row."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    row = next((r for r in rows if r["seq"].startswith("COMBINED")),
               rows[-1])
    return {k: float(v) for k, v in row.items()
            if k != "seq" and v not in ("", "nan")}


def plot_compare_trackers(tracker_folder: str,
                          tracker_list: Sequence[str], cls: str,
                          output_folder: str,
                          plots_list=None) -> List[str]:
    """One scatter PNG per metric pair; trackers ranked by the sort
    metric (y of the first plot).  Layout mirrors
    trackeval.plotting.plot_compare_trackers: each tracker's folder
    holds `{cls}_summary.csv`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plots_list = plots_list or DEFAULT_PLOTS
    data = {}
    for trk in tracker_list:
        path = os.path.join(tracker_folder, trk, f"{cls}_summary.csv")
        if os.path.isfile(path):
            data[trk] = load_tracker_summary(path)
    if not data:
        raise FileNotFoundError(
            f"no {cls}_summary.csv under {tracker_folder} for "
            f"{list(tracker_list)}"
        )
    os.makedirs(output_folder, exist_ok=True)
    out_paths = []
    for x_label, y_label, bg_label, bg_name in plots_list:
        pts = {t: (d.get(x_label), d.get(y_label))
               for t, d in data.items()
               if d.get(x_label) is not None and d.get(y_label) is not None}
        if not pts:
            continue
        # percentage scale (metrics are stored as fractions)
        xs = np.array([v[0] for v in pts.values()]) * 100.0
        ys = np.array([v[1] for v in pts.values()]) * 100.0
        fig, ax = plt.subplots(figsize=(6, 6))
        if bg_name:  # iso-contours of the combined metric
            gx, gy = np.meshgrid(np.linspace(0, 100, 201),
                                 np.linspace(0, 100, 201))
            z = BG_FNS[bg_name](gx, gy)
            cs = ax.contour(gx, gy, z, levels=np.arange(10, 100, 10),
                            colors="gray", linewidths=0.5, alpha=0.6)
            ax.clabel(cs, fmt="%d", fontsize=7)
        # pareto-optimal front (plotting.py:204)
        order = np.argsort(-xs)
        best_y = -np.inf
        px, py = [], []
        for i in order:
            if ys[i] > best_y:
                best_y = ys[i]
                px.append(xs[i])
                py.append(ys[i])
        ax.plot(px, py, "--", color="tab:red", linewidth=1, alpha=0.7)
        for (t, _), x, y in zip(pts.items(), xs, ys):
            ax.scatter([x], [y], s=40)
            ax.annotate(t, (x, y), fontsize=8,
                        xytext=(3, 3), textcoords="offset points")
        ax.set_xlabel(x_label)
        ax.set_ylabel(y_label)
        title = f"{x_label} vs {y_label}"
        if bg_label:
            title += f" ({bg_label} contours)"
        ax.set_title(f"{cls}: {title}")
        lo = max(0.0, min(xs.min(), ys.min()) - 10)
        hi = min(100.0, max(xs.max(), ys.max()) + 10)
        ax.set_xlim(lo, hi)
        ax.set_ylim(lo, hi)
        out = os.path.join(output_folder,
                           f"{cls}_{x_label}_vs_{y_label}.png")
        fig.savefig(out, dpi=100, bbox_inches="tight")
        plt.close(fig)
        out_paths.append(out)
    return out_paths
