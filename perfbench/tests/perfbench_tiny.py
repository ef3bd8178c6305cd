"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
detector (yolov7-w6 at its widths, nc 2) at 320 px on 192 x 320 frames
in float32, batches of 2, a 32-track table with 40 detection slots,
20-frame sequences of public detections."""

from __future__ import annotations

import copy
import os
import time

import torch

from perfbench.harness import cell_run, manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def shrink(cell: manifest.Cell) -> manifest.Cell:
    c = copy.deepcopy(cell)
    c.config["pipeline"].update(img_size=320, nc=2, dtype="float32",
                                detector_batch=2)
    c.config["tracker"].update(capacity=32, det_capacity=40)
    c.config["weights"]["box_px"] = [12, 24]
    if "reid_calib_boxes" in c.config["weights"]:
        c.config["weights"]["reid_calib_boxes"] = 40
    c.config["check"].update(step_rate=0.5, det_rate=0.1)
    if "frames" in c.traffic:
        c.traffic.update(frames=20, pedestrians=[8, 10], crossings=2)
    else:
        c.traffic.update(height=192, width=320)
    return c


def tiny(workload: str, root: str = ROOT) -> manifest.Cell:
    return shrink(manifest.load(root, workload))


def run(workload: str, seed: int = 20250101, seconds: float = 2.0,
        control: bool = False, mutate=None, traced: bool = False,
        root: str = ROOT) -> dict:
    torch.set_num_threads(2)
    return cell_run.run(root, tiny(workload, root), seed, seconds, traced,
                        "cpu", time.time(), control=control, mutate=mutate)
