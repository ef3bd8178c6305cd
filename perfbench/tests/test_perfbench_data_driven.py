"""A later PR adds a configuration, a traffic mix, a source of traffic, a
tracker's reference and a per-layer metric as new files and entries; the
harness finds each by name, runs the new cell, and no file it had
changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from perfbench_tiny import ROOT

NEW_METRIC = '''"""Frames of the traced window (a test metric)."""


def read(r):
    return float(r.frames) if r.frames else None
'''

NEW_SOURCE = '''"""A still camera: one noise frame, every frame (a test source)."""

import numpy as np

from perfbench.harness.seeds import sub_seed


class Still:
    def __init__(self, frame):
        self.still = frame

    def frame(self, k):
        return self.still

    def first_frame(self):
        return self.still


def make(seed, p):
    rng = np.random.default_rng(sub_seed(seed, 9))
    return Still(rng.integers(0, 256, (p["height"], p["width"], 3),
                              np.uint8))
'''

NEW_TRACKER = '''"""SORT's plain reference (a test stand-in: ByteTrack's)."""

from perfbench.named import by_name

_bytetrack = by_name("reference/trackers", "bytetrack")
step, solves_per_frame = _bytetrack.step, _bytetrack.solves_per_frame
'''

RUN_THE_CELL = """
import json, sys
sys.path[:0] = [{copy!r}, {tests!r}]
sys.path.append({root!r})
from perfbench.harness import check, manifest
from perfbench_tiny import run
cell = manifest.load({copy!r}, "w6-c128.still")
res = run("w6-c128.still", seconds=1.0, traced=True, root={copy!r})
sort = check.tracker_reference(dict(cell.config, tracker={{"tracker": "sort"}}))
print(json.dumps([res["correct"], res["metrics"], sort.__file__]))
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_new_files_add_a_cell_a_source_a_tracker_and_a_metric(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(root, "perfbench")
    before = _digests(pb)
    cfg = json.load(open(os.path.join(pb, "configs",
                                      "yolov7-w6.bytetrack.json")))
    cfg["tracker"]["capacity"] = 128
    _write(os.path.join(pb, "configs", "yolov7-w6.bytetrack-c128.json"),
           json.dumps(cfg))
    _write(os.path.join(pb, "traffic", "still.json"), json.dumps(
        {"kind": "still", "entry": "run_sequence_stateful",
         "height": 1080, "width": 1920}))
    _write(os.path.join(pb, "sources", "still.py"), NEW_SOURCE)
    _write(os.path.join(pb, "reference", "trackers", "sort.py"),
           NEW_TRACKER)
    _write(os.path.join(pb, "metrics", "frames_traced.py"), NEW_METRIC)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({
        "name": "yolov7-w6.bytetrack-c128", "source": "https://example.org",
        "file": "perfbench/configs/yolov7-w6.bytetrack-c128.json",
        "reduced": ["capacity"], "why": "a test configuration"})
    bench["workloads"].append({
        "name": "w6-c128.still", "config": "yolov7-w6.bytetrack-c128",
        "traffic": "still", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "pipeline", "moves": "frames_per_s",
        "workloads": ["w6-c128.still"]})
    _write(os.path.join(root, "BENCHMARK.json"), json.dumps(bench))

    out = subprocess.run(
        [sys.executable, "-c", RUN_THE_CELL.format(
            copy=root, tests=os.path.join(pb, "tests"), root=ROOT)],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, sort_file = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert correct
    # each metric lists its cells: the new cell reads only its own
    assert list(metrics) == ["frames_traced"] and metrics[
        "frames_traced"]["value"] > 0
    assert sort_file == os.path.join(pb, "reference", "trackers", "sort.py")
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
