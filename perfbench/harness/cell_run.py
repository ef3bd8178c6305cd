"""One run of one cell: set-up, the measured window, the traced reading,
then the check against the reference once the window has closed."""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from perfbench.harness import check, manifest, spans as spans_mod, trace
from perfbench.harness import traffic
from perfbench.harness.weights import detector_weights, reid_weights
from perfbench.named import by_name


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def build_pipeline(config: dict, device, seed: int, source):
    """The program under test, as the configuration states it: its
    ``pipeline`` section is the PipelineConfig and its ``tracker`` section
    the TrackerConfig, each passed whole, with the benchmark's seeded
    weights; returns (pipeline, the ReID weights or None)."""
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as S

    pcfg = PipelineConfig(**config["pipeline"])
    tcfg = S.TrackerConfig(**config["tracker"])
    reid_sd = reid_weights(config, seed, source.first_frame(), device) \
        if pcfg.reid != "none" else None
    pipe = TrackingPipeline(pcfg, tcfg, state_dict=detector_weights(
        config, seed, device), reid_state_dict=reid_sd, device=device)
    return pipe, reid_sd


def end_to_end(name: str, frames: int, window_s: float,
               setup_s: float) -> float:
    if name == "frames_per_s":
        return frames / window_s
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def run(root: str, cell: manifest.Cell, seed: int, seconds: float,
        traced: bool, device, t_process: float, control: bool = False,
        mutate: Optional[Callable] = None) -> dict:
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = time.time()
    source = traffic.make(seed, cell.traffic)
    pipe, reid_sd = build_pipeline(cell.config, device, seed, source)
    runner = by_name("runners", cell.traffic["entry"]).Runner(
        pipe, source, cell.config)
    log(f"built the pipeline and the traffic: {time.time() - t:.2f} s")
    t = time.time()
    for _ in range(2):
        runner.warm()
    sync()
    log(f"warm-up, two units: {time.time() - t:.2f} s")
    if mutate is not None:
        mutate(pipe)
    chk = cell.config["check"]
    recorder = check.Recorder(pipe, seed, chk["det_rate"], chk["step_rate"])
    sp = None
    if traced:
        sp = spans_mod.Spans(device)
        sp.wrap(runner, "unit", "pipeline")
        for attr, name in manifest.spans(root, cell.per_layer).items():
            sp.wrap(pipe, attr, name)
    gc.collect()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if traced and cuda:
        trace.start()

    t0 = time.time()
    setup_s = t0 - t_process
    frames = units = 0
    while True:
        frames += runner.unit()
        units += 1
        if time.time() - t0 >= seconds:
            break
    window_s = time.time() - t0

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {units} units, {frames} frames in {window_s:.3f} s; "
        f"set-up {setup_s:.3f} s; " + load(recorder, runner))
    result = {"correct": False, "attempted": frames, "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if cuda else "cpu",
                  "kind": (torch.cuda.get_device_name(0) if cuda
                           else "cpu"),
                  "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if traced:
        prof_out = trace.stop({r[0] for r in sp.records}) if cuda else {
            "device_ops": {}, "kernels": 0, "busy_s": 0.0, "idle_gaps": {}}
        reading = trace.TraceReading(
            config=cell.config, traffic=cell.traffic, frames=frames,
            window_s=window_s, spans=sp.totals(),
            detected=sum(d[3].shape[0] for d in recorder.dets),
            detections=recorder.detections(
                cell.config["tracker"]["det_capacity"]), **prof_out)
        result["metrics"] = manifest.read_metrics(root, cell.per_layer,
                                                  reading)
        result["device"].update(busy_s=reading.busy_s, window_s=window_s)
        result["breakdown"] = trace.breakdown(reading)
        log("spans (ms): " + ", ".join(
            f"{k} {v['ms']:.1f} (self {v['self_ms']:.1f}, {v['count']})"
            for k, v in reading.spans.items()))
    else:
        result["metrics"] = {
            m["name"]: {"value": end_to_end(m["name"], frames, window_s,
                                            setup_s),
                        "unit": m["unit"]} for m in cell.end_to_end}
    if cuda:
        result["device"]["power_limit_w"] = power_limit()

    # the program's state goes; what the window produced stays
    del pipe
    runner.pipe = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.time()
    got, ctl = check.run(cell, seed, runner, recorder, device, control,
                         reid_sd)
    steps, ties = got.pop("steps_checked"), got.pop("ties")
    limits = cell.config["check"]["limits"]
    result["correct"] = all(got[k] <= limits[k] for k in got)
    log(f"check: {steps} tracker steps, {time.time() - t:.2f} s; "
        "pairings that tie with the exact one, taken: "
        f"{ties['taken']} (most over the optimum {ties['most_over_optimum']!r}"
        f"), refused: {ties['refused']} (most over "
        f"{ties['refused_most_over']!r}); rows_differ against the exact "
        f"pairing alone {ties['exact_rows_differ']!r}")
    if ctl:
        log("control: " + ", ".join(f"{k} {v!r} (limit {limits[k]!r})"
                                    for k, v in ctl.items()))
        result["control"] = ctl
    result["checks"] = {k: {"value": got[k], "limit": limits[k]}
                        for k in got}
    for k in got:
        log(f"check {k} {got[k]!r} limit {limits[k]!r}")
    return result


def load(recorder, runner) -> str:
    """How much work the window's inputs made: detections a frame out of
    NMS and tracks emitted a frame."""
    out = []
    if recorder.dets:
        counts = torch.cat([d[3] for d in recorder.dets]).float()
        out.append(f"NMS survivors a frame {counts.mean().item():.1f}")
    rows = getattr(runner, "results", None)
    if rows and isinstance(rows[0], list):
        rows = [r for seq in rows for r in seq]
    if rows:
        out.append(f"tracks a frame {np.mean([len(r[1]) for r in rows]):.1f}")
    return ", ".join(out)


def power_limit() -> Optional[float]:
    """The card's power limit in W, from nvidia-smi (None if it cannot
    say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
