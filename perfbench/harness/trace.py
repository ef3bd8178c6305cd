"""The traced run: the PyTorch profiler over the whole measured window,
recording the device's kernels, copies and sets and, on the host, only
the benchmark's own spans (user-scope ranges; no aten op is recorded,
which keeps the profiler's own cost on the host small), and what the
metric readers get from it (a ``TraceReading``).

A device idle gap is named by the innermost benchmark span open on the
host at the gap's middle (the profiler puts both on one clock); gaps
outside every span are "between calls".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.autograd import (_disable_profiler, _enable_profiler,
                            _prepare_profiler)
from torch.autograd.profiler import profile as _autograd_profile
from torch.profiler import ProfilerActivity
from torch._C._profiler import RecordScope

TOP = 10


@dataclasses.dataclass
class TraceReading:
    config: dict
    traffic: dict
    frames: int                        # frames completed in the window
    window_s: float                    # the window, host clock
    spans: Dict[str, Dict[str, float]]  # spans.Spans.totals()
    detected: int                      # frames the detector ran on
    detections: int                    # valid detections the tracker got
    device_ops: Dict[str, float]       # seconds by device op name
    kernels: int                       # kernel launches in the window
    busy_s: float                      # union of device op intervals
    idle_gaps: Dict[str, float]        # idle seconds by open span


def start():
    """Start the profiler; ``stop`` ends it."""
    torch.cuda.synchronize()
    cfg = _autograd_profile(use_device="cuda").config()
    acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})


def _interval(e) -> Tuple[int, int]:
    """(start, end) in ns; older profilers give microseconds."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = e.start_us() * 1000
    return s, s + e.duration_us() * 1000




def stop(span_names) -> dict:
    """Device ops, busy time and idle gaps of the profiled window; the
    benchmark's spans are the host ranges named ``span_names`` (the
    profiler mirrors them on the device's timeline: those are no ops)."""
    torch.cuda.synchronize()
    events = _disable_profiler().events()
    ops: Dict[str, float] = {}
    intervals, spans = [], []
    kernels = 0
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() in span_names:
                continue
            name = e.name()
            s, t = _interval(e)
            ops[name] = ops.get(name, 0.0) + (t - s) * 1e-9
            intervals.append((s, t))
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.name() in span_names:
            spans.append((*_interval(e), e.name()))
    intervals.sort()
    merged: List[List[int]] = []
    for s, t in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    # sweep the gaps' middles through the spans' opens and closes; the
    # spans nest, so the innermost open one is the top of the stack
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(t, 0, i) for i, (_, t, _) in enumerate(spans)])
    gaps: Dict[str, float] = {}
    open_, k = [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        while k < len(marks) and marks[k][0] <= mid:
            _, opens, i = marks[k]
            if opens:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            k += 1
        name = spans[open_[-1]][2] if open_ else "between calls"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9
    return {"device_ops": ops, "kernels": kernels, "busy_s": busy,
            "idle_gaps": gaps}


def breakdown(reading: TraceReading) -> dict:
    top = sorted(reading.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(reading.idle_gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
