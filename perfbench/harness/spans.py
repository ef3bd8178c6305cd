"""The benchmark's own spans around calls into the program's layers.

``wrap(obj, attr, name)`` replaces a bound method of the pipeline
instance by one that opens the span ``name``: two CUDA events recorded on
the current stream at its boundaries (no synchronize: their times are
read once the window has closed) and a ``record_function`` range, which
the profiler's trace shows on the host's timeline. A span's self time is
its time less that of the spans opened inside it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.profiler import record_function


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.records: List[list] = []     # [name, parent, start, end]
        self.stack: List[int] = []

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @contextlib.contextmanager
    def span(self, name: str):
        idx = len(self.records)
        self.records.append([name, self.stack[-1] if self.stack else -1,
                             self._mark(), None])
        self.stack.append(idx)
        try:
            with record_function(name):
                yield
        finally:
            self.stack.pop()
            self.records[idx][3] = self._mark()

    def wrap(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, wrapped)

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {"ms", "self_ms", "count"}}, after the device is done."""
        if self.cuda:
            torch.cuda.synchronize()
            dur = [s.elapsed_time(e) for _, _, s, e in self.records]
        else:
            dur = [(e - s) * 1e3 for _, _, s, e in self.records]
        child = [0.0] * len(self.records)
        for i, (_, parent, _, _) in enumerate(self.records):
            if parent >= 0:
                child[parent] += dur[i]
        out: Dict[str, Dict[str, float]] = {}
        for i, (name, _, _, _) in enumerate(self.records):
            t = out.setdefault(name, {"ms": 0.0, "self_ms": 0.0, "count": 0})
            t["ms"] += dur[i]
            t["self_ms"] += dur[i] - child[i]
            t["count"] += 1
        return out
