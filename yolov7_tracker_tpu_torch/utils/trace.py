"""The port's tracer: named spans and counters, kept in memory.

    with trace.span("tracker.solve", cost):   # times the block
        ...
    trace.count("host_syncs.nms")             # one device-to-host read

Recording is on inside ``recording()`` (blocks nest), and while a
``torch.profiler`` or autograd profiler collects in this thread
(``torch._C._autograd._profiler_enabled()``). The second switch is the
one a profiled window already flips: a benchmark that starts the
profiler just before its measured window and stops it just after gets
the program's spans and counts of exactly that window, and none of
set-up, warm-up or checks. Off, ``span`` and ``count`` cost that one
check: ``span`` hands back one shared no-op object and allocates
nothing, records no CUDA event and reads no clock. On an H100's host
(Python 3.12, torch 2.11): off, 0.55 us a span and 0.11 us a count; on,
35-45 us a span with CUDA events (their records and read-back), 1-2 us
one on the host's clock.

A recorded span keeps its name, its parent (the innermost span open
when it opened), its unit (the ordinal of the ``pipeline`` span around
it: every span of one entry call of the pipeline shares it; -1 outside
one), its host start and end from ``time.time_ns()`` (the Unix clock
that ``torch.profiler`` stamps its events with, so a span can be laid
over the profiler's trace), and, where the span is given a CUDA tensor
or device, two CUDA events recorded on that device's current stream,
with no synchronize (as a span closes, the events the device has passed
are read back without waiting and reused). A span does not open inside
an open span of the same name, so a recursive entry counts once.

Inside ``aside()`` (a CUDA graph's warm-up and capture,
trackers/graphed.py) no span opens and the counts go to the dict the
block yields, recording or not: the graph credits them again on each
replay.

The tracer opens no range of the profiler's (no user annotation, no
NVTX range): the profiler mirrors such ranges onto the device's
timeline, where a reader that counts the device's events would take
them for kernels and their intervals for busy time.

Reads (after the window; ``totals`` waits for the card): ``totals()``
{name: {ms, self_ms, host_ms, count}} (ms on the device's events where
the span had them, else the host's clock; self time is a span's time
less that of the spans opened inside it), ``counters()`` {name: n},
``chrome_events(base_ns)`` (complete events for a Chrome trace), and
``reset()``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, Deque, Dict, List, Optional

import torch

_profiling = getattr(torch._C._autograd, "_profiler_enabled",
                     lambda: False)


class _NoSpan:
    """What ``span`` hands back when it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "gen", "idx")

    def __init__(self, tracer: "Tracer", gen: int, idx: int):
        self.tracer, self.gen, self.idx = tracer, gen, idx

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tracer._close(self.gen, self.idx)
        return False


def _cuda_device(on) -> Optional[torch.device]:
    """The CUDA device of a tensor or device, None for anything else."""
    if isinstance(on, torch.Tensor):
        return on.device if on.is_cuda else None
    if isinstance(on, torch.device) and on.type == "cuda":
        return on
    return None


class Tracer:
    """Spans and counters of one process (the module's functions use one
    shared instance)."""

    def __init__(self):
        self.depth = 0          # open recording() blocks
        self.kept: Optional[Dict[str, int]] = None  # counts of aside()
        # CUDA events read back, for reuse: creating a pair costs tens of
        # microseconds of host time, recording one a few
        self.free: Dict[torch.device, List[torch.cuda.Event]] = {}
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter; spans open now record nothing
        when they close."""
        # [name, parent, unit, start_ns, end_ns, ms (None until known),
        #  (event0, event1) until read back or None, the events' device,
        #  the stream they are recorded on]
        self.records: List[list] = []
        self.stack: List[int] = []      # open spans, innermost last
        self.names: List[str] = []      # their names
        self.pending: Deque[int] = collections.deque()  # closed, unread
        self.counts: Dict[str, int] = {}
        self.units = 0
        self.unit = -1
        self.gen = getattr(self, "gen", 0) + 1

    @contextlib.contextmanager
    def recording(self):
        self.depth += 1
        try:
            yield self
        finally:
            self.depth -= 1

    @contextlib.contextmanager
    def aside(self):
        """A block that opens no span and keeps its counts apart, in the
        dict it yields, whether the tracer records or not."""
        outer, self.kept = self.kept, {}
        try:
            yield self.kept
        finally:
            self.kept = outer

    def span(self, name: str, on=None):
        """A context manager timing its block as the span ``name``;
        ``on`` a CUDA tensor or device: CUDA events on its current stream
        time it too."""
        if (not (self.depth or _profiling()) or name in self.names
                or self.kept is not None):
            return NO_SPAN
        dev = _cuda_device(on)
        events = stream = None
        if dev is not None:
            free = self.free.get(dev)
            events = ((free.pop(), free.pop()) if free else
                      (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
            stream = torch.cuda.current_stream(dev)
            events[0].record(stream)
        if name == "pipeline":
            self.unit = self.units
            self.units += 1
        idx = len(self.records)
        self.records.append([name, self.stack[-1] if self.stack else -1,
                             self.unit, time.time_ns(), None, None, events,
                             dev, stream])
        self.stack.append(idx)
        self.names.append(name)
        return _Span(self, self.gen, idx)

    def _close(self, gen: int, idx: int) -> None:
        if gen != self.gen:
            return
        rec = self.records[idx]
        rec[4] = time.time_ns()
        if rec[6] is None:
            rec[5] = (rec[4] - rec[3]) * 1e-6
        else:
            rec[6][1].record(rec[8])
            self.pending.append(idx)
            self._read_back()
        # spans close innermost first; one opened but never entered goes
        # with the span around it (and stays open: it is not counted)
        if idx in self.stack:
            pos = self.stack.index(idx)
            del self.stack[pos:], self.names[pos:]
        if rec[0] == "pipeline":
            self.unit = -1

    def _read_back(self) -> None:
        """The device's ms of the closed spans whose events the device has
        passed, oldest first, without waiting; their events go back to
        the free lists."""
        while self.pending:
            rec = self.records[self.pending[0]]
            start, end = rec[6]
            if not end.query():
                return
            rec[5] = start.elapsed_time(end)
            rec[6] = None
            self.free.setdefault(rec[7], []).extend((start, end))
            self.pending.popleft()

    def count(self, name: str, n: int = 1) -> None:
        if self.kept is not None:
            self.kept[name] = self.kept.get(name, 0) + n
        elif self.depth or _profiling():
            self.counts[name] = self.counts.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        return dict(self.counts)

    def _durations(self) -> List[Optional[float]]:
        """Each span's ms (None while open), the device's where it has
        events; waits for the devices still behind."""
        if self.pending:
            for dev in {self.records[i][7] for i in self.pending}:
                torch.cuda.synchronize(dev)
            self._read_back()
        return [r[5] for r in self.records]

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {"ms", "self_ms", "host_ms", "count"}} of the closed
        spans."""
        dur = self._durations()
        child = [0.0] * len(dur)
        for i, r in enumerate(self.records):
            if dur[i] is not None and r[1] >= 0:
                child[r[1]] += dur[i]
        out: Dict[str, Dict[str, float]] = {}
        for i, r in enumerate(self.records):
            if dur[i] is None:
                continue
            t = out.setdefault(r[0], {"ms": 0.0, "self_ms": 0.0,
                                      "host_ms": 0.0, "count": 0})
            t["ms"] += dur[i]
            t["self_ms"] += dur[i] - child[i]
            t["host_ms"] += (r[4] - r[3]) * 1e-6
            t["count"] += 1
        return out

    def chrome_events(self, base_ns: int, pid: int = 0,
                      tid: int = 0) -> List[dict]:
        """The closed spans as Chrome trace complete events on the host's
        clock, ``ts`` in microseconds after ``base_ns`` (Unix ns), on one
        row (``pid``, ``tid``); ``args`` give the unit, the parent's name
        and the device's ms."""
        dur = self._durations()
        return [{"name": r[0], "ph": "X", "pid": pid, "tid": tid,
                 "ts": (r[3] - base_ns) / 1e3, "dur": (r[4] - r[3]) / 1e3,
                 "args": {"unit": r[2],
                          "parent": (self.records[r[1]][0] if r[1] >= 0
                                     else None),
                          "ms": dur[i]}}
                for i, r in enumerate(self.records) if dur[i] is not None]


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
recording = TRACER.recording
aside = TRACER.aside
totals = TRACER.totals
counters = TRACER.counters
reset = TRACER.reset
chrome_events = TRACER.chrome_events


def first_tensor(*args, **kwargs):
    """The first tensor among a call's arguments, None if there is none:
    ``traced``'s ``on`` for a function of tensors."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a
    return None


def traced(name: str, on: Optional[Callable] = None):
    """Decorator: each call of the function is a span ``name``; ``on``,
    given the call's arguments, returns the CUDA tensor or device whose
    stream the span also times (called only while recording)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (TRACER.depth or _profiling()):
                return fn(*args, **kwargs)
            with span(name, on(*args, **kwargs) if on else None):
                return fn(*args, **kwargs)

        return wrapper

    return deco
