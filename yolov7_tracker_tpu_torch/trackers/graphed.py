"""The tracker step as one CUDA graph.

``graphed(step)`` wraps a slab step ``(slab, *det_slabs, **options) ->
(slab, FrameOutput)``; trackers/registry.py wraps every step it builds,
a tracker's and the predict-only one. The step is the JAX package's
fixed-shape masked update with no host sync, so a frame's ~550 small
launches (the Kalman filter, the cost matrices, K4 or K4's cascade, K1 or
K3, the lifecycle's masked updates) can be captured once and replayed in
one launch, in place of being launched from Python every frame.

A graph is keyed by its signature: the slab's device, each field's shape
and dtype of every input (the stream axes of stacked slabs,
det_capacity, feature_dim and feature_hist among them) and the options
(``cfg``, ``solve_stage1``, deepmot's ``dhn``). The first call with a new
signature runs the step eagerly on a side stream ``WARMUP`` times (the
kernels' libraries load, K4 raises its shared memory limit, the solver's
thresholds are made on the device), then captures it; a capture that
fails raises. Each call then copies its inputs into the graph's static
inputs, replays the graph on the current stream and returns clones of
its outputs: a later replay overwrites no tensor a caller holds, and
nothing reads the device. The arithmetic is the eager step's, kernel for
kernel: a replay equals the eager step bit for bit. Tensors the step
reads besides its inputs (deepmot's DHN weights) are read where they
were at capture: change them in place, or pass another module.

A step runs eagerly on CPU tensors (the tests and the JAX parity) and
inside a capture already in progress. ``GRAPHS`` graphs are kept a
step, the least recently used dropped, so a change of shape recaptures
rather than accumulates.

The tracer (utils/trace.py): the warm-up and the capture record nothing
(``trace.aside``); the counts the capture made (``launches.k4``,
``launches.k4_cascade``, ``launches.k1`` / ``k3``) are credited again on
each replay, so a replayed step counts the launches the eager one does.
The spans inside the step (``tracker.kalman``, ``tracker.solve``,
deepmot's ``tracker.dhn``) do not open in a replay: their kernels run
inside the graph. Counters:
``tracker.graph_captures``, ``tracker.graph_replays`` and
``tracker.graph_eager`` (calls run eagerly).
"""

from __future__ import annotations

import collections
import functools
from typing import Callable

import torch

from ..utils import trace

GRAPHS = 4      # graphs kept a step, the least recently used dropped
WARMUP = 3      # eager runs on a side stream before a capture


def signature(args, kwargs) -> tuple:
    """What a call's graph is keyed by: the slab's device, the shape and
    dtype of every field of every input, and the options. Raises
    TypeError where no graph can be keyed: an input passed by name, an
    option that is a tensor or cannot be hashed."""
    if not args or not all(isinstance(a, tuple) for a in args) or any(
            isinstance(v, (torch.Tensor, tuple)) for v in kwargs.values()):
        raise TypeError("a graphed step takes its slabs by position and no "
                        "tensor as an option")
    key = (args[0][0].device,
           tuple(tuple((t.shape, t.dtype) for t in a) for a in args),
           tuple(sorted(kwargs.items(), key=lambda kv: kv[0])))
    hash(key)
    return key


def _on_card(key: tuple) -> bool:
    """A graph can run the call: its slab is on the card, and no capture
    is in progress."""
    return key[0].type == "cuda" and \
        not torch.cuda.is_current_stream_capturing()


class _Graph:
    """One captured step: its static inputs on the slab's device, the
    graph, and the outputs each replay writes."""

    def __init__(self, step: Callable, args, kwargs):
        self.step, self.kwargs = step, kwargs
        dev = args[0][0].device
        self.inputs = [[torch.empty(t.shape, dtype=t.dtype, device=dev)
                        for t in a] for a in args]
        self._load(args)
        static = [type(a)(*ins) for a, ins in zip(args, self.inputs)]
        self.counts, self.outputs, self.replay = self._capture(
            dev, lambda: step(*static, **kwargs))

    @staticmethod
    def _capture(dev, body: Callable):
        """``body`` run ``WARMUP`` times on a side stream, then captured.
        Returns (the counts the capture made, its outputs, the graph's
        replay)."""
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), trace.aside():
            for _ in range(WARMUP):
                body()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with trace.aside() as counts, torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            outputs = body()
        return counts, outputs, graph.replay

    def _load(self, args) -> None:
        for ins, a in zip(self.inputs, args):
            for v, t in zip(ins, a):
                v.copy_(t)

    def __call__(self, args):
        self._load(args)
        self.replay()
        return tuple(type(out)(*(t.clone() for t in out))
                     for out in self.outputs)


def graphed(step: Callable) -> Callable:
    """``step`` replayed as one CUDA graph a signature where one can run
    it (module docstring). The wrapper's ``graphs`` is its cache
    {signature: graph}, most recent last."""
    graphs: "collections.OrderedDict[tuple, _Graph]" = \
        collections.OrderedDict()

    @functools.wraps(step)
    def run(*args, **kwargs):
        key = signature(args, kwargs)
        if not _on_card(key):
            trace.count("tracker.graph_eager")
            return step(*args, **kwargs)
        g = graphs.get(key)
        if g is None:
            g = graphs[key] = _Graph(step, args, kwargs)
            trace.count("tracker.graph_captures")
            if len(graphs) > GRAPHS:
                graphs.popitem(last=False)
        else:
            graphs.move_to_end(key)
        trace.count("tracker.graph_replays")
        for name, n in g.counts.items():
            trace.count(name, n)
        return g(args)

    run.graphs = graphs
    return run
