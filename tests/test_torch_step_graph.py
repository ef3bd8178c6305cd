"""The tracker step's CUDA graph wrapper (trackers/graphed.py) on the
CPU: the built steps run eagerly here and equal the registered step bit
for bit; the graph's own bookkeeping (static inputs, the outputs cloned,
the counts credited on each replay) runs with a stand-in capture that
replays the captured body eagerly, and equals the eager step too; the
signature; the bounded cache; and the ``tracker_graph_share`` metric.
The card tests (tests/test_torch_cuda.py) hold the real graphs."""

import importlib.util
import os
import sys

import pytest

from tests.step_scenes import (differing, det_slabs, graphs_on_the_cpu,
                               scene, stacked)
from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
from yolov7_tracker_tpu_torch.trackers import graphed
from yolov7_tracker_tpu_torch.trackers import registry
from yolov7_tracker_tpu_torch.trackers import slab as S
from yolov7_tracker_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 30
SMALL = dict(capacity=32, det_capacity=16)
CONFIGS = {
    "bytetrack": dict(tracker="bytetrack", **SMALL),
    "deepsort": dict(tracker="deepsort", feature_dim=16, feature_hist=4,
                     **SMALL),
}


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The graph path on CPU tensors, with the stand-in capture."""
    graphs_on_the_cpu(monkeypatch)


def _steps(name):
    """(the built step, the registered step over the same config, the
    config), or the predict-only pair for ``name`` "predict"."""
    cfg = registry.resolve_config(S.TrackerConfig(
        **CONFIGS["bytetrack" if name == "predict" else name]))
    if name == "predict":
        built = registry.build_predict_only(cfg)
        return built, built.__wrapped__.__wrapped__, cfg
    built, cfg = registry.build_tracker(cfg, "cpu")
    return built, lambda *a, **k: registry._STEPS[name][0](
        *a, cfg=cfg, **k), cfg


def _run(step, cfg, dets, predict_every=0):
    """The scene through ``step``: (every slab, every output); with
    ``predict_every``, each such frame is a predict-only step of the
    detected tracks (``step`` then the pair (tracker, predict))."""
    slab = S.init_slab(cfg, "cpu")
    slabs, outs = [], []
    for i, det in enumerate(dets):
        if predict_every and i % predict_every == 1:
            slab, out = step[1](slab)
        else:
            slab, out = (step[0] if predict_every else step)(slab, det)
        slabs.append(slab)
        outs.append(out)
    return slabs, outs


def _assert_same_runs(got, want):
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert not differing(a, b), (i, differing(a, b))
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert not differing(a, b), (i, differing(a, b))


def _case(name):
    built, plain, cfg = _steps(name)
    dets = det_slabs(cfg, scene(11, FRAMES), "cpu")
    if name == "predict":
        tracker, _ = registry.build_tracker(cfg, "cpu")
        raw = lambda *a, **k: registry._STEPS["bytetrack"][0](  # noqa: E731
            *a, cfg=cfg, **k)
        return (tracker, built), (raw, plain), cfg, dets, 3
    return built, plain, cfg, dets, 0


@pytest.mark.parametrize("name", ["bytetrack", "deepsort", "predict"])
def test_built_step_runs_eagerly_on_the_cpu_and_equals_the_step(name):
    """On the CPU the built step (its graph wrapper inside its span) is
    the registered step, bit for bit, over 30 seeded frames, and every
    call counts as eager."""
    built, plain, cfg, dets, every = _case(name)
    with trace.recording():
        got = _run(built, cfg, dets, every)
        counts = trace.counters()
    _assert_same_runs(got, _run(plain, cfg, dets, every))
    assert counts["tracker.graph_eager"] == FRAMES
    assert "tracker.graph_replays" not in counts
    wrapper = built[1] if every else built.func
    assert not wrapper.__wrapped__.graphs


@pytest.mark.parametrize("name", ["bytetrack", "deepsort", "predict"])
def test_graph_bookkeeping_equals_the_eager_step(cpu_graphs, name):
    """Through the graph path (the stand-in capture replays the captured
    body): every slab and output over 30 frames equals the eager step's
    bit for bit, one capture serves every frame, and the spans inside
    the step do not open in a replay."""
    built, plain, cfg, dets, every = _case(name)
    with trace.recording():
        got = _run(built, cfg, dets, every)
        counts, totals = trace.counters(), trace.totals()
    _assert_same_runs(got, _run(plain, cfg, dets, every))
    assert counts["tracker.graph_replays"] == FRAMES
    assert counts["tracker.graph_captures"] == (2 if every else 1)
    assert "tracker.graph_eager" not in counts
    assert totals["tracker"]["count"] == FRAMES
    assert "tracker.kalman" not in totals and "tracker.solve" not in totals


def test_slabs_the_caller_holds_survive_later_replays(cpu_graphs):
    """Every slab and output the step returned keeps its values after
    the later replays, and a returned slab modified in place steps as
    the eager step steps it."""
    built, plain, cfg, dets, _ = _case("bytetrack")
    slab = S.init_slab(cfg, "cpu")
    kept = []
    for det in dets:
        slab, out = built(slab, det)
        kept.append((slab, out, S.TrackSlab(*(t.clone() for t in slab)),
                     S.FrameOutput(*(t.clone() for t in out))))
    for slab_, out, slab_copy, out_copy in kept:
        assert not differing(slab_, slab_copy)
        assert not differing(out, out_copy)
    # the step from a slab modified in place is the eager step from it
    slab.score.add_(1.0)
    got = built(slab, dets[0])
    want = plain(slab, dets[0])
    assert not differing(got[0], want[0]) and not differing(got[1], want[1])


def test_a_capture_that_fails_raises(monkeypatch):
    """A step whose capture fails is no graph and no eager step: the
    error reaches the caller, and nothing is cached."""
    def failing(dev, body):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphed, "_on_card", lambda key: True)
    monkeypatch.setattr(graphed._Graph, "_capture", staticmethod(failing))
    built, _, cfg, dets, _ = _case("bytetrack")
    with trace.recording():
        with pytest.raises(RuntimeError, match="capturing"):
            built(S.init_slab(cfg, "cpu"), dets[0])
        counts = trace.counters()
    assert not built.func.__wrapped__.graphs
    assert not {"tracker.graph_captures", "tracker.graph_replays",
                "tracker.graph_eager"} & set(counts)


def test_counts_made_in_the_capture_are_credited_on_each_replay(cpu_graphs):
    """A step's counts (the kernels' launches) made while it was captured
    count again on each replay while the tracer records, and not at all
    in the warm-up."""
    def step(slab, det, cfg):
        trace.count("launches.k4", 2)
        trace.count("launches.k4_cascade")
        return slab._replace(frame=slab.frame + 1), S.frame_output(
            slab, "default", cfg)

    cfg = S.TrackerConfig(**SMALL)
    run = graphed.graphed(step)
    det = det_slabs(cfg, scene(2, 1), "cpu")[0]
    slab = S.init_slab(cfg, "cpu")
    slab, _ = run(slab, det, cfg=cfg)           # captured, not recording
    with trace.recording():
        for _ in range(5):
            slab, _ = run(slab, det, cfg=cfg)
        counts = trace.counters()
    assert counts == {"tracker.graph_replays": 5, "launches.k4": 10,
                      "launches.k4_cascade": 5}
    assert int(slab.frame) == 6


def test_signature_changes_with_capacity_streams_and_solver_only():
    """The key moves with det_capacity, the stream axes and
    ``solve_stage1``, and with nothing else: not with the values, the
    frame, the warp's device or another DetSlab of the same shapes."""
    cfg = S.TrackerConfig(**SMALL)
    frames = scene(5, 4)
    dets = det_slabs(cfg, frames, "cpu")
    slab = S.init_slab(cfg, "cpu")
    opts = dict(cfg=cfg)
    base = graphed.signature((slab, dets[0]), opts)
    assert graphed.signature((slab, dets[1]), opts) == base
    moved = slab._replace(frame=slab.frame + 3, score=slab.score + 1.0)
    assert graphed.signature((moved, dets[2]), opts) == base
    assert graphed.signature(
        (slab, dets[0]._replace(warp=S.IDENTITY_WARP)), opts) == base
    wider = S.TrackerConfig(**dict(SMALL, det_capacity=24))
    assert graphed.signature(
        (slab, det_slabs(wider, frames, "cpu")[0]), opts) != base
    two = graphed.signature((stacked([slab] * 2), stacked(dets[:2])), opts)
    three = graphed.signature((stacked([slab] * 3), stacked(dets[:3])),
                              opts)
    assert len({base, two, three}) == 3
    assert graphed.signature((slab, dets[0]), dict(
        opts, solve_stage1=masked_assignment)) != base
    # a tensor passed as an option or an input by name: no graph keys it
    with pytest.raises(TypeError):
        graphed.signature((slab,), dict(opts, dets=dets[0]))
    with pytest.raises(TypeError):
        graphed.signature((), dict(slab=slab))


def test_the_cache_keeps_a_bounded_number_of_graphs(cpu_graphs):
    """Past ``GRAPHS`` signatures the least recently used graph goes and
    a call with its signature captures again."""
    built, _, cfg, _, _ = _case("bytetrack")
    graphs = built.func.__wrapped__.graphs
    frames = scene(9, 1)
    keys = []
    with trace.recording():
        for d in range(8, 8 + graphed.GRAPHS + 1):
            c = S.TrackerConfig(**dict(SMALL, det_capacity=d))
            det = det_slabs(c, frames, "cpu")[0]
            built(S.init_slab(cfg, "cpu"), det)
            keys.append(graphed.signature(
                (S.init_slab(cfg, "cpu"), det), dict(cfg=cfg)))
        assert list(graphs) == keys[1:]
        c = S.TrackerConfig(**dict(SMALL, det_capacity=8))
        built(S.init_slab(cfg, "cpu"), det_slabs(c, frames, "cpu")[0])
        counts = trace.counters()
    assert list(graphs) == keys[2:] + keys[:1]
    assert counts["tracker.graph_captures"] == graphed.GRAPHS + 2


def _metric():
    path = os.path.join(ROOT, "perfbench", "metrics",
                        "tracker_graph_share.py")
    spec = importlib.util.spec_from_file_location("tracker_graph_share",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tracker_graph_share_reads_the_counters(monkeypatch):
    """100 where every ``tracker`` span was replayed, 0 where every one
    ran eagerly, None where the program counts neither (a program
    without graphed steps) or has no tracer."""
    read = _metric().read
    with trace.recording():
        for _ in range(7):
            with trace.span("tracker"):
                trace.count("tracker.graph_replays")
    assert read(None) == 100.0
    trace.reset()
    with trace.recording():
        with trace.span("tracker"):
            trace.count("tracker.graph_eager")
    assert read(None) == 0.0
    trace.reset()
    with trace.recording():
        with trace.span("tracker"):
            pass
    assert read(None) is None
    for name in ("yolov7_tracker_tpu_torch.utils.trace",
                 "yolov7_tracker_tpu_torch.utils"):
        monkeypatch.setitem(sys.modules, name, None)
    assert read(None) is None


@pytest.mark.parametrize("graphs", [False, True])
def test_a_traced_tiny_cell_reads_tracker_graph_share(monkeypatch, graphs):
    """A traced tiny ``w6-bytetrack.public-dets`` run on the CPU through
    the benchmark's harness: 0 with every step eager, as on CPU tensors;
    100 with the stand-in capture, every step replayed."""
    if graphs:
        graphs_on_the_cpu(monkeypatch)
    sys.path.insert(0, os.path.join(ROOT, "perfbench", "tests"))
    try:
        from perfbench_tiny import run
    finally:
        sys.path.remove(os.path.join(ROOT, "perfbench", "tests"))
    with trace.recording():
        res = run("w6-bytetrack.public-dets", seconds=0.5, traced=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["tracker_graph_share"]["value"] == \
        (100.0 if graphs else 0.0)
