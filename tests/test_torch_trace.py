"""utils/trace.py, the port's tracer: off it records nothing; on, its
spans nest by parent and unit and its counters count; it records while
the autograd profiler collects, on that profiler's clock, and emits no
range of its own; the benchmark's per-layer metrics read it in tiny cells
of both configurations; ``host_syncs.nms`` counts every host read of the
NMS loops; and ``cli/track.py --profile`` lays the spans over the
profiler's trace."""

import contextlib
import json
import os
import sys
import time

import pytest
import torch
from torch.autograd import (_disable_profiler, _enable_profiler,
                            _prepare_profiler)
from torch.autograd.profiler import profile as _autograd_profile
from torch.profiler import ProfilerActivity, record_function
from torch._C._profiler import RecordScope

import chip_smoke
from yolov7_tracker_tpu_torch.ops import nms
from yolov7_tracker_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the per-layer metrics that read the tracer, and the cells that list them
NEW_METRICS = ("frames_in_ms_per_frame", "rows_out_ms_per_frame",
               "letterbox_ms_per_frame", "kalman_ms_per_frame",
               "solve_ms_per_frame", "reid_cnn_ms_per_frame",
               "host_syncs_per_frame")


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    yield
    trace.reset()


@contextlib.contextmanager
def profiler():
    """The autograd profiler on the CPU, enabled as perfbench's traced
    run enables it (user-scope ranges only); yields the list that gets
    its events when the block ends."""
    cfg = _autograd_profile().config()
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    events = []
    try:
        yield events
    finally:
        events.extend(_disable_profiler().events())


def _records():
    """(name, parent's name, unit) of every span the tracer kept."""
    recs = trace.TRACER.records
    return [(r[0], recs[r[1]][0] if r[1] >= 0 else None, r[2]) for r in recs]


def test_off_the_tracer_records_nothing():
    assert not torch._C._autograd._profiler_enabled()
    s = trace.span("pipeline", torch.zeros(1))
    assert s is trace.NO_SPAN and trace.span("x") is s
    with s as entered:
        assert entered is s
        trace.count("host_syncs.nms")
    calls = []
    f = trace.traced("x", lambda *a: calls.append(a))(lambda v: v + 1)
    assert f(1) == 2 and not calls      # ``on`` is not called either
    assert trace.totals() == {} and trace.counters() == {}
    assert trace.TRACER.records == []


def test_spans_parents_units_self_time_counters_and_reset():
    with trace.recording():
        with trace.recording():                       # blocks nest
            trace.count("launches.k4")
        with trace.span("pipeline"):
            with trace.span("tracker"):
                time.sleep(0.004)
                with trace.span("tracker.solve"):
                    time.sleep(0.002)
                    # a span of an open span's name does not open
                    assert trace.span("tracker") is trace.NO_SPAN
                    trace.count("launches.k4", 2)
            assert trace.span("pipeline") is trace.NO_SPAN
        with trace.span("pipeline"):
            with trace.span("tracker"):
                pass
        with trace.span("nms"):
            trace.count("host_syncs.nms")
    with trace.span("tracker"):                       # off again
        trace.count("host_syncs.nms")
    assert _records() == [
        ("pipeline", None, 0), ("tracker", "pipeline", 0),
        ("tracker.solve", "tracker", 0), ("pipeline", None, 1),
        ("tracker", "pipeline", 1), ("nms", None, -1)]
    got = trace.totals()
    assert {k: v["count"] for k, v in got.items()} == {
        "pipeline": 2, "tracker": 2, "tracker.solve": 1, "nms": 1}
    assert got["tracker.solve"]["ms"] >= 2.0
    assert got["tracker"]["ms"] >= 6.0
    for name, t in got.items():
        assert t["ms"] == pytest.approx(t["host_ms"])  # no CUDA events
    assert got["tracker"]["self_ms"] == pytest.approx(
        got["tracker"]["ms"] - got["tracker.solve"]["ms"])
    assert got["pipeline"]["self_ms"] == pytest.approx(
        got["pipeline"]["ms"] - got["tracker"]["ms"])
    assert trace.counters() == {"launches.k4": 3, "host_syncs.nms": 1}
    events = trace.chrome_events(0, pid=7)
    assert [e["name"] for e in events] == [r[0] for r in _records()]
    assert all(e["ph"] == "X" and e["pid"] == 7 and e["dur"] >= 0
               for e in events)
    assert events[2]["args"]["parent"] == "tracker"
    trace.reset()
    assert trace.totals() == {} and trace.counters() == {}


def test_a_span_left_open_by_reset_closes_quietly():
    with trace.recording():
        with trace.span("pipeline"):
            trace.reset()
            with trace.span("nms"):
                pass
    assert _records() == [("nms", None, -1)]


def test_records_while_the_profiler_collects_on_its_clock():
    """perfbench's traced window: the autograd profiler switches the
    tracer on and off; a span 1 ms inside a ``record_function`` range
    lies inside that range on the profiler's own event clock; the tracer
    adds no event of its own."""
    with profiler() as events:
        with record_function("outer"):
            time.sleep(0.001)
            with trace.span("inner"):
                time.sleep(0.002)
                trace.count("host_syncs.rows_out")
            time.sleep(0.001)
    assert trace.span("inner") is trace.NO_SPAN
    trace.count("host_syncs.rows_out")                 # off: not counted
    names = [e.name() for e in events]
    assert "outer" in names and "inner" not in names
    outer = next(e for e in events if e.name() == "outer")
    start, end = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    inner = next(r for r in trace.TRACER.records if r[0] == "inner")
    assert start + 1_000_000 <= inner[3] < inner[4] <= end - 1_000_000
    assert trace.counters() == {"host_syncs.rows_out": 1}


def test_nms_counts_every_host_read():
    """host_syncs.nms equals the Tensor.__bool__ calls inside
    nms_from_raw, counted apart by patching __bool__."""
    g = torch.Generator().manual_seed(3)
    levels = [torch.randn((2, s, s, 3, 8), generator=g) * 2.0
              for s in (16, 8, 4)]
    anchors = torch.tensor([[[10, 13], [16, 30], [33, 23]],
                            [[30, 61], [62, 45], [59, 119]],
                            [[116, 90], [156, 198], [373, 326]]],
                           dtype=torch.float32)
    calls = []
    plain = torch.Tensor.__bool__

    def counted(self):
        calls.append(1)
        return plain(self)

    torch.Tensor.__bool__ = counted
    try:
        with trace.recording():
            dets, count = nms.nms_from_raw(levels, anchors, (8, 16, 32),
                                           0.25, 0.45, max_det=40,
                                           top_k=256, chunk=16)
    finally:
        torch.Tensor.__bool__ = plain
    assert int(count.min()) > 16        # more than one chunk an image
    assert trace.counters() == {"host_syncs.nms": len(calls)}
    assert len(calls) >= 2 * dets.shape[0]


@pytest.mark.parametrize("workload", ["w6-bytetrack.video",
                                      "w6-deepsort.video"])
def test_tiny_cell_reads_every_new_metric(workload):
    """A traced tiny cell on the CPU, the tracer and the autograd profiler
    on from after the warm-up: every new metric of the cell reads a
    positive value; the spans nest as the layers do; the profiler's host
    events are the benchmark's own spans, none of the program's."""
    sys.path.insert(0, os.path.join(ROOT, "perfbench", "tests"))
    try:
        from perfbench_tiny import run
    finally:
        sys.path.remove(os.path.join(ROOT, "perfbench", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    listed = [m["name"] for m in bench["per_layer"]
              if m["name"] in NEW_METRICS and workload in m["workloads"]]
    assert len(listed) == 7 - (workload == "w6-bytetrack.video")
    with contextlib.ExitStack() as stack:
        def mutate(pipe):
            stack.enter_context(trace.recording())
            got.append(stack.enter_context(profiler()))

        got = []
        res = run(workload, seconds=0.5, traced=True, mutate=mutate)
    assert res["correct"], res["checks"]
    for name in listed:
        assert res["metrics"][name]["value"] > 0, name
    parents = {(n, p) for n, p, _ in _records()}
    for pair in [("pipeline.frames_in", "pipeline"),
                 ("detector", "pipeline"),
                 ("detector.letterbox", "detector"), ("nms", "detector"),
                 ("tracker", "pipeline"), ("tracker.kalman", "tracker"),
                 ("tracker.solve", "tracker"),
                 ("pipeline.rows_out", "pipeline")]:
        assert pair in parents, pair
    if workload == "w6-deepsort.video":
        assert {("reid", "pipeline"), ("reid.cnn", "reid")} <= parents
    assert all(u >= 0 for _, _, u in _records())
    spans = trace.totals()
    host = [e.name() for e in got[0]
            if e.device_type() == torch.autograd.DeviceType.CPU]
    # the benchmark's wrappers open ranges named as the program's outer
    # spans, once a call each: were the tracer to open ranges, there
    # would be twice as many, and the dotted names would show
    assert set(host) <= {"pipeline", "detector", "nms", "reid", "tracker"}
    for name in set(host):
        assert host.count(name) == spans[name]["count"], name


def test_track_cli_profile_lays_spans_over_the_profilers_trace(tmp_path):
    """cli/track.py --profile on the CPU over the tiny MOT dataset the CLI
    tests write: the file holds the profiler's events and the program's
    spans, and every span lies inside the profiler's time range."""
    from yolov7_tracker_tpu_torch.cli import track

    cfg_dir, det_dir, _ = chip_smoke.write_mot_dataset(
        str(tmp_path / "data"), n_seqs=1, n_frames=30, n_peds=(10, 14))
    path = str(tmp_path / "trace.json")
    track.main(["--dataset", chip_smoke.SCORE_DATASET, "--config_dir",
                cfg_dir, "--split", "train", "--output_dir",
                str(tmp_path / "out"), "--tracker", "bytetrack",
                "--detections", det_dir, "--model", "yolov7-tiny",
                "--img_size", "160", "--capacity", "32", "--det_capacity",
                "48", "--track_eval", "false", "--device", "cpu",
                "--profile", path])
    with open(path) as f:
        doc = json.load(f)
    meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"
            and e.get("args", {}).get("name") == "program spans"]
    assert len(meta) == 1
    pid = meta[0]["pid"]
    ours = [e for e in doc["traceEvents"]
            if e.get("pid") == pid and e.get("ph") == "X"]
    theirs = [e for e in doc["traceEvents"]
              if e.get("pid") != pid and e.get("ph") == "X"]
    assert {e["name"] for e in ours} >= {
        "pipeline", "tracker", "tracker.kalman", "tracker.solve",
        "pipeline.rows_out"}
    assert sum(e["name"] == "tracker" for e in ours) == 30
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ours)
    assert trace.span("x") is trace.NO_SPAN     # the profiler has stopped
