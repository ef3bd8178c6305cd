"""The cells ``w6-deepsort-osnet.video`` and ``w6-bytetrack.public-dets``
on the CPU at a tiny size: the program equals the plain reference, the
control fails, and so does a run with the timed path broken underneath;
a traced run reads the per-layer metrics that BENCHMARK.json lists for
each cell (the program's spans recorded on the CPU under
``trace.recording()``, which the card's profiler switches on there).

OSNet x1_0 keeps its published widths here; 8 detection slots a frame
(of perfbench_tiny's 40) keep its CPU forwards to seconds."""

import time

import pytest
import torch

from perfbench.harness import cell_run
from perfbench_tiny import ROOT, tiny
from test_perfbench_check import _altered_embedding, _same_state

OSNET, PUBLIC = "w6-deepsort-osnet.video", "w6-bytetrack.public-dets"


def run(workload, control=False, mutate=None, traced=False):
    cell = tiny(workload)
    if workload == OSNET:
        cell.config["tracker"]["det_capacity"] = 8
        cell.config["weights"]["reid_calib_boxes"] = 8
    torch.set_num_threads(2)
    return cell_run.run(ROOT, cell, 20250101, 1.0, traced, "cpu",
                        time.time(), control=control, mutate=mutate)


@pytest.mark.parametrize("workload", [OSNET, PUBLIC])
def test_reference_equals_the_program(workload):
    res = run(workload, control=True)
    got = {k: v["value"] for k, v in res["checks"].items()}
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert res["correct"], res["checks"]
    assert got["rows_differ"] == 0.0 and got["state_differ"] == 0.0
    if workload == OSNET:
        assert got["emb_rel_err"] < 1e-5
        assert res["control"]["emb_rel_err"] > limits["emb_rel_err"]
    else:                            # the detector never runs
        assert set(got) == {"rows_differ", "state_differ"}
    assert any(res["control"][k] > limits[k] for k in limits), \
        res["control"]


@pytest.mark.parametrize("workload,fault", [
    (OSNET, _altered_embedding), (OSNET, _same_state), (PUBLIC, _same_state),
])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    assert not run(workload, mutate=fault)["correct"]


@pytest.mark.parametrize("workload", [OSNET, PUBLIC])
def test_a_traced_run_reads_the_cells_metrics(workload):
    from yolov7_tracker_tpu_torch.utils import trace

    cell = tiny(workload)
    # read on the card from the profiler's trace alone
    device_only = {"device_idle_pct", "kernel_launches_per_frame",
                   "solver_roofline"}
    want = {m["name"] for m in cell.per_layer} - device_only
    trace.reset()
    try:
        with trace.recording():
            res = run(workload, traced=True)
    finally:
        trace.reset()
    assert res["correct"]
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values()), \
        res["metrics"]
