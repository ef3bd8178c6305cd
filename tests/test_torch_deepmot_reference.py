"""DeepMOT's Deep Hungarian Net and step against the benchmark's plain
references (perfbench/reference/dhn.py, reference/trackers/deepmot.py),
the DHN's torch checkpoints and the benchmark's trainer of them, its
span, and NMS's hand-over order, which the cut to det_capacity relies
on."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import check
from perfbench.reference import dhn as ref_dhn
from perfbench.reference.track_common import (Judge, judged_pairs,
                                              lapjv_extended)
from perfbench.named import by_name
from yolov7_tracker_tpu_torch.ops import nms as tnms
from yolov7_tracker_tpu_torch.reid import dhn as tdhn
from yolov7_tracker_tpu_torch.trackers import slab as S
from yolov7_tracker_tpu_torch.trackers.registry import build_tracker
from yolov7_tracker_tpu_torch.utils import trace

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

GRU = "weights/dhn_h32.msgpack"


def _seeded_dhn(hidden: int, seed: int = 0) -> tdhn.DHN:
    """A DHN with every bias drawn, the GRUs' r and z hidden biases among
    them (Flax's GRUCell has none, so the msgpack path never sets them)."""
    torch.manual_seed(seed)
    model = tdhn.DHN(hidden)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "bias" in name:
                p.uniform_(-0.5, 0.5)
    return model.eval()


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("shape", [(6, 5), (2, 8, 6)])
def test_reference_dhn_equals_the_ports(hidden, shape):
    """The reference's written-out GRU equations against the port's
    nn.GRU, both in float64, on one cost and on two stacked."""
    model = _seeded_dhn(hidden).double()
    sd = {k: v.double() for k, v in model.state_dict().items()}
    assert float(sd["lstm_row.bias_hh_l0"][:2 * hidden].abs().min()) > 0
    cost = np.random.default_rng(1).uniform(0, 1, shape)
    with torch.no_grad():
        want = model(torch.from_numpy(cost)).numpy()
    got = ref_dhn.forward(sd, cost).numpy()
    assert want.std() > 1e-4
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)


@pytest.mark.parametrize("hidden,h,w", [(256, 6, 5), (32, 4, 7)])
def test_dhn_flops_counts_the_references_products(hidden, h, w):
    """dhn_flops against torch's count of every matmul the reference
    forward makes (two a multiply-add), on two stacked costs."""
    sd = {k: v.double() for k, v in _seeded_dhn(hidden).state_dict().items()}
    with FlopCounterMode(display=False) as counter:
        ref_dhn.forward(sd, np.zeros((2, h, w)))
    assert counter.get_total_flops() == 2 * ref_dhn.dhn_flops(hidden, h, w)
    assert ref_dhn.dhn_flops(256, 1, 1) == 8_162_432


def test_compact_cost_equals_the_ports():
    rng = np.random.default_rng(4)
    cost = rng.uniform(0, 1, (9, 7))
    rows, cols = rng.random(9) < 0.6, rng.random(7) < 0.5
    key = rng.permutation(9)
    got, rperm, cperm = ref_dhn.compact_cost(cost, rows, cols, row_key=key)
    want, trp, tcp = tdhn.compact_cost(
        torch.from_numpy(cost), torch.from_numpy(rows),
        torch.from_numpy(cols), row_key=torch.from_numpy(key))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(rperm, trp.numpy())
    np.testing.assert_array_equal(cperm, tcp.numpy())
    np.testing.assert_array_equal(ref_dhn.uncompact(got, rperm, cperm),
                                  tdhn.uncompact(want, trp, tcp).numpy())


@pytest.mark.parametrize("form", ["pth", "pt", "state_dict"])
def test_load_dhn_reads_torch_checkpoints(form, tmp_path):
    """A bare state dict (.pth, .pt) or one under ``state_dict`` with
    DataParallel's ``module.`` prefix loads as saved, every GRU bias as it
    stands."""
    model = _seeded_dhn(16)
    sd = model.state_dict()
    path = str(tmp_path / f"dhn.{'pt' if form == 'pt' else 'pth'}")
    if form == "state_dict":
        torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                    "epoch": 3}, path)
    else:
        torch.save(sd, path)
    got = tdhn.load_dhn(path, "gru", 16, "cpu")
    assert not got.training
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    cost = torch.rand(5, 4)
    with torch.no_grad():
        assert torch.equal(got(cost), model(cost))
    # the benchmark's reference reads the same file
    ref_sd = ref_dhn.load(path)
    assert set(ref_sd) == set(sd)


def test_load_dhn_refuses_a_checkpoint_that_does_not_fit(tmp_path):
    path = str(tmp_path / "dhn.pth")
    torch.save(_seeded_dhn(16).state_dict(), path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tdhn.load_dhn(path, "gru", 32, "cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        tdhn.load_dhn(path, "sinkhorn", device="cpu")
    torch.save(torch.zeros(3), str(tmp_path / "bare.pt"))
    with pytest.raises(ValueError, match="not a state dict"):
        tdhn.load_dhn(str(tmp_path / "bare.pt"), "gru", 16, "cpu")


def test_benchmark_trainer_imports_nothing_of_the_program():
    """perfbench/weights/train_dhn.py, which makes the cell's DHN weights,
    is the benchmark's own: no import of the port or the JAX package."""
    import ast
    import pathlib

    tree = ast.parse(pathlib.Path(
        "perfbench/weights/train_dhn.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"__future__", "argparse", "time", "numpy", "torch",
                    "scipy"}, tops


def test_benchmark_trainer_writes_munkrs(tmp_path):
    """A few steps of the benchmark's trainer at hidden 8 lower its loss
    on a held batch and move every bias, the GRUs' r and z hidden biases
    among them; the file it writes loads in the port's load_dhn and in
    the reference, which agree in float64."""
    from perfbench.weights import train_dhn as B

    rng = np.random.default_rng(3)
    held = B.batch(rng, 8, 6, "cpu")
    torch.manual_seed(0)
    start = B.Munkrs(8)
    with torch.no_grad():
        before = float(B.focal_bce(start(held[0]), held[1]))
    model = B.train(hidden=8, steps=60, size=6, n=8, lr=3e-3, seed=0,
                    log_every=0)
    with torch.no_grad():
        after = float(B.focal_bce(model(held[0]), held[1]))
    assert after < 0.8 * before
    for name, p in model.state_dict().items():
        if "bias_hh" in name:
            assert not torch.equal(p[:16], start.state_dict()[name][:16])
    path = B.save(model, str(tmp_path / "dhn_h8.pth"))
    port = tdhn.load_dhn(path, "gru", 8, "cpu").double()
    cost = np.random.default_rng(4).uniform(0, 1, (2, 7, 5))
    with torch.no_grad():
        want = port(torch.from_numpy(cost)).numpy()
        mine = model.double()(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(want, mine)
    np.testing.assert_allclose(
        ref_dhn.forward(ref_dhn.load(path), cost).numpy(), want, atol=1e-10,
        rtol=0)


def test_committed_dhn_weights_fit_munkrs_h256():
    """The cell's weights file holds Munkrs's state dict at hidden 256,
    which the port and the reference both read."""
    from perfbench.weights import train_dhn as B

    path = "perfbench/weights/dhn_gru_h256.pth"
    want = B.Munkrs(256).state_dict()
    sd = ref_dhn.load(path)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    port = tdhn.load_dhn(path, "gru", 256, "cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(v.double(), sd[k]), k


@pytest.mark.parametrize("name,dhn", [
    ("void dhn_gru_persistent<float, 256>(float const*, float*)", True),
    ("dhn_gru_step_kernel", True),
    ("void tracker::gru_layer<256>(float*)", True),
    ("elemWiseRNNcell<float, float, float, (cudnnRNNMode_t)3>", True),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::sigmoid_kernel_cuda>", False),
    ("void auction_k4<float>(float const*, int*)", False),
    ("kalman_predict_gru_free", False),
])
def test_dhn_kernel_pattern_takes_hand_written_dhn_kernels(name, dhn):
    """dhn_ms_per_frame's rule for kernels to come: a function name that
    begins with dhn_ or gru_ counts as the DHN's."""
    pattern = by_name("metrics", "dhn_ms_per_frame").DHN
    assert bool(pattern.search(name)) == dhn


def test_load_dhn_reads_msgpack_as_before(tmp_path):
    """The Flax file loads as it did, and saved again as a torch
    checkpoint (train/dhn_train.save_dhn) it loads to the same module."""
    from yolov7_tracker_tpu_torch.models.from_jax import dhn_state_dict
    from yolov7_tracker_tpu_torch.train.dhn_train import save_dhn
    from yolov7_tracker_tpu_torch.utils.flax_msgpack import load_variables

    got = tdhn.load_dhn(GRU, "gru", 32, "cpu")
    want = dhn_state_dict(load_variables(GRU), "gru")
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
    path = save_dhn(str(tmp_path / "dhn_h32.pth"), got, "gru")
    again = tdhn.load_dhn(path, "gru", 32, "cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _scene(frames: int = 32, d: int = 12, seed: int = 5):
    """Detections a frame of a 1080 x 1920 scene: walkers on straight
    paths, some born late and some leaving early, two pairs crossing head
    on, 5% missed, a false positive now and then, a few low scores (for
    stage 2); each frame's rows in descending score, at most ``d``."""
    rng = np.random.default_rng(seed)
    objs = []
    for k in range(10):
        start = 0 if k < 5 else int(rng.integers(1, 14))
        end = frames if k % 4 else int(rng.integers(16, 26))
        xy = rng.uniform([100, 100], [1700, 900])
        v = rng.uniform(-6, 6, 2)
        wh = rng.uniform([40, 90], [90, 200])
        objs.append((start, end, xy, v, wh))
    for y in (300.0, 700.0):          # head-on crossings at frame ~16
        objs.append((0, frames, np.array([600.0, y]), np.array([12.0, 0]),
                     np.array([60.0, 140.0])))
        objs.append((0, frames, np.array([984.0, y + 4]),
                     np.array([-12.0, 0]), np.array([60.0, 140.0])))
    out = []
    for t in range(frames):
        rows = []
        for start, end, xy, v, wh in objs:
            if start <= t < end and rng.random() > 0.05:
                c = xy + v * t + rng.normal(0, 1.0, 2)
                s = (rng.uniform(0.55, 0.95) if rng.random() > 0.15
                     else rng.uniform(0.25, 0.45))
                rows.append([*(c - wh / 2), *(c + wh / 2), s, 0.0])
        if rng.random() < 0.3:
            c = rng.uniform([100, 100], [1800, 1000])
            rows.append([*(c - 30), *(c + 30), rng.uniform(0.65, 0.9), 0.0])
        rows = np.array(sorted(rows, key=lambda r: -r[4])[:d])
        out.append(rows)
    return out


def _rows(out) -> dict:
    valid = out.valid.numpy()
    return {int(i): t.astype(np.float64) for i, t in
            zip(out.track_id.numpy()[valid], out.tlwh.numpy()[valid])}


def _exact_stage1(cost, row_mask, col_mask, thresh):
    """``solve_assignment``'s contract by the reference's exact solver."""
    r = np.flatnonzero(row_mask.numpy())
    c = np.flatnonzero(col_mask.numpy())
    r2c = torch.full(row_mask.shape, -1, dtype=torch.int32)
    c2r = torch.full(col_mask.shape, -1, dtype=torch.int32)
    for i, j in lapjv_extended(cost.double().numpy()[np.ix_(r, c)], thresh):
        r2c[r[i]], c2r[c[j]] = int(c[j]), int(r[i])
    return r2c, c2r


@pytest.mark.parametrize("weights,solver", [("seeded", "exact"),
                                            ("seeded", "port"),
                                            ("trained", "port")])
def test_reference_step_equals_the_ports(weights, solver, tmp_path):
    """The port's deepmot step (eager on the CPU, the DHN in float32) from
    its own state, frame by frame, against the plain reference from that
    state (float64, scipy's exact solver), exact and with the port's
    pairings judged: the rows and the state after the step equal.
    ``seeded``: a hidden-32 DHN with every bias drawn, whose scores sit
    near 0.5: stage 1 is dense, and K4's plain version (``port``) breaks
    its near ties (up to 0.001 over the optimum) otherwise than the exact
    solver, so there the judged reference alone equals it, and the port
    with an exact stage 1 (``exact``) equals the exact reference too;
    ``trained``: the repo's hidden-32 file, saved as a torch checkpoint,
    whose scores separate."""
    path = str(tmp_path / "dhn.pth")
    model = (_seeded_dhn(32, seed=3) if weights == "seeded"
             else tdhn.load_dhn(GRU, "gru", 32, "cpu"))
    torch.save(model.state_dict(), path)
    step, cfg = build_tracker(S.TrackerConfig(
        tracker="deepmot", capacity=16, det_capacity=12, conf_thresh=0.5,
        dhn_weights=path, dhn_hidden=32), "cpu")
    kw = {"solve_stage1": _exact_stage1} if solver == "exact" else {}
    dense_ties = (weights, solver) == ("seeded", "port")
    ref = by_name("reference/trackers", "deepmot")
    rcfg = dataclasses.asdict(cfg)
    slab = S.init_slab(cfg, "cpu")
    stats = {"matched": 0, "lost": 0, "removed": 0, "ties": 0,
             "exact_differ": 0}
    for t, rows in enumerate(_scene()):
        det = S.make_det_slab(cfg, rows[:, :4], rows[:, 4], rows[:, 5],
                              len(rows), "cpu")
        st = check._state(slab)
        slab, out = step(slab, det, **kw)
        prog = check._state(slab)
        dets = {"tlbr": rows[:, :4], "score": rows[:, 4], "cls": rows[:, 5]}
        tlwh = np.c_[rows[:, :2], rows[:, 2:4] - rows[:, :2]]
        judge = Judge(judged_pairs(st, prog, {"tlwh": tlwh,
                                              "score": rows[:, 4]}), 0.01)
        for j in (None, judge):
            new, ref_rows = ref.step(st, dets, rcfg, judge=j)
            differ = (check._rows_cmp(_rows(out), ref_rows, 1e-3)[0]
                      + check._state_cmp(prog, new, 1e-3)[0])
            if j is None and dense_ties:
                stats["exact_differ"] += differ
            else:
                assert differ == 0, (t, j)
        assert judge.refused == 0
        stats["ties"] += judge.ties
        stats["matched"] += len(judge.pairs)
        stats["lost"] += int((prog["occupied"] & (prog["state"] == 2)).sum())
        stats["removed"] += int((st["occupied"] & ~prog["occupied"]).sum())
    assert int(slab.next_id) > 14                      # births
    assert stats["matched"] > 150 and stats["lost"] and stats["removed"]
    if dense_ties:
        # the exact pairing differs, the judge takes the port's
        assert stats["exact_differ"] > 0 and stats["ties"] > 0
    else:
        assert stats["ties"] == 0


def test_dhn_span_and_cells_count_in_an_eager_step():
    step, cfg = build_tracker(S.TrackerConfig(
        tracker="deepmot", capacity=16, det_capacity=12, conf_thresh=0.5,
        dhn_weights=GRU, dhn_hidden=32), "cpu")
    rows = _scene(frames=2)
    slab = S.init_slab(cfg, "cpu")
    trace.reset()
    try:
        with trace.recording():
            for r in rows:
                slab, _ = step(slab, S.make_det_slab(
                    cfg, r[:, :4], r[:, 4], r[:, 5], len(r), "cpu"))
        spans, counts = trace.totals(), trace.counters()
    finally:
        trace.reset()
    assert spans["tracker.dhn"]["count"] == 2
    assert spans["tracker"]["count"] == 2
    assert counts["tracker.graph_eager"] == 2


def test_nms_hands_over_rows_in_descending_score():
    """nms_from_raw keeps its rows in descending score (ties in index
    order), so the step's DetSlab, which keeps NMS's first det_capacity
    rows, holds the detections the check's cut keeps: the top
    det_capacity by score, stable."""
    rng = np.random.default_rng(7)
    b, na, nc = 2, 3, 4
    levels = [torch.from_numpy(rng.normal(0, 2, (b, n, n, na, 5 + nc))
                               .astype(np.float32)) for n in (16, 8)]
    for lv in levels:
        lv[..., 4:] += 3.0                   # most candidates above conf
        lv[:, :, 1::2] = lv[:, :, ::2]      # equal scores, other boxes
    anchors = torch.tensor([[[10, 13], [16, 30], [33, 23]],
                            [[30, 61], [62, 45], [59, 119]]], dtype=torch.float32)
    dets, count = tnms.nms_from_raw(levels, anchors, (8, 16),
                                    conf_thres=0.01, iou_thres=0.45,
                                    max_det=120, top_k=600)
    cfg = S.TrackerConfig(tracker="deepmot", capacity=32, det_capacity=48)
    for i in range(b):
        n = int(count[i])
        assert n > 48
        s = dets[i, :n, 4]
        assert bool((s[1:] <= s[:-1]).all())
        full = {"tlbr": dets[i, :n, :4].double().numpy(),
                "score": s.double().numpy(),
                "cls": dets[i, :n, 5].double().numpy()}
        cut = check._cut(full, cfg.det_capacity)
        slab = S.make_det_slab(cfg, dets[i, :, :4], dets[i, :, 4],
                               dets[i, :, 5], count[i], "cpu")
        np.testing.assert_array_equal(slab.tlbr.numpy(),
                                      cut["tlbr"].astype(np.float32))
        np.testing.assert_array_equal(slab.score.numpy(),
                                      cut["score"].astype(np.float32))
