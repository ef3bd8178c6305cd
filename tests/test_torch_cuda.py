"""Tests of the PyTorch port that need a CUDA card (its hand-written
kernels have no CPU mode); each skips without one. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from yolov7_tracker_tpu_torch.ops import auction, auction_square

STEEP = dict(n_phases=2, phase_factor=4.0 ** 2.5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the auction kernel has no CPU mode")
    return torch.device("cuda")


def _problem(rng, n, m, kind):
    if kind == "assoc":
        iou = np.where(rng.random((n, m)) < 0.05,
                       rng.uniform(0, 0.3, (n, m)), 0.0)
        k = min(n, m) // 2
        iou[rng.permutation(n)[:k], rng.permutation(m)[:k]] = rng.uniform(
            0.5, 0.95, k)
        cost = 1.0 - iou
    else:
        cost = rng.random((n, m))
    return (torch.from_numpy(cost.astype(np.float32)),
            torch.from_numpy(rng.random(n) < 0.8),
            torch.from_numpy(rng.random(m) < 0.8))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(128, 300), (256, 300), (7, 5)])
def test_kernel_equals_plain_version(card, n, m):
    """Bit-exact on the card, with the weights staged in shared memory
    (128 x 300) and recomputed from the cost matrix (256 x 300)."""
    rng = np.random.default_rng(n + m)
    for kind in ("assoc", "dense"):
        cost, rm, cm = (t.to(card) for t in _problem(rng, n, m, kind))
        for th in (0.5, 0.9):
            before = auction.LAUNCHES
            k = auction.masked_assignment_auction_cuda(cost, rm, cm, th,
                                                       **STEEP)
            assert auction.LAUNCHES == before + 1
            p = auction.masked_assignment_auction_torch(cost, rm, cm, th,
                                                        **STEEP)
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_batch_of_two_thresholds(card):
    rng = np.random.default_rng(1)
    cost, _, _ = _problem(rng, 128, 300, "assoc")
    rms = torch.from_numpy(rng.random((2, 128)) < 0.5).to(card)
    cms = torch.from_numpy(rng.random((2, 300)) < 0.6).to(card)
    cost = cost.to(card)
    kr, kc = auction.masked_assignment_auction_cuda(cost, rms, cms,
                                                    (0.5, 0.7), **STEEP)
    pr, pc = auction.masked_assignment_auction_torch(cost, rms, cms,
                                                     (0.5, 0.7), **STEEP)
    assert torch.equal(kr, pr) and torch.equal(kc, pc)


def _k2_both(card, cost, rm, cm, th, **kw):
    """K2 and its plain version on the same problem or batch: (r2c, c2r,
    sweeps per problem) of each."""
    kw = {**STEEP, **kw}
    b = rm.shape[0] if rm.dim() == 2 else 1
    outs = []
    for solve in (auction.masked_assignment_auction_cuda,
                  auction.masked_assignment_auction_torch):
        sweeps = torch.zeros(b, dtype=torch.int32, device=card)
        outs.append(solve(cost, rm, cm, th, sweeps=sweeps, **kw) + (sweeps,))
    torch.cuda.synchronize()
    return outs


def _dense_host_case_9():
    """The tenth dense host case of tests/test_torch_auction.py (same
    generator, same seed), a phase of which ends on an unchanged state."""
    rng = np.random.default_rng(3)
    for _ in range(10):
        n, m = int(rng.integers(2, 60)), int(rng.integers(2, 60))
        cost = rng.random((n, m)).astype(np.float32)
        rm, cm = rng.random(n) < 0.85, rng.random(m) < 0.85
        th = float(rng.choice([0.3, 0.5, 0.8]))
    return (torch.from_numpy(cost), torch.from_numpy(rm),
            torch.from_numpy(cm), th)


_K2_STRESS = {
    # name: (n, m, kind, masks, thresh, solver arguments)
    "equal_costs_all_rows_bid": (128, 300, "equal", "none", 0.9, {}),
    "unstaged_256x300": (256, 300, "dense", "random", 0.9, {}),
    "scalar_7x5": (7, 5, "dense", "random", 0.7, {}),
    "more_rows_than_columns": (300, 128, "dense", "random", 0.7,
                               {"max_iters": 64}),
    "odd_widths": (127, 301, "dense", "random", 0.7, {}),
    "all_masked": (128, 300, "assoc", "all", 0.9, {}),
    "max_iters_hit": (128, 300, "dense", "random", 0.9, {"max_iters": 3}),
    "unchanged_state_stop": (0, 0, "host9", "own", 0.0, {}),
    "five_phases": (128, 300, "dense", "random", 0.9,
                    {"n_phases": 5, "phase_factor": 4.0}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_K2_STRESS))
def test_kernel_on_problems_that_stress_the_sweep(card, name):
    """Bit-exact, sweep counts included, where every row bids on equal
    costs (ties by jitter and row), on the unstaged and the scalar-load
    paths, with more rows than columns (the sweep limit cuts an
    oscillation), with nothing to match, with max_iters hit, where a phase
    ends on an unchanged state, and over five phases."""
    n, m, kind, masks, th, kw = _K2_STRESS[name]
    rng = np.random.default_rng(len(name) + n)
    if kind == "host9":
        cost, rm, cm, th = _dense_host_case_9()
    elif kind == "equal":
        cost = torch.full((n, m), 0.25)
    else:
        cost, rm, cm = _problem(rng, n, m, kind)
    if masks == "none":
        rm, cm = torch.ones(n, dtype=torch.bool), torch.ones(m,
                                                             dtype=torch.bool)
    elif masks == "all":
        rm, cm = torch.zeros(n, dtype=torch.bool), torch.zeros(
            m, dtype=torch.bool)
    k, p = _k2_both(card, cost.to(card), rm.to(card), cm.to(card), th, **kw)
    for got, want in zip(k, p):
        assert torch.equal(got, want)
    assert int(k[2]) > 0
    if name == "max_iters_hit":
        whole = torch.zeros(1, dtype=torch.int32, device=card)
        auction.masked_assignment_auction_cuda(
            cost.to(card), rm.to(card), cm.to(card), th, sweeps=whole,
            **STEEP)
        assert int(k[2]) <= 6 and int(k[2]) < int(whole)
    if name == "equal_costs_all_rows_bid":
        assert int((k[0] >= 0).sum()) == n
    if name == "all_masked":
        assert int((k[0] >= 0).sum()) == 0 and int(k[2]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("b", [6, 264])
def test_kernel_batches_with_their_own_costs_and_thresholds(card, b):
    """A (B, N, M) cost with B thresholds, one block per problem; B = 264
    is two waves of blocks on 132 SMs. Results and sweep counts equal the
    plain version's."""
    rng = np.random.default_rng(b)
    probs = [_problem(rng, 128, 300, "assoc" if i % 3 else "dense")
             for i in range(b)]
    cost, rm, cm = (torch.stack(x).to(card) for x in zip(*probs))
    th = torch.from_numpy(rng.choice([0.3, 0.5, 0.7, 0.9], b)).float()
    k, p = _k2_both(card, cost, rm, cm, th.to(card))
    for got, want in zip(k, p):
        assert torch.equal(got, want)
    assert len({int(x) for x in k[2]}) > 1


@pytest.mark.cuda
def test_profiling_build_solves_the_same_and_counts_cycles(card):
    """The -DAUCTION_PROFILE build gives the timed build's result, fills a
    cycle count for every part of the solve on every warp of the block, and
    adds to no launch count."""
    cost, rm, cm = (t.to(card) for t in _problem(
        np.random.default_rng(4), 128, 300, "dense"))
    before = auction.LAUNCHES
    r2c, c2r, cycles = auction.profile_auction(cost, rm, cm, 0.9, **STEEP)
    assert auction.LAUNCHES == before
    k = auction.masked_assignment_auction_cuda(cost, rm, cm, 0.9, **STEEP)
    assert torch.equal(r2c, k[0]) and torch.equal(c2r, k[1])
    parts = auction.profile_parts()
    assert cycles.shape == (1, auction.PROFILE_WARPS, len(parts))
    timed = [i for i, part in enumerate(parts) if not part.endswith("count")]
    assert bool((cycles[0, :16][:, timed].sum(dim=1) > 0).all())
    assert int(cycles[0, 16:].sum()) == 0
    fire = auction.prepared_auction(cost, rm, cm, 0.9, **STEEP)
    fire()
    assert auction.LAUNCHES == before + 2


@pytest.mark.cuda
def test_wrapper_checks_its_inputs(card):
    cost, rm, cm = (t.to(card) for t in _problem(
        np.random.default_rng(2), 16, 12, "assoc"))
    with pytest.raises(ValueError):
        auction.masked_assignment_auction_cuda(cost.double(), rm, cm, 0.5)
    with pytest.raises(ValueError):
        auction.masked_assignment_auction_cuda(cost.t(), rm, cm, 0.5)
    with pytest.raises(ValueError):
        auction.masked_assignment_auction_cuda(cost, rm[:5], cm, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(128, 300), (256, 300), (7, 5)])
def test_square_kernel_k1_equals_plain_version(card, n, m):
    """Bit-exact on the card, sweep and cell counts included, with the real block
    staged in shared memory (128 x 300) and read from the cost matrix
    (256 x 300)."""
    rng = np.random.default_rng(n * m)
    for kind in ("assoc", "dense"):
        cost, rm, cm = (t.to(card) for t in _problem(rng, n, m, kind))
        for th in (0.5, 0.9):
            before = auction_square.LAUNCHES_K1
            ks = torch.zeros((1, 5), dtype=torch.int32, device=card)
            ps = torch.zeros((1, 5), dtype=torch.int32, device=card)
            kn = torch.zeros(1, dtype=torch.int64, device=card)
            pn = torch.zeros(1, dtype=torch.int64, device=card)
            k = auction_square.masked_assignment_square_cuda(
                cost, rm, cm, th, n_phases=5, sweeps=ks, cells=kn)
            assert auction_square.LAUNCHES_K1 == before + 1
            p = auction_square.masked_assignment_square_torch(
                cost, rm, cm, th, n_phases=5, sweeps=ps, cells=pn)
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
            assert torch.equal(ks, ps) and torch.equal(kn, pn)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 16])
def test_square_kernel_k3_equals_plain_and_k1(card, b):
    """One block per problem, each leaving when its own problem is done ==
    the lockstep plain version == K1 on each problem alone."""
    rng = np.random.default_rng(b)
    probs = [_problem(rng, 128, 300, "assoc" if i % 4 else "dense")
             for i in range(b)]
    cost, rm, cm = (torch.stack(x).to(card) for x in zip(*probs))
    before = auction_square.LAUNCHES_K3
    kr, kc = auction_square.masked_assignment_square_cuda(cost, rm, cm, 0.9,
                                                          n_phases=5)
    assert auction_square.LAUNCHES_K3 == before + 1
    pr, pc = auction_square.masked_assignment_square_torch(cost, rm, cm, 0.9,
                                                           n_phases=5)
    assert torch.equal(kr, pr) and torch.equal(kc, pc)
    for i in range(b):
        r, c = auction_square.masked_assignment_square_cuda(
            cost[i].contiguous(), rm[i], cm[i], 0.9, n_phases=5)
        assert torch.equal(r, kr[i]) and torch.equal(c, kc[i])


def _square_both(card, cost, rm, cm, th, **kw):
    """K1/K3 and the plain version on the same problem: results, sweeps
    per phase and problem, cells read."""
    b = cost.shape[0] if cost.dim() == 3 else 1
    n_phases = kw.setdefault("n_phases", 5)
    outs = []
    for solve in (auction_square.masked_assignment_square_cuda,
                  auction_square.masked_assignment_square_torch):
        sweeps = torch.zeros((b, n_phases), dtype=torch.int32, device=card)
        cells = torch.zeros(b, dtype=torch.int64, device=card)
        r2c, c2r = solve(cost, rm, cm, th, sweeps=sweeps, cells=cells, **kw)
        outs.append((r2c, c2r, sweeps, cells))
    torch.cuda.synchronize()
    return outs


_STRESS = {
    # name: (n, m, kind, masks, thresh, solver arguments)
    "all_rows_bid": (128, 300, "low", "none", 0.9, {}),
    "unstaged_256x300": (256, 300, "dense", "random", 0.9, {}),
    "scalar_7x5": (7, 5, "dense", "random", 0.7, {}),
    "more_rows_than_columns": (130, 100, "dense", "random", 0.7, {}),
    "more_rows_odd_width": (40, 23, "dense", "random", 0.7, {}),
    "all_masked": (128, 300, "assoc", "all", 0.9, {}),
    "max_iters_hit": (128, 300, "assoc", "random", 0.9, {"max_iters": 20}),
    "six_phases": (128, 300, "assoc", "random", 0.9, {"n_phases": 6}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_STRESS))
def test_square_kernel_on_problems_that_stress_the_sweep(card, name):
    """Bit-exact, sweeps per phase and cells included, where the carried
    bidder list is long (every cost under the limit: each release frees
    every row), empty from the start (everything masked out) or cut by
    max_iters, on the unstaged and the scalar-load paths, with more rows
    than columns, and over six phases."""
    n, m, kind, masks, th, kw = _STRESS[name]
    rng = np.random.default_rng(len(name) + n)
    if kind == "low":
        cost = torch.from_numpy(
            rng.uniform(0.0, 0.4, (n, m)).astype(np.float32))
    else:
        cost, rm, cm = _problem(rng, n, m, kind)
    if masks == "none":
        rm, cm = torch.ones(n, dtype=torch.bool), torch.ones(m,
                                                             dtype=torch.bool)
    elif masks == "all":
        rm, cm = torch.zeros(n, dtype=torch.bool), torch.zeros(
            m, dtype=torch.bool)
    k, p = _square_both(card, cost.to(card), rm.to(card), cm.to(card), th,
                        **kw)
    for got, want in zip(k, p):
        assert torch.equal(got, want)
    if name == "max_iters_hit":
        assert int(k[2].max()) == 20
    if name == "all_rows_bid":
        assert int((k[0] >= 0).sum()) == n


@pytest.mark.cuda
def test_square_kernel_k3_two_waves_of_blocks(card):
    """B = 264 problems on 132 SMs, one block each: the second wave starts
    as blocks of the first leave."""
    rng = np.random.default_rng(264)
    probs = [_problem(rng, 128, 300, "assoc" if i % 8 else "dense")
             for i in range(264)]
    cost, rm, cm = (torch.stack(x).to(card) for x in zip(*probs))
    k, p = _square_both(card, cost, rm, cm, 0.9)
    for got, want in zip(k, p):
        assert torch.equal(got, want)
    assert len({int(x) for x in k[2].sum(dim=1)}) > 8


@pytest.mark.cuda
def test_square_wrapper_checks_its_inputs(card):
    cost, rm, cm = (t.to(card) for t in _problem(
        np.random.default_rng(2), 16, 12, "assoc"))
    square = auction_square.masked_assignment_square_cuda
    with pytest.raises(ValueError):
        square(cost.double(), rm, cm, 0.5)
    with pytest.raises(ValueError):
        square(cost.t(), rm, cm, 0.5)
    with pytest.raises(ValueError):
        square(cost, rm[:5], cm, 0.5)
    with pytest.raises(ValueError):
        square(cost, rm[None], cm[None], 0.5)   # batched masks, single cost


# ---------------------------------------------------------------------------
# ReID crops and models, ECC: torch ops on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def full_float32():
    """TF32 off for the comparison, restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture
def tf32_allowed():
    """TF32 on for cuDNN and cuBLAS (beyond PyTorch's default, which
    allows it for cuDNN only), restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["osnet_x1_0", "deepsort_cnn"])
def test_reid_crops_and_model_on_the_card(card, tf32_allowed, name):
    """The model in float32 (reid.float32_exact, as the pipeline runs it)
    even where the process allows TF32."""
    from yolov7_tracker_tpu_torch.reid import (build_reid, extractor,
                                               float32_exact)
    from yolov7_tracker_tpu_torch.reid import random_reid_state_dict

    rng = np.random.default_rng(5)
    frame = torch.from_numpy(rng.integers(0, 255, (1080, 1920, 3), np.uint8))
    xy = rng.uniform(-20, 1800, (16, 2))
    tlbr = torch.from_numpy(np.c_[xy, xy + rng.uniform(8, 300, (16, 2))]
                            .astype(np.float32))
    model, hw = build_reid(name)
    model.load_state_dict(random_reid_state_dict(model, seed=1))
    outs = []
    for dev in ("cpu", card):
        crops = extractor.extract_crops(frame.to(dev), tlbr.to(dev), hw)
        with torch.no_grad(), float32_exact():
            feats = model.to(dev).eval()(crops.permute(0, 3, 1, 2))
        outs.append((crops.cpu(), feats.cpu()))
    (c_cpu, f_cpu), (c_card, f_card) = outs
    assert float((c_cpu - c_card).abs().max()) < 1e-4
    assert bool(torch.isfinite(f_card).all())
    rel = float((f_cpu - f_card).abs().max() / f_cpu.abs().max())
    assert rel <= 1e-3, rel


@pytest.mark.cuda
def test_ecc_on_the_card_recovers_a_translation(card, full_float32):
    from yolov7_tracker_tpu_torch.trackers.gmc import GMC

    rng = np.random.default_rng(0)
    # smooth texture: on white noise at this size ECC's steps diverge
    small = torch.from_numpy(rng.integers(0, 255, (135, 240, 3), np.uint8))
    f0 = torch.nn.functional.interpolate(
        small.permute(2, 0, 1)[None].float(), size=(1080, 1920),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    f0 = f0.round().clamp(0, 255).to(torch.uint8).numpy()
    f1 = np.roll(f0, 8, axis=1)           # the scene moves 8 px right
    gmc = GMC("ecc")
    gmc.apply(torch.from_numpy(f0).to(card))
    warp = gmc.apply(torch.from_numpy(f1).to(card))
    assert warp.is_cuda
    assert abs(float(warp[0, 2]) - 8.0) < 0.5, warp
    assert abs(float(warp[1, 2])) < 0.5, warp


# ---------------------------------------------------------------------------
# no host sync inside a tracker step
# ---------------------------------------------------------------------------

_SYNC_CASES = {
    "sort": dict(tracker="sort"),
    "c_bioutracker": dict(tracker="c_bioutracker"),
    "uavmot": dict(tracker="uavmot"),
    "botsort": dict(tracker="botsort"),
    "deepsort": dict(tracker="deepsort", feature_dim=16),
    "strongsort": dict(tracker="strongsort", feature_dim=16),
    "bytetrack_features": dict(tracker="bytetrack", feature_dim=16),
    "deepmot": dict(tracker="deepmot"),
    "deepmot_gru": dict(tracker="deepmot",
                        dhn_weights="weights/dhn_h32.msgpack", dhn_hidden=32),
    "deepmot_sinkhorn": dict(tracker="deepmot", dhn_arch="sinkhorn",
                             dhn_weights="weights/dhn_sinkhorn.msgpack"),
}


def _card_dets(cfg, rng, t, card, warp=None):
    """One frame of 12 jittered boxes moving on a grid, each with its own
    basis vector (plus noise) as feature, made on the card by
    make_det_slab."""
    from yolov7_tracker_tpu_torch.trackers import slab as S

    xy = np.stack(np.meshgrid(np.arange(4), np.arange(3)), -1).reshape(-1, 2)
    xy = xy * 120.0 + 40.0 + t * 3.0 + rng.normal(0, 1.0, xy.shape)
    tlbr = np.c_[xy, xy + 60.0].astype(np.float32)
    feat = ((np.eye(12, cfg.feature_dim)
             + rng.normal(0, 0.01, (12, cfg.feature_dim))).astype(np.float32)
            if cfg.feature_dim else None)
    return S.make_det_slab(cfg, tlbr, rng.uniform(0.3, 0.95, 12),
                           np.zeros(12), np.ones(12, bool), card,
                           feature=feat, warp=warp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_SYNC_CASES))
def test_tracker_step_makes_no_host_sync(card, name):
    """Every step, with no GMC (the identity warp make_det_slab builds on
    the card), runs under torch.cuda.set_sync_debug_mode('error'): any
    device-to-host wait inside it raises. The first step runs outside, as
    it makes the solver's per-device constants."""
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

    step, cfg = build_tracker(S.TrackerConfig(
        capacity=32, det_capacity=24, conf_thresh=0.5, **_SYNC_CASES[name]),
        card)
    rng = np.random.default_rng(0)
    dets = [_card_dets(cfg, rng, t, card) for t in range(12)]
    assert all(d.warp.is_cuda for d in dets)
    slab, _ = step(S.init_slab(cfg, card), dets[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for det in dets[1:]:
            slab, out = step(slab, det)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out.valid.sum()) > 0


@pytest.mark.cuda
def test_ecc_estimate_makes_no_host_sync(card):
    """GMC('ecc') on frames on the card: identity for the first frame and
    an estimate for the second, both without a device-to-host wait."""
    from yolov7_tracker_tpu_torch.trackers.gmc import GMC

    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 255, (2, 64, 96, 3),
                                           np.uint8)).to(card)
    gmc = GMC("ecc")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warps = [gmc.apply(f) for f in frames]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(w.is_cuda for w in warps)
    assert torch.equal(warps[0].cpu(), torch.eye(2, 3))
    assert bool(torch.isfinite(warps[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["strongsort", "deepmot_gru"])
def test_streaming_step_makes_no_host_sync(card, name):
    """The tracker step of process_multistream: three streams stacked,
    stage 1 by the square auction (K3); strongsort with 512-d features as
    ReID gives them, deepmot with the DHN batched over the streams."""
    from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

    kw = dict(_SYNC_CASES[name])
    if name == "strongsort":
        kw["feature_dim"] = 512
    step, cfg = build_tracker(S.TrackerConfig(
        capacity=32, det_capacity=24, conf_thresh=0.5, **kw), card)
    rngs = [np.random.default_rng(s) for s in range(3)]
    dets = []
    for t in range(8):
        lanes = [_card_dets(cfg, r, t, card) for r in rngs]
        dets.append(S.DetSlab(*(torch.stack(x) for x in zip(*lanes))))
    slabs = S.TrackSlab(*(x[None].repeat((3,) + (1,) * x.dim())
                          for x in S.init_slab(cfg, card)))
    slabs, _ = step(slabs, dets[0], solve_stage1=masked_assignment)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for det in dets[1:]:
            slabs, out = step(slabs, det, solve_stage1=masked_assignment)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out.valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch,hidden", [("gru", 32), ("gru", 256),
                                         ("sinkhorn", 0)])
def test_dhn_on_the_card_equals_the_cpu(card, tf32_allowed, arch, hidden):
    """The DHN on a 128 x 48 compacted cost (deepmot's registered
    capacities) and on two stacked, in float32 (deepmot runs it under
    reid.float32_exact) even where the process allows TF32: card against
    CPU within 1e-4. hidden 256 (the reference's width) has seeded
    weights, the others the repo's trained files."""
    from yolov7_tracker_tpu_torch.reid import dhn as dhn_mod
    from yolov7_tracker_tpu_torch.reid import float32_exact

    if hidden == 256:
        torch.manual_seed(0)
        model = dhn_mod.build_dhn(arch, hidden).eval()
    else:
        path = ("weights/dhn_h32.msgpack" if arch == "gru"
                else "weights/dhn_sinkhorn.msgpack")
        model = dhn_mod.load_dhn(path, arch, hidden or dhn_mod.HIDDEN)
    cost = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 128, 48)).astype(np.float32))
    outs = []
    for dev in ("cpu", card):
        model = model.to(dev)
        with torch.no_grad(), float32_exact():
            outs.append([model(cost[0].to(dev)).cpu(),
                         model(cost.to(dev)).cpu()])
    for cpu, dev in zip(*outs):
        assert bool(torch.isfinite(dev).all())
        assert float((cpu - dev).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(541, 961), (1081, 1921), (1080, 1920),
                                (7, 11)])
def test_downscale_on_the_card_equals_the_cpu(card, hw):
    """GMC's gray -> half-size downscale (cv2's INTER_LINEAR in integer
    arithmetic; tests/test_torch_gmc.py holds the CPU against OpenCV),
    bit for bit on the card."""
    from yolov7_tracker_tpu_torch.trackers.gmc import downscale2, to_gray

    frame = torch.from_numpy(np.random.default_rng(hw[0]).integers(
        0, 256, hw + (3,), np.uint8))
    want = downscale2(to_gray(frame))
    got = downscale2(to_gray(frame.to(card)))
    assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("tracker", ["bytetrack", "c_bioutracker"])
def test_predict_only_step_on_the_card_equals_the_cpu(card, tracker):
    """Full steps on every third frame and the predict-only step between
    (--detect_per_frame 3), on the card with no host sync in any step:
    the same tracks as the CPU, boxes within 1e-3."""
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import (
        build_predict_only, build_tracker)

    cfg = S.TrackerConfig(tracker=tracker, capacity=32, det_capacity=24,
                          conf_thresh=0.5)
    outs = {}
    for dev in ("cpu", card):
        step, rcfg = build_tracker(cfg, dev)
        predict = build_predict_only(rcfg)
        rng = np.random.default_rng(0)
        dets = [_card_dets(rcfg, rng, t, dev) for t in range(12)]
        slab, out = step(S.init_slab(rcfg, dev), dets[0])   # constants
        got = [out]
        if dev == card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(1, 12):
                slab, out = (step(slab, dets[t]) if t % 3 == 0
                             else predict(slab))
                got.append(out)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs[str(dev)] = got
    coasted = 0
    for t, (a, b) in enumerate(zip(outs["cpu"], outs[str(card)])):
        v = a.valid
        assert torch.equal(v, b.valid.cpu()), t
        assert torch.equal(a.track_id[v], b.track_id.cpu()[v]), t
        assert torch.allclose(a.tlwh[v], b.tlwh.cpu()[v], atol=1e-3), t
        coasted += int(v.sum()) if t % 3 else 0
    assert coasted > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tracker", ["bytetrack", "sort"])
def test_detections_path_on_the_card_equals_the_cpu(card, tracker):
    """run_sequence_detections (the --detections seam) at the CLI's
    capacity 256 / det_capacity 300, every step on the card after the
    first (which makes the solver's per-device constants) with no host
    sync: the same rows as the CPU."""
    from yolov7_tracker_tpu_torch.pipeline import TrackingPipeline
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 1700, (40, 2))
    vel = rng.uniform(-3, 3, (40, 2))
    dets = {}
    for f in range(1, 31):
        xy = pos + vel * f + rng.normal(0, 2.0, pos.shape)
        keep = rng.uniform(size=40) > 0.1
        rows = np.c_[xy, xy + [40.0, 97.0], rng.uniform(0.5, 0.95, 40),
                     np.zeros(40)][keep]
        fp = rng.uniform(0, 1700, (5, 2))
        dets[f] = np.r_[rows, np.c_[fp, fp + [40.0, 97.0],
                                    rng.uniform(0.1, 0.45, 5), np.zeros(5)]]
    cfg = S.TrackerConfig(tracker=tracker, capacity=256, det_capacity=300)
    results = {}
    for dev in ("cpu", card):
        pipe = TrackingPipeline.__new__(TrackingPipeline)
        pipe.device = torch.device(dev)
        step, pipe.tcfg = build_tracker(cfg, dev)

        calls = []

        def no_sync(slab, det, **kw):
            calls.append(1)
            if pipe.device.type != "cuda" or len(calls) == 1:
                return step(slab, det, **kw)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(slab, det, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        pipe.step = no_sync
        results[str(dev)] = pipe.run_sequence_detections(dets, 30)
    rows = 0
    for a, b in zip(results["cpu"], results[str(card)]):
        assert a[0] == b[0] and a[1] == b[1]
        np.testing.assert_allclose(np.reshape(a[2], (-1, 4)),
                                   np.reshape(b[2], (-1, 4)), atol=1e-3)
        rows += len(a[1])
    assert rows > 300
