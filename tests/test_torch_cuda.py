"""Tests of the PyTorch port that need a CUDA card (its hand-written
kernels have no CPU mode); each skips without one. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from yolov7_tracker_tpu_torch.ops import assignment, auction, auction_square
from yolov7_tracker_tpu_torch.utils import trace

STEEP = dict(n_phases=2, phase_factor=4.0 ** 2.5)


@pytest.fixture
def card():
    """The card; the test runs while the tracer records, so ``launches``
    reads the kernels' launch counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the auction kernel has no CPU mode")
    with trace.recording():
        yield torch.device("cuda")


def launches(kernel: str) -> int:
    """The launches of ``kernel`` (k1, k2, k3, k4, k4_cascade, k5) the
    tracer has counted."""
    return trace.counters().get("launches." + kernel, 0)


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
            before = launches("k2")
            k = auction.masked_assignment_auction_cuda(cost, rm, cm, th,
                                                       **STEEP)
            assert launches("k2") == before + 1
            p = auction.masked_assignment_auction_torch(cost, rm, cm, th,
                                                        **STEEP)
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(128, 300), (256, 300), (127, 301), (7, 5)])
def test_twin_kernel_equals_plain_version(card, n, m):
    """K4 bit-exact on the card (r2c, c2r and sweeps), with the weights
    staged with 16-byte loads (128 x 300), recomputed from the cost matrix
    (256 x 300) and staged with scalar loads (127 x 301); each call is one
    K4 launch and none of K2."""
    rng = np.random.default_rng(n * m)
    for kind in ("assoc", "dense"):
        cost, rm, cm = (t.to(card) for t in _problem(rng, n, m, kind))
        for th in (0.5, 0.9):
            before = launches("k4"), launches("k2")
            ks = torch.zeros(1, dtype=torch.int32, device=card)
            k = auction.masked_assignment_twin_cuda(cost, rm, cm, th,
                                                    sweeps=ks, **STEEP)
            assert (launches("k4"), launches("k2")) == (
                before[0] + 1, before[1])
            ps = torch.zeros(1, dtype=torch.int32, device=card)
            p = auction.masked_assignment_twin_torch(cost, rm, cm, th,
                                                     sweeps=ps, **STEEP)
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
            assert torch.equal(ks, ps) and int(ks) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 16])
def test_twin_kernel_batches_with_their_own_thresholds(card, b):
    rng = np.random.default_rng(b)
    probs = [_problem(rng, 128, 300, "dense" if k % 2 else "assoc")
             for k in range(b)]
    cost, rm, cm = (torch.stack(x).to(card) for x in zip(*probs))
    th = torch.from_numpy(rng.choice([0.3, 0.5, 0.7, 0.9], b).astype(
        np.float32)).to(card)
    k = auction.masked_assignment_twin_cuda(cost, rm, cm, th, **STEEP)
    p = auction.masked_assignment_twin_torch(cost, rm, cm, th, **STEEP)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["max_iters_hit", "all_masked",
                                  "more_rows_than_columns"])
def test_twin_kernel_on_problems_that_stress_the_rounds(card, case):
    rng = np.random.default_rng(3)
    kw = dict(STEEP)
    if case == "more_rows_than_columns":
        cost, rm, cm = _problem(rng, 300, 128, "dense")
        kw["max_iters"] = 64
    else:
        cost, rm, cm = _problem(rng, 128, 300, "dense")
    if case == "max_iters_hit":
        kw["max_iters"] = 3
    if case == "all_masked":
        rm, cm = torch.zeros_like(rm), torch.zeros_like(cm)
    cost, rm, cm = (t.to(card) for t in (cost, rm, cm))
    ks = torch.zeros(1, dtype=torch.int32, device=card)
    ps = torch.zeros(1, dtype=torch.int32, device=card)
    k = auction.masked_assignment_twin_cuda(cost, rm, cm, 0.7, sweeps=ks,
                                            **kw)
    p = auction.masked_assignment_twin_torch(cost, rm, cm, 0.7, sweeps=ps,
                                             **kw)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(ks, ps)


@pytest.mark.cuda
def test_solve_assignment_launches_k4(card):
    """The trackers' solver on a CUDA tensor is one K4 launch, no K2."""
    from yolov7_tracker_tpu_torch.ops.assignment import solve_assignment

    cost, rm, cm = (t.to(card) for t in _problem(
        np.random.default_rng(9), 128, 300, "dense"))
    before = launches("k4"), launches("k2")
    r2c, c2r = solve_assignment(cost, rm, cm, 0.7)
    assert (launches("k4"), launches("k2")) == (before[0] + 1,
                                                       before[1])
    p = auction.masked_assignment_twin_torch(cost, rm, cm, 0.7, **STEEP)
    assert torch.equal(r2c, p[0]) and torch.equal(c2r, p[1])


def _cascade(rng, n, m, depth, b=None):
    """chip_smoke.cascade_problem's DeepSORT-shaped cascade as tensors, or
    b of them stacked."""
    from chip_smoke import cascade_problem

    probs = [cascade_problem(rng, n, m, depth) for _ in range(b or 1)]
    return tuple(torch.from_numpy(np.stack(x) if b else x[0])
                 for x in zip(*probs))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,b", [(128, 300, None), (128, 300, 4),
                                   (256, 300, None), (127, 301, None)])
def test_twin_cascade_kernel_equals_plain_version(card, n, m, b):
    """K4's cascade entry bit-exact on the card (r2c, c2r, every level's
    sweeps) with the weights staged with 16-byte loads (128 x 300), read
    through L2 (256 x 300) and staged with scalar loads (127 x 301); a
    batch with a threshold each; one launch of the entry, no K4."""
    rng = np.random.default_rng(n + m + (b or 0))
    depth = 30 if m == 300 and n == 128 else 8
    cost, rm, cm, tsu = (t.to(card) for t in _cascade(rng, n, m, depth, b))
    th = 0.9 if b is None else torch.tensor([0.5, 0.7, 0.8, 0.9],
                                            device=card)
    k_sw = torch.zeros((b or 1, depth), dtype=torch.int32, device=card)
    p_sw = torch.zeros_like(k_sw)
    before = launches("k4_cascade"), launches("k4")
    k = auction.masked_assignment_twin_cascade_cuda(
        cost, rm, cm, tsu, th, depth, sweeps=k_sw, **STEEP)
    assert (launches("k4_cascade"), launches("k4")) == (
        before[0] + 1, before[1])
    p = assignment.masked_assignment_twin_cascade_torch(
        cost, rm, cm, tsu, th, depth, sweeps=p_sw, **STEEP)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k_sw, p_sw) and int((k[0] >= 0).sum()) > 0


@pytest.mark.cuda
def test_matching_cascade_is_one_launch_on_the_card(card):
    """trackers/appearance.matching_cascade on a CUDA tensor with no solver
    given: one launch of K4's cascade entry and no per-level K4, equal to
    the level-by-level loop over solve_assignment (30 K4 launches)."""
    import types

    from yolov7_tracker_tpu_torch.ops.assignment import solve_assignment
    from yolov7_tracker_tpu_torch.trackers import appearance

    cost, rm, cm, tsu = (t.to(card) for t in _cascade(
        np.random.default_rng(5), 128, 300, 30))
    slab = types.SimpleNamespace(time_since_update=tsu)
    before = launches("k4_cascade"), launches("k4"), launches("k2")
    one = appearance.matching_cascade(cost, slab, rm, cm, 0.9, 30)
    assert (launches("k4_cascade"), launches("k4"),
            launches("k2")) == (before[0] + 1, before[1], before[2])
    loop = appearance.matching_cascade(cost, slab, rm, cm, 0.9, 30,
                                       solve=solve_assignment)
    assert launches("k4") == before[1] + 30
    assert torch.equal(one[0], loop[0]) and torch.equal(one[1], loop[1])


@pytest.mark.cuda
def test_twin_profiling_build_solves_the_same_and_counts_cycles(card):
    """K4's -DAUCTION_PROFILE build (the same library as K2's) gives the
    timed build's result and sweeps, fills a cycle count for every warp
    of the block, and adds to no launch count."""
    cost, rm, cm = (t.to(card) for t in _problem(
        np.random.default_rng(6), 128, 300, "dense"))
    before = launches("k4")
    sw = torch.zeros(1, dtype=torch.int32, device=card)
    r2c, c2r, cycles = auction.profile_twin(cost, rm, cm, 0.9, sweeps=sw,
                                            **STEEP)
    assert launches("k4") == before
    ks = torch.zeros(1, dtype=torch.int32, device=card)
    k = auction.masked_assignment_twin_cuda(cost, rm, cm, 0.9, sweeps=ks,
                                            **STEEP)
    assert torch.equal(r2c, k[0]) and torch.equal(c2r, k[1])
    assert torch.equal(sw, ks)
    parts = auction.profile_parts()
    timed = [i for i, part in enumerate(parts) if not part.endswith("count")]
    assert bool((cycles[0, :16][:, timed].sum(dim=1) > 0).all())
    assert int(cycles[0, 16:].sum()) == 0


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
    before = launches("k2")
    r2c, c2r, cycles = auction.profile_auction(cost, rm, cm, 0.9, **STEEP)
    assert launches("k2") == before
    k = auction.masked_assignment_auction_cuda(cost, rm, cm, 0.9, **STEEP)
    assert torch.equal(r2c, k[0]) and torch.equal(c2r, k[1])
    parts = auction.profile_parts()
    assert cycles.shape == (1, auction.PROFILE_WARPS, len(parts))
    timed = [i for i, part in enumerate(parts) if not part.endswith("count")]
    assert bool((cycles[0, :16][:, timed].sum(dim=1) > 0).all())
    assert int(cycles[0, 16:].sum()) == 0
    fire = auction.prepared_auction(cost, rm, cm, 0.9, **STEEP)
    fire()
    assert launches("k2") == before + 2


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
            before = launches("k1")
            ks = torch.zeros((1, 5), dtype=torch.int32, device=card)
            ps = torch.zeros((1, 5), dtype=torch.int32, device=card)
            kn = torch.zeros(1, dtype=torch.int64, device=card)
            pn = torch.zeros(1, dtype=torch.int64, device=card)
            k = auction_square.masked_assignment_square_cuda(
                cost, rm, cm, th, n_phases=5, sweeps=ks, cells=kn)
            assert launches("k1") == before + 1
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
    before = launches("k3")
    kr, kc = auction_square.masked_assignment_square_cuda(cost, rm, cm, 0.9,
                                                          n_phases=5)
    assert launches("k3") == before + 1
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


def _k5_case(n, dev, seed):
    """The DeepSORT CNN with seeded weights on ``dev``, its folded weights
    and n seeded 128 x 64 crops there."""
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5
    from yolov7_tracker_tpu_torch.reid import (build_reid,
                                               random_reid_state_dict)

    model = build_reid("deepsort_cnn")[0]
    model.load_state_dict(random_reid_state_dict(model, seed=seed))
    model = model.to(dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    crops = torch.randn((n, 128, 64, 3), generator=gen, device=dev)
    return model, k5.fold(model), crops


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 613, 8 * 300])
def test_k5_equals_the_module_and_its_plain_version(card, tf32_allowed, n):
    """K5 against the DeepSORT CNN's eager forward under float32_exact and
    the folded plain version, within 1e-5 of the largest |value|: one crop,
    a frame's 300 slots, a ragged edge, a tick of 8 streams. Each forward
    is 18 launches, each counted once."""
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5
    from yolov7_tracker_tpu_torch.reid import float32_exact

    model, folded, crops = _k5_case(n, card, n)
    before = launches("k5")
    got = k5.forward_cuda(folded, crops)
    torch.cuda.synchronize()
    assert launches("k5") == before + 18
    with torch.no_grad(), float32_exact():
        want = model(crops.permute(0, 3, 1, 2))
        plain = k5.forward_plain(folded, crops)
    scale = float(want.abs().max())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) / scale <= 1e-5
    assert float((got - plain).abs().max()) / scale <= 1e-5


@pytest.mark.cuda
def test_k5_builds_launches_and_checks_its_inputs(card):
    """The build and every launch raise nothing (each launch returns
    cudaGetLastError, which the wrapper raises on; the synchronize
    surfaces a fault during the run), and the wrapper refuses what the
    kernels do not take."""
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5

    lib = k5.load_library()
    assert k5.load_library() is lib
    _, folded, crops = _k5_case(3, card, 3)
    out = k5.forward(folded, crops)
    torch.cuda.synchronize()
    assert out.shape == (3, 512)
    assert torch.allclose(out.norm(dim=1), torch.ones(3, device=card))
    for bad in (crops[:, ::2, ::2].contiguous(), crops.double(),
                crops.cpu()):
        with pytest.raises(ValueError):
            k5.forward_cuda(folded, bad)
    _, cpu_folded, _ = _k5_case(1, "cpu", 3)
    with pytest.raises(ValueError, match="device"):
        k5.forward_cuda(cpu_folded, crops)


@pytest.mark.cuda
def test_pipeline_runs_the_deepsort_cnn_as_k5(card):
    """The pipeline's ReID on the card: the DeepSORT CNN through K5 (18
    launches an embed_dets, features within 1e-5 of the module's), OSNet
    through its module (no K5 launch)."""
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.reid import float32_exact
    from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

    rng = np.random.default_rng(8)
    frame = torch.from_numpy(
        rng.integers(0, 255, (1080, 1920, 3), np.uint8)).to(card)
    xy = rng.uniform(0, 1700, (300, 2))
    tlbr = torch.from_numpy(np.c_[xy, xy + rng.uniform(20, 200, (300, 2))]
                            .astype(np.float32)).to(card)
    for reid, tracker, k5_launches in (("deepsort_cnn", "deepsort", 18),
                                       ("osnet_x0_25", "strongsort", 0)):
        pipe = TrackingPipeline(
            PipelineConfig(model="yolov7-tiny", nc=8, img_size=64,
                           detector_batch=1, dtype="float32", max_det=300,
                           reid=reid),
            TrackerConfig(tracker=tracker, capacity=16, det_capacity=300),
            device=card)
        before = launches("k5")
        feats = pipe.embed_dets(frame, tlbr)
        torch.cuda.synchronize()
        assert launches("k5") == before + k5_launches, reid
        if reid != "deepsort_cnn":
            continue
        from yolov7_tracker_tpu_torch.reid import extractor

        crops = extractor.extract_crops(frame, tlbr, pipe.reid_hw)
        with torch.no_grad(), float32_exact():
            want = pipe.reid_model(crops.permute(0, 3, 1, 2))
        assert float((feats - want).abs().max() / want.abs().max()) <= 1e-5


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


# ---------------------------------------------------------------------------
# the rest of the detector zoo on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolov7", "yolov7-e6e", "yolov5s",
                                  "yolov8s", "yolov4-csp", "yolov3-spp"])
def test_zoo_detector_on_the_card_equals_the_cpu(card, full_float32, name):
    """A model of each new kind at full width, seeded weights: float32 on
    the card equals the CPU, fused and unfused, within chip_smoke's
    ZOO_REL_TOL on each part of the output (each level's xy, wh,
    objectness and class logits; DetectV8's boxes and scores) over
    max(1, the part's largest value); the same forward in bf16 on the
    card is finite, of the same shape, and off by more than that."""
    from chip_smoke import ZOO_REL_TOL, output_parts
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import (YoloV7,
                                                      random_state_dict)

    spec = zoo.get_spec(name, nc=80)
    sd = random_state_dict(spec, seed=0, gain=1.4)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 256, 320, 3)).astype(np.float32))
    outs = {}
    for key, dev, fused, dtype in (("cpu", "cpu", True, torch.float32),
                                   ("card", card, True, torch.float32),
                                   ("unfused", card, False, torch.float32),
                                   ("bf16", card, True, torch.bfloat16)):
        model = YoloV7(spec, fused=fused)
        model.load_state_dict(fuse_state_dict(sd) if fused else sd)
        model = model.to(dev, dtype).eval()
        with torch.no_grad():
            out = model(x.to(dev, dtype))
        outs[key] = output_parts(
            [o.float().cpu() for o in (out if isinstance(out, list)
                                       else [out])], spec, (256, 320))

    def rel(key):
        return max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(outs[key], outs["cpu"]))

    for key in ("card", "unfused"):
        assert rel(key) <= ZOO_REL_TOL, (key, rel(key))
    assert [o.shape for o in outs["bf16"]] == [o.shape for o in outs["cpu"]]
    assert all(bool(torch.isfinite(o).all()) for o in outs["bf16"])
    assert rel("bf16") > ZOO_REL_TOL


@pytest.mark.cuda
def test_v8_pipeline_on_the_card_equals_the_cpu(card, full_float32):
    """yolov8n through TrackingPipeline (DetectV8 -> decoded-path NMS ->
    ByteTrack) in float32, card against CPU: the same ids and boxes
    within 1e-2 px; K2 twice a frame on the card."""
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import (random_state_dict,
                                                      sharpen_heads)
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as S

    spec = zoo.get_spec("yolov8n", nc=4)
    sd = random_state_dict(spec, seed=1, gain=1.6)
    sharpen_heads(sd, spec, obj_boost=10.0)
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (360, 640, 3), np.uint8)
    frames = [np.roll(base, 4 * t, axis=1) for t in range(8)]
    results = {}
    for dev in ("cpu", card):
        pipe = TrackingPipeline(
            PipelineConfig(model="yolov8n", nc=4, img_size=320,
                           detector_batch=4, dtype="float32"),
            S.TrackerConfig(tracker="bytetrack", conf_thresh=0.5,
                            capacity=64, det_capacity=300),
            state_dict=sd, spec=spec, device=dev)
        before = launches("k4")
        results[str(dev)] = pipe.run_sequence(iter(frames))
        launched = launches("k4") - before
    assert launched == 2 * len(frames)
    rows = 0
    for a, b in zip(results["cpu"], results[str(card)]):
        assert a[0] == b[0] and a[1] == b[1]
        np.testing.assert_allclose(np.reshape(a[2], (-1, 4)),
                                   np.reshape(b[2], (-1, 4)), atol=1e-2)
        rows += len(a[1])
    assert rows > 0


# ---------------------------------------------------------------------------
# training and the detector test on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu(card, full_float32):
    """One float32 train step of the narrow four-level IAuxDetect model
    (aux SimOTA, accumulation to the nominal batch, ni = 500 so that every
    group moves) from one seeded state, card against CPU: the losses
    within 1e-4 relative; parameters, EMA, momentum buffers, gradient sum
    and BN statistics within 1e-4 of each tensor's largest value; and a
    second card step makes no host sync."""
    from tests.torch_train_cfgs import narrow_aux_cfg, seeded_batch
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
    from yolov7_tracker_tpu_torch.parallel import train_step as ts

    spec = parse_yaml_cfg(narrow_aux_cfg(), name="aux")
    cfg = ts.OptConfig(batch_size=16)
    runs = {}
    for dev in ("cpu", card):
        state = ts.make_train_state(spec, cfg, seed=0, device=dev)
        state.step = 500
        step = ts.make_train_step(spec, img_size=128, opt_cfg=cfg)
        metrics = step(state, *(torch.from_numpy(x).to(dev)
                                for x in seeded_batch(0)))
        runs[str(dev)] = (state, {k: float(v) for k, v in metrics.items()},
                          step)
    (cpu, cpu_m, _), (gpu, gpu_m, gpu_step) = runs["cpu"], runs[str(card)]
    for k, v in cpu_m.items():
        assert abs(gpu_m[k] - v) <= 1e-4 * abs(v), (k, gpu_m[k], v)
    want, got = cpu.state_dict(), gpu.state_dict()
    for sec in ("model", "ema", "momentum", "grad_acc"):
        for k, v in want[sec].items():
            if v.is_floating_point():
                err = float((got[sec][k].cpu() - v).abs().max())
                assert err <= 1e-4 * float(v.abs().max()) or err == 0.0, (
                    sec, k, err)
    second = [torch.from_numpy(x).to(card) for x in seeded_batch(1)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu_step(gpu, *second)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert gpu.step == 502


@pytest.mark.cuda
def test_multi_label_nms_on_the_card_equals_the_cpu(card):
    """ops/nms.nms with multi_label (cli/test.py's call) on seeded decoded
    rows with tied scores: the same detections on the card as on the
    CPU."""
    from yolov7_tracker_tpu_torch.ops import nms as nms_mod

    rng = np.random.default_rng(0)
    b, n, nc = 2, 2000, 12
    rows = np.concatenate([rng.uniform(20, 600, (b, n, 2)),
                           rng.uniform(8, 80, (b, n, 2)),
                           rng.uniform(0, 1, (b, n, 1)),
                           rng.uniform(0, 1, (b, n, nc)) ** 3],
                          -1).astype(np.float32)
    rows[:, 9::10] = rows[:, 8::10]
    pred = torch.from_numpy(rows)
    for top_k in (8192, 256):
        want = nms_mod.nms(pred, 0.001, 0.65, multi_label=True, top_k=top_k)
        got = nms_mod.nms(pred.to(card), 0.001, 0.65, multi_label=True,
                          top_k=top_k)
        assert torch.equal(got[1].cpu(), want[1])
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   rtol=0, atol=1e-4)
        assert int(want[1].min()) > 0


# ---------------------------------------------------------------------------
# the rest of training on the card: the IBin head and its loss, the rank
# losses, the DHN trainer (chip_smoke phase 11)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_ibin_detector_on_the_card_equals_the_cpu(card, full_float32):
    """yolov7's rows with an IBin head at full width, seeded weights
    calibrated on the input as phase 11a calibrates them (so that the
    scores spread over (0, 1)): float32 on the card equals the CPU, fused
    and unfused, within ZOO_REL_TOL on each raw part (xy, w bins, h bins,
    objectness, class); bf16 lands above it; the decoded output agrees
    (chip_smoke.ibin_decode_check: a bin may differ only at a near tie,
    the scores within IBIN_SCORE_TOL while bf16's lie above it)."""
    from chip_smoke import (IBIN_RUN, ZOO_BN_SCALE, ZOO_REL_TOL,
                            calibrate_detector_bn, ibin_decode_check,
                            ibin_spec, ibin_weights, output_parts,
                            standardize_heads)
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import YoloV7

    spec = ibin_spec()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 256, 320, 3)).astype(np.float32))
    _, spread, boost = IBIN_RUN
    sd = calibrate_detector_bn(spec, ibin_weights(spec), x.to(card),
                               ZOO_BN_SCALE)
    sd = standardize_heads(spec, sd, x.to(card), spread, boost)
    raws = {}
    for key, dev, fused, dtype in (("cpu", "cpu", True, torch.float32),
                                   ("card", card, True, torch.float32),
                                   ("unfused", card, False, torch.float32),
                                   ("bf16", card, True, torch.bfloat16)):
        model = YoloV7(spec, fused=fused)
        model.load_state_dict(fuse_state_dict(sd) if fused else sd)
        model = model.to(dev, dtype).eval()
        with torch.no_grad():
            raws[key] = [o.float().cpu() for o in model(x.to(dev, dtype))]
    parts = {k: output_parts(v, spec, (256, 320)) for k, v in raws.items()}
    assert len(parts["cpu"]) == 5 * spec.nl

    def rel(key):
        return max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(parts[key], parts["cpu"]))

    for key in ("card", "unfused"):
        assert rel(key) <= ZOO_REL_TOL, (key, rel(key))
    assert rel("bf16") > ZOO_REL_TOL
    res = ibin_decode_check(spec, raws["card"], raws["cpu"], raws["bf16"])
    assert res["bin_flips_not_near_tie"] == 0


@pytest.mark.cuda
def test_bin_loss_on_the_card_equals_the_cpu(card):
    """A narrow IBin model (the tiny rows at width 0.25) in training mode
    in float64, compute_loss_bin_ota on its float32 preds and backward,
    card against CPU: the same assignments, loss parts within 1e-4
    relative, every gradient within 1e-4 of its tensor's largest."""
    from tests.torch_train_cfgs import seeded_batch
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
    from yolov7_tracker_tpu_torch.models.yolo import (YoloV7,
                                                      random_state_dict)
    from yolov7_tracker_tpu_torch.train import loss as loss_mod

    rows = zoo.yolov7_tiny_rows()
    f, n, _, args = rows[-1]
    rows[-1] = [f, n, "IBin", args]
    spec = parse_yaml_cfg({"nc": 8, "depth_multiple": 1.0,
                           "width_multiple": 0.25,
                           "anchors": zoo.ANCHORS_P5_TINY,
                           "backbone": rows, "head": []}, name="tiny-ibin")
    sd = random_state_dict(spec, seed=0)
    x, t, m = (torch.from_numpy(v) for v in seeded_batch(0))
    runs = {}
    for dev in ("cpu", card):
        model = YoloV7(spec)
        model.load_state_dict(sd)
        model = model.to(dev, torch.float64).train()
        preds = model(x.to(dev, torch.float64), training=True)
        loss, parts = loss_mod.compute_loss_bin_ota(
            [p.float() for p in preds], t.to(dev), m.to(dev), spec, 128)
        loss.backward()
        runs[str(dev)] = ({k: float(v.detach()) for k, v in parts.items()},
                          {k: p.grad.cpu()
                           for k, p in model.named_parameters()})
    (want, want_g), (got, got_g) = runs["cpu"], runs[str(card)]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)
    for k, g in want_g.items():
        assert float((got_g[k] - g).abs().max()) <= 1e-4 * float(
            g.abs().max()), k


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["rank_sort", "alrp", "ap"])
def test_rank_losses_on_the_card_equal_the_cpu(card, loss):
    """Each rank loss at N = 2,000 (15% positives): values and gradient on
    the card within 1e-5 of the CPU's largest."""
    import chip_smoke

    old = chip_smoke.RANK_N
    chip_smoke.RANK_N = 2000
    try:
        inputs = chip_smoke.rank_inputs(loss, seed=1)
    finally:
        chip_smoke.RANK_N = old
    want, want_g = chip_smoke.rank_loss_run(loss, inputs)
    got, got_g = chip_smoke.rank_loss_run(loss, [v.to(card) for v in inputs])
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-30)
    assert float((got_g.cpu() - want_g).abs().max()) <= 1e-5 * float(
        want_g.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,hidden", [("gru", 32), ("sinkhorn", 32)])
def test_dhn_train_step_on_the_card_equals_the_cpu(card, arch, hidden):
    """The first DHN train step (size 16, pad_train, batch 8) in float64 on
    the card against the CPU: loss and gradients within 1e-6
    (chip_smoke.dhn_first_step_parity)."""
    from chip_smoke import dhn_first_step_parity

    rec = dhn_first_step_parity(arch, hidden, card)
    assert rec["loss_rel"] <= 1e-6 and rec["grad_worst_rel"] <= 1e-6


@pytest.mark.cuda
def test_dhn_trainer_on_the_card_feeds_deepmot(card, tmp_path):
    """python -m ...train.dhn_train --device cuda: the file it writes keeps
    the r / z hidden biases at zero, loads on the card and runs in deepmot
    with K2 twice a frame."""
    from yolov7_tracker_tpu_torch.reid.dhn import load_dhn
    from yolov7_tracker_tpu_torch.train import dhn_train
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

    out = str(tmp_path / "dhn.msgpack")
    dhn_train.main(["--steps", "20", "--size", "8", "--hidden", "16",
                    "--pad_train", "--batch", "4", "--device", "cuda",
                    "--out", out])
    model = load_dhn(out, "gru", 16, card)
    for k, v in model.state_dict().items():
        if "bias_hh" in k:
            assert not v[:32].any(), k
    step, cfg = build_tracker(S.TrackerConfig(
        tracker="deepmot", capacity=32, det_capacity=24, conf_thresh=0.5,
        dhn_weights=out, dhn_hidden=16), card)
    rng = np.random.default_rng(0)
    slab = S.init_slab(cfg, card)
    before = launches("k4")
    for t in range(6):
        slab, _ = step(slab, _card_dets(cfg, rng, t, card))
    assert launches("k4") - before == 12
    assert int(slab.next_id) > 1


# ---------------------------------------------------------------------------
# int8 serving and the zoo's tail on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_int8_accumulation_on_the_card_is_exact(card):
    """A 3x3 conv over 640 int8 channels near +127 (sums near 9e7, past
    2^24): the card's float64 accumulation equals the CPU's bit for bit,
    and both equal the integer sums, which a float32 conv does not
    give."""
    from yolov7_tracker_tpu_torch.models.blocks import quant_accumulate

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(100, 128, (2, 640, 6, 7)).astype(
        np.float32))
    w = torch.from_numpy(rng.integers(100, 128, (8, 640, 3, 3)).astype(
        np.int8))
    w[::2] *= -1
    cpu = quant_accumulate(q, w, 1, 1, 1)
    got = quant_accumulate(q.to(card), w.to(card), 1, 1, 1).cpu()
    assert torch.equal(got, cpu)
    exact = torch.nn.functional.conv2d(q.long().double(), w.double(), None,
                                       1, 1)
    assert torch.equal(cpu, exact) and float(cpu.abs().max()) > 2 ** 24
    f32 = torch.nn.functional.conv2d(q.to(card), w.float().to(card), None,
                                     1, 1).cpu()
    assert (f32.double() != got).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolov7-tiny", "yolov7-w6"])
def test_int8_detector_on_the_card_equals_the_cpu(card, full_float32, name):
    """The int8 model (calibrated on the CPU) on the card against the
    same state on the CPU, float32 input: each raw part within
    chip_smoke's ZOO_REL_TOL (the activations after a QuantConv are
    rounded from float64, so q is the same on both devices)."""
    from chip_smoke import ZOO_REL_TOL, output_parts
    from yolov7_tracker_tpu_torch.models import quant, zoo
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import (YoloV7,
                                                      random_state_dict)

    spec = zoo.get_spec(name, nc=80)
    fused = fuse_state_dict(random_state_dict(spec, seed=0, gain=1.4))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 256, 320, 3)).astype(np.float32))
    sd = quant.quantize_state_dict(spec, fused, calib_batches=[x[:1]],
                                   device="cpu")
    outs = {}
    for dev in ("cpu", card):
        model = YoloV7(spec, fused="int8")
        model.load_state_dict(sd)
        model = model.to(dev).eval()
        with torch.no_grad():
            outs[str(dev)] = output_parts(
                [o.cpu() for o in model(x.to(dev))], spec, (256, 320))
    rel = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
              for a, b in zip(outs[str(card)], outs["cpu"]))
    assert rel <= ZOO_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ghost", "swin", "orepa", "robust"])
def test_tail_cfgs_on_the_card_equal_the_cpu(card, full_float32, name):
    """chip_smoke's tail cfgs (the JAX package's own test cfgs) at 256 x
    320, seeded weights: float32 on the card equals the CPU, fused and
    unfused, within ZOO_REL_TOL of each raw part."""
    from chip_smoke import TAIL_CFGS, ZOO_REL_TOL, output_parts
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
    from yolov7_tracker_tpu_torch.models.yolo import (YoloV7,
                                                      random_state_dict)

    nc, anchors, rows = TAIL_CFGS[name]
    spec = parse_yaml_cfg({"nc": nc, "depth_multiple": 1.0,
                           "width_multiple": 1.0, "anchors": anchors,
                           "backbone": rows, "head": []}, name=name)
    sd = random_state_dict(spec, seed=0)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 256, 320, 3)).astype(np.float32))
    outs = {}
    for key, dev, fused in (("cpu", "cpu", True), ("card", card, True),
                            ("unfused", card, False)):
        model = YoloV7(spec, fused=fused)
        model.load_state_dict(fuse_state_dict(sd) if fused else sd)
        model = model.to(dev).eval()
        with torch.no_grad():
            outs[key] = output_parts([o.cpu() for o in model(x.to(dev))],
                                     spec, (256, 320))

    def rel(key):
        return max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(outs[key], outs["cpu"]))

    assert rel("card") <= ZOO_REL_TOL and rel("unfused") <= ZOO_REL_TOL


# ---------------------------------------------------------------------------
# the parallel layer on one card: two ranks share it over gloo (a
# correctness check: gloo moves the card's tensors through the host)
# ---------------------------------------------------------------------------

PAR_TRACK = dict(tracker="bytetrack", conf_thresh=0.5, capacity=16,
                 det_capacity=16, track_buffer=3)


def _launch_on(devices, body, *args):
    """``body`` on one rank a device (gloo where a card repeats, NCCL for
    one)."""
    import datetime

    from yolov7_tracker_tpu_torch.parallel import mesh as M

    return M.launch(body, len(devices), devices, *args,
                    timeout=datetime.timedelta(seconds=300))


def _suite_on_the_card(card, tmp_path, cases):
    from tests import torch_parallel_ranks as ranks

    path = str(tmp_path / "cases.pt")
    torch.save(cases, path)
    return _launch_on([f"{card}:0"] * 2, ranks.suite, path)


@pytest.mark.cuda
def test_sharded_tracking_on_one_card(card, tmp_path):
    """8 ByteTrack streams on two ranks of one card: each rank launches K3
    (stage 1) and K2 (stages 2 + 3) once a frame for its 4 streams, and
    the gathered slabs and outputs equal one process's track_scan_multi
    on the card, bit for bit."""
    from tests import torch_parallel_ranks as ranks
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers import slab as TS

    auction.load_library()          # built once, before the ranks start
    auction_square.load_library()
    dets = ranks.det_streams(8, 12)
    got = _suite_on_the_card(card, tmp_path, {
        "track": {"cfg": PAR_TRACK, "dets": dets}})
    assert got["world"] == (2, "gloo")
    assert got["track"]["launches"].tolist() == [[12, 12], [12, 12]]
    pipe = TrackingPipeline(PipelineConfig(model="yolov7-tiny", nc=1,
                                           img_size=64, dtype="float32"),
                            TS.TrackerConfig(**PAR_TRACK), device=card)
    slabs, outs = pipe.track_scan_multi(
        pipe.init_multistream(8),
        TS.DetSlab(*(torch.from_numpy(x).to(card) for x in dets)))
    for name, a, b in zip(TS.TrackSlab._fields + TS.FrameOutput._fields,
                          got["track"]["slabs"] + got["track"]["outs"],
                          tuple(slabs) + tuple(outs)):
        assert torch.equal(a.to(card), b), name
    assert int(outs.valid.sum()) > 200


@pytest.mark.cuda
def test_spatial_detection_on_one_card(card, full_float32, tmp_path):
    """yolov7-tiny (nc 4, seeded, heads sharpened) height-sharded over two
    ranks of one card in float32: the raw levels within 1e-4 of each
    level's largest value against the unsharded model, and
    detect_batch_spatial with detect_batch's counts and boxes."""
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import (random_state_dict,
                                                      sharpen_heads)
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

    spec = zoo.get_spec("yolov7-tiny", nc=4)
    sd = random_state_dict(spec, seed=3)
    sharpen_heads(sd, spec)
    pcfg = dict(model="yolov7-tiny", nc=4, img_size=256, detector_batch=1,
                dtype="float32", conf_thres=0.01)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (1, 240, 320, 3), np.uint8)
    imgs = rng.uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
    got = _suite_on_the_card(card, tmp_path, {"spatial": {
        "model": "yolov7-tiny", "nc": 4, "pipe": pcfg, "state_dict": sd,
        "imgs": imgs, "frames": frames}})["spatial"]
    pipe = TrackingPipeline(PipelineConfig(**pcfg),
                            TrackerConfig(capacity=16, det_capacity=16),
                            state_dict=sd, spec=spec, device=card)
    with torch.no_grad():
        want = pipe.model(torch.from_numpy(imgs).to(card))
    for a, b in zip(got["raw"], want):
        assert float((a.to(card) - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    want = [x.cpu().numpy() for x in pipe.detect_batch(frames)]
    got = [x.cpu().numpy() for x in got["detect"]]
    np.testing.assert_array_equal(got[3], want[3])
    n = int(want[3][0])
    assert n > 10
    np.testing.assert_allclose(np.sort(got[1][0, :n]),
                               np.sort(want[1][0, :n]), rtol=1e-4)


@pytest.mark.cuda
def test_data_parallel_train_step_on_one_card(card, tmp_path):
    """Two train steps (ni 1003: accumulation carries, then applies) of the
    narrow IAuxDetect model on a global batch of 4, float32 (TF32 off):
    two ranks sharing the card (gloo) against one rank (NCCL). The ranks'
    states equal bit for bit; against one rank, parameters, EMA,
    momentum, gradient sum and BN statistics within 1e-4 of each tensor's
    largest value, losses within 1e-4 relative."""
    from tests import torch_parallel_ranks as ranks
    from tests.torch_train_cfgs import narrow_aux_cfg, seeded_batch
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
    from yolov7_tracker_tpu_torch.parallel import train_step as ts

    cfg = narrow_aux_cfg()
    opt = dict(batch_size=16, nominal_batch=64, epochs=2, steps_per_epoch=4)
    sd = ts.make_train_state(parse_yaml_cfg(cfg, name="aux"),
                             ts.OptConfig(**opt), seed=0,
                             device="cpu").state_dict()
    sd["step"] = 1003
    path = str(tmp_path / "case.pt")
    torch.save({"spec_cfg": cfg, "opt": opt, "hyp": {}, "img": 128,
                "runs": [(sd, [seeded_batch(0), seeded_batch(1)])]}, path)
    out = {}
    for n in (1, 2):
        d = tmp_path / f"world{n}"
        d.mkdir()
        _launch_on([f"{card}:0"] * n, ranks.train_steps, path, str(d))
        out[n] = [torch.load(str(d / f"rank{r}.pt"), weights_only=False)
                  ["runs"][0] for r in range(n)]
    for (a, ma), (b, mb) in zip(out[2][0], out[2][1]):
        assert ma == mb
        for sec in ("model", "ema", "momentum", "grad_acc"):
            for k, v in a[sec].items():
                assert torch.equal(v, b[sec][k]), (sec, k)
    for (got, gm), (want, wm) in zip(out[2][0], out[1][0]):
        for k, v in wm.items():
            assert abs(gm[k] - v) <= 1e-4 * abs(v), (k, gm[k], v)
        for sec in ("model", "ema", "momentum", "grad_acc"):
            for k, v in want[sec].items():
                if v.is_floating_point():
                    err = float((got[sec][k] - v).abs().max())
                    assert err <= 1e-4 * float(v.abs().max()) or err == 0.0, (
                        sec, k, err)
    assert [s["ema_count"] for s, _ in out[2][0]] == [0, 1]


@pytest.mark.cuda
def test_tracer_times_on_the_card_without_a_sync(card):
    """utils/trace.py on a CUDA tensor: spans opened and closed under
    sync-debug "error" (two CUDA events each, no synchronize), the
    device's time of queued matmuls read back after the fact (longer
    than the host's time to launch them), and the events reused once
    read back."""
    x = torch.randn(2048, 2048, device=card)
    x @ x                               # cuBLAS set up before the spans
    trace.reset()
    # the events earlier tests' spans left for reuse: the counts below are
    # this test's own
    trace.TRACER.free.pop(x.device, None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            with trace.span("outer", x):
                with trace.span("inner", x):
                    for _ in range(20):
                        x = (x @ x) * 1e-3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = trace.totals()
    assert got["inner"]["count"] == got["outer"]["count"] == 3
    assert got["inner"]["ms"] > 2 * got["inner"]["host_ms"]
    assert got["inner"]["ms"] <= got["outer"]["ms"]
    assert got["outer"]["self_ms"] == pytest.approx(
        got["outer"]["ms"] - got["inner"]["ms"])
    free = trace.TRACER.free[x.device]
    assert len(free) == 12 and not trace.TRACER.pending
    with trace.span("again", x):
        pass
    assert len(free) == 10
    trace.reset()


# ---------------------------------------------------------------------------
# the tracker step as one CUDA graph (trackers/graphed.py)
# ---------------------------------------------------------------------------

_GRAPH_CASES = {
    "sort": dict(tracker="sort"),
    "bytetrack": dict(tracker="bytetrack"),
    "c_bioutracker": dict(tracker="c_bioutracker"),
    "deepsort": dict(tracker="deepsort"),
    "botsort": dict(tracker="botsort"),
    "uavmot": dict(tracker="uavmot"),
    "strongsort": dict(tracker="strongsort"),
    "deepmot": dict(tracker="deepmot"),
    "deepmot_gru": _SYNC_CASES["deepmot_gru"],
    "deepmot_sinkhorn": _SYNC_CASES["deepmot_sinkhorn"],
}
_KERNELS = ("k1", "k2", "k3", "k4", "k4_cascade")


def _graph_step(card, name, det_capacity=32, **extra):
    """(the built step, the registered step over the same options, the
    resolved config) of ``name``, 64 tracks."""
    from yolov7_tracker_tpu_torch.trackers import registry
    from yolov7_tracker_tpu_torch.trackers import slab as S

    step, cfg = registry.build_tracker(S.TrackerConfig(
        capacity=64, det_capacity=det_capacity, **_GRAPH_CASES[name],
        **extra), card)
    eager = functools.partial(registry._STEPS[cfg.tracker][0],
                              **step.keywords)
    return step, eager, cfg


def _stepped(steps, slab, dets, predict_every=0, **kw):
    """Every (slab, output) of the frames; with ``predict_every`` each
    such frame is a predict-only step (``steps`` = (tracker, predict)),
    else ``steps`` is the tracker. The counts of the kernels' launches
    over the frames ride along."""
    before = {k: launches(k) for k in _KERNELS}
    out = []
    for i, det in enumerate(dets):
        if predict_every and i % predict_every == 1:
            slab, o = steps[1](slab)
        else:
            slab, o = (steps[0] if predict_every else steps)(slab, det, **kw)
        out.append((slab, o))
    return out, {k: launches(k) - before[k] for k in _KERNELS}


def _assert_bitwise(got, want):
    from tests.step_scenes import differing

    assert len(got) == len(want)
    for i, ((s, o), (ws, wo)) in enumerate(zip(got, want)):
        assert not differing(s, ws), (i, differing(s, ws))
        assert not differing(o, wo), (i, differing(o, wo))


def _graph_counts():
    c = trace.counters()
    return {k: c.get("tracker.graph_" + k, 0)
            for k in ("captures", "replays", "eager")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_GRAPH_CASES)
                         + ["botsort_cpu_warp", "predict"])
def test_graphed_step_equals_the_eager_step(card, name):
    """Every registered tracker (deepmot with no DHN, a GRU DHN and a
    Sinkhorn one), a warp handed over on the CPU, and the predict-only
    step between ByteTrack's frames: the graphed step equals the eager
    step bit for bit on every field of every slab and output over a
    60-frame scene with births, losses, removals, a crossing and a frame
    of more detections than det_capacity; one capture serves the 60
    frames, and the kernels' launches a frame are the eager step's."""
    from tests.step_scenes import det_slabs, scene
    from yolov7_tracker_tpu_torch.trackers import registry
    from yolov7_tracker_tpu_torch.trackers import slab as S

    every = 0
    base = {"botsort_cpu_warp": "botsort", "predict": "bytetrack"}
    step, eager, cfg = _graph_step(card, base.get(name, name))
    dets = det_slabs(cfg, scene(7, 60), card)
    assert max(int(d.valid.sum()) for d in dets) == cfg.det_capacity
    if name == "botsort_cpu_warp":
        dets = [d._replace(warp=d.warp.cpu()) for d in dets]
    if name == "predict":
        predict = registry.build_predict_only(cfg)
        step = (step, predict)
        eager = (eager, predict.__wrapped__.__wrapped__)
        every = 3
    before = _graph_counts()
    got, got_n = _stepped(step, S.init_slab(cfg, card), dets, every)
    counts = _graph_counts()
    want, want_n = _stepped(eager, S.init_slab(cfg, card), dets, every)
    _assert_bitwise(got, want)
    assert got_n == want_n and sum(want_n.values()) > 0, (got_n, want_n)
    assert counts["captures"] - before["captures"] == 1 + (every > 0)
    assert counts["replays"] - before["replays"] == 60
    assert counts["eager"] == before["eager"]
    assert int(got[-1][1].valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bytetrack", "deepsort", "strongsort",
                                  "deepmot_gru"])
def test_graphed_stacked_step_equals_the_eager_step(card, name):
    """Four streams stacked, stage 1 by the square auction (K3), as
    process_multistream steps them: the graphed step equals the eager
    one bit for bit over 60 frames, with the same launches."""
    from tests.step_scenes import det_slabs, scene, stacked
    from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
    from yolov7_tracker_tpu_torch.trackers import slab as S

    step, eager, cfg = _graph_step(card, name)
    lanes = [det_slabs(cfg, scene(seed, 60), card) for seed in range(4)]
    dets = [stacked(list(frame)) for frame in zip(*lanes)]
    slabs = stacked([S.init_slab(cfg, card)] * 4)
    got, got_n = _stepped(step, slabs, dets,
                          solve_stage1=masked_assignment)
    want, want_n = _stepped(eager, slabs, dets,
                            solve_stage1=masked_assignment)
    _assert_bitwise(got, want)
    # a K3 launch a frame; deepsort's cascade is solved level by level,
    # a K3 launch for each of its 30 levels
    k3 = 60 * (30 if name == "deepsort" else 1)
    assert got_n == want_n and got_n["k3"] == k3, (got_n, want_n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bytetrack", "deepsort"])
def test_graphed_step_leaves_the_callers_tensors_alone(card, name):
    """Every slab and output a caller keeps holds its values after the
    later replays, whether the next call is handed the slab it returned
    or another."""
    from tests.step_scenes import det_slabs, differing, scene
    from yolov7_tracker_tpu_torch.trackers import slab as S

    step, _, cfg = _graph_step(card, name)
    dets = det_slabs(cfg, scene(3, 60), card)
    slab = S.init_slab(cfg, card)
    kept = []
    for i, det in enumerate(dets):
        if i % 10 == 5:               # a slab the graph did not return
            slab = S.TrackSlab(*(t.clone() for t in slab))
        slab, out = step(slab, det)
        kept.append((slab, out, S.TrackSlab(*(t.clone() for t in slab)),
                     S.FrameOutput(*(t.clone() for t in out))))
    for i, (slab, out, slab_then, out_then) in enumerate(kept):
        assert not differing(slab, slab_then), (i, differing(slab, slab_then))
        assert not differing(out, out_then), (i, differing(out, out_then))


@pytest.mark.cuda
def test_one_capture_a_signature(card):
    """One capture for each det_capacity, the first kept when another
    comes (no capture on coming back), and each graph the eager step's;
    no step span inside a replay, and no host sync in one."""
    from tests.step_scenes import det_slabs, scene
    from yolov7_tracker_tpu_torch.trackers import slab as S

    step, eager, cfg = _graph_step(card, "bytetrack")
    wide, _, wide_cfg = _graph_step(card, "bytetrack", det_capacity=48)
    frames = scene(5, 30)
    narrow_dets = det_slabs(cfg, frames, card)
    wide_dets = det_slabs(wide_cfg, frames, card)
    dets = narrow_dets[:10] + wide_dets[10:20] + narrow_dets[20:]
    trace.reset()
    slab = S.init_slab(cfg, card)
    got = []
    for i, det in enumerate(dets):
        if i not in (0, 10):            # a replay, not a capture
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            slab, out = step(slab, det)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got.append((slab, out))
        if i in (9, 19):
            assert _graph_counts()["captures"] == (1 if i == 9 else 2)
    assert _graph_counts() == {"captures": 2, "replays": 30, "eager": 0}
    totals = trace.totals()
    assert totals["tracker"]["count"] == 30
    assert "tracker.kalman" not in totals and "tracker.solve" not in totals
    assert len(step.func.__wrapped__.graphs) == 2
    want, _ = _stepped(eager, S.init_slab(cfg, card), dets)
    _assert_bitwise(got, want)
