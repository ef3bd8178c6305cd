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
