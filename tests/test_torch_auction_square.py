"""The K1/K3 port (ops/auction_square.py): its plain PyTorch version against
the JAX package's Pallas kernels (interpret mode) bit for bit, against the
XLA function the JAX package runs off the TPU, and against the scipy
oracle, including the dense cases on which the private-dummy auction (K2)
is not exact. The kernels themselves run only on a card:
tests/test_torch_cuda.py holds them against the plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_auction import _host_cases, _launches
from yolov7_tracker_tpu.ops.assignment import masked_assignment as j_masked
from yolov7_tracker_tpu.ops.pallas_auction import (
    masked_assignment_pallas, masked_assignment_pallas_batched,
)
from yolov7_tracker_tpu_torch.ops import auction_square
from yolov7_tracker_tpu_torch.utils import trace
from yolov7_tracker_tpu_torch.ops.assignment import (
    linear_assignment_host, masked_assignment,
)
from yolov7_tracker_tpu_torch.ops.auction_square import (
    masked_assignment_square_torch,
)


def _pallas_test_problems():
    """The three seeded (24, 16) problems of tests/test_assignment.py's
    Pallas interpret tests (association-shaped, prefix masks)."""
    rng = np.random.default_rng(0)
    t, d = 24, 16
    out = []
    for _ in range(3):
        nt, nd = rng.integers(4, t), rng.integers(4, d)
        iou = rng.uniform(0, 0.3, (t, d)).astype(np.float32)
        for k in range(min(nt, nd) - 1):
            iou[k, k] = rng.uniform(0.5, 0.95)
        out.append((1.0 - iou, np.arange(t) < nt, np.arange(d) < nd))
    return out


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _pairs(r2c):
    return {(i, int(j)) for i, j in enumerate(np.asarray(r2c)) if j >= 0}


def _gap_to_scipy(cost, rm, cm, thresh, r2c, c2r):
    """Weight (thresh - cost, summed over the pairs) that the solution
    leaves on the table against scipy's optimum."""
    for i, j in _pairs(r2c):
        assert int(c2r[j]) == i
        assert rm[i] and cm[j] and cost[i, j] <= thresh
    big = np.where(rm[:, None] & cm[None, :], cost, 1e9)
    m0, _, _ = linear_assignment_host(big, thresh)
    want = sum(thresh - cost[a, b] for a, b in m0)
    got = sum(thresh - cost[i, j] for i, j in _pairs(r2c))
    return float(want - got)


@pytest.mark.parametrize("case", range(3))
def test_plain_version_equals_pallas_k1(case):
    """Exact (max |diff| 0 on r2c and c2r) against masked_assignment_pallas
    in interpret mode, whose extended matrix is padded to 128 lanes: the
    plain version drops the padding."""
    cost, rm, cm = _pallas_test_problems()[case]
    j_r2c, j_c2r = masked_assignment_pallas(
        jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm), 0.8,
        n_phases=5, interpret=True)
    sweeps = torch.zeros((1, 5), dtype=torch.int32)
    cells = torch.zeros(1, dtype=torch.int64)
    t_r2c, t_c2r = masked_assignment_square_torch(
        *_t(cost, rm, cm), 0.8, n_phases=5, sweeps=sweeps, cells=cells)
    np.testing.assert_array_equal(t_r2c.numpy(), np.asarray(j_r2c))
    np.testing.assert_array_equal(t_c2r.numpy(), np.asarray(j_c2r))
    assert int((t_r2c >= 0).sum()) > 0 and int(sweeps.sum()) > 0
    # cells read: every row at each release, then at least one unassigned
    # row and at most all of them per sweep
    n, m = cost.shape
    release = 5 * (n * (m + 1) + m * (n + 1))
    per_sweep = int(cells) - release
    assert int(sweeps.sum()) * (min(n, m) + 1) <= per_sweep
    assert per_sweep <= int(sweeps.sum()) * (release // 5)


def test_plain_version_equals_pallas_k3_and_single_solves():
    """The batched plain version == masked_assignment_pallas_batched in
    interpret mode, exactly, and == each problem solved alone (a problem
    that is done idles while the others finish)."""
    costs, rms, cms = map(np.stack, zip(*_pallas_test_problems()))
    j_r2c, j_c2r = masked_assignment_pallas_batched(
        jnp.asarray(costs), jnp.asarray(rms), jnp.asarray(cms), 0.8,
        n_phases=5, interpret=True)
    sweeps = torch.zeros((3, 5), dtype=torch.int32)
    t_r2c, t_c2r = masked_assignment_square_torch(
        *_t(costs, rms, cms), 0.8, n_phases=5, sweeps=sweeps)
    np.testing.assert_array_equal(t_r2c.numpy(), np.asarray(j_r2c))
    np.testing.assert_array_equal(t_c2r.numpy(), np.asarray(j_c2r))
    for b in range(3):
        alone = torch.zeros((1, 5), dtype=torch.int32)
        r2c, c2r = masked_assignment_square_torch(
            *_t(costs[b], rms[b], cms[b]), 0.8, n_phases=5, sweeps=alone)
        assert torch.equal(r2c, t_r2c[b]) and torch.equal(c2r, t_c2r[b])
        assert torch.equal(alone[0], sweeps[b])
    assert len({int(s) for s in sweeps.sum(dim=1)}) > 1  # unequal lengths


@pytest.mark.parametrize("case", range(3))
def test_same_pairs_as_the_jax_cpu_solver(case):
    """ops.assignment.masked_assignment of the JAX package (the XLA
    function its streaming modes run off the TPU) takes its eps scale from
    the matrix; with a masked-out pair in it, as every padded slab has,
    that scale is thresh + 1, the kernels' own, and the pair sets agree."""
    cost, rm, cm = _pallas_test_problems()[case]
    j_r2c, j_c2r = j_masked(jnp.asarray(cost), jnp.asarray(rm),
                            jnp.asarray(cm), 0.8, n_phases=5)
    t_r2c, t_c2r = masked_assignment(*_t(cost, rm, cm), 0.8, n_phases=5)
    assert _pairs(t_r2c) == _pairs(j_r2c)
    np.testing.assert_array_equal(t_c2r.numpy(), np.asarray(j_c2r))


def test_schedule_differs_from_the_jax_cpu_solver_without_masked_pairs():
    """With every pair masked in and every cost under thresh + 1 the XLA
    function's scale is the matrix's own spread (max cost), not
    thresh + 1: another eps schedule. Both stay optimal (total cost within
    1e-3 of scipy)."""
    rng = np.random.default_rng(4)
    cost = rng.uniform(0.05, 1.0, (12, 9)).astype(np.float32)
    rm, cm = np.ones(12, bool), np.ones(9, bool)
    j_r2c, j_c2r = j_masked(jnp.asarray(cost), jnp.asarray(rm),
                            jnp.asarray(cm), 0.9, n_phases=5)
    t_r2c, t_c2r = masked_assignment(*_t(cost, rm, cm), 0.9, n_phases=5)
    for r2c, c2r in ((np.asarray(j_r2c), np.asarray(j_c2r)),
                     (t_r2c.numpy(), t_c2r.numpy())):
        assert abs(_gap_to_scipy(cost, rm, cm, 0.9, r2c, c2r)) < 1e-3


@pytest.mark.parametrize("thresh", [0.5, 0.7, 0.9])
def test_matches_scipy_on_association_problems(thresh):
    """IoU-distance shaped problems across shapes and masks: the same
    pairs as scipy, total cost within 1e-3."""
    rng = np.random.default_rng(int(thresh * 10))
    for _ in range(6):
        n, m = int(rng.integers(2, 40)), int(rng.integers(2, 40))
        iou = np.where(rng.random((n, m)) < 0.1,
                       rng.uniform(0.0, 0.05, (n, m)), 0.0)
        k = int(rng.integers(1, min(n, m) + 1))
        rows, cols = rng.permutation(n)[:k], rng.permutation(m)[:k]
        iou[rows, cols] = rng.uniform(0.55, 0.95, k)
        iou[rng.choice(rows, k // 2), rng.choice(cols, k // 2)] = (
            rng.uniform(0.32, 0.45, k // 2))
        cost = (1.0 - iou).astype(np.float32)
        rm, cm = rng.random(n) < 0.85, rng.random(m) < 0.85
        r2c, c2r = masked_assignment(*_t(cost, rm, cm), thresh)
        assert abs(_gap_to_scipy(cost, rm, cm, thresh, r2c.numpy(),
                                 c2r.numpy())) < 1e-3


@pytest.mark.parametrize("case", range(12))
def test_exact_on_the_dense_cases_that_pin_k2(case):
    """The twelve dense U[0, 1] host cases, on three of which the
    private-dummy auction leaves 0.0125 to 0.38 of weight
    (tests/test_torch_auction.py::test_solver_on_dense_host_cases_pins_k2).
    At the kernels' own 6 phases (eps_final = (thresh + 1) / 4096, at the
    2e-4 floor) the total cost is within 1e-3 of scipy on every case. At
    the tracker's 5 phases (eps_final = (thresh + 1) / 1024 = 1.3e-3 to
    1.8e-3) it is within 5e-3: four cases sit 5e-4 to 4.5e-3 off, inside
    the auction's (n + m) * eps_final bound, as the JAX package measured
    for its own solver (0.007 at 5 phases, ops/assignment.py)."""
    cost, rm, cm, thresh = _host_cases()[case]
    for n_phases, tol in ((6, 1e-3), (5, 5e-3)):
        r2c, c2r = masked_assignment(*_t(cost, rm, cm), thresh,
                                     n_phases=n_phases)
        assert abs(_gap_to_scipy(cost, rm, cm, thresh, r2c.numpy(),
                                 c2r.numpy())) < tol, n_phases


def test_cpu_tensor_never_reaches_the_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")

    monkeypatch.setattr(auction_square, "load_library", boom)
    monkeypatch.setattr(auction_square, "masked_assignment_square_cuda", boom)
    with trace.recording():
        before = _launches("k1", "k3")
        cost, rm, cm = _pallas_test_problems()[0]
        r2c, _ = masked_assignment(*_t(cost, rm, cm), 0.8)
        assert r2c.dtype == torch.int32 and (r2c >= 0).any()
        r2c, _ = masked_assignment(*_t(cost[None], rm[None], cm[None]), 0.8)
        assert r2c.shape == (1, 24)
        assert _launches("k1", "k3") == before


def test_cuda_wrapper_refuses_cpu_tensors():
    cost, rm, cm = _pallas_test_problems()[0]
    with pytest.raises(ValueError):
        auction_square.masked_assignment_square_cuda(*_t(cost, rm, cm), 0.8)


# ---------------------------------------------------------------------------
# What the CUDA kernels' sweep rests on, modelled in numpy: the bidder list
# carried from sweep to sweep, the column keys that the winner clears, and a
# row's top two by per-lane scans and three integer reduces over the warp.
# ---------------------------------------------------------------------------

from hypothesis import given, settings
from hypothesis import strategies as st

_NEG = np.float32(-1e9)
_INT_MAX = np.iinfo(np.int32).max


def _image(x):
    """Order-preserving uint32 image of float32 values, -0.0 as +0.0."""
    u = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def _unimage(u):
    u = np.asarray(u, np.uint32)
    return np.where(u & np.uint32(0x80000000), u & np.uint32(0x7fffffff),
                    ~u).astype(np.uint32).view(np.float32)


def _lane_tops(values, lanes):
    """Each lane's (b1, bi, b2) over its entries of ``values`` (indexed by
    column, taken in rising column order): best value, its first column,
    second-best value with a duplicate of the best counting."""
    b1 = np.full(32, -np.inf, np.float32)
    b2 = np.full(32, -np.inf, np.float32)
    bi = np.full(32, _INT_MAX, np.int64)
    for lane in range(32):
        cols = np.flatnonzero(lanes == lane)
        if cols.size:
            v = values[cols]
            a = int(v.argmax())                 # the first maximum
            b1[lane], bi[lane] = v[a], cols[a]
            rest = np.delete(v, a)
            if rest.size:
                b2[lane] = rest.max()
    return b1, bi, b2


def _three_reduce(b1, bi, b2):
    """The warp's top two from the lanes': max of the best values' images,
    min column among the lanes that hold it, max of what is left."""
    i1 = _image(b1)
    m1 = i1.max()
    wi = np.where(i1 == m1, bi, _INT_MAX).min()
    m2 = np.where(bi == wi, _image(b2), i1).max()
    return _unimage(m1)[()], int(wi), _unimage(m2)[()]


def _butterfly(b1, bi, b2):
    """The xor-shuffle merge of (value, lowest column) pairs; lane 0."""
    b1, bi, b2 = b1.copy(), bi.copy(), b2.copy()
    for off in (16, 8, 4, 2, 1):
        peer = np.arange(32) ^ off
        o1, oi, o2 = b1[peer], bi[peer], b2[peer]
        take = (o1 > b1) | ((o1 == b1) & (oi < bi))
        b2 = np.where(take, np.maximum(o2, b1), np.maximum(b2, o1))
        b1 = np.where(take, o1, b1)
        bi = np.where(take, oi, bi)
    return b1[0], int(bi[0]), b2[0]


_ROW_VALUES = st.one_of(
    st.sampled_from([-1e9, -2.0, -0.5, -0.0, 0.0, 0.25, 1.0]),
    st.floats(-4.0, 4.0, width=32))


@settings(max_examples=200, deadline=None)
@given(st.lists(_ROW_VALUES, min_size=2, max_size=301), st.booleans())
def test_three_reduce_top2_equals_butterfly_and_plain(row, vec):
    """Rows with duplicated maxima and -1e9 entries, dealt to the lanes four
    columns a load (vec) or one: the three-reduce result == the butterfly's
    == the plain version's (v1, first best_j, v2)."""
    values = np.asarray(row, np.float32)
    cols = np.arange(values.size)
    lanes = ((cols >> 2) if vec else cols) & 31
    tops = _lane_tops(values, lanes)
    t = torch.from_numpy(values)
    v1, best_j = t.max(dim=0)
    v2 = torch.where(torch.arange(t.numel()) == best_j,
                     torch.tensor(-np.inf), t).max()
    for got in (_three_reduce(*tops), _butterfly(*tops)):
        assert got[0] == float(v1) and got[1] == int(best_j)
        assert got[2] == float(v2)


_WARPS = 4      # the model's block: few warps, so both kinds of sweep run


def _kernel_model(cost, rm, cm, thresh, n_phases, max_iters=4096):
    """The kernels' solve in numpy float32. A row's top two come from its
    shared-out columns by lanes and three reduces, with its one reserved
    column merged last. While more rows bid than the block has warps they
    stand in a list that the winners hand the evicted rows on to; from
    then on each warp carries one bidder (a loser bids again, a winner
    takes over the row it evicted), and the last bidder of a phase runs
    alone. A column's bids meet in one (bid image, ~row) key, in two
    arrays taken in turn, which the winner clears one sweep late. Returns (extended r2c, sweeps per phase,
    {(phase, sweep): bidders after it})."""
    th = torch.tensor([thresh], dtype=torch.float32)
    sched, cap = auction_square.eps_schedule(th, n_phases, 4.0)
    w, _ = auction_square._extended_weights(
        torch.from_numpy(cost)[None], torch.from_numpy(rm)[None],
        torch.from_numpy(cm)[None], th)
    w, sched, cap = w[0].numpy(), sched[0].numpy(), cap.numpy()[0]
    n, m = cost.shape
    s = n + m
    vec = n % 4 == 0 and m % 4 == 0
    ids = np.arange(s)
    prices = np.zeros(s, np.float32)
    keys = [[0] * s, [0] * s]
    r2c = np.where(ids < n, ids + m, ids - n)
    c2r = np.where(ids < m, ids + n, ids - m)

    def scan(r):
        lanes = np.full(s, -1)
        shared = np.arange(m if r < n else n)
        own = m + r if r < n else r - n
        lanes[shared + (0 if r < n else m)] = (
            (shared >> 2) if vec else shared) & 31
        values = w[r] - prices
        b1, bi, b2 = _three_reduce(*_lane_tops(values, lanes))
        v = values[own]
        if v > b1 or (v == b1 and own < bi):
            return v, own, b1
        return b1, bi, max(b2, v)

    def bid_of(r, key):
        b1, bi, b2 = scan(r)
        bv = (prices[bi] + min(b1 - max(b2, _NEG), cap)) + eps
        assert bv.dtype == np.float32
        key[bi] = max(key[bi], ((int(_image(bv)) << 32)
                                | (0x7fffffff - r)))
        return bi, bv

    def award(r, j, bv):
        """Row r won column j: returns the evicted row or -1."""
        prev = int(c2r[j])
        if prev >= 0:
            r2c[prev] = -1
        c2r[j], r2c[r], prices[j] = r, j, bv
        return prev

    sweeps, lists = [], {}
    for ph in range(n_phases):
        eps = sched[ph]
        for r in range(s):
            v1, _, _ = scan(r)
            rc = r2c[r]
            if rc >= 0 and not max(w[r, rc] - prices[rc], _NEG) >= v1 - eps:
                r2c[r] = -1
        c2r[:] = -1
        c2r[r2c[r2c >= 0]] = ids[r2c >= 0]
        bidders = [int(r) for r in ids[r2c < 0]]
        lists[ph, -1] = list(bidders)
        it = 0
        while it < max_iters and len(bidders) > _WARPS:
            key = keys[0]
            bids = [bid_of(r, key) for r in bidders]
            won = [0x7fffffff - (key[j] & 0xffffffff) == r
                   for r, (j, _) in zip(bidders, bids)]
            handed_on = []
            for r, (j, bv), w_r in zip(bidders, bids, won):
                hand_on = r
                if w_r:
                    hand_on = award(r, j, bv)
                    key[j] = 0
                if hand_on >= 0:
                    handed_on.append(hand_on)
            bidders = handed_on
            lists[ph, it] = list(bidders)
            it += 1
        assert not any(keys[0]) and not any(keys[1])
        rows = bidders + [-1] * (_WARPS - len(bidders))     # one a warp
        clear = [-1] * _WARPS
        turn = 0
        while it < max_iters and sum(r >= 0 for r in rows) > 1:
            key, old = keys[turn], keys[turn ^ 1]
            turn ^= 1
            for j in clear:
                if j >= 0:
                    old[j] = 0
            assert not any(old)         # free for the sweep after this one
            clear = [-1] * _WARPS
            bids = [bid_of(r, key) if r >= 0 else None for r in rows]
            prevs = [int(c2r[b[0]]) if b else -1 for b in bids]
            for k, (r, b) in enumerate(zip(list(rows), bids)):
                if b and 0x7fffffff - (key[b[0]] & 0xffffffff) == r:
                    assert award(r, *b) == prevs[k]
                    clear[k], rows[k] = b[0], prevs[k]
            lists[ph, it] = [r for r in rows if r >= 0]
            it += 1
        for j in clear:
            if j >= 0:
                keys[turn ^ 1][j] = 0
        # the last bidder finishes the phase alone: it wins every sweep
        solo = [r for r in rows if r >= 0]
        while it < max_iters and solo:
            b1, bi, b2 = scan(solo[0])
            bv = (prices[bi] + min(b1 - max(b2, _NEG), cap)) + eps
            prev = award(solo[0], bi, bv)
            solo = [prev] if prev >= 0 else []
            lists[ph, it] = list(solo)
            it += 1
        sweeps.append(it)
    return r2c, sweeps, lists


def _model_problems():
    """The file's seeded association problems, two of the dense host cases
    and one (20, 24) dense problem whose width takes the four-column
    loads."""
    out = [(c.astype(np.float32), rm, cm, 0.8)
           for c, rm, cm in _pallas_test_problems()]
    out += [(np.asarray(c, np.float32), np.asarray(rm), np.asarray(cm),
             float(th)) for c, rm, cm, th in _host_cases()[:2]]
    rng = np.random.default_rng(7)
    out.append((rng.random((20, 24)).astype(np.float32),
                rng.random(20) < 0.8, rng.random(24) < 0.8, 0.7))
    return out


@pytest.mark.parametrize("case", range(6))
def test_carried_bidder_list_is_the_unassigned_set_after_every_sweep(case):
    """The kernels never rebuild their bidder list inside a phase. The
    model's carried list (losers plus evicted rows) == the rows with
    r2c < 0 of the plain version after every release and every sweep, with
    no row twice; the model's matching and sweep counts == the plain
    version's."""
    cost, rm, cm, thresh = _model_problems()[case]
    n_phases = 5
    th = torch.tensor([thresh], dtype=torch.float32)
    sched, cap = auction_square.eps_schedule(th, n_phases, 4.0)
    unassigned = {}
    final = {}

    def on_sweep(ph, it, r2c):
        unassigned[ph, it] = set(torch.nonzero(r2c[0] < 0)[:, 0].tolist())
        final["r2c"] = r2c[0].numpy().copy()

    _, _, sweeps, _ = auction_square._solve_torch(
        torch.from_numpy(cost)[None], torch.from_numpy(rm)[None],
        torch.from_numpy(cm)[None], th, sched, cap, 4096, on_sweep=on_sweep)
    r2c, model_sweeps, lists = _kernel_model(cost, rm, cm, thresh, n_phases)
    assert model_sweeps == sweeps[0].tolist() and sum(model_sweeps) > 0
    assert sorted(lists) == sorted(unassigned)
    for step, bidders in lists.items():
        assert len(set(bidders)) == len(bidders), step
        assert set(bidders) == unassigned[step], step
    np.testing.assert_array_equal(r2c, final["r2c"])
    assert max(len(v) for v in lists.values()) > 1


def test_profiling_build_is_cached_under_its_own_name(monkeypatch, tmp_path):
    """ops/cuda_build.build_library passes its defines to nvcc and names
    the library by source and defines, so the profiling build of K1/K3
    never stands in for the timed one; no path asks for it."""
    import subprocess

    from yolov7_tracker_tpu_torch.ops import cuda_build

    commands = []

    def fake_run(cmd, **kw):
        commands.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    timed = cuda_build.build_library("auction_square.cu")
    prof = cuda_build.build_library("auction_square.cu",
                                    ("AUCTION_PROFILE",))
    again = cuda_build.build_library("auction_square.cu")
    assert timed.lib != prof.lib and again.lib == timed.lib
    assert len(commands) == 2 and again.log == ""
    assert "-DAUCTION_PROFILE" in commands[1]
    assert not any(arg.startswith("-D") for arg in commands[0])

    loads = []
    monkeypatch.setattr(auction_square, "load_library",
                        lambda profile=False: loads.append(profile))
    cost, rm, cm = _pallas_test_problems()[0]
    masked_assignment(*_t(cost, rm, cm), 0.8)
    with pytest.raises(ValueError):
        auction_square.profile_square(*_t(cost, rm, cm), 0.8)
    assert loads == []          # a CPU tensor builds and loads nothing
