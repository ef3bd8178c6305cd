"""The K2 and K4 ports (ops/auction.py): K2's plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) bit for bit, K4's
against the JAX package's XLA twin (masked_assignment_v2 at the TPU
branch's arguments) bit for bit, the port's solver (K4) against the scipy
oracle, and the device dispatch (a CPU tensor never reaches a CUDA
kernel). The kernels themselves run only on a card:
tests/test_torch_cuda.py holds them against the plain versions there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolov7_tracker_tpu.ops.assignment import (
    linear_assignment_host as j_linear_assignment_host,
    masked_assignment_v2,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.ops.pallas_auction import masked_assignment_pallas_v2
from yolov7_tracker_tpu_torch.ops import auction
from yolov7_tracker_tpu_torch.ops.assignment import (
    linear_assignment_host, masked_assignment_twin_cascade_torch,
    solve_assignment,
)
from yolov7_tracker_tpu_torch.utils import trace
from chip_smoke import cascade_problem

STEEP = dict(n_phases=2, phase_factor=4.0 ** 2.5)


def _launches(*kernels):
    """The launches of each kernel (k1, k2, k3, k4, k4_cascade) that the
    tracer has counted."""
    got = trace.counters()
    return tuple(got.get("launches." + k, 0) for k in kernels)


def _problem(rng, n, m, kind):
    if kind == "assoc":
        iou = rng.uniform(0, 0.3, (n, m))
        for k in range(min(n, m) - 2):
            iou[k, (k * 5) % m] = rng.uniform(0.5, 0.95)
        cost = 1.0 - iou
    else:
        cost = rng.random((n, m))
    return (cost.astype(np.float32), rng.random(n) < 0.8,
            rng.random(m) < 0.8)


def _host_cases():
    """The shapes, masks and thresholds of test_assignment.py's
    test_masked_assignment_v2_matches_host (dense U[0, 1] costs)."""
    rng = np.random.default_rng(3)
    cases = []
    for _ in range(12):
        n, m = int(rng.integers(2, 60)), int(rng.integers(2, 60))
        cost = rng.random((n, m)).astype(np.float32)
        rm = rng.random(n) < 0.85
        cm = rng.random(m) < 0.85
        cases.append((cost, rm, cm, float(rng.choice([0.3, 0.5, 0.8]))))
    return cases


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _reid_problem(rng, noise, d=128):
    """A dense appearance cost as ReID features give it: N, M in [10, 60];
    unit 128-d track embeddings, each a shared component (0.8 base) plus
    an identity vector; every det a track's embedding plus Gaussian noise;
    cosine distance; masks at 0.85; a threshold of 0.3, 0.5, 0.7 or 0.9."""
    n, m = (int(x) for x in rng.integers(10, 61, 2))
    base = _unit(rng.normal(size=d))
    tracks = _unit(0.8 * base + _unit(rng.normal(size=(n, d))))
    src = rng.permutation(max(n, m))[:m] % n
    dets = _unit(tracks[src] + rng.normal(0, noise, (m, d)))
    cost = (1.0 - tracks @ dets.T).astype(np.float32)
    return (cost, rng.random(n) < 0.85, rng.random(m) < 0.85,
            float(rng.choice([0.3, 0.5, 0.7, 0.9])))


def _reid_cases(noise, count=12):
    rng = np.random.default_rng(int(round(noise * 100)))
    return [_reid_problem(rng, noise) for _ in range(count)]


def _assoc_cases():
    rng = np.random.default_rng(17)
    return [_problem(rng, int(rng.integers(2, 60)), int(rng.integers(2, 60)),
                     "assoc") + (float(rng.choice([0.5, 0.7, 0.9])),)
            for _ in range(8)]


def _k2_steep(cost, rm, cm, thresh):
    return auction.masked_assignment_auction(cost, rm, cm, thresh, **STEEP)


def _vs_scipy(cost, rm, cm, thresh, solver=solve_assignment):
    """(solver's pairs, scipy pairs, weight the solver leaves on the
    table)."""
    r2c, c2r = solver(torch.from_numpy(cost), torch.from_numpy(rm),
                      torch.from_numpy(cm), thresh)
    for i, j in enumerate(r2c.tolist()):
        if j >= 0:
            assert int(c2r[j]) == i
    big = np.where(rm[:, None] & cm[None, :], cost, 1e9)
    m0, _, _ = linear_assignment_host(big, thresh)
    got = {(i, int(v)) for i, v in enumerate(r2c.tolist()) if v >= 0}
    want = {(int(a), int(b)) for a, b in m0}
    gap = (sum(thresh - cost[i, j] for i, j in want)
           - sum(thresh - cost[i, j] for i, j in got))
    return got, want, float(gap)


@pytest.mark.parametrize("case", ["assoc", "dense", "host9"])
def test_plain_version_equals_pallas_kernel(case):
    """Bit-exact against masked_assignment_pallas_v2 in interpret mode,
    including a dense problem where K2 itself misses scipy's optimum."""
    if case == "host9":
        cost, rm, cm, thresh = _host_cases()[9]
    else:
        thresh = 0.8 if case == "assoc" else 0.5
        cost, rm, cm = _problem(np.random.default_rng(7), 24, 16, case)
    j_r2c, j_c2r = masked_assignment_pallas_v2(
        jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm), thresh,
        interpret=True, **STEEP)
    t_r2c, t_c2r = auction.masked_assignment_auction_torch(
        torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
        thresh, **STEEP)
    np.testing.assert_array_equal(t_r2c.numpy(), np.asarray(j_r2c))
    np.testing.assert_array_equal(t_c2r.numpy(), np.asarray(j_c2r))
    assert int((t_r2c >= 0).sum()) > 0


@pytest.mark.parametrize("thresh", [0.5, 0.7, 0.9])
def test_solver_matches_scipy_on_association_problems(thresh):
    """IoU-distance shaped problems (true pairs, distractors, sparse
    background, every cost >= 0.02 from the threshold) across shapes and
    masks: the same pairs as scipy and the same cost within 1e-3."""
    rng = np.random.default_rng(int(thresh * 10))
    for _ in range(8):
        n, m = int(rng.integers(2, 60)), int(rng.integers(2, 60))
        iou = np.where(rng.random((n, m)) < 0.1,
                       rng.uniform(0.0, 0.05, (n, m)), 0.0)
        k = int(rng.integers(1, min(n, m) + 1))
        rows, cols = rng.permutation(n)[:k], rng.permutation(m)[:k]
        iou[rows, cols] = rng.uniform(0.55, 0.95, k)
        iou[rng.choice(rows, k // 2), rng.choice(cols, k // 2)] = (
            rng.uniform(0.32, 0.45, k // 2))
        cost = (1.0 - iou).astype(np.float32)
        got, want, gap = _vs_scipy(cost, rng.random(n) < 0.85,
                                   rng.random(m) < 0.85, thresh)
        assert got == want
        assert abs(gap) < 1e-3


# K2's fused release/bid sweep (the Pallas kernel, and so its port) stops
# short of scipy's optimum on three of the dense U[0, 1] host cases, two
# of them by more than the auction's n * eps_final bound; the Pallas
# kernel gives the same pairs (case 9 is in the bit-exact test above).
# The XLA twin the JAX package runs on the TPU (masked_assignment_v2, and
# so K4, the port's solver) keeps release out of the bid loop and is
# within 6e-3 on all twelve (test_solver_within_6e3_of_scipy_on_host_cases).
K2_DENSE_GAPS = {0: 0.01254, 8: 0.38168, 9: 0.10571}


def test_solver_on_dense_host_cases_pins_k2():
    for t, (cost, rm, cm, thresh) in enumerate(_host_cases()):
        got, want, gap = _vs_scipy(cost, rm, cm, thresh, _k2_steep)
        assert len(got) == len(want), t
        if t in K2_DENSE_GAPS:
            assert abs(gap - K2_DENSE_GAPS[t]) < 1e-4, (t, gap)
        else:
            assert got == want and abs(gap) < 1e-3, (t, gap)


# ---------------------------------------------------------------------------
# K4: the XLA twin, bit for bit, and the solver it makes
# ---------------------------------------------------------------------------

def _twin_cases(kind):
    if kind == "host":
        return _host_cases()
    if kind == "assoc":
        return _assoc_cases()
    return _reid_cases(float(kind.split("_")[1]))


@pytest.mark.parametrize("kind", ["host", "assoc", "reid_0.02", "reid_0.06",
                                  "reid_0.10"])
def test_twin_plain_version_equals_jax_twin(kind):
    """K4's plain version against masked_assignment_v2 at the arguments of
    the JAX package's TPU branch (2 phases at factor 4^2.5, 512 bid rounds
    a phase), r2c and c2r bit for bit: the twelve dense host cases,
    association problems and ReID-like dense problems."""
    pairs = 0
    for cost, rm, cm, thresh in _twin_cases(kind):
        j_r2c, j_c2r = masked_assignment_v2(
            jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm), thresh,
            **STEEP)
        t_r2c, t_c2r = auction.masked_assignment_twin_torch(
            torch.from_numpy(cost), torch.from_numpy(rm),
            torch.from_numpy(cm), thresh, **STEEP)
        np.testing.assert_array_equal(t_r2c.numpy(), np.asarray(j_r2c))
        np.testing.assert_array_equal(t_c2r.numpy(), np.asarray(j_c2r))
        pairs += int((t_r2c >= 0).sum())
    assert pairs > 0


@pytest.mark.parametrize("b", [2, 16])
def test_twin_batch_equals_jax_vmap(b):
    """A (B, N, M) batch with its own masks and threshold for each problem
    against jax.vmap of the twin; the sweep counts of the batch are those
    of the problems solved alone."""
    rng = np.random.default_rng(40 + b)
    n, m = 20, 28
    cost = np.stack([_problem(rng, n, m, "dense" if k % 2 else "assoc")[0]
                     for k in range(b)])
    rm, cm = rng.random((b, n)) < 0.85, rng.random((b, m)) < 0.85
    th = rng.choice([0.3, 0.5, 0.7, 0.9], b).astype(np.float32)
    j_r2c, j_c2r = jax.vmap(
        lambda c, r, k, t: masked_assignment_v2(c, r, k, t, **STEEP))(
        jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm), jnp.asarray(th))
    sweeps = torch.zeros(b, dtype=torch.int32)
    t_r2c, t_c2r = auction.masked_assignment_twin_torch(
        torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
        torch.from_numpy(th), sweeps=sweeps, **STEEP)
    np.testing.assert_array_equal(t_r2c.numpy(), np.asarray(j_r2c))
    np.testing.assert_array_equal(t_c2r.numpy(), np.asarray(j_c2r))
    for k in (0, b - 1):
        one = torch.zeros(1, dtype=torch.int32)
        auction.masked_assignment_twin_torch(
            torch.from_numpy(cost[k]), torch.from_numpy(rm[k]),
            torch.from_numpy(cm[k]), float(th[k]), sweeps=one, **STEEP)
        assert int(one) == int(sweeps[k]) > 0


def test_solver_within_6e3_of_scipy_on_host_cases():
    """solve_assignment (K4) finds as many pairs as scipy on the twelve
    dense host cases and leaves at most 6e-3 of weight on the table (K2:
    up to 0.38, test_solver_on_dense_host_cases_pins_k2)."""
    for t, (cost, rm, cm, thresh) in enumerate(_host_cases()):
        got, want, gap = _vs_scipy(cost, rm, cm, thresh)
        assert len(got) == len(want), t
        assert -1e-6 <= gap < 6e-3, (t, gap)


@pytest.mark.parametrize("noise", [0.02, 0.06, 0.10])
def test_solver_within_2e3_of_scipy_on_reid_problems(noise):
    """solve_assignment (K4) on ReID-like dense costs: within 2e-3 of
    scipy's optimum on every problem, where K2 leaves up to 0.69."""
    gaps, k2_gaps = [], []
    for cost, rm, cm, thresh in _reid_cases(noise, 40):
        gaps.append(_vs_scipy(cost, rm, cm, thresh)[2])
        k2_gaps.append(_vs_scipy(cost, rm, cm, thresh, _k2_steep)[2])
    assert max(gaps) < 2e-3 and min(gaps) > -1e-6, gaps
    assert max(k2_gaps) > 0.1       # the regime K2 loses matches in


def test_linear_assignment_host_matches_jax_copy():
    rng = np.random.default_rng(5)
    cost = rng.random((9, 13))
    for a, b in zip(linear_assignment_host(cost, 0.6),
                    j_linear_assignment_host(cost, 0.6)):
        np.testing.assert_array_equal(a, b)


def test_batched_solve_matches_single_solves():
    """ByteTrack's stage-2/3 form: one (N, M) cost, two mask pairs, two
    thresholds, solved as one batch-2 call."""
    rng = np.random.default_rng(11)
    cost, _, _ = _problem(rng, 20, 30, "assoc")
    rms = torch.from_numpy(rng.random((2, 20)) < 0.6)
    cms = torch.from_numpy(rng.random((2, 30)) < 0.7)
    c = torch.from_numpy(cost)
    r2c_b, c2r_b = solve_assignment(c, rms, cms, (0.5, 0.7))
    for k, th in enumerate((0.5, 0.7)):
        r2c, c2r = solve_assignment(c, rms[k], cms[k], th)
        assert torch.equal(r2c_b[k], r2c) and torch.equal(c2r_b[k], c2r)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")

    monkeypatch.setattr(auction, "load_library", boom)
    monkeypatch.setattr(auction, "masked_assignment_auction_cuda", boom)
    monkeypatch.setattr(auction, "masked_assignment_twin_cuda", boom)
    with trace.recording():
        before = _launches("k2", "k4")
        cost, rm, cm = _problem(np.random.default_rng(1), 12, 9, "assoc")
        r2c, _ = solve_assignment(torch.from_numpy(cost),
                                  torch.from_numpy(rm), torch.from_numpy(cm),
                                  0.8)
        assert r2c.dtype == torch.int32 and (r2c >= 0).any()
        r2c, _ = auction.masked_assignment_auction(
            torch.from_numpy(cost), torch.from_numpy(rm),
            torch.from_numpy(cm), 0.8)
        assert (r2c >= 0).any()
        assert _launches("k2", "k4") == before


def test_cuda_wrapper_refuses_cpu_tensors():
    cost, rm, cm = _problem(np.random.default_rng(2), 8, 8, "assoc")
    for wrapper in (auction.masked_assignment_auction_cuda,
                    auction.masked_assignment_twin_cuda):
        with pytest.raises(ValueError):
            wrapper(torch.from_numpy(cost), torch.from_numpy(rm),
                    torch.from_numpy(cm), 0.8)


# ---------------------------------------------------------------------------
# What the CUDA kernel's sweep rests on, modelled in numpy: a row scans its
# real columns and its own dummy only, the release test is made on what can
# have changed since the sweep before, the bidders stand in a handed-on
# list, a column's winner is the maximum of (bid image, ~row) keys, and the
# unchanged-state stop is told from what the sweep touched.
# ---------------------------------------------------------------------------

from hypothesis import given, settings
from hypothesis import strategies as st

_NEG = np.float32(-1e9)
_ZERO = np.float32(0.0)


def _image(x):
    """Order-preserving uint32 image of a float32 value, -0.0 as +0.0."""
    u = int((np.float32(x) + _ZERO).view(np.uint32))
    return (~u & 0xffffffff) if u & 0x80000000 else (u | 0x80000000)


def _weights(cost, rm, cm, thresh):
    """The (n, m) real weights, by the plain version's own arithmetic."""
    c, r, k = (torch.from_numpy(np.asarray(x)) for x in (cost, rm, cm))
    valid = r[:, None] & k[None, :]
    neg = torch.tensor(auction.NEG_F, dtype=torch.float32)
    th = torch.tensor(thresh, dtype=torch.float32)
    w = torch.where(valid, th - c, neg)
    return torch.where(valid, w + auction._jitter(*c.shape, "cpu"),
                       neg).numpy()


def _kernel_model(cost, rm, cm, thresh, n_phases, phase_factor,
                  max_iters=auction.MAX_ITERS, on_sweep=None):
    """The kernel's solve in numpy float32 on the compact n x (m + n)
    problem. Returns (r2c, c2r, prices, sweeps, row scans)."""
    n, m = cost.shape
    w = _weights(cost, rm, cm, thresh)
    sched, cap = auction.eps_schedule(
        torch.tensor([thresh], dtype=torch.float32), n_phases, phase_factor)
    sched, cap = sched[0].numpy(), cap.numpy()[0]
    prices = np.zeros(m + n, np.float32)
    c2r = np.full(m + n, -1)
    r2c = np.full(n, -1)
    keys = [[0] * (m + n), [0] * (m + n)]   # taken in turn, sweep by sweep
    bidders, winners, freed = list(range(n)), [], []
    won_at, rel_at = [-2] * n, [-1] * n
    old_col, old_price, hint = [0] * n, [_ZERO] * n, [_ZERO] * n
    sweeps = scans = 0

    def held(i, rc):
        return max((w[i, rc] if rc < m else _ZERO) - prices[rc], _NEG)

    def passes_whole(i):
        v1 = max((w[i] - prices[:m]).max(), _ZERO - prices[m + i])
        return held(i, r2c[i]) >= v1 - eps

    for ph in range(n_phases):
        eps = sched[ph]
        it, n_open, first = 0, 1, True
        while it < max_iters and n_open > 0:
            key, key_before = keys[sweeps & 1], keys[~sweeps & 1]
            # the winners of the sweep before clear their keys of that sweep
            for i in winners:
                key_before[r2c[i]] = 0
            assert not any(key_before) and not any(key)
            # release tests, all at the prices the sweep before left
            if first:
                whole = [i for i in range(n) if r2c[i] >= 0]
                kept = []
            else:
                whole = winners
                kept = [i for i in range(n)
                        if r2c[i] >= 0 and won_at[i] != sweeps - 1]
            released = []
            for i in whole:
                if not rm[i]:
                    # a masked-out row holds its own dummy and passes
                    assert r2c[i] == m + i and passes_whole(i)
                elif not first and held(i, r2c[i]) >= hint[i] - eps:
                    # it won a sweep ago; nothing is worth more than its
                    # bid's second-best value now
                    assert passes_whole(i)
                else:
                    scans += 1
                    if not passes_whole(i):
                        released.append(i)
            for i in kept:
                if not rm[i]:
                    continue
                h = held(i, r2c[i])
                if not all(h >= (w[i, j] - prices[j]) - eps
                           for j in freed if j < m):
                    released.append(i)
            assert len(set(released)) == len(released)
            released = [(i, int(r2c[i])) for i in released]
            for i, rc in released:
                rel_at[i], old_col[i], old_price[i] = sweeps, rc, prices[rc]
                r2c[i], c2r[rc], prices[rc] = -1, -1, _ZERO
                bidders.append(i)
            # one bid round: real columns, then the own dummy, merged last
            assert len(set(bidders)) == len(bidders)
            assert set(bidders) == set(np.flatnonzero(r2c < 0).tolist())
            bids = []
            for i in bidders:
                scans += bool(rm[i])
                values = w[i] - prices[:m]
                bi = int(values.argmax())               # the first maximum
                b1 = values[bi]
                b2 = np.delete(values, bi).max() if m > 1 else -np.inf
                own_v = _ZERO - prices[m + i]
                if own_v > b1:
                    b1, bi, b2 = own_v, m + i, b1
                else:
                    b2 = max(b2, own_v)
                b2 = max(b2, _NEG)
                if not rm[i]:
                    # the closed form of a masked-out row
                    assert (b1, bi, b2) == (own_v, m + i, _NEG)
                bv = (prices[bi] + min(b1 - b2, cap)) + eps
                assert bv.dtype == np.float32
                key[bi] = max(key[bi], (_image(bv) << 32) | (0x7fffffff - i))
                bids.append((bi, bv, b2))
            wins = [0x7fffffff - (key[bi] & 0xffffffff) == i
                    for i, (bi, _, _) in zip(bidders, bids)]
            handed_on, winners, changed = [], [], False
            for i, (bi, bv, b2), win in zip(bidders, bids, wins):
                if not win:
                    handed_on.append(i)
                    continue
                prev = int(c2r[bi])
                if prev >= 0:
                    r2c[prev] = -1
                    handed_on.append(prev)
                c2r[bi], r2c[i], prices[bi] = i, bi, bv
                won_at[i], hint[i] = sweeps, b2
                winners.append(i)
                if not (rel_at[i] == sweeps and old_col[i] == bi
                        and old_price[i].view(np.int32) == bv.view(np.int32)):
                    changed = True
            assert sum(map(bool, key)) == len(winners)
            freed = [rc for _, rc in released]
            n_open = len(handed_on) + len(released)
            repeat = not changed and len(winners) == len(released)
            bidders, first = handed_on, False
            if on_sweep is not None:
                on_sweep(ph, it, r2c, c2r, prices)
            it += 1
            sweeps += 1
            if repeat:
                break
    return r2c, c2r, prices, sweeps, scans


def _stress_cases():
    """name -> (cost, rm, cm, thresh, solver arguments): small twins of the
    problems chip_smoke.py stresses the kernel with on the card."""
    rng = np.random.default_rng(21)
    steep = dict(n_phases=2, phase_factor=4.0 ** 2.5)

    def dense(n, m):
        return _problem(rng, n, m, "dense")

    ones = (np.ones(24, bool), np.ones(36, bool))
    cases = {
        "assoc": (*_problem(rng, 24, 16, "assoc"), 0.8, steep),
        "dense": (*dense(24, 16), 0.5, steep),
        "equal_costs_all_rows_bid": (
            np.full((24, 36), 0.25, np.float32), *ones, 0.9, steep),
        "width_of_four": (*dense(16, 40), 0.7, steep),
        "7x5": (*dense(7, 5), 0.7, steep),
        "more_rows_than_columns": (*dense(30, 12), 0.7, steep),
        "odd_widths": (*dense(13, 29), 0.7, steep),
        "all_masked": (dense(12, 20)[0], np.zeros(12, bool),
                       np.zeros(20, bool), 0.9, steep),
        "max_iters_hit": (*dense(24, 32), 0.9, dict(max_iters=3, **steep)),
        "five_phases": (*dense(24, 32), 0.9,
                        dict(n_phases=5, phase_factor=4.0)),
    }
    cost, rm, cm, thresh = _host_cases()[9]
    cases["unchanged_state_stop"] = (cost, rm, cm, thresh, steep)
    return cases


@pytest.mark.parametrize("name", sorted(_stress_cases()))
def test_kernel_model_equals_plain_version_after_every_sweep(name):
    """The numpy model of the kernel's sweep leaves the plain version's
    (r2c, c2r, prices), bit for bit, after every sweep of every phase, and
    stops where it stops."""
    cost, rm, cm, thresh, kw = _stress_cases()[name]
    n, m = cost.shape
    sched, cap = auction.eps_schedule(
        torch.tensor([thresh], dtype=torch.float32), kw["n_phases"],
        kw["phase_factor"])
    max_iters = kw.get("max_iters", auction.MAX_ITERS)
    plain, model = {}, {}

    def seen(into):
        def on_sweep(ph, it, r2c, c2r, prices):
            into[ph, it] = (np.asarray(r2c)[:n].copy(),
                            np.asarray(c2r)[:m + n].copy(),
                            np.asarray(prices)[:m + n].copy())
        return on_sweep

    p_r2c, p_c2r, p_sweeps = auction._solve_one_torch(
        *(torch.from_numpy(np.asarray(x)) for x in (cost, rm, cm)),
        torch.tensor(thresh, dtype=torch.float32), sched[0], cap[0],
        max_iters, on_sweep=seen(plain))
    r2c, _, _, sweeps, scans = _kernel_model(
        cost, rm, cm, thresh, kw["n_phases"], kw["phase_factor"], max_iters,
        on_sweep=seen(model))
    assert sweeps == p_sweeps == len(plain) and sorted(model) == sorted(plain)
    for step in plain:
        for got, want in zip(model[step], plain[step]):
            assert got.dtype.kind == want.dtype.kind
            np.testing.assert_array_equal(
                got.view(np.int32) if got.dtype == np.float32 else got,
                want.view(np.int32) if want.dtype == np.float32 else want,
                err_msg=str(step))
    # the gate of the plain version applied to the model's matching
    gated = [j if 0 <= j < m and rm[i] and cost[i, j] <= np.float32(thresh)
             else -1 for i, j in enumerate(r2c)]
    assert gated == p_r2c.tolist()
    # far fewer row scans than the dense sweep's two for every row
    assert scans <= 2 * n * sweeps
    if name == "max_iters_hit":
        assert sweeps == 3 * kw["n_phases"]
    if name == "unchanged_state_stop":
        last = max(plain)
        assert last[1] > 0 and all(
            np.array_equal(a.view(np.int32), b.view(np.int32))
            for a, b in zip(plain[last], plain[last[0], last[1] - 1]))


def test_batch_with_distinct_thresholds_equals_single_solves():
    """A (B, N, M) cost with B thresholds: each problem's result and sweep
    count are those of the problem solved alone."""
    rng = np.random.default_rng(13)
    probs = [_problem(rng, 16, 20, "dense") for _ in range(3)]
    cost, rm, cm = (torch.from_numpy(np.stack(x)) for x in zip(*probs))
    ths = (0.4, 0.6, 0.9)
    sweeps = torch.zeros(3, dtype=torch.int32)
    r2c, c2r = auction.masked_assignment_auction_torch(
        cost, rm, cm, torch.tensor(ths), sweeps=sweeps, **STEEP)
    for b, th in enumerate(ths):
        one = torch.zeros(1, dtype=torch.int32)
        r, c = auction.masked_assignment_auction_torch(
            cost[b], rm[b], cm[b], th, sweeps=one, **STEEP)
        assert torch.equal(r, r2c[b]) and torch.equal(c, c2r[b])
        assert int(one) == int(sweeps[b]) > 0


_ROW_VALUES = st.one_of(
    st.sampled_from([-1e9, -2.0, -0.5, -0.0, 0.0, 0.25, 1.0]),
    st.floats(-4.0, 4.0, width=32))
# prices up to the bid cap 2 (thresh + 1) plus eps, thresh <= 1
_PRICES = st.one_of(st.sampled_from([0.0, 2e-4, 4.0]),
                    st.floats(0.0, 6.0, width=32))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_ROW_VALUES, _PRICES), min_size=1, max_size=40),
       st.integers(0, 39), st.sampled_from([2e-4, 0.0594, 1.9]),
       st.booleans())
def test_release_test_column_by_column_equals_the_row_maximum(row, held_at,
                                                              eps, dup):
    """cur >= max_j(v_j) - eps holds exactly when cur >= v_j - eps holds
    for every column (rounded subtraction is monotone): on rows with
    duplicated maxima, -1e9 weights and prices up to the bid cap."""
    w = np.asarray([x[0] for x in row], np.float32)
    prices = np.asarray([x[1] for x in row], np.float32)
    if dup:
        w = np.concatenate([w, w[:1]])
        prices = np.concatenate([prices, prices[:1]])
    eps = np.float32(eps)
    values = w - prices
    cur = max(values[held_at % values.size], _NEG)
    whole = bool(cur >= values.max() - eps)
    by_column = all(bool(cur >= v - eps) for v in values)
    assert whole == by_column
    # and through torch's float32, as the plain version computes it
    t = torch.from_numpy(w) - torch.from_numpy(prices)
    assert whole == bool(torch.tensor(cur) >= t.max() - torch.tensor(eps))


def test_profiling_build_is_cached_under_its_own_name(monkeypatch, tmp_path):
    """The profiling build of K2 (-DAUCTION_PROFILE) never stands in for
    the timed one, and no path asks for it."""
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
    timed = cuda_build.build_library("auction.cu")
    prof = cuda_build.build_library("auction.cu", ("AUCTION_PROFILE",))
    assert timed.lib != prof.lib and len(commands) == 2
    assert "-DAUCTION_PROFILE" in commands[1]
    assert not any(arg.startswith("-D") for arg in commands[0])
    assert commands[0][-1].endswith("csrc/auction.cu")

    loads = []
    monkeypatch.setattr(auction, "load_library",
                        lambda profile=False: loads.append(profile))
    cost, rm, cm = (torch.from_numpy(x) for x in _problem(
        np.random.default_rng(1), 12, 9, "assoc"))
    solve_assignment(cost, rm, cm, 0.8)
    with pytest.raises(ValueError):
        auction.profile_auction(cost, rm, cm, 0.8)
    assert loads == []          # a CPU tensor builds and loads nothing


# ---------------------------------------------------------------------------
# K4's solve as the CUDA kernel makes it, modelled in numpy: the release
# fixpoint tests every assigned row in full only in a phase's first
# iteration, then only the columns the iteration before freed; the bidders
# of a round are the losers and the evicted rows of the round before,
# handed on in a list; a column's winner is the maximum of (bid image,
# ~row) keys, cleared a round late. K2's shortcut (a row that won since the
# last price fall passes if cur >= b2 - eps, b2 its bid's second-best
# value) is sound here too, but the fixpoint's whole-row tests all come
# with a new, smaller eps, under which it never passes: the model counts
# where it would, and the kernel does not carry it.
# ---------------------------------------------------------------------------

def _twin_model(cost, rm, cm, thresh, n_phases, phase_factor,
                max_iters=auction.TWIN_MAX_ITERS, on_sweep=None):
    """K4's solve in numpy float32 on the compact n x (m + n) problem.
    Returns (r2c, c2r, sweeps, counts): counts of whole-row release scans,
    of those K2's second-best shortcut would have passed, of freed-column
    tests and of bid scans."""
    n, m = cost.shape
    w = _weights(cost, rm, cm, thresh)
    sched, cap = auction.eps_schedule(
        torch.tensor([thresh], dtype=torch.float32), n_phases, phase_factor)
    sched, cap = sched[0].numpy(), cap.numpy()[0]
    prices = np.zeros(m + n, np.float32)
    c2r = np.full(m + n, -1)
    r2c = np.full(n, -1)
    for i in np.flatnonzero(~rm):           # masked-out rows: own dummies
        r2c[i], c2r[m + i] = m + i, i
    keys = [[0] * (m + n), [0] * (m + n)]   # taken in turn, round by round
    bidders = [int(i) for i in np.flatnonzero(rm)]
    won_cols = []                           # the last round's, keys to clear
    hint, won_epoch, epoch = [_ZERO] * n, [-1] * n, 0
    sweeps = rounds = 0
    counts = dict(whole=0, b2_would_pass=0, column_tests=0, bid=0)

    def held(i):
        rc = r2c[i]
        return (w[i, rc] if rc < m else _ZERO) - prices[rc]

    def row_max(i):
        return max((w[i] - prices[:m]).max(), _ZERO - prices[m + i])

    for ph in range(n_phases):
        eps = sched[ph]
        freed = None                 # None: a phase's first iteration
        for it in range(n + 1):
            released = []
            for i in range(n):
                if r2c[i] < 0 or not rm[i]:
                    continue         # masked-out rows hold their dummies
                h = held(i)
                if freed is None:
                    if won_epoch[i] == epoch and h >= hint[i] - eps:
                        # no price fell since its bid: nothing else is worth
                        # more to it than that bid's second-best value
                        counts["b2_would_pass"] += 1
                        assert h >= row_max(i) - eps
                    counts["whole"] += 1
                    if not h >= row_max(i) - eps:
                        released.append(i)
                else:
                    # it passed the iteration before: only a freed column,
                    # now at price 0, can fail it
                    real = [j for j in freed if j < m]
                    counts["column_tests"] += len(real)
                    ok = all(h >= (w[i, j] - prices[j]) - eps for j in real)
                    assert ok == bool(h >= row_max(i) - eps)
                    if not ok:
                        released.append(i)
            freed = [int(r2c[i]) for i in released]
            for i in released:
                rc = r2c[i]
                r2c[i], c2r[rc], prices[rc] = -1, -1, _ZERO
                bidders.append(i)
            epoch += bool(released)
            sweeps += 1
            if on_sweep is not None:
                on_sweep(ph, "release", it, r2c, c2r, prices)
            if not released:
                break
        for it in range(max_iters):
            if not bidders:
                break
            key, key_before = keys[rounds & 1], keys[~rounds & 1]
            for j in won_cols:
                key_before[j] = 0
            assert not any(key_before) and not any(key)
            assert len(set(bidders)) == len(bidders)
            assert set(bidders) == set(np.flatnonzero(r2c < 0).tolist())
            bids = []
            for i in bidders:
                counts["bid"] += 1
                values = w[i] - prices[:m]
                bi = int(values.argmax())               # the first maximum
                b1 = values[bi]
                b2 = np.delete(values, bi).max() if m > 1 else -np.inf
                own_v = _ZERO - prices[m + i]
                if own_v > b1:
                    b1, bi, b2 = own_v, m + i, b1
                else:
                    b2 = max(b2, own_v)
                b2 = max(b2, _NEG)
                bv = (prices[bi] + min(b1 - b2, cap)) + eps
                assert bv.dtype == np.float32
                key[bi] = max(key[bi], (_image(bv) << 32) | (0x7fffffff - i))
                bids.append((bi, bv, b2))
            handed_on, won_cols = [], []
            for i, (bi, bv, b2) in zip(bidders, bids):
                if 0x7fffffff - (key[bi] & 0xffffffff) != i:
                    handed_on.append(i)
                    continue
                prev = int(c2r[bi])
                if prev >= 0:
                    r2c[prev] = -1
                    handed_on.append(prev)
                c2r[bi], r2c[i], prices[bi] = i, bi, bv
                won_epoch[i], hint[i] = epoch, b2
                won_cols.append(bi)
            assert sum(map(bool, key)) == len(won_cols)
            bidders = handed_on
            rounds += 1
            sweeps += 1
            if on_sweep is not None:
                on_sweep(ph, "bid", it, r2c, c2r, prices)
    return r2c, c2r, sweeps, counts


def _twin_model_cases():
    """name -> (cost, rm, cm, thresh, solver arguments): the stress cases,
    the twelve dense host cases and ReID-like dense problems."""
    cases = dict(_stress_cases())
    for name, kw in (("max_iters_hit", dict(max_iters=3)),
                     ("more_rows_than_columns", dict(max_iters=64))):
        *case, steep = cases[name]
        cases[name] = (*case, {**steep, **kw})
    for k, case in enumerate(_host_cases()):
        cases[f"host_{k}"] = (*case, STEEP)
    for k, case in enumerate(_reid_cases(0.06, 6)):
        cases[f"reid_{k}"] = (*case, STEEP)
    return cases


@pytest.mark.parametrize("name", sorted(_twin_model_cases()))
def test_twin_kernel_model_equals_plain_version_after_every_sweep(name):
    """The numpy model of K4's solve leaves the plain version's (r2c, c2r,
    prices), bit for bit, after every release iteration and every bid
    round of every phase, with as many sweeps; it scans a whole row in the
    release fixpoint only in a phase's first iteration."""
    cost, rm, cm, thresh, kw = _twin_model_cases()[name]
    n, m = cost.shape
    sched, cap = auction.eps_schedule(
        torch.tensor([thresh], dtype=torch.float32), kw["n_phases"],
        kw["phase_factor"])
    max_iters = kw.get("max_iters", auction.TWIN_MAX_ITERS)
    plain, model = [], []

    def seen(into):
        def on_sweep(ph, kind, it, r2c, c2r, prices):
            r2c, c2r = np.asarray(r2c).copy(), np.asarray(c2r).copy()
            # the plain version clamps unowned prices at the next step
            prices = np.where(c2r < 0, _ZERO, np.asarray(prices))
            into.append(((ph, kind, it), r2c, c2r, prices))
        return on_sweep

    p_r2c, p_c2r, p_sweeps = auction._solve_one_twin(
        *(torch.from_numpy(np.asarray(x)) for x in (cost, rm, cm)),
        torch.tensor(thresh, dtype=torch.float32), sched[0], cap[0],
        max_iters, on_sweep=seen(plain))
    r2c, _, sweeps, counts = _twin_model(
        cost, rm, cm, thresh, kw["n_phases"], kw["phase_factor"], max_iters,
        on_sweep=seen(model))
    assert sweeps == p_sweeps == len(plain) == len(model)
    for (step, *want), (got_step, *got) in zip(plain, model):
        assert step == got_step
        for a, b in zip(got, want):
            np.testing.assert_array_equal(
                a.view(np.int32) if a.dtype == np.float32 else a,
                b.view(np.int32) if b.dtype == np.float32 else b,
                err_msg=str(step))
    gated = [j if 0 <= j < m and rm[i] and cost[i, j] <= np.float32(thresh)
             else -1 for i, j in enumerate(r2c)]
    assert gated == p_r2c.tolist()
    # whole-row release scans: at most every masked-in row once a phase;
    # K2's second-best shortcut would have spared none of them
    assert counts["whole"] <= int(rm.sum()) * kw["n_phases"]
    assert counts["b2_would_pass"] == 0


# ---------------------------------------------------------------------------
# K4's cascade entry: matching_cascade in one call, against JAX's lax.scan
# over masked_assignment_v2 at the TPU branch's arguments
# ---------------------------------------------------------------------------

def _jax_cascade(cost, rm, cm, tsu, thresh, depth, monkeypatch):
    """JAX's matching_cascade with the solver its chip runs at every
    level (masked_assignment_v2, steep schedule)."""
    import types

    from yolov7_tracker_tpu.trackers import appearance as JA

    monkeypatch.setattr(JA, "masked_assignment",
                        lambda c, r, k, t: masked_assignment_v2(c, r, k, t,
                                                                **STEEP))
    slab = types.SimpleNamespace(time_since_update=jnp.asarray(tsu))
    r2c, c2r = JA.matching_cascade(jnp.asarray(cost), slab, jnp.asarray(rm),
                                   jnp.asarray(cm), thresh, depth)
    return np.asarray(r2c), np.asarray(c2r)


@pytest.mark.parametrize("kind,thresh", [("dense", 0.7), ("deepsort", 0.9),
                                         ("all_taken_at_level_0", 0.9)])
def test_twin_cascade_plain_version_equals_jax_cascade(kind, thresh,
                                                        monkeypatch):
    """masked_assignment_twin_cascade_torch against JAX's matching_cascade
    on masked_assignment_v2, r2c and c2r bit for bit: levels with no rows
    (chip_smoke.cascade_problem leaves every odd age above 1 out), rows
    beyond the last level, DeepSORT's gated costs, and a level 0 that
    takes every column (the later levels solve with no column left)."""
    rng = np.random.default_rng(len(kind))
    depth = 8
    if kind == "all_taken_at_level_0":
        cost, rm, cm, tsu = cascade_problem(rng, 30, 12, depth, "dense")
        cost[:14] *= np.float32(0.01)
        tsu[:14] = 1
        rm[:14] = True
        cm[:] = True
    else:
        cost, rm, cm, tsu = cascade_problem(rng, 40, 36, depth, kind)
    ages = set(tsu[rm].tolist())
    assert not ages >= set(range(1, depth + 1)) and max(ages) > depth
    j_r2c, j_c2r = _jax_cascade(cost, rm, cm, tsu, thresh, depth,
                                monkeypatch)
    t_r2c, t_c2r = masked_assignment_twin_cascade_torch(
        *(torch.from_numpy(x) for x in (cost, rm, cm, tsu)), thresh, depth,
        **STEEP)
    np.testing.assert_array_equal(t_r2c.numpy(), j_r2c)
    np.testing.assert_array_equal(t_c2r.numpy(), j_c2r)
    assert int((t_r2c >= 0).sum()) > 0
    if kind == "all_taken_at_level_0":
        assert int((t_c2r >= 0).sum()) == cost.shape[1]
        assert (t_r2c.numpy()[tsu > 1] < 0).all()


def test_twin_cascade_batch_equals_jax_and_level_sweeps(monkeypatch):
    """A (B, N, M) cascade with a threshold for each problem: each problem
    as JAX's cascade gives it, and the sweeps of each level those of the
    twin solved level by level (empty levels included)."""
    rng = np.random.default_rng(8)
    depth, ths = 6, (0.5, 0.7, 0.9)
    cases = [cascade_problem(rng, 24, 20, depth, kind)
             for kind in ("dense", "deepsort", "dense")]
    cost, rm, cm, tsu = (np.stack(x) for x in zip(*cases))
    sweeps = torch.zeros((3, depth), dtype=torch.int32)
    r2c, c2r = masked_assignment_twin_cascade_torch(
        *(torch.from_numpy(x) for x in (cost, rm, cm, tsu)),
        torch.tensor(ths), depth, sweeps=sweeps, **STEEP)
    for b, th in enumerate(ths):
        j_r2c, j_c2r = _jax_cascade(cost[b], rm[b], cm[b], tsu[b], th,
                                    depth, monkeypatch)
        np.testing.assert_array_equal(r2c[b].numpy(), j_r2c)
        np.testing.assert_array_equal(c2r[b].numpy(), j_c2r)
        avail = torch.from_numpy(cm[b])
        for lvl in range(depth):
            rows = torch.from_numpy(rm[b] & (tsu[b] == 1 + lvl))
            one = torch.zeros(1, dtype=torch.int32)
            _, c2r_l = auction.masked_assignment_twin_torch(
                torch.from_numpy(cost[b]), rows, avail, th, sweeps=one,
                **STEEP)
            assert int(one) == int(sweeps[b, lvl]), (b, lvl)
            avail = avail & (c2r_l < 0)
    # an empty level: one release iteration in each phase, no bid round
    assert int(sweeps.min()) == 2


def test_matching_cascade_on_cpu_never_reaches_a_kernel(monkeypatch):
    """trackers/appearance.matching_cascade with no solver given runs the
    plain cascade on a CPU tensor (no kernel, no launch count), equal to
    the level-by-level loop over solve_assignment."""
    from yolov7_tracker_tpu_torch.trackers import appearance as TA

    def boom(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")

    for name in ("load_library", "masked_assignment_twin_cuda",
                 "masked_assignment_twin_cascade_cuda"):
        monkeypatch.setattr(auction, name, boom)
    import types

    with trace.recording():
        before = _launches("k2", "k4", "k4_cascade")
        cost, rm, cm, tsu = (torch.from_numpy(x) for x in cascade_problem(
            np.random.default_rng(2), 30, 25, 5, "dense"))
        slab = types.SimpleNamespace(time_since_update=tsu)
        one = TA.matching_cascade(cost, slab, rm, cm, 0.7, 5)
        loop = TA.matching_cascade(cost, slab, rm, cm, 0.7, 5,
                                   solve=solve_assignment)
        assert torch.equal(one[0], loop[0]) and torch.equal(one[1], loop[1])
        assert (one[0] >= 0).any()
        assert _launches("k2", "k4", "k4_cascade") == before


def test_cascade_and_k4_profile_wrappers_refuse_cpu_tensors():
    cost, rm, cm, tsu = (torch.from_numpy(x) for x in cascade_problem(
        np.random.default_rng(3), 8, 8, 3, "dense"))
    with pytest.raises(ValueError):
        auction.masked_assignment_twin_cascade_cuda(cost, rm, cm, tsu, 0.8,
                                                    3)
    with pytest.raises(ValueError):
        auction.profile_twin(cost, rm, cm, 0.8)
