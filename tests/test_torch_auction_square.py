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
from tests.test_torch_auction import _host_cases
from yolov7_tracker_tpu.ops.assignment import masked_assignment as j_masked
from yolov7_tracker_tpu.ops.pallas_auction import (
    masked_assignment_pallas, masked_assignment_pallas_batched,
)
from yolov7_tracker_tpu_torch.ops import auction_square
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
    before = (auction_square.LAUNCHES_K1, auction_square.LAUNCHES_K3)
    cost, rm, cm = _pallas_test_problems()[0]
    r2c, _ = masked_assignment(*_t(cost, rm, cm), 0.8)
    assert r2c.dtype == torch.int32 and (r2c >= 0).any()
    r2c, _ = masked_assignment(*_t(cost[None], rm[None], cm[None]), 0.8)
    assert r2c.shape == (1, 24)
    assert (auction_square.LAUNCHES_K1,
            auction_square.LAUNCHES_K3) == before


def test_cuda_wrapper_refuses_cpu_tensors():
    cost, rm, cm = _pallas_test_problems()[0]
    with pytest.raises(ValueError):
        auction_square.masked_assignment_square_cuda(*_t(cost, rm, cm), 0.8)
