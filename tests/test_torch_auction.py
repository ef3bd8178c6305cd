"""The K2 port (ops/auction.py): its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) bit for bit, the port's solver
against the scipy oracle, and the device dispatch (a CPU tensor never
reaches the CUDA kernel). The kernel itself runs only on a card:
tests/test_torch_cuda.py holds it against the plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolov7_tracker_tpu.ops.assignment import (
    linear_assignment_host as j_linear_assignment_host,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.ops.pallas_auction import masked_assignment_pallas_v2
from yolov7_tracker_tpu_torch.ops import auction
from yolov7_tracker_tpu_torch.ops.assignment import (
    linear_assignment_host, solve_assignment,
)

STEEP = dict(n_phases=2, phase_factor=4.0 ** 2.5)


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


def _vs_scipy(cost, rm, cm, thresh):
    """(port pairs, scipy pairs, weight the port leaves on the table)."""
    r2c, c2r = solve_assignment(torch.from_numpy(cost), torch.from_numpy(rm),
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
# The XLA twin the JAX package runs on the TPU (masked_assignment_v2)
# keeps release out of the bid loop and is within 6e-3 on all twelve.
K2_DENSE_GAPS = {0: 0.01254, 8: 0.38168, 9: 0.10571}


def test_solver_on_dense_host_cases_pins_k2():
    for t, (cost, rm, cm, thresh) in enumerate(_host_cases()):
        got, want, gap = _vs_scipy(cost, rm, cm, thresh)
        assert len(got) == len(want), t
        if t in K2_DENSE_GAPS:
            assert abs(gap - K2_DENSE_GAPS[t]) < 1e-4, (t, gap)
        else:
            assert got == want and abs(gap) < 1e-3, (t, gap)


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
    before = auction.LAUNCHES
    cost, rm, cm = _problem(np.random.default_rng(1), 12, 9, "assoc")
    r2c, _ = solve_assignment(torch.from_numpy(cost), torch.from_numpy(rm),
                              torch.from_numpy(cm), 0.8)
    assert r2c.dtype == torch.int32 and (r2c >= 0).any()
    assert auction.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    cost, rm, cm = _problem(np.random.default_rng(2), 8, 8, "assoc")
    with pytest.raises(ValueError):
        auction.masked_assignment_auction_cuda(
            torch.from_numpy(cost), torch.from_numpy(rm),
            torch.from_numpy(cm), 0.8)
