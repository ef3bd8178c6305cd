"""Tests of the PyTorch port that need a CUDA card (its hand-written
kernels have no CPU mode); each skips without one. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from yolov7_tracker_tpu_torch.ops import auction

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
