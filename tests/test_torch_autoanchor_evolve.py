"""The port's host-only training helpers against the JAX package's from the
same seeds: train/autoanchor.py (check_anchors' recall and anchors above
threshold, kmean_anchors' k-means + genetic refinement, numpy's global
state seeded alike for scipy's k-means) and train/evolve.py (mutate's
children and evolve's sequence of hyps, best result and evolve.txt, byte
for byte, for a seeded train_fn)."""

import numpy as np
import pytest

from yolov7_tracker_tpu.train import autoanchor as j_aa
from yolov7_tracker_tpu.train import evolve as j_ev
from yolov7_tracker_tpu_torch.train import autoanchor as t_aa
from yolov7_tracker_tpu_torch.train import evolve as t_ev


def _label_whs(seed, n=400):
    rng = np.random.default_rng(seed)
    wh = np.exp(rng.normal(3.5, 0.8, (n, 2)))
    wh[:5] = 1.0                                  # below the 2 px floor
    return wh


@pytest.mark.parametrize("seed", [0, 1])
def test_check_anchors_matches_jax(seed):
    wh = _label_whs(seed)
    anchors = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                        [59, 119], [116, 90], [156, 198], [373, 326]],
                       np.float64)
    for thr in (2.0, 4.0):
        got = t_aa.check_anchors(wh, anchors, thr)
        assert got == j_aa.check_anchors(wh, anchors, thr)
        assert 0 < got["bpr"] <= 1


@pytest.mark.parametrize("n,seed", [(9, 0), (6, 3)])
def test_kmean_anchors_matches_jax(n, seed):
    wh = _label_whs(seed + 10)
    np.random.seed(seed)
    got = t_aa.kmean_anchors(wh, n=n, gen=60, seed=seed)
    np.random.seed(seed)
    want = j_aa.kmean_anchors(wh, n=n, gen=60, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n, 2)
    assert (np.diff(got.prod(1)) >= 0).all()


def _base_hyp():
    return {k: (lo + hi) / 2 for k, (_, lo, hi) in j_ev.META.items()} | {
        "not_evolved": 1.25}


def test_meta_and_mutate_match_jax():
    assert t_ev.META == j_ev.META
    history = [(0.1 * i, {k: v * (1 + 0.01 * i)
                          for k, v in _base_hyp().items()})
               for i in range(7)]
    for seed in range(4):
        for hist in ([], history[:1], history):
            got = t_ev.mutate(_base_hyp(), hist, np.random.default_rng(seed))
            want = j_ev.mutate(_base_hyp(), hist,
                               np.random.default_rng(seed))
            assert got == want
            if not hist:      # a key outside META is never mutated
                assert got["not_evolved"] == 1.25


def test_evolve_matches_jax(tmp_path):
    """The same train_fn (fitness from the hyps and its own seeded noise)
    sees the same hyps in the same order; the best result and the log
    file are the same."""
    def train_fn_factory():
        rng = np.random.default_rng(42)
        seen = []

        def train_fn(hyp):
            seen.append(dict(hyp))
            return float(-abs(hyp["lr0"] - 0.01) - abs(hyp["box"] - 0.05)
                         + 0.01 * rng.random())
        return train_fn, seen

    runs = []
    for mod, name in ((t_ev, "t"), (j_ev, "j")):
        fn, seen = train_fn_factory()
        log = tmp_path / f"evolve_{name}.txt"
        best = mod.evolve(fn, _base_hyp(), generations=12, seed=5,
                          log_path=str(log))
        runs.append((best, seen, log.read_bytes()))
    assert runs[0][1] == runs[1][1]
    assert runs[0][0] == runs[1][0]
    assert runs[0][2] == runs[1][2]
    assert len(runs[0][2].splitlines()) == 12
