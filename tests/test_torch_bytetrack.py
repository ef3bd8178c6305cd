"""ByteTrack slab step: the PyTorch port against the JAX package on
synthetic detection streams (>= 60 frames) that exercise births, low-score
second-stage matches, occlusion (lost and refound tracks) and false
positives. Ids must be identical and boxes within 1e-4."""

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu.trackers.registry import build_tracker as j_build
from yolov7_tracker_tpu_torch.trackers import slab as TS
from yolov7_tracker_tpu_torch.trackers.registry import build_tracker as t_build


def _stream(seed, n_frames=64, n_obj=8, d=24):
    """Per frame: (tlbr (d,4), score (d,), valid (d,)) numpy arrays."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(50, 500, (n_obj, 2))
    vel = rng.uniform(-5, 5, (n_obj, 2))
    wh = rng.uniform(25, 70, (n_obj, 2))
    gone = [(int(rng.integers(5, max(6, n_frames - 15))),
             int(rng.integers(3, 12)))
            for _ in range(n_obj)]
    frames = []
    for t in range(n_frames):
        rows, scores = [], []
        for i in range(n_obj):
            start, length = gone[i]
            if start <= t < start + length and i % 2 == 0:
                continue  # occluded
            xy = pos[i] + vel[i] * t + rng.normal(0, 1.0, 2)
            rows.append(np.r_[xy, xy + wh[i]])
            scores.append(rng.uniform(0.7, 0.95) if rng.random() > 0.2
                          else rng.uniform(0.25, 0.45))
        for _ in range(int(rng.integers(0, 3))):  # false positives
            xy = rng.uniform(0, 600, 2)
            rows.append(np.r_[xy, xy + rng.uniform(20, 60, 2)])
            scores.append(rng.uniform(0.2, 0.8))
        order = rng.permutation(len(rows))
        tlbr = np.zeros((d, 4), np.float32)
        score = np.zeros(d, np.float32)
        valid = np.zeros(d, bool)
        n = len(rows)
        tlbr[:n] = np.asarray(rows, np.float32)[order]
        score[:n] = np.asarray(scores, np.float32)[order]
        valid[:n] = True
        frames.append((tlbr, score, valid))
    return frames


@pytest.mark.parametrize("seed", [0, 1])
def test_bytetrack_matches_jax(seed):
    cfg = JS.TrackerConfig(tracker="bytetrack", conf_thresh=0.5,
                           capacity=32, det_capacity=24)
    j_step, j_cfg = j_build(cfg)
    t_step, t_cfg = t_build(TS.TrackerConfig(**vars(cfg)), "cpu")
    j_slab = JS.init_slab(j_cfg)
    t_slab = TS.init_slab(t_cfg, "cpu")
    n_rows = 0
    for tlbr, score, valid in _stream(seed):
        cls = np.zeros_like(score)
        j_slab, j_out = j_step(j_slab, JS.make_det_slab(
            j_cfg, tlbr, score, cls, valid))
        t_slab, t_out = t_step(t_slab, TS.make_det_slab(
            t_cfg, tlbr, score, cls, valid, "cpu"))
        jv = np.asarray(j_out.valid)
        tv = t_out.valid.numpy()
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(t_out.track_id.numpy()[tv],
                                      np.asarray(j_out.track_id)[jv])
        np.testing.assert_allclose(t_out.tlwh.numpy()[tv],
                                   np.asarray(j_out.tlwh)[jv], atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(t_slab.state.numpy(),
                                      np.asarray(j_slab.state))
        n_rows += int(tv.sum())
    assert n_rows > 200  # the stream really carried tracks
    assert int(t_slab.next_id) == int(j_slab.next_id)


def test_slab_checkpoint_roundtrip(tmp_path):
    cfg = TS.TrackerConfig(tracker="bytetrack", conf_thresh=0.5,
                           capacity=32, det_capacity=24)
    step, cfg = t_build(cfg, "cpu")
    slab = TS.init_slab(cfg, "cpu")
    for tlbr, score, valid in _stream(3, n_frames=8):
        slab, _ = step(slab, TS.make_det_slab(
            cfg, tlbr, score, np.zeros_like(score), valid, "cpu"))
    path = str(tmp_path / "state.npz")
    TS.save_slab(path, slab, cfg, tag="cam0")
    back = TS.load_slab(path, cfg, "cpu", expect_tag="cam0")
    for a, b in zip(slab, back):
        assert torch.equal(a, b)
    # the JAX package reads the same checkpoint
    jback = JS.load_slab(path, JS.TrackerConfig(**vars(cfg)),
                         expect_tag="cam0")
    np.testing.assert_array_equal(np.asarray(jback.track_id),
                                  slab.track_id.numpy())
    with pytest.raises(ValueError):
        TS.load_slab(path, cfg, "cpu", expect_tag="cam1")
