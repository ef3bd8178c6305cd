"""The port's camera-motion compensation on the CPU: grayscale and the 2x
downscale bit for bit against OpenCV, ecc_affine against the JAX
package's, the GMC estimator's state and failure rules, ORB against the
JAX estimator and without OpenCV, and the pipeline with ReID and GMC at a
tiny detector against the JAX pipeline (with a checkpointed resume)."""

import sys

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    narrow_w6_cfg, one_torch_thread, random_variables, sharpen_heads,
)
from tests.test_torch_reid import flax_variables
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg
from yolov7_tracker_tpu.pipeline import PipelineConfig as JPipelineConfig
from yolov7_tracker_tpu.pipeline import TrackingPipeline as JPipeline
from yolov7_tracker_tpu.reid.osnet import build_osnet as j_build_osnet
from yolov7_tracker_tpu.trackers import gmc as jgmc
from yolov7_tracker_tpu.trackers.slab import TrackerConfig as JTrackerConfig
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models.from_jax import (
    jax_variables_to_torch, osnet_variables_to_torch,
)
from yolov7_tracker_tpu_torch.pipeline import PipelineConfig, TrackingPipeline
from yolov7_tracker_tpu_torch.reid import build_reid
from yolov7_tracker_tpu_torch.trackers import gmc as tgmc
from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig


def _smooth_frame(rng, h, w, k=8):
    """Blocks of k x k pixels, bilinearly upsampled: texture at every
    scale ECC looks at."""
    base = rng.integers(0, 255, (h // k + 1, w // k + 1, 3), np.uint8)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize("hw", [(36, 50), (37, 51), (1080, 1920)])
def test_gray_equals_cv2(hw):
    frame = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,),
                                                  np.uint8)
    np.testing.assert_array_equal(
        tgmc.to_gray(torch.from_numpy(frame)).numpy(),
        cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("hw", [(36, 50), (540, 960), (1080, 1920)])
def test_downscale_equals_cv2_at_even_sizes(hw):
    gray = np.random.default_rng(hw[1]).integers(0, 256, hw, np.uint8)
    np.testing.assert_array_equal(
        tgmc.downscale2(torch.from_numpy(gray)).numpy(),
        cv2.resize(gray, (hw[1] // 2, hw[0] // 2)))


def test_downscale_at_odd_sizes():
    """At an odd size cv2 resamples bilinearly at a scale a little above 2
    (its fixed-point INTER_LINEAR); the port reproduces it bit for bit, on
    a smooth 541 x 961 frame and on noise at odd sizes."""
    smooth = cv2.cvtColor(_smooth_frame(np.random.default_rng(0), 541, 961),
                          cv2.COLOR_BGR2GRAY)
    rng = np.random.default_rng(1)
    grays = [smooth] + [rng.integers(0, 256, hw, np.uint8)
                        for hw in ((541, 961), (1081, 1921), (1079, 1919),
                                   (7, 11))]
    for gray in grays:
        h, w = gray.shape
        np.testing.assert_array_equal(
            tgmc.downscale2(torch.from_numpy(gray)).numpy(),
            cv2.resize(gray, (w // 2, h // 2)), err_msg=f"{h} x {w}")


@pytest.mark.parametrize("hw", [(540, 961), (541, 960), (5, 2), (3, 3)])
def test_downscale_equals_cv2_with_one_odd_side(hw):
    """One odd side is enough for cv2 to leave its half-size path on both
    axes."""
    gray = np.random.default_rng(hw[0] + hw[1]).integers(0, 256, hw,
                                                         np.uint8)
    np.testing.assert_array_equal(
        tgmc.downscale2(torch.from_numpy(gray)).numpy(),
        cv2.resize(gray, (hw[1] // 2, hw[0] // 2)))


def test_ecc_matches_jax():
    rng = np.random.default_rng(0)
    img = cv2.cvtColor(_smooth_frame(rng, 64, 96), cv2.COLOR_BGR2GRAY)
    img = img.astype(np.float32)
    for m in (np.float32([[1, 0, 2.0], [0, 1, -1.5]]),
              np.float32([[0.999, -0.02, 1.0], [0.02, 0.999, 0.5]])):
        shifted = cv2.warpAffine(img, m, (96, 64))
        want = np.asarray(jgmc.ecc_affine(jnp.asarray(img),
                                          jnp.asarray(shifted)))
        got = tgmc.ecc_affine(torch.from_numpy(img),
                              torch.from_numpy(shifted)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_ecc_gmc_recovers_a_shift_and_keeps_state():
    rng = np.random.default_rng(1)
    f0 = _smooth_frame(rng, 120, 200)
    f1 = np.roll(f0, 6, axis=1)
    g = tgmc.GMC("ecc")
    assert torch.equal(g.apply(torch.from_numpy(f0)), tgmc.IDENTITY_WARP)
    warp = g.apply(torch.from_numpy(f1))
    assert abs(float(warp[0, 2]) - 6.0) < 0.5 and abs(float(warp[1, 2])) < 0.5
    # the state round-trips through numpy (checkpoints) and gives the
    # same next warp
    h = tgmc.GMC("ecc")
    h.set_state(g.get_state())
    f2 = np.roll(f1, 6, axis=1)
    assert torch.equal(h.apply(torch.from_numpy(f2)),
                       g.apply(torch.from_numpy(f2)))


def test_ecc_gmc_non_finite_is_identity(monkeypatch):
    g = tgmc.GMC("ecc")
    frame = torch.from_numpy(_smooth_frame(np.random.default_rng(2), 40, 60))
    g.apply(frame)
    monkeypatch.setattr(tgmc, "ecc_affine",
                        lambda a, b: torch.full((6,), float("nan")))
    assert torch.equal(g.apply(frame), tgmc.IDENTITY_WARP)


def test_orb_matches_jax_and_needs_opencv(monkeypatch):
    rng = np.random.default_rng(1)
    base = rng.integers(0, 255, (30, 40, 3), np.uint8)
    f1 = cv2.resize(base, (320, 240), interpolation=cv2.INTER_NEAREST)
    f2 = cv2.warpAffine(f1, np.float32([[1, 0, 6.0], [0, 1, 2.0]]),
                        (320, 240))
    j, t = jgmc.GMC("orb"), tgmc.GMC("orb")
    for f in (f1, f2):
        np.testing.assert_array_equal(t.apply(f).numpy(), j.apply(f))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tgmc.GMC("orb").apply(f1)
    with pytest.raises(ValueError):
        tgmc.GMC("sift")


N_FRAMES = 9
PIPE = dict(model="yolov7-w6", nc=8, img_size=128, detector_batch=3,
            dtype="float32", max_det=64, reid="osnet_x0_25",
            reid_capacity=8, gmc_method="ecc")
TRACK = dict(tracker="strongsort", conf_thresh=0.5, capacity=32,
             det_capacity=64)


def _frames():
    """Bright blocks on a smooth background, the camera panning 4 px a
    frame."""
    rng = np.random.default_rng(0)
    base = _smooth_frame(rng, 96, 200) // 3
    for _ in range(6):
        y, x = rng.integers(0, 72), rng.integers(0, 176)
        base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
    return [np.ascontiguousarray(np.roll(base, 4 * t, axis=1)[:, :160])
            for t in range(N_FRAMES)]


@pytest.fixture(scope="module")
def pipes():
    spec = parse_yaml_cfg(narrow_w6_cfg())
    weights = sharpen_heads(random_variables(spec, seed=1), spec,
                            obj_boost=7.0, levels=(0,))
    reid_vars = flax_variables(j_build_osnet("osnet_x0_25"), (128, 256), 4)
    jpipe = JPipeline(JPipelineConfig(wpack=False, **PIPE),
                      JTrackerConfig(**TRACK),
                      variables=jax.tree.map(jnp.asarray, weights),
                      spec=spec, reid_variables=reid_vars)
    tspec_ = tspec.parse_yaml_cfg(narrow_w6_cfg())

    def port():
        return TrackingPipeline(
            PipelineConfig(**PIPE), TrackerConfig(**TRACK),
            state_dict=jax_variables_to_torch(weights, tspec_),
            spec=tspec_, device="cpu",
            reid_state_dict=osnet_variables_to_torch(
                reid_vars, build_reid("osnet_x0_25")[0]))

    return jpipe, port


def test_pipeline_with_reid_and_gmc_matches_jax(pipes, tmp_path,
                                                monkeypatch):
    """The random detector's 64 overlapping boxes and the random OSNet's
    look-alike features make StrongSORT's fused costs dense, where two
    optimal-enough matchings can differ: the port's tracker solves with
    the square auction here, as the JAX package does on the CPU (the
    private-dummy auction is held against the Pallas kernel in
    tests/test_torch_auction.py)."""
    from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
    from yolov7_tracker_tpu_torch.trackers import strongsort

    monkeypatch.setattr(strongsort, "solve_assignment", masked_assignment)
    jpipe, port = pipes
    frames = _frames()
    want = jpipe.run_sequence(iter(frames))
    pipe = port()
    got = pipe.run_sequence(iter(frames))
    assert [r[0] for r in got] == [r[0] for r in want]
    rows = 0
    for g, w in zip(got, want):
        assert g[1] == w[1], g[0]
        np.testing.assert_allclose(np.asarray(g[2]).reshape(-1, 4),
                                   np.asarray(w[2]).reshape(-1, 4),
                                   atol=1e-3, rtol=0)
        rows += len(g[1])
    assert rows >= 2 * N_FRAMES
    # a checkpointed resume (slab + the GMC's previous frame) continues
    # as one run does
    pipe = port()
    first, mid = pipe.run_sequence_stateful(iter(frames[:4]))
    path = str(tmp_path / "state.npz")
    pipe.save_tracker_state(mid, path, tag="cam")
    resumed = port()
    slab = resumed.load_tracker_state(path, expect_tag="cam")
    second, _ = resumed.run_sequence_stateful(iter(frames[4:]),
                                              initial_slab=slab)
    for a, b in zip(got, first + second):
        assert a[:2] == b[:2]
    with pytest.raises(NotImplementedError):
        resumed.step_frame(resumed.init_tracker(), frames[0])


def test_reid_needs_feature_dim():
    with pytest.raises(ValueError, match="feature_dim=0"):
        TrackingPipeline(PipelineConfig(model="yolov7-tiny", nc=4,
                                        img_size=64, reid="osnet_x0_25"),
                         TrackerConfig(tracker="sort"), device="cpu")


def test_ecc_diverging_to_nan_gives_identity(monkeypatch):
    """A singular Hessian makes the steps NaN (solve_ex does not raise):
    the samples stay in bounds and the warp becomes identity, as in the
    JAX package."""
    g = tgmc.GMC("ecc")
    frame = torch.from_numpy(_smooth_frame(np.random.default_rng(3), 40, 60))
    g.apply(frame)
    solve = torch.linalg.solve_ex
    monkeypatch.setattr(torch.linalg, "solve_ex", lambda a, b: (
        torch.full_like(b, float("nan")), solve(a, b)[1]))
    assert torch.equal(g.apply(frame), tgmc.IDENTITY_WARP)


def test_ecc_does_not_recover_a_shift_of_full_size_noise():
    """At 1080x1920 (540x960 after the downscale) ECC's steps diverge on
    white noise for an 8-px shift, while the same shift of smooth texture
    is recovered (test_ecc_gmc_recovers_a_shift_and_keeps_state; on the
    card, tests/test_torch_cuda.py): why chip_smoke's ECC trackers run on
    a smooth pan."""
    f0 = np.random.default_rng(0).integers(0, 255, (1080, 1920, 3), np.uint8)
    g = tgmc.GMC("ecc")
    g.apply(torch.from_numpy(f0))
    warp = g.apply(torch.from_numpy(np.roll(f0, 8, axis=1)))
    assert bool(torch.isfinite(warp).all())
    assert abs(float(warp[0, 2]) - 8.0) > 5.0, warp
