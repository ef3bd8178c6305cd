"""The port's native host layer (yolov7_tracker_tpu_torch/native) and its
one-call loader against the JAX package's: FrameLoader and lapjv against
yolov7_tracker_tpu.native on the same PNG directory and costs, the port's
iter_frames decoding ahead on the native pool, its cv2 fallback where the
loader cannot be built, and load_pipeline against the JAX load_pipeline
on one Flax msgpack file (the same MOT rows)."""

import functools

import cv2
import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables, sharpen_heads)
import yolov7_tracker_tpu as jpkg
from yolov7_tracker_tpu import native as j_native
from yolov7_tracker_tpu import pipeline as j_pipeline
from yolov7_tracker_tpu.data import sequence as j_seq
from yolov7_tracker_tpu.models import zoo as j_zoo
from yolov7_tracker_tpu.utils.checkpoint import save_variables
import yolov7_tracker_tpu_torch as tpkg
from yolov7_tracker_tpu_torch import native
from yolov7_tracker_tpu_torch import pipeline as t_pipeline
from yolov7_tracker_tpu_torch.data import sequence as t_seq
from yolov7_tracker_tpu_torch.data import writer as t_writer
from yolov7_tracker_tpu_torch.ops.assignment import linear_assignment_host


def _frames(n, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, 3), np.uint8) for _ in range(n)]


@pytest.fixture
def png_dir(tmp_path):
    """12 PNG frames of two sizes, named in order."""
    frames = _frames(8) + _frames(4, 72, 40, seed=1)
    paths = []
    for t, f in enumerate(frames):
        path = str(tmp_path / f"{t:06d}.png")
        cv2.imwrite(path, f)
        paths.append(path)
    return paths, frames


@pytest.mark.parametrize("n_threads,capacity", [(1, 1), (4, 8), (3, 2)])
def test_frameloader_equals_jax(png_dir, n_threads, capacity):
    """In order, the same arrays as the JAX package's loader and as
    cv2.imread, whatever the pool and ring sizes."""
    paths, frames = png_dir
    assert native.frameloader_available()
    got = list(native.FrameLoader(paths, n_threads=n_threads,
                                  capacity=capacity))
    want = list(j_native.FrameLoader(paths, n_threads=n_threads,
                                     capacity=capacity))
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        assert g.dtype == np.uint8 and g.shape == f.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)


def test_frameloader_grows_its_buffer(png_dir):
    """A staging buffer smaller than a frame (fl_next's -2): the frame stays
    in the ring and comes out whole, as in JAX."""
    paths, frames = png_dir
    got = list(native.FrameLoader(paths, max_hw=(8, 8)))
    want = list(j_native.FrameLoader(paths, max_hw=(8, 8)))
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)


def test_frameloader_unreadable_frame(png_dir, tmp_path):
    """fl_next's -3: "skip" warns and leaves the frame out (the JAX
    loader's frames), "raise" raises at that frame, after the ones before
    it."""
    paths, frames = png_dir
    bad = str(tmp_path / "broken.png")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    paths = paths[:3] + [bad] + paths[3:]
    with pytest.warns(UserWarning, match="skipping unreadable frame"):
        got = list(native.FrameLoader(paths, on_error="skip"))
    with pytest.warns(UserWarning, match="skipping unreadable frame"):
        want = list(j_native.FrameLoader(paths, on_error="skip"))
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    seen = []
    with pytest.raises(OSError, match="broken.png"):
        for img in native.FrameLoader(paths):
            seen.append(img)
    assert len(seen) == 3
    with pytest.raises(ValueError):
        native.FrameLoader(paths, on_error="ignore")


def test_iter_frames_decodes_on_the_native_pool(png_dir, monkeypatch):
    """iter_frames reads through the native loader (cv2.imread is never
    called), with the JAX reader's frames."""
    paths, frames = png_dir

    def no_imread(*a, **k):
        raise AssertionError("decoded by cv2 on the caller's thread")

    spec = t_seq.SequenceSpec("seq", paths)
    want = [b[0] for b, _ in j_seq.iter_frames(j_seq.SequenceSpec(
        "seq", paths))]
    monkeypatch.setattr(cv2, "imread", no_imread)
    got = list(t_seq.iter_frames(spec))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_iter_frames_without_the_native_loader(png_dir, monkeypatch, capsys):
    """Where the loader cannot be built (no OpenCV headers), frames decode
    with cv2 on the caller's thread, the same frames, and stderr says so
    once."""
    paths, frames = png_dir
    real_build = native.build

    def no_opencv(name, flags=()):
        if name == "frameloader.cpp":
            raise RuntimeError("g++ failed (1) on frameloader.cpp:\n"
                               "opencv2/imgcodecs.hpp: No such file")
        return real_build(name, flags)

    monkeypatch.setattr(native, "build", no_opencv)
    monkeypatch.setattr(native, "_FL_FAILED", None)
    spec = t_seq.SequenceSpec("seq", paths)
    for _ in range(2):
        got = list(t_seq.iter_frames(spec))
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, f)
    assert not native.frameloader_available()
    err = capsys.readouterr().err
    assert err.count("frame loader cannot be built") == 1, err


@pytest.mark.parametrize("seed", range(4))
def test_lapjv_equals_jax(seed):
    """The host JV with a cost limit: JAX's native.lapjv's r2c and c2r on
    the same costs, the scipy oracle's pairs."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    cost = rng.random((n, m))
    for thresh in (0.3, 0.7, 1.5):
        r2c, c2r = native.lapjv(cost, thresh)
        j_r2c, j_c2r = j_native.lapjv(cost, thresh)
        np.testing.assert_array_equal(r2c, j_r2c)
        np.testing.assert_array_equal(c2r, j_c2r)
        assert r2c.dtype == c2r.dtype == np.int32
        m0, _, _ = linear_assignment_host(cost, thresh)
        pairs = {(i, int(j)) for i, j in enumerate(r2c) if j >= 0}
        assert pairs == {(int(a), int(b)) for a, b in m0}
        for i, j in pairs:
            assert c2r[j] == i
    assert native.available()


def test_lapjv_raises_when_it_cannot_build(monkeypatch):
    """No quiet fallback: g++ is present wherever the port runs."""
    def fail(name, flags=()):
        raise RuntimeError("g++ cannot run: not found")

    monkeypatch.setattr(native, "build", fail)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.lapjv(np.zeros((2, 2)), 0.5)
    assert not native.available()


# ---------------------------------------------------------------------------
# load_pipeline
# ---------------------------------------------------------------------------

LOAD = dict(model="yolov7-tiny", tracker="bytetrack", img_size=160, nc=8)
TRACKER_KW = dict(conf_thresh=0.5, capacity=32, det_capacity=64)


@pytest.fixture(scope="module")
def tiny8_msgpack(tmp_path_factory):
    """Seeded yolov7-tiny (nc 8) Flax variables with the stride-8 head
    sharpened, written by the JAX package's save_variables."""
    spec = j_zoo.get_spec("yolov7-tiny", nc=8)
    variables = sharpen_heads(random_variables(spec, seed=3), spec,
                              sharpen=32.0, obj_boost=4.0, levels=(0,))
    path = tmp_path_factory.mktemp("weights") / "tiny8.msgpack"
    save_variables(str(path), variables)
    return str(path)


def _moving_frames(n=8):
    """A noise background with bright blocks moving 3 px a frame."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 96, (96, 160, 3), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, 72), rng.integers(0, 136)
        base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
    return [np.roll(base, 3 * t, axis=1) for t in range(n)]


def _mot_text(tmp_path, name, results):
    return open(t_writer.save_results(str(tmp_path / name), "seq",
                                      results)).read()


def test_load_pipeline_equals_jax(tiny8_msgpack, monkeypatch, tmp_path):
    """Both loaders on one Flax msgpack file, in float32 on the plain graph
    (the JAX side without its width-packed front): the same MOT rows over
    the frames."""
    monkeypatch.setattr(j_pipeline, "PipelineConfig", functools.partial(
        j_pipeline.PipelineConfig, dtype="float32", wpack=False))
    monkeypatch.setattr(t_pipeline, "PipelineConfig", functools.partial(
        t_pipeline.PipelineConfig, dtype="float32"))
    frames = _moving_frames()
    port = tpkg.load_pipeline(**LOAD, weights=tiny8_msgpack, device="cpu",
                              **TRACKER_KW)
    jpipe = jpkg.load_pipeline(**LOAD, weights=tiny8_msgpack, **TRACKER_KW)
    assert port.device == torch.device("cpu")
    assert vars(port.tcfg) == vars(jpipe.tcfg)
    got = port.run_sequence(iter(frames))
    want = jpipe.run_sequence(iter(frames))
    text = _mot_text(tmp_path, "t", got)
    assert text == _mot_text(tmp_path, "j", want)
    assert sum(len(r[1]) for r in got) > 0, "no tracks"


def test_load_pipeline_reads_a_state_dict_pt(tiny8_msgpack, tmp_path):
    """A .pt state_dict (the port's names) loads the same weights as the
    msgpack file it came from."""
    from yolov7_tracker_tpu_torch.models.convert import load_detector_weights
    from yolov7_tracker_tpu_torch.models.zoo import get_spec

    port = tpkg.load_pipeline(**LOAD, weights=tiny8_msgpack, device="cpu")
    path = str(tmp_path / "tiny8.pt")
    torch.save(load_detector_weights(tiny8_msgpack, get_spec(
        "yolov7-tiny", nc=8)), path)
    again = tpkg.load_pipeline(**LOAD, weights=path, device="cpu")
    x = torch.from_numpy(np.stack(_moving_frames(2)))
    for a, b in zip(port.detect_batch(x), again.detect_batch(x)):
        assert torch.equal(a, b)
