"""The port's AFLink and GSI against the JAX package on the CPU: the
PostLinker from the same seeded Flax variables (float32, 1e-5), link_tracks
(the same merged ids) and gsi_interpolation (the same rows) on
tests/test_aflink_post.py's inputs and on a crowd of fragments, and
--aflink / --gsi through the track CLI against the JAX package's
post-processing of the same rows."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from tests.test_aflink_post import _fragmented_rows
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    narrow_w6_cfg, one_torch_thread, random_variables, sharpen_heads,
)
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg
from yolov7_tracker_tpu.reid.aflink import PostLinker as JPostLinker
from yolov7_tracker_tpu.trackers import aflink_post as japost
from yolov7_tracker_tpu_torch.reid.aflink import PostLinker, load_postlinker
from yolov7_tracker_tpu_torch.trackers import aflink_post as tapost


def linker_variables(seed=0):
    """Seeded PostLinker variables as numpy: lecun-normal kernels, random
    BN affine terms and statistics, small biases."""
    x = jnp.zeros((1, 30, 3))
    shapes = jax.eval_shape(lambda: JPostLinker().init(
        jax.random.PRNGKey(0), x, x))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, leaf.shape)
        elif name == "mean":
            v = rng.normal(0, 0.1, leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.normal(0, 0.05, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def linkers(tmp_path_factory):
    """(JAX variables, the msgpack file, the port's PostLinker from it)."""
    variables = linker_variables()
    path = tmp_path_factory.mktemp("aflink") / "linker.msgpack"
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    return variables, str(path), load_postlinker(str(path))


def test_postlinker_matches_jax(linkers):
    variables, _, port = linkers
    rng = np.random.default_rng(1)
    x1, x2 = (rng.normal(0, 1, (6, 30, 3)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(JPostLinker().apply(variables, x1, x2))
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    assert want[:, 1].std() > 1e-3          # the snippets score apart
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert isinstance(port, PostLinker) and not port.training


def _crowd(seed=3):
    """Twelve trajectories, each cut into fragments with gaps of 2-12
    frames and new ids, plus jitter: many gated candidate pairs."""
    rng = np.random.default_rng(seed)
    rows, tid = [], 1
    for _ in range(12):
        p, v = rng.uniform(100, 600, 2), rng.uniform(-3, 3, 2)
        f = 1
        while f < 90:
            n = int(rng.integers(8, 25))
            for k in range(f, min(f + n, 90)):
                xy = p + v * k + rng.normal(0, 1.5, 2)
                rows.append([k, tid, *xy, 30, 60])
            tid += 1
            f += n + int(rng.integers(2, 13))
    return np.asarray(rows, float)


@pytest.mark.parametrize("rows_name", ["fragmented", "crowd"])
def test_link_tracks_matches_jax(linkers, rows_name):
    variables, _, port = linkers
    rows = _fragmented_rows() if rows_name == "fragmented" else _crowd()
    probe = japost.link_tracks(rows, variables, thr=0.0)
    merged = 0
    for thr in (0.0, 0.5, 0.95, 1.1):
        want = japost.link_tracks(rows, variables, thr=thr)
        got = tapost.link_tracks(rows, port, thr=thr)
        np.testing.assert_array_equal(got, want, err_msg=f"thr {thr}")
        merged = max(merged, int((want[:, 1] != rows[:, 1]).sum()))
    assert merged > 0 and (probe[:, 1] != rows[:, 1]).any()
    far = rows.copy()
    far[:, 2] += 5000 * (far[:, 1] % 2)     # odd ids far away: fewer pairs
    np.testing.assert_array_equal(tapost.link_tracks(far, port, thr=0.0),
                                  japost.link_tracks(far, variables, thr=0.0))


@pytest.mark.parametrize("interval,tau", [(20, 5.0), (20, 10.0), (4, 10.0)])
def test_gsi_interpolation_matches_jax(interval, tau):
    rng = np.random.default_rng(0)
    rows = []
    for f in range(1, 31):
        if f in (10, 11, 12):
            continue
        rows.append([f, 1, 100 + 3 * f + rng.normal(0, 4), 50 + f, 20, 40])
    rows = np.concatenate([np.asarray(rows, float), _crowd()[:200]])
    want = japost.gsi_interpolation(rows, interval=interval, tau=tau)
    got = tapost.gsi_interpolation(rows, interval=interval, tau=tau)
    assert len(want) > len(rows) or interval <= 4   # a 4-frame hole
    np.testing.assert_array_equal(got, want)
    assert tapost.gsi_interpolation(np.zeros((0, 6))).shape == (0, 6)
    assert tapost.link_tracks(np.zeros((0, 6)), None).shape == (0, 6)


def test_track_cli_aflink_gsi_matches_jax_post_processing(linkers, tmp_path):
    """The CLI's rows with --aflink and --gsi equal the JAX package's
    link_tracks + gsi_interpolation (and its regrouping onto the frames) of
    the same CLI's rows without them."""
    import cv2

    from yolov7_tracker_tpu_torch.cli import track
    from yolov7_tracker_tpu_torch.models import spec as tspec
    from yolov7_tracker_tpu_torch.models.from_jax import (
        jax_variables_to_torch,
    )

    variables, linker_path, _ = linkers
    rng = np.random.default_rng(0)
    base = rng.integers(0, 96, (96, 160, 3), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, 72), rng.integers(0, 136)
        base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
    seq_dir = tmp_path / "data" / "images" / "test" / "SYN-01" / "img1"
    seq_dir.mkdir(parents=True)
    for t in range(8):
        cv2.imwrite(str(seq_dir / f"{t + 1:06d}.png"),
                    np.roll(base, 3 * t, axis=1))
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    with open(cfg_dir / "synth.yaml", "w") as fh:
        yaml.safe_dump({"DATASET_ROOT": str(tmp_path / "data")}, fh)
    model_yaml = tmp_path / "w6n.yaml"
    with open(model_yaml, "w") as fh:
        yaml.safe_dump(narrow_w6_cfg(), fh)
    spec = parse_yaml_cfg(narrow_w6_cfg())
    weights = sharpen_heads(random_variables(spec, seed=1), spec,
                            obj_boost=7.0, levels=(0,))
    sd_path = tmp_path / "w6n.pt"
    torch.save(jax_variables_to_torch(
        weights, tspec.parse_yaml_cfg(narrow_w6_cfg())), sd_path)
    common = [
        "--dataset", "synth", "--config_dir", str(cfg_dir),
        "--tracker", "sort", "--model", str(model_yaml),
        "--model_path", str(sd_path), "--nc", "8", "--img_size", "128",
        "--conf_thresh", "0.5", "--detector_batch", "4", "--capacity", "32",
        "--det_capacity", "64", "--dtype", "float32", "--track_eval",
        "false", "--device", "cpu"]

    def rows(folder):
        with open(os.path.join(folder, "SYN-01.txt")) as fh:
            return [r.split(",") for r in fh.read().splitlines()]

    plain = rows(track.main(common + ["--output_dir", str(tmp_path / "a")]))
    post = rows(track.main(common + ["--output_dir", str(tmp_path / "b"),
                                     "--aflink", linker_path, "--gsi"]))
    # the JAX CLI's post-processing (yolov7_tracker_tpu/cli/track.py) of
    # the plain rows, regrouped onto the frames as it does: the writer zips
    # each frame's rows with its original classes, so a frame keeps at most
    # as many rows as it had
    arr = np.asarray([[float(x) for x in r[:6]] for r in plain])
    want = japost.gsi_interpolation(japost.link_tracks(arr, variables))
    count = {}
    for r in plain:
        count[int(r[0])] = count.get(int(r[0]), 0) + 1
    by_frame = {}
    for r in want:
        by_frame.setdefault(int(r[0]), []).append(r)
    want_rows = [(f, int(r[1]), r[2:6]) for f in sorted(count)
                 for r in by_frame.get(f, [])[:count[f]]]
    assert len(post) == len(want_rows) >= 8
    for g, (f, tid, box) in zip(post, want_rows):
        assert (int(g[0]), int(g[1])) == (f, tid)
        # the JAX side smooths the txt's rows, rounded to 0.01 px, which
        # the GP's linear smoother carries through at a gain below 2
        np.testing.assert_allclose([float(x) for x in g[2:6]], box,
                                   atol=0.02)
