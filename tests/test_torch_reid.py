"""The port's ReID models and crops against the JAX package on the CPU:
OSNet (x0_25 at the tracker's crop size, x1_0 at full width on small
crops) and the DeepSORT CNN from the same Flax variables through
models/from_jax.py (float32, relative 1e-4), the gather crops against
JAX extract_crops, the checkpoint rules, and the track CLI with
strongsort, a seeded OSNet checkpoint and ECC."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    narrow_w6_cfg, one_torch_thread, random_variables, sharpen_heads,
)
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg
from yolov7_tracker_tpu.reid import extractor as jext
from yolov7_tracker_tpu.reid.deepsort_cnn import DeepSortCNN as JDeepSort
from yolov7_tracker_tpu.reid.osnet import build_osnet as j_build_osnet
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models.from_jax import (
    deepsort_cnn_variables_to_torch, jax_variables_to_torch,
    osnet_variables_to_torch,
)
from yolov7_tracker_tpu_torch.reid import (
    build_reid, load_reid_state_dict, random_reid_state_dict, resolve_reid,
)
from yolov7_tracker_tpu_torch.reid import extractor as text


def flax_variables(model, hw, seed):
    """Seeded Flax variables of ``model`` as numpy: lecun-normal kernels,
    random BN affine terms and statistics (shapes from model.init)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,))))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            x = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        elif name == "scale":
            x = rng.uniform(0.8, 1.2, x.shape)
        elif name == "mean":
            x = rng.normal(0, 0.1, x.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, x.shape)
        else:
            x = rng.normal(0, 0.05, x.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _both(j_model, t_model, convert, hw, batch=2, seed=0):
    variables = flax_variables(j_model, hw, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch,) + hw + (3,)).astype(np.float32)
    want = np.asarray(j_model.apply(variables, jnp.asarray(x)))
    t_model.load_state_dict(convert(variables, t_model))
    with torch.no_grad():
        got = t_model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (batch, 512)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name,hw", [("osnet_x0_25", (128, 256)),
                                     ("osnet_x1_0", (32, 64))])
def test_osnet_matches_jax(name, hw):
    _both(j_build_osnet(name), build_reid(name)[0], osnet_variables_to_torch,
          hw)


def test_deepsort_cnn_matches_jax():
    _both(JDeepSort(), build_reid("deepsort_cnn")[0],
          deepsort_cnn_variables_to_torch, (128, 64))


def test_crops_match_jax():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 255, (90, 160, 3), np.uint8)
    # interior, off-edge (clamped), sub-pixel, tiny, degenerate and the
    # padded slab's zero box
    tlbr = np.array([[10.3, 20.7, 50.9, 80.2], [-5.0, -8.0, 30.0, 40.0],
                     [100.0, 40.0, 170.0, 95.0], [12.0, 12.0, 13.0, 13.0],
                     [30.0, 30.0, 30.0, 30.0], [0.0, 0.0, 0.0, 0.0]],
                    np.float32)
    for out_hw in [(128, 64), (128, 256), (8, 8)]:
        got = text.extract_crops(torch.from_numpy(frame),
                                 torch.from_numpy(tlbr), out_hw).numpy()
        want = np.asarray(jext.extract_crops(jnp.asarray(frame),
                                             jnp.asarray(tlbr), out_hw))
        assert got.shape == want.shape == (6, *out_hw, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_checkpoint_rules(tmp_path):
    """torchreid checkpoints load by the reference's rule: ``module.``
    stripped, entries the model lacks (the classifier) dropped; the width
    comes from the file name; deepsort takes its own CNN."""
    model, hw = build_reid("osnet_x0_25")
    assert hw == (128, 256)
    sd = random_reid_state_dict(model, seed=3)
    ckpt = {"module." + k: v for k, v in sd.items()}
    ckpt["module.classifier.weight"] = torch.zeros(751, 512)
    path = tmp_path / "osnet_x0_25_msmt17.pth"
    torch.save({"state_dict": ckpt}, path)
    name, loaded = resolve_reid("strongsort", str(path))
    assert name == "osnet_x0_25"
    fresh = load_reid_state_dict(build_reid(name)[0], loaded)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert resolve_reid("strongsort", "") == ("none", None)
    torch.save({"net_dict": random_reid_state_dict(
        build_reid("deepsort_cnn")[0])}, tmp_path / "ckpt.t7")
    assert resolve_reid("deepsort", str(tmp_path / "ckpt.t7"))[0] == \
        "deepsort_cnn"
    with pytest.raises(ValueError, match="no entry"):
        load_reid_state_dict(build_reid("deepsort_cnn")[0], ckpt)


def test_track_cli_strongsort_reid_ecc(tmp_path):
    import cv2

    from yolov7_tracker_tpu_torch.cli import track

    rng = np.random.default_rng(0)
    base = rng.integers(0, 96, (96, 160, 3), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, 72), rng.integers(0, 136)
        base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
    seq_dir = tmp_path / "data" / "images" / "test" / "SYN-01" / "img1"
    seq_dir.mkdir(parents=True)
    for t in range(6):
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
    reid_path = tmp_path / "osnet_x0_25.pth"
    torch.save(random_reid_state_dict(build_reid("osnet_x0_25")[0], seed=5),
               reid_path)
    folder = track.main([
        "--dataset", "synth", "--config_dir", str(cfg_dir),
        "--tracker", "strongsort", "--reid_model_path", str(reid_path),
        "--reid_capacity", "8", "--gmc", "ecc",
        "--model", str(model_yaml), "--model_path", str(sd_path),
        "--nc", "8", "--img_size", "128", "--conf_thresh", "0.5",
        "--detector_batch", "3", "--capacity", "32", "--det_capacity", "64",
        "--dtype", "float32", "--track_eval", "false", "--device", "cpu",
        "--output_dir", str(tmp_path / "out")])
    with open(os.path.join(folder, "SYN-01.txt")) as fh:
        rows = [r.split(",") for r in fh.read().splitlines()]
    assert rows and {int(r[0]) for r in rows} <= set(range(1, 7))
    assert len({int(r[1]) for r in rows}) >= 2


def test_seeded_reid_needs_measured_bn_statistics():
    """chip_smoke's seeded ReID weights: with random BN statistics the
    embeddings of different noise crops are nearly parallel; with the
    statistics measured on those crops (chip_smoke.calibrate_bn) they part,
    and OSNet's come out at unit mean norm."""
    import chip_smoke

    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 255, (270, 480, 3), np.uint8))
    xy = rng.uniform(0, 400, (24, 2))
    tlbr = torch.from_numpy(np.c_[xy, xy + rng.uniform(20, 80, (24, 2))]
                            .astype(np.float32))
    model, hw = build_reid("osnet_x0_25")
    model.load_state_dict(random_reid_state_dict(model, seed=0))
    crops = text.extract_crops(frame, tlbr, hw).permute(0, 3, 1, 2)

    def mean_cosine():
        with torch.no_grad():
            f = model.eval()(crops)
        f = f / f.norm(dim=1, keepdim=True)
        cos = f @ f.T
        return float(cos[~torch.eye(24, dtype=torch.bool)].mean()), f

    before, _ = mean_cosine()
    chip_smoke.calibrate_bn(model, crops)
    after, _ = mean_cosine()
    with torch.no_grad():
        norm = float(model(crops).norm(dim=1).mean())
    assert before > 0.99 and after < 0.6, (before, after)
    assert abs(norm - 1.0) < 1e-3
