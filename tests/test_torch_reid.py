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


# ---------------------------------------------------------------------------
# K5: the DeepSORT CNN folded (ops/deepsort_cnn.py), its plain version here
# ---------------------------------------------------------------------------

def _far_bn_state_dict(model, seed):
    """Seeded weights whose BN statistics and affine terms are far from
    identity (means N(0, 2), variances U(0.01, 10), scales U(-2, 2)), so
    that a wrong fold shows."""
    sd = random_reid_state_dict(model, seed=seed)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            x = rng.normal(0.0, 2.0, v.shape)
        elif k.endswith("running_var"):
            x = rng.uniform(0.01, 10.0, v.shape)
        elif k.endswith(".weight") and v.dim() == 1:
            x = rng.uniform(-2.0, 2.0, v.shape)
        else:
            continue
        sd[k] = torch.from_numpy(x.astype(np.float32))
    return sd


def _k5_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("n,hw,far", [
    (1, (128, 64), False), (7, (128, 64), False), (7, (128, 64), True),
    # the CPU's float32 convs take 16 s for 300 crops of 128 x 64 on one
    # thread: the two large N run at a quarter of the pixels
    (300, (64, 32), False), (613, (64, 32), True)])
def test_deepsort_folded_plain_equals_eager(n, hw, far):
    """The folded network's plain version (what the CPU runs, K5's
    arithmetic) against the module's eager forward, relative 1e-5."""
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5

    model = build_reid("deepsort_cnn")[0]
    model.load_state_dict(_far_bn_state_dict(model, n) if far
                          else random_reid_state_dict(model, seed=n))
    crops = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n,) + hw + (3,)).astype(np.float32))
    folded = k5.fold(model.eval())
    with torch.no_grad():
        want = model(crops.permute(0, 3, 1, 2))
        got = k5.forward(folded, crops)
    assert got.shape == want.shape == (n, 512)
    assert _k5_rel(got, want) <= 1e-5


def test_deepsort_fold_lays_out_the_kernels_weights():
    """fold: BN in float64 into each conv; the 3x3 rows in K5's K step
    order, the projection's rows and bias added to the second conv of each
    downsampling block."""
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5

    model = build_reid("deepsort_cnn")[0]
    model.load_state_dict(_far_bn_state_dict(model, 4))
    folded = k5.fold(model.eval())
    model.requires_grad_(False)
    assert folded.stem_weight.shape == (27, 64)
    assert [(c.weight.shape[0], c.c_in, c.stride, c.project)
            for c in folded.convs[4:6]] == [(576, 64, 2, False),
                                            (1152 + 64, 128, 1, True)]
    blk = model.layer2[0]
    s = (blk.bn2.weight.double()
         / torch.sqrt(blk.bn2.running_var.double() + blk.bn2.eps))
    sd = (blk.downsample[1].weight.double()
          / torch.sqrt(blk.downsample[1].running_var.double() + 1e-5))
    w = folded.convs[5].weight
    # row (chunk 2, tap (1, 2), channel 3) of the 3x3 part
    want = blk.conv2.weight.double()[:, 2 * 16 + 3, 1, 2] * s
    np.testing.assert_allclose(w[(2 * 9 + 5) * 16 + 3].numpy(),
                               want.float().numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        w[1152 + 10].numpy(),
        (blk.downsample[0].weight.double()[:, 10, 0, 0] * sd).float().numpy(),
        rtol=1e-6)
    bias = ((-blk.bn2.running_mean.double()) * s + blk.bn2.bias.double()
            + (-blk.downsample[1].running_mean.double()) * sd
            + blk.downsample[1].bias.double())
    np.testing.assert_allclose(folded.convs[5].bias.numpy(),
                               bias.float().numpy(), rtol=1e-6, atol=1e-6)


def _reid_pipe(reid, tracker):
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

    return TrackingPipeline(
        PipelineConfig(model="yolov7-tiny", nc=8, img_size=64,
                       detector_batch=1, dtype="float32", max_det=8,
                       reid=reid),
        TrackerConfig(tracker=tracker, capacity=8, det_capacity=8),
        device="cpu")


def test_reid_forward_routes_by_model_type(monkeypatch):
    """reid_forward: the DeepSORT CNN through ops/deepsort_cnn.forward on
    the weights folded when the pipeline was built (and again by
    fold_reid after the module's weights change); OSNet through its
    module, never the folded path."""
    from yolov7_tracker_tpu_torch import pipeline
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5

    calls = []
    forward = k5.forward
    monkeypatch.setattr(pipeline.k5, "forward", lambda folded, crops: (
        calls.append(crops.shape[0]), forward(folded, crops))[1])
    rng = np.random.default_rng(2)
    crops = torch.from_numpy(
        rng.standard_normal((3, 128, 64, 3)).astype(np.float32))

    pipe = _reid_pipe("deepsort_cnn", "deepsort")
    assert pipe.reid_folded is not None
    with torch.no_grad():
        got = pipe.reid_forward(crops)
        want = pipe.reid_model(crops.permute(0, 3, 1, 2))
    assert calls == [3] and _k5_rel(got, want) <= 1e-5
    pipe.reid_model.load_state_dict(_far_bn_state_dict(pipe.reid_model, 5))
    pipe.fold_reid()
    with torch.no_grad():
        got = pipe.reid_forward(crops)
        want = pipe.reid_model(crops.permute(0, 3, 1, 2))
    assert calls == [3, 3] and _k5_rel(got, want) <= 1e-5

    osnet = _reid_pipe("osnet_x0_25", "strongsort")
    assert osnet.reid_folded is None
    wide = torch.from_numpy(
        rng.standard_normal((2, 128, 256, 3)).astype(np.float32))
    with torch.no_grad():
        got = osnet.reid_forward(wide)
        want = osnet.reid_model(wide.permute(0, 3, 1, 2))
    assert calls == [3, 3] and torch.equal(got, want)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    """On the CPU neither the build nor a launch is reached: K5's library
    and its launcher raise if called."""
    from yolov7_tracker_tpu_torch.ops import deepsort_cnn as k5

    def refuse(*args, **kwargs):
        raise AssertionError("K5 reached on a CPU tensor")

    launcher = k5.forward_cuda
    monkeypatch.setattr(k5, "load_library", refuse)
    monkeypatch.setattr(k5, "forward_cuda", refuse)
    pipe = _reid_pipe("deepsort_cnn", "deepsort")
    frame = torch.from_numpy(np.random.default_rng(6).integers(
        0, 255, (90, 160, 3), np.uint8))
    tlbr = torch.tensor([[10.0, 5.0, 40.0, 70.0], [60.0, 20.0, 90.0, 85.0]])
    feats = pipe.embed_dets(frame, tlbr)
    assert feats.shape == (2, 512) and bool(torch.isfinite(feats).all())
    # the launcher itself refuses a CPU tensor before it builds anything
    with pytest.raises(ValueError, match="CUDA"):
        launcher(pipe.reid_folded, torch.zeros(1, 128, 64, 3))
