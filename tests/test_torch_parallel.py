"""The port's parallel layer (yolov7_tracker_tpu_torch/parallel/{mesh,
tracking,spatial}.py and the global BatchNorm of models/blocks.py) on CPU
ranks over gloo, against the JAX package on the same seeded numpy inputs:
the ranks run in processes that ``parallel.mesh.launch`` spawns
(tests/torch_parallel_ranks.py, which imports no JAX), JAX in this one
on its 8-device virtual CPU mesh. One launch of 2 ranks computes the
BatchNorm, sharded-tracking and spatial cases, one of 3 ranks the spatial
case with uneven bands whose halos span two neighbours; every collective
gives up after TIMEOUT, so a stuck rank fails the fixture instead of
hanging the suite."""

import datetime

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as ranks
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables, sharpen_heads)
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models import zoo as jzoo
from yolov7_tracker_tpu.parallel import mesh as jmesh
from yolov7_tracker_tpu.parallel import tracking as jtracking
from yolov7_tracker_tpu.pipeline import PipelineConfig as JPipelineConfig
from yolov7_tracker_tpu.pipeline import TrackingPipeline as JPipeline
from yolov7_tracker_tpu.trackers import build_tracker as j_build_tracker
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu_torch.models import blocks
from yolov7_tracker_tpu_torch.models import zoo as tzoo
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
from yolov7_tracker_tpu_torch.models.yolo import YoloV7
from yolov7_tracker_tpu_torch.parallel import mesh as M
from yolov7_tracker_tpu_torch.parallel import spatial
from yolov7_tracker_tpu_torch.pipeline import PipelineConfig, TrackingPipeline
from yolov7_tracker_tpu_torch.trackers import slab as TS

TIMEOUT = datetime.timedelta(seconds=120)
N_SEQ, T = 8, 12
TRACK = dict(tracker="bytetrack", conf_thresh=0.5, capacity=16,
             det_capacity=16, track_buffer=3)
IMG = 256
PIPE = dict(model="yolov7-tiny", nc=4, img_size=IMG, detector_batch=1,
            dtype="float32", conf_thres=0.01)
LEVEL_TOL = 1e-4     # of each level's largest |value|


@pytest.fixture(scope="module")
def weights():
    spec = jzoo.get_spec("yolov7-tiny", nc=4)
    return sharpen_heads(random_variables(spec, seed=3), spec)


def _bn_case():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (8, 6, 4, 4)).astype(np.float32)
    return {"x": x, "w": rng.normal(0, 1, x.shape).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "bias": rng.normal(0, 0.5, 6).astype(np.float32)}


def _frames(h, w, seed):
    return np.random.default_rng(seed).integers(0, 255, (1, h, w, 3),
                                                np.uint8)


def _spatial_case(weights, frames, rows):
    spec = tzoo.get_spec("yolov7-tiny", nc=4)
    imgs = np.random.default_rng(1).uniform(
        0, 1, (1, rows, IMG, 3)).astype(np.float32)
    return {"model": "yolov7-tiny", "nc": 4, "pipe": PIPE,
            "state_dict": jax_variables_to_torch(weights, spec),
            "imgs": imgs, "frames": frames}


def _launch(tmp_path_factory, n, cases):
    path = str(tmp_path_factory.mktemp("parallel") / "cases.pt")
    torch.save(cases, path)
    return M.launch(ranks.suite, n, "cpu", path, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def two_ranks(weights, tmp_path_factory):
    cases = {"bn": _bn_case(),
             "track": {"cfg": TRACK, "dets": ranks.det_streams(N_SEQ, T)},
             "spatial": _spatial_case(weights, _frames(240, 320, 5), IMG)}
    return cases, _launch(tmp_path_factory, 2, cases)


@pytest.fixture(scope="module")
def three_ranks(weights, tmp_path_factory):
    """7 rows of stride 32 over 3 ranks: bands of 3, 2 and 2 rows, and
    SPPCSPC's k = 13 pool reads 6 rows, past the next band."""
    cases = {"spatial": _spatial_case(weights, _frames(224, 256, 6), 224)}
    return cases, _launch(tmp_path_factory, 3, cases)


def test_ranks_import_no_jax(two_ranks, three_ranks):
    for _, got in (two_ranks, three_ranks):
        assert got["jax_modules"].tolist() == [0] * got["world"][0]
        assert got["world"][1] == "gloo"


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_shard_batch_is_jax_layout():
    """Rank r's block is the r-th shard of JAX's P("data") on a mesh of
    the same size; a batch that does not divide raises."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    j_mesh = jmesh.data_mesh(2)
    shards = sorted(jmesh.shard_batch(j_mesh, x).addressable_shards,
                    key=lambda s: s.index[0].start)
    for r, shard in enumerate(shards):
        mesh = M.DataMesh(2, r, torch.device("cpu"), None, "gloo")
        got = M.shard_batch(mesh, {"x": torch.from_numpy(x), "n": 3})
        np.testing.assert_array_equal(got["x"].numpy(),
                                      np.asarray(shard.data))
        assert got["n"] == 3
    with pytest.raises(ValueError, match="does not divide"):
        M.shard_batch(M.DataMesh(3, 0, torch.device("cpu"), None, "gloo"),
                      torch.zeros(8))


def test_more_card_ranks_than_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 card ranks asked for, 1 "):
        M.launch(ranks.suite, 2, "cuda", "unused")
    with pytest.raises(ValueError, match="outside a launched world"):
        M.data_mesh(2, "cpu")


# ---------------------------------------------------------------------------
# BatchNorm over the global batch
# ---------------------------------------------------------------------------

def test_batchnorm_statistics_are_global(two_ranks):
    """The port's analogue of tests/test_parallel.py::
    test_batchnorm_is_sync_under_pjit: the statistics of 2 ranks' shards
    are Flax's over the whole batch, not the shard's."""
    import flax.linen as nn

    cases, got = two_ranks
    x = cases["bn"]["x"]
    bn = nn.BatchNorm(use_running_average=False, momentum=0.0, epsilon=1e-5)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = bn.init(jax.random.PRNGKey(0), x_nhwc)
    _, upd = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
    mean = got["bn"]["mean"].numpy()
    np.testing.assert_allclose(mean, x.mean(axis=(0, 2, 3)), atol=1e-5)
    np.testing.assert_allclose(mean, np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["bn"]["var"].numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)
    assert not np.allclose(mean, x[:4].mean(axis=(0, 2, 3)), atol=1e-3)


def test_batchnorm_gradient_is_the_whole_batch(two_ranks):
    """Forward and backward through the global statistics equal one
    process's BatchNorm on the whole batch: the input gradient of each
    shard, and the scale and bias gradients summed over the ranks."""
    cases, got = two_ranks
    case = cases["bn"]
    m = blocks.BatchNorm2d(6).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(case["scale"]))
        m.bias.copy_(torch.from_numpy(case["bias"]))
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    with blocks.batch_stats_sink([]):
        y = m(x)
    (y * torch.from_numpy(case["w"])).sum().backward()
    for name, want in (("y", y.detach()), ("x_grad", x.grad),
                       ("scale_grad", m.weight.grad),
                       ("bias_grad", m.bias.grad)):
        np.testing.assert_allclose(got["bn"][name].numpy(), want.numpy(),
                                   rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# sequence-parallel tracking
# ---------------------------------------------------------------------------

def test_sharded_tracker_matches_jax(two_ranks):
    """8 ByteTrack streams over 2 ranks against JAX's make_sharded_tracker
    on data_mesh(8): the same ids and valid masks, boxes within 1e-5
    relative."""
    cases, got = two_ranks
    step, cfg = j_build_tracker(JS.TrackerConfig(**TRACK))
    tracker = jtracking.make_sharded_tracker(step, jmesh.data_mesh(8))
    dets = JS.DetSlab(*(jnp.asarray(x) for x in cases["track"]["dets"]))
    _, j_outs = tracker(jax.tree.map(jnp.asarray,
                                     jtracking.stack_slabs(cfg, N_SEQ)),
                        dets)
    outs = TS.FrameOutput(*got["track"]["outs"])
    valid = outs.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(j_outs.valid))
    np.testing.assert_array_equal(outs.track_id.numpy()[valid],
                                  np.asarray(j_outs.track_id)[valid])
    np.testing.assert_allclose(outs.tlwh.numpy()[valid],
                               np.asarray(j_outs.tlwh)[valid], rtol=1e-5,
                               atol=0)
    assert valid.sum() > 200 and len(np.unique(
        outs.track_id.numpy()[valid])) > N_SEQ


def test_sharded_tracker_equals_track_scan_multi(two_ranks):
    """The gathered slabs and outputs equal one process's track_scan_multi
    on all 8 streams, bit for bit."""
    cases, got = two_ranks
    pipe = TrackingPipeline(PipelineConfig(model="yolov7-tiny", nc=1,
                                           img_size=64, dtype="float32"),
                            TS.TrackerConfig(**TRACK), device="cpu")
    dets = TS.DetSlab(*(torch.from_numpy(x) for x in cases["track"]["dets"]))
    slabs, outs = pipe.track_scan_multi(pipe.init_multistream(N_SEQ), dets)
    for name, a, b in zip(TS.TrackSlab._fields, got["track"]["slabs"],
                          slabs):
        assert torch.equal(a, b), name
    for name, a, b in zip(TS.FrameOutput._fields, got["track"]["outs"],
                          outs):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# height-sharded detection
# ---------------------------------------------------------------------------

def _jax_levels(weights, imgs):
    spec = jzoo.get_spec("yolov7-tiny", nc=4)
    model = jyolo.YoloV7(spec)
    _, raw = jax.jit(lambda v, x: model.apply(v, x, training=False))(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(imgs))
    return [np.asarray(r) for r in raw]


def _assert_levels(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=LEVEL_TOL * np.abs(b).max())


def _assert_detections(got, jpipe, frames):
    want = [np.asarray(x) for x in jpipe.detect_batch(frames)]
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[3], want[3])
    n = int(got[3][0])
    assert n > 10
    # survivors whose scores differ in the last bits may leave NMS in
    # either order: each port row has its own JAX row
    left = list(range(n))
    for i in range(n):
        j = next(j for j in left
                 if abs(got[1][0, i] - want[1][0, j])
                 <= 1e-4 * max(abs(want[1][0, j]), 1.0)
                 and np.allclose(got[0][0, i], want[0][0, j], rtol=1e-4,
                                 atol=1e-3))
        left.remove(j)


@pytest.fixture(scope="module")
def jpipe(weights):
    return JPipeline(JPipelineConfig(wpack=False, **PIPE),
                     JS.TrackerConfig(capacity=16, det_capacity=16),
                     variables=jax.tree.map(jnp.asarray, weights),
                     spec=jzoo.get_spec("yolov7-tiny", nc=4))


@pytest.mark.parametrize("world", [2, 3])
def test_spatial_levels_match_jax(world, two_ranks, three_ranks, weights):
    """The raw head levels of the height-sharded forward within 1e-4 of
    each level's largest value against JAX's unsharded model.apply: 2
    ranks on 256 rows (even bands), 3 ranks on 224 (3, 2 and 2 rows)."""
    cases, got = two_ranks if world == 2 else three_ranks
    _assert_levels(got["spatial"]["raw"],
                   _jax_levels(weights, cases["spatial"]["imgs"]))


@pytest.mark.parametrize("world", [2, 3])
def test_detect_batch_spatial_matches_jax(world, two_ranks, three_ranks,
                                          jpipe):
    """detect_batch_spatial on every rank against JAX's detect_batch on
    one device: the same counts, boxes within rtol 1e-4 / atol 1e-3,
    scores within 1e-4."""
    cases, got = two_ranks if world == 2 else three_ranks
    _assert_detections(got["spatial"]["detect"], jpipe,
                       cases["spatial"]["frames"])


def test_spatial_limits():
    """A frame needs a row of the coarsest level a rank; bands are as even
    as the largest stride allows; blocks that mix rows globally are
    refused by name."""
    assert spatial.bands(448, 64, 3) == [192, 128, 128]
    with pytest.raises(ValueError, match="H / max_stride"):
        spatial.bands(128, 64, 3)
    mesh = M.DataMesh(2, 0, torch.device("cpu"), None, "gloo")
    for row, block in ((["SwinTransformerBlock", [16, 2, 1]], "SwinBlock"),
                       (["RepConv_OREPA", [16, 3, 1]], "RepConvOREPA")):
        cfg = {"nc": 2, "depth_multiple": 1.0, "width_multiple": 1.0,
               "anchors": tzoo.ANCHORS_P5[:1],
               "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1] + row,
                            [[1], 1, "Detect", ["nc", "anchors"]]],
               "head": []}
        model = YoloV7(parse_yaml_cfg(cfg, name="x"))
        with pytest.raises(NotImplementedError, match=block):
            spatial.make_spatial_detector(model, mesh)
