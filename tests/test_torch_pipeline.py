"""The whole slice on the CPU: frames -> letterbox -> narrowed yolov7-w6
(sharpened heads, float32) -> NMS -> ByteTrack -> MOT rows, the PyTorch
port's TrackingPipeline against the JAX TrackingPipeline (wpack off) on
the same weights and frames: ids exact, boxes within 1e-3. Also the
port's track CLI on an image-dir sequence, its defaults against the JAX
CLI's, and run_sequence_detections' det_capacity cut on tied scores."""

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
from yolov7_tracker_tpu.pipeline import PipelineConfig as JPipelineConfig
from yolov7_tracker_tpu.pipeline import TrackingPipeline as JPipeline
from yolov7_tracker_tpu.trackers.slab import TrackerConfig as JTrackerConfig
from yolov7_tracker_tpu_torch.data import writer
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.pipeline import PipelineConfig, TrackingPipeline
from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

N_FRAMES = 12
PIPE = dict(model="yolov7-w6", nc=8, img_size=128, detector_batch=4,
            dtype="float32", max_det=64)
TRACK = dict(tracker="bytetrack", conf_thresh=0.5, capacity=32,
             det_capacity=64)


def _frames():
    """A noise background with bright blocks moving 3 px per frame."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 96, (96, 160, 3), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, 72), rng.integers(0, 136)
        base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
    return [np.roll(base, 3 * t, axis=1) for t in range(N_FRAMES)]


@pytest.fixture(scope="module")
def weights():
    spec = parse_yaml_cfg(narrow_w6_cfg())
    # Only the stride-8 head is sharpened: at 128 px the larger anchors
    # give boxes that clip to the whole 96x160 frame, several of them
    # identical, and an assignment between identical boxes is a tie that
    # the port's solver (the private-dummy auction) and the JAX CPU solver
    # (the square auction) may break differently. This load gives about 7
    # tracks per frame, with births and removals, and no ties.
    return sharpen_heads(random_variables(spec, seed=1), spec, obj_boost=7.0,
                         levels=(0,))


def _port(weights):
    spec = tspec.parse_yaml_cfg(narrow_w6_cfg())
    return TrackingPipeline(
        PipelineConfig(**PIPE), TrackerConfig(**TRACK),
        state_dict=jax_variables_to_torch(weights, spec), spec=spec,
        device="cpu")


def test_pipeline_matches_jax(weights, tmp_path):
    spec = parse_yaml_cfg(narrow_w6_cfg())
    jpipe = JPipeline(JPipelineConfig(wpack=False, **PIPE),
                      JTrackerConfig(**TRACK),
                      variables=jax.tree.map(jnp.asarray, weights),
                      spec=spec)
    frames = _frames()
    j_res = jpipe.run_sequence(iter(frames))
    t_res = _port(weights).run_sequence(iter(frames))
    assert [r[0] for r in t_res] == list(range(1, N_FRAMES + 1))
    assert sum(len(r[1]) for r in t_res) >= 4 * N_FRAMES  # tracks carried
    for (jf, jids, jtlwh, jcls), (tf, tids, ttlwh, tcls) in zip(j_res,
                                                                t_res):
        assert (tf, tids, tcls) == (jf, jids, jcls)
        np.testing.assert_allclose(np.asarray(ttlwh).reshape(-1, 4),
                                   np.asarray(jtlwh).reshape(-1, 4),
                                   atol=1e-3, rtol=0)
    path = writer.save_results(str(tmp_path), "syn", t_res)
    with open(path) as f:
        assert len(f.readlines()) == sum(len(r[1]) for r in t_res)


def test_pack_output_ids_exact_past_float32():
    from yolov7_tracker_tpu_torch.trackers.slab import FrameOutput

    ids = torch.tensor([0, 1, 2**24 + 1, 2**24 + 2, 2**31 - 1],
                       dtype=torch.int32)
    outs = FrameOutput(track_id=ids, tlwh=torch.arange(20.).reshape(5, 4),
                       score=torch.linspace(0, 1, 5),
                       cls=torch.arange(5.),
                       valid=torch.tensor([1, 1, 0, 1, 1], dtype=torch.bool))
    back = TrackingPipeline.unpack_output(TrackingPipeline.pack_output(outs))
    assert back.track_id.tolist() == ids.tolist()
    assert back.valid.tolist() == [True, True, False, True, True]


def test_stateful_resume_matches_one_run(weights):
    pipe = _port(weights)
    frames = _frames()
    whole = pipe.run_sequence(iter(frames))
    first, mid = pipe.run_sequence_stateful(iter(frames[:4]))
    second, _ = pipe.run_sequence_stateful(iter(frames[4:]),
                                           initial_slab=mid)
    for a, b in zip(whole, first + second):
        assert a[:2] == b[:2]


def test_track_cli_writes_mot_rows(weights, tmp_path):
    import cv2

    from yolov7_tracker_tpu_torch.cli import track

    seq_dir = tmp_path / "data" / "images" / "test" / "SYN-01" / "img1"
    seq_dir.mkdir(parents=True)
    for t, f in enumerate(_frames()[:6]):
        cv2.imwrite(str(seq_dir / f"{t + 1:06d}.png"), f)
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    with open(cfg_dir / "synth.yaml", "w") as fh:
        yaml.safe_dump({"DATASET_ROOT": str(tmp_path / "data")}, fh)
    model_yaml = tmp_path / "w6n.yaml"
    with open(model_yaml, "w") as fh:
        yaml.safe_dump(narrow_w6_cfg(), fh)
    sd_path = tmp_path / "w6n.pt"
    torch.save(jax_variables_to_torch(
        weights, tspec.parse_yaml_cfg(narrow_w6_cfg())), sd_path)
    folder = track.main([
        "--dataset", "synth", "--config_dir", str(cfg_dir),
        "--model", str(model_yaml), "--model_path", str(sd_path),
        "--nc", "8", "--img_size", "128", "--conf_thresh", "0.5",
        "--detector_batch", "4", "--capacity", "32", "--det_capacity", "300",
        "--dtype", "float32", "--track_eval", "false", "--device", "cpu",
        "--output_dir", str(tmp_path / "out")])
    with open(os.path.join(folder, "SYN-01.txt")) as fh:
        rows = [r.split(",") for r in fh.read().splitlines()]
    assert rows and {int(r[0]) for r in rows} <= set(range(1, 7))
    assert all(r[6:] == ["1.0", "-1", "-1", "-1"] for r in rows)
    # --track_eval at its default (true) scores only a config with a
    # TRACK_EVAL section; this one has none, so the run writes the same
    # rows and no score files
    again = track.main([
        "--dataset", "synth", "--config_dir", str(cfg_dir),
        "--model", str(model_yaml), "--model_path", str(sd_path),
        "--nc", "8", "--img_size", "128", "--conf_thresh", "0.5",
        "--detector_batch", "4", "--capacity", "32", "--det_capacity", "300",
        "--dtype", "float32", "--device", "cpu",
        "--output_dir", str(tmp_path / "out_default")])
    assert os.listdir(again) == ["SYN-01.txt"]
    with open(os.path.join(again, "SYN-01.txt")) as fh:
        assert [r.split(",") for r in fh.read().splitlines()] == rows


def test_track_cli_defaults_match_jax():
    """Every option the two track CLIs share has the same default
    (--tracker sort); the port reads its package's copy of the JAX
    package's configs/, so each dataset name (mot among them) resolves to
    the same config."""
    from yolov7_tracker_tpu.cli import track as jtrack
    from yolov7_tracker_tpu_torch.cli import track as ttrack

    j, t = vars(jtrack.parse_args([])), vars(ttrack.parse_args([]))
    shared = sorted(set(j) & set(t) - {"config_dir"})
    assert len(shared) >= 27
    assert {"data_format", "split_txt", "detect_per_frame", "detections",
            "nms_thresh", "save_images", "save_videos",
            "track_eval"} <= set(shared)
    # every option of the JAX CLI is the port's too, --quant among them
    assert set(j) - set(t) == set() and "quant" in shared
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    assert t["tracker"] == "sort"
    for name in ("mot", "mot17", "uavdt", "visdrone"):
        argv = ["--dataset", name]
        assert ttrack.load_dataset_config(ttrack.parse_args(argv)) == \
            jtrack.load_dataset_config(jtrack.parse_args(argv)), name


def test_detections_cut_keeps_the_jax_rows_on_tied_scores():
    """300 rows a frame (NMS's max_det) for 64 det slots, with 225 tied
    scores across the cut: the port keeps the rows the JAX package keeps,
    in its order (numpy's default sort, which here is not the stable
    one), and tracks them alike."""
    from yolov7_tracker_tpu.trackers import slab as JS
    from yolov7_tracker_tpu.trackers.registry import build_tracker as jbuild
    from yolov7_tracker_tpu_torch.trackers.registry import (
        build_tracker as tbuild,
    )

    n, d = 300, 64
    kw = dict(tracker="sort", conf_thresh=0.3, capacity=128, det_capacity=d)
    rng = np.random.default_rng(0)
    dets, differs = {}, False
    for f in range(1, 6):
        xy = np.stack([np.arange(n) % 30 * 40.0 + f,
                       np.arange(n) // 30 * 40.0 + f], 1)
        score = np.where(np.arange(n) < 225, 0.8, rng.uniform(0.35, 0.7, n))
        rows = np.c_[xy, xy + 20.0, score, np.zeros(n)].astype(np.float32)
        dets[f] = rows[rng.permutation(n)]
        s = -dets[f][:, 4]
        differs |= set(np.argsort(s)[:d]) != set(
            np.argsort(s, kind="stable")[:d])
    assert differs
    jpipe = JPipeline.__new__(JPipeline)
    jpipe.step, jpipe.tcfg = jbuild(JS.TrackerConfig(**kw))
    port = TrackingPipeline.__new__(TrackingPipeline)
    port.step, port.tcfg = tbuild(TrackerConfig(**kw), "cpu")
    port.device = torch.device("cpu")
    want = jpipe.run_sequence_detections(dets, 5)
    got = port.run_sequence_detections(dets, 5)
    assert sum(len(r[1]) for r in want) >= 2 * d
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3] == w[3]
        np.testing.assert_allclose(np.reshape(g[2], (-1, 4)),
                                   np.reshape(w[2], (-1, 4)), atol=1e-4)
