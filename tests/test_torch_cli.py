"""The port's CLI seams and frame sources against the JAX package's:
tracking from detection files with scoring (cli/track.py --detections
--track_eval), --detect_per_frame and the predict-only step, the YOLO
split, Flax msgpack detector weights, VideoFrames / StreamFrames,
cli/track_demo.py and the serve CLI's video sources. Same seeded inputs
on both sides; MOT rows are compared as the text the writers produce."""

import functools
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tests.test_torch_trackers import feature_stream
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables, sharpen_heads)
from yolov7_tracker_tpu import pipeline as j_pipeline
from yolov7_tracker_tpu.cli import serve as j_serve
from yolov7_tracker_tpu.cli import track as j_track
from yolov7_tracker_tpu.cli import track_demo as j_demo
from yolov7_tracker_tpu.data import detections as j_dets
from yolov7_tracker_tpu.data import sequence as j_seq
from yolov7_tracker_tpu.models import zoo as j_zoo
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu.trackers.registry import build_predict_only as j_po
from yolov7_tracker_tpu.trackers.registry import build_tracker as j_build
from yolov7_tracker_tpu.utils.checkpoint import save_variables
from yolov7_tracker_tpu_torch.cli import serve as t_serve
from yolov7_tracker_tpu_torch.cli import track as t_track
from yolov7_tracker_tpu_torch.cli import track_demo as t_demo
from yolov7_tracker_tpu_torch.data import detections as t_dets
from yolov7_tracker_tpu_torch.data import sequence as t_seq
from yolov7_tracker_tpu_torch.models import zoo as t_zoo
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.pipeline import PipelineConfig, TrackingPipeline
from yolov7_tracker_tpu_torch.trackers import slab as TS
from yolov7_tracker_tpu_torch.trackers.registry import build_predict_only
from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

N_FRAMES = 12
TINY = dict(model="yolov7-tiny", nc=1, img_size=160)


def _frames(n=N_FRAMES):
    """A noise background with bright blocks moving 3 px per frame."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 96, (96, 160, 3), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, 72), rng.integers(0, 136)
        base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
    return [np.roll(base, 3 * t, axis=1) for t in range(n)]


@pytest.fixture(scope="module")
def tiny_variables():
    """Seeded yolov7-tiny (nc 1) Flax variables as numpy, with the
    stride-8 head sharpened so that 3-4 tracks live through the frames.
    Stronger heads fill the slab with overlapping boxes of near-equal
    cost, where the port's sequence solver (the private-dummy auction, the
    JAX package's TPU choice) and the JAX CPU run's square auction may pick
    different matchings (ROADMAP, limits of parity); the tracker tests
    hold the two packages on scenes without such ties."""
    spec = j_zoo.get_spec("yolov7-tiny", nc=1)
    return sharpen_heads(random_variables(spec, seed=3), spec,
                         sharpen=32.0, obj_boost=4.0, levels=(0,))


@pytest.fixture(scope="module")
def tiny_msgpack(tiny_variables, tmp_path_factory):
    """The variables written by the JAX package's save_variables."""
    path = tmp_path_factory.mktemp("weights") / "tiny.msgpack"
    save_variables(str(path), tiny_variables)
    return str(path)


@pytest.fixture
def jax_float32(monkeypatch):
    """The JAX CLIs build PipelineConfig with their defaults (bfloat16, the
    width-packed front); here they compute in float32 on the plain graph,
    as the port's CLIs do with --dtype float32."""
    monkeypatch.setattr(j_pipeline, "PipelineConfig", functools.partial(
        j_pipeline.PipelineConfig, dtype="float32", wpack=False))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """The frames as a PNG directory and as an MJPG video."""
    root = tmp_path_factory.mktemp("media")
    frames = _frames()
    img_dir = root / "clip_frames"
    img_dir.mkdir()
    for t, f in enumerate(frames):
        cv2.imwrite(str(img_dir / f"{t + 1:06d}.png"), f)
    video = str(root / "clip.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (160, 96))
    for f in frames:
        vw.write(f)
    vw.release()
    return {"dir": str(img_dir), "video": video}


@pytest.fixture
def live_camera(media, monkeypatch):
    """cv2.VideoCapture opens the media's video for a webcam id or a
    stream URL (no camera, no network here)."""
    real = cv2.VideoCapture

    def capture(src, *args):
        if isinstance(src, int) or "://" in str(src):
            src = media["video"]
        return real(src, *args)

    monkeypatch.setattr(cv2, "VideoCapture", capture)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# data: detection files, the YOLO split, video and stream sources
# ---------------------------------------------------------------------------

def test_mot_detections_round_trip_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    by_frame = {}
    for f in (1, 2, 5):
        xy = rng.uniform(0, 500, (4, 2))
        by_frame[f] = np.c_[xy, xy + rng.uniform(10, 80, (4, 2)),
                            rng.uniform(0, 1, 4), rng.integers(0, 3, 4)]
    t_dets.save_mot_detections(str(tmp_path / "t" / "seq.txt"), by_frame)
    j_dets.save_mot_detections(str(tmp_path / "j" / "seq.txt"), by_frame)
    assert _read(tmp_path / "t" / "seq.txt") == _read(tmp_path / "j" /
                                                      "seq.txt")
    # short rows (no score, no class) and blank lines
    with open(tmp_path / "t" / "seq.txt", "a") as fh:
        fh.write("\n7,-1,1,2,3,4\n8 -1 5 6 7 8 0.5\n")
    got = t_dets.load_mot_detections(str(tmp_path / "t" / "seq.txt"))
    want = j_dets.load_mot_detections(str(tmp_path / "t" / "seq.txt"))
    assert list(got) == list(want) == [1, 2, 5, 7, 8]
    for f in got:
        assert got[f].dtype == np.float32
        np.testing.assert_array_equal(got[f], want[f])


def test_discover_sequences_yolo_split_equals_jax(tmp_path):
    root = tmp_path / "data"
    lines = []
    for seq in ("MOT17-02", "MOT17-04", "MOT17-09"):
        d = root / "images" / "train" / seq
        d.mkdir(parents=True)
        for f in (3, 1, 2):
            (d / f"{f:06d}.jpg").touch()
            rel = f"images/train/{seq}/{f:06d}.jpg"
            lines.append(rel if seq != "MOT17-09" else str(root / rel))
    lines.insert(4, "")
    split = tmp_path / "train.txt"
    split.write_text("\n".join(lines) + "\n")
    for kw in ({}, {"seqs": ["MOT17-04", "MOT17-09"]},
               {"ignore_seqs": ["MOT17-02"]}):
        got = t_seq.discover_sequences(str(root), data_format="yolo",
                                       split_txt=str(split), **kw)
        want = j_seq.discover_sequences(str(root), "yolo",
                                        split_txt=str(split), **kw)
        assert [(s.name, s.frame_paths) for s in got] == \
            [(s.name, s.frame_paths) for s in want], kw
        assert got
    got = t_seq.discover_sequences(str(root), split="train")
    want = j_seq.discover_sequences(str(root), split="train")
    assert [(s.name, s.frame_paths) for s in got] == \
        [(s.name, s.frame_paths) for s in want]
    with pytest.raises(ValueError, match="split txt"):
        t_seq.discover_sequences(str(root), data_format="yolo")


def test_video_and_stream_frames_equal_jax(media, live_camera):
    got = list(t_seq.VideoFrames(media["video"]))
    want = list(j_seq.VideoFrames(media["video"]))
    assert len(got) == len(want) == N_FRAMES
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for src in (media["video"], "0", "rtsp://cam/1"):
        for kw in ({}, {"skip": 1, "max_frames": 3}, {"max_frames": 5},
                   {"skip": 2}):
            t_src, j_src = t_seq.StreamFrames(src, **kw), \
                j_seq.StreamFrames(src, **kw)
            got, want = list(t_src), list(j_src)
            t_src.release()
            j_src.release()
            assert len(got) == len(want) > 0, (src, kw)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    assert len(list(t_seq.StreamFrames(media["video"], skip=1,
                                       max_frames=3))) == 3
    with pytest.raises(OSError, match="cannot open video"):
        t_seq.VideoFrames(str(media["dir"]) + "/missing.avi")


# ---------------------------------------------------------------------------
# the predict-only step and --detect_per_frame
# ---------------------------------------------------------------------------

def _run_with_predict_only(tracker, schedule):
    """Step both packages through ``schedule``: a frame's (tlbr, score,
    valid) takes the full step, None the predict-only step. The outputs
    and the slabs equal JAX's frame by frame. Returns the port's occupied
    slot count after each frame and the rows emitted on predict-only
    frames."""
    kw = dict(tracker=tracker, conf_thresh=0.5, capacity=32, det_capacity=24)
    j_step, j_cfg = j_build(JS.TrackerConfig(**kw))
    t_step, t_cfg = build_tracker(TS.TrackerConfig(**kw))
    j_pred, t_pred = j_po(j_cfg), build_predict_only(t_cfg)
    j_slab, t_slab = JS.init_slab(j_cfg), TS.init_slab(t_cfg, "cpu")
    occupied, rows = [], 0
    for k, frame in enumerate(schedule):
        if frame is not None:
            tlbr, score, valid = frame
            cls = np.zeros_like(score)
            j_slab, j_out = j_step(j_slab, JS.make_det_slab(
                j_cfg, tlbr, score, cls, valid))
            t_slab, t_out = t_step(t_slab, TS.make_det_slab(
                t_cfg, tlbr, score, cls, valid, "cpu"))
        else:
            j_slab, j_out = j_pred(j_slab)
            t_slab, t_out = t_pred(t_slab)
            rows += int(t_out.valid.sum())
        v = np.asarray(j_out.valid)
        np.testing.assert_array_equal(t_out.valid.numpy(), v, err_msg=k)
        np.testing.assert_array_equal(t_out.track_id.numpy()[v],
                                      np.asarray(j_out.track_id)[v])
        np.testing.assert_allclose(t_out.tlwh.numpy()[v],
                                   np.asarray(j_out.tlwh)[v], atol=1e-4,
                                   rtol=0, err_msg=k)
        for name in ("frame", "state", "track_id", "occupied",
                     "time_since_update", "next_id"):
            np.testing.assert_array_equal(
                getattr(t_slab, name).numpy(),
                np.asarray(getattr(j_slab, name)), err_msg=f"{k} {name}")
        occ = np.asarray(j_slab.occupied)
        np.testing.assert_allclose(t_slab.mean.numpy()[occ],
                                   np.asarray(j_slab.mean)[occ], atol=1e-3,
                                   rtol=1e-5, err_msg=k)
        occupied.append(int(occ.sum()))
    return occupied, rows


@pytest.mark.parametrize("tracker", ["bytetrack", "c_bioutracker"])
def test_build_predict_only_matches_jax(tracker):
    """Full steps on every third frame of a stream with births, losses and
    refinds, the predict-only step on the two between (--detect_per_frame
    3)."""
    schedule = [f[:3] if k % 3 == 0 else None
                for k, f in enumerate(feature_stream(3))]
    _, rows = _run_with_predict_only(tracker, schedule)
    assert rows > 20            # tracks were emitted on predict-only frames


def test_predict_only_removes_duplicates_like_jax():
    """A track lost while moving right coasts onto a younger track that
    stands still: on a predict-only frame the two overlap and the
    duplicate removal drops the younger, as in JAX."""
    def frame(boxes):
        tlbr = np.zeros((24, 4), np.float32)
        tlbr[:len(boxes)] = boxes
        valid = np.arange(24) < len(boxes)
        return tlbr, np.where(valid, 0.9, 0.0).astype(np.float32), valid

    def box(x):
        return [x, 100.0, x + 40.0, 180.0]

    schedule = ([frame([box(100.0 + 6 * t)]) for t in range(6)]
                + [frame([box(100.0 + 6 * 14)]) for _ in range(4)]
                + [None] * 10)
    occupied, _ = _run_with_predict_only("bytetrack", schedule)
    assert occupied[9] == 2 and occupied[-1] == 1, occupied


@pytest.mark.parametrize("k", [2, 3])
def test_detect_per_frame_matches_jax(k, tiny_variables):
    pkw = dict(TINY, detector_batch=4, dtype="float32", detect_per_frame=k)
    tkw = dict(tracker="bytetrack", conf_thresh=0.5, capacity=32,
               det_capacity=64)
    jpipe = j_pipeline.TrackingPipeline(
        j_pipeline.PipelineConfig(wpack=False, **pkw),
        JS.TrackerConfig(**tkw),
        variables=jax.tree.map(jnp.asarray, tiny_variables))
    spec = t_zoo.get_spec("yolov7-tiny", nc=1)
    port = TrackingPipeline(PipelineConfig(**pkw), TS.TrackerConfig(**tkw),
                            state_dict=jax_variables_to_torch(tiny_variables,
                                                              spec),
                            spec=spec, device="cpu")
    frames = _frames()
    want, _ = jpipe.run_sequence_stateful(iter(frames))
    got, _ = port.run_sequence_stateful(iter(frames))
    assert [r[0] for r in got] == list(range(1, N_FRAMES + 1))
    assert sum(len(r[1]) for r in got) >= 2 * N_FRAMES
    for (tf, tids, ttlwh, tcls), (jf, jids, jtlwh, jcls) in zip(got, want):
        assert (tf, tids, tcls) == (jf, jids, jcls)
        np.testing.assert_allclose(np.reshape(ttlwh, (-1, 4)),
                                   np.reshape(jtlwh, (-1, 4)), atol=1e-3,
                                   rtol=0)
    # resumed mid-cadence (after frame 5) from the saved state: one run
    first, mid = port.run_sequence_stateful(iter(frames[:5]))
    second, _ = port.run_sequence_stateful(iter(frames[5:]),
                                           initial_slab=mid)
    assert [r[:2] for r in first + second] == [r[:2] for r in got]


# ---------------------------------------------------------------------------
# cli/track.py
# ---------------------------------------------------------------------------

def _track_argv(cfg_dir, out, extra):
    return ["--dataset", chip_smoke.SCORE_DATASET, "--config_dir", cfg_dir,
            "--split", "train", "--output_dir", str(out)] + extra


def _results(folder):
    return {f: _read(os.path.join(folder, f))
            for f in sorted(os.listdir(folder))}


@pytest.mark.parametrize("tracker", ["bytetrack", "sort"])
def test_track_cli_detections_score_like_jax(tracker, tmp_path, capsys):
    """The MOT17-layout dataset of chip_smoke's phase 8a at a small size,
    tracked from its detection files and scored (--track_eval at its
    default, true): the same MOT rows, CSV and printed table as the JAX
    CLI. A sequence without a detection file is skipped by both. The slab
    is cut to 64 / 100 (about 25 detections a frame here): the JAX CLI
    compiles its scan at the CLI's 256 / 300 for most of a minute on the
    CPU; chip_smoke's phase 8a runs those sizes, card against CPU."""
    cfg_dir, det_dir, seqs = chip_smoke.write_mot_dataset(
        str(tmp_path / "data"), n_seqs=3, n_frames=30, n_peds=(10, 14))
    os.remove(os.path.join(det_dir, "SMOKE-03.txt"))
    extra = ["--tracker", tracker, "--detections", det_dir,
             "--model", "yolov7-tiny", "--img_size", "160",
             "--capacity", "64", "--det_capacity", "100"]
    j_folder = j_track.main(_track_argv(cfg_dir, tmp_path / "j", extra))
    j_out = capsys.readouterr().out
    t_folder = t_track.main(_track_argv(cfg_dir, tmp_path / "t", extra +
                                        ["--device", "cpu"]))
    t_out = capsys.readouterr().out
    got, want = _results(t_folder), _results(j_folder)
    assert sorted(got) == ["SMOKE-01.txt", "SMOKE-02.txt",
                           "pedestrian_summary.csv"]
    assert got == want
    assert got["SMOKE-01.txt"].count(b"\n") > 200
    table = t_out[t_out.index("=== class: pedestrian ==="):]
    assert table == j_out[j_out.index("=== class: pedestrian ==="):]
    assert "SMOKE-03: no detections at" in t_out
    assert "COMBINED_SEQ" in table


def test_track_cli_detect_per_frame_yolo_split_and_msgpack_equal_jax(
        tiny_msgpack, jax_float32, tmp_path):
    """Frames found through a YOLO split, detected on every second frame
    by the JAX package's msgpack checkpoint: the same MOT rows."""
    root = tmp_path / "data"
    d = root / "images" / "SYN-01"
    d.mkdir(parents=True)
    for t, f in enumerate(_frames()):
        cv2.imwrite(str(d / f"{t + 1:06d}.png"), f)
    split = tmp_path / "split.txt"
    split.write_text("".join(f"images/SYN-01/{t + 1:06d}.png\n"
                             for t in range(N_FRAMES)))
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    (cfg_dir / "yolosyn.yaml").write_text(f"DATASET_ROOT: {root}\n")
    common = ["--dataset", "yolosyn", "--config_dir", str(cfg_dir),
              "--data_format", "yolo", "--split_txt", str(split),
              "--model", "yolov7-tiny", "--nc", "1", "--img_size", "160",
              "--model_path", tiny_msgpack, "--tracker", "bytetrack",
              "--conf_thresh", "0.5", "--capacity", "32",
              "--det_capacity", "64", "--detector_batch", "4",
              "--detect_per_frame", "2"]
    j_folder = j_track.main(common + ["--output_dir", str(tmp_path / "j")])
    t_folder = t_track.main(common + ["--output_dir", str(tmp_path / "t"),
                                      "--dtype", "float32", "--device",
                                      "cpu"])
    got, want = _results(t_folder), _results(j_folder)
    assert list(got) == ["SYN-01.txt"]
    assert got == want
    frames = {int(r.split(b",")[0]) for r in got["SYN-01.txt"].splitlines()}
    assert frames >= {2, 3, 4}      # rows on predict-only frames too


def test_msgpack_weights_give_jax_detections(tiny_variables, tiny_msgpack):
    spec = t_zoo.get_spec("yolov7-tiny", nc=1)
    port = TrackingPipeline(
        PipelineConfig(dtype="float32", **TINY),
        TS.TrackerConfig(tracker="sort", det_capacity=300),
        state_dict=t_track.load_detector_weights(tiny_msgpack, spec),
        spec=spec, device="cpu")
    jpipe = j_pipeline.TrackingPipeline(
        j_pipeline.PipelineConfig(dtype="float32", wpack=False, **TINY),
        JS.TrackerConfig(tracker="sort"),
        variables=jax.tree.map(jnp.asarray, tiny_variables))
    frames = np.stack(_frames(4))
    got = [x.numpy() for x in port.detect_batch(frames)]
    want = [np.asarray(x) for x in jpipe.detect_batch(frames)]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].min() > 0
    for b, n in enumerate(got[3]):
        # survivors whose scores differ in the last bits may come out of
        # NMS in either order: each port row has its own JAX row
        left = list(range(n))
        for i in range(n):
            j = next(j for j in left
                     if abs(got[1][b, i] - want[1][b, j]) <= 1e-5
                     and np.abs(got[0][b, i] - want[0][b, j]).max() <= 1e-3)
            left.remove(j)


# ---------------------------------------------------------------------------
# cli/track_demo.py and the serve CLI's video sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["dir", "video", "stream"])
def test_track_demo_writes_jax_rows(source, media, tiny_msgpack, jax_float32,
                                    live_camera, tmp_path):
    """Two runs of each demo: the second resumes from the first's state
    file and appends past the rows already written."""
    obj = {"dir": media["dir"], "video": media["video"],
           "stream": "rtsp://cam/1"}[source]
    common = ["--obj", obj, "--model_path", tiny_msgpack, "--nc", "1",
              "--img_size", "160", "--conf_thresh", "0.5",
              "--max_frames", "7", "--state_ckpt_every", "3"]
    txt = {}
    for name, demo, extra in (("j", j_demo, []), ("t", t_demo, [
            "--dtype", "float32", "--device", "cpu"])):
        out = tmp_path / name
        state = str(tmp_path / f"{name}_state.npz")
        argv = common + extra + ["--save_dir", str(out),
                                 "--state_ckpt", state]
        demo.main(argv + (["--save_images"] if source == "dir" else []))
        demo.main(argv + ["--resume_state", state])
        (name_txt,) = [f for f in os.listdir(out) if f.endswith(".txt")]
        txt[name] = (name_txt, _read(out / name_txt))
    assert txt["t"] == txt["j"]
    frames = {int(r.split(b",")[0]) for r in txt["t"][1].splitlines()}
    n = 7 if source == "stream" else N_FRAMES
    assert max(frames) == 2 * n and min(frames) <= 2
    if source == "dir":
        assert sorted(os.listdir(tmp_path / "t" / "clip_frames_imgs")) == \
            sorted(os.listdir(tmp_path / "j" / "clip_frames_imgs"))


def test_serve_takes_a_video_source(media, tiny_variables, tiny_msgpack,
                                    jax_float32, tmp_path):
    spec = t_zoo.get_spec("yolov7-tiny", nc=1)
    pt = str(tmp_path / "tiny.pt")
    torch.save(jax_variables_to_torch(tiny_variables, spec), pt)
    common = ["--streams", media["video"], "--model", "yolov7-tiny",
              "--nc", "1", "--img_size", "160", "--conf_thresh", "0.5",
              "--capacity", "32", "--det_capacity", "16"]
    want, _ = j_serve.main(common + ["--model_path", tiny_msgpack,
                                     "--save_dir", str(tmp_path / "j")])
    got, _ = t_serve.main(common + ["--model_path", pt, "--dtype",
                                    "float32", "--device", "cpu",
                                    "--save_dir", str(tmp_path / "t")])
    assert [r[0] for r in got[0]] == list(range(1, N_FRAMES + 1))
    assert sum(len(r[1]) for r in got[0]) > 0
    assert _results(tmp_path / "t") == _results(tmp_path / "j")


def test_track_demo_defaults_match_jax():
    """Every option the two demo CLIs share has the same default; the port
    adds --dtype and --device, as its other CLIs have them."""
    j = vars(j_demo.parse_args(["--obj", "0"]))
    t = vars(t_demo.parse_args(["--obj", "0"]))
    assert set(t) - set(j) == {"dtype", "device"} and set(j) <= set(t)
    assert {k: t[k] for k in j} == j
