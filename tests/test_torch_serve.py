"""The port's multi-stream serving CLI (yolov7_tracker_tpu_torch/cli/serve.py)
on the CPU: the counterparts of tests/test_serve.py (lockstep ticks,
state checkpoints and auto-resume, stream tags, dead and stalled streams,
SIGTERM, append-only results), ReID (strongsort with a seeded OSNet,
resumed from the port's state files and from the JAX package's), and
tracker-state files exchanged with the JAX package in both directions.
yolov7-tiny nc 1 at 160 px, float32, seeded weights with sharpened heads
so that the streams carry tracks."""

import os
import signal
import threading

import cv2
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu.trackers.registry import build_tracker as j_build
from yolov7_tracker_tpu_torch.cli import serve
from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
from yolov7_tracker_tpu_torch.models import zoo
from yolov7_tracker_tpu_torch.models.yolo import (random_state_dict,
                                                  sharpen_heads)
from yolov7_tracker_tpu_torch.trackers import slab as TS

TEST_SECONDS = 120      # a hung serve loop fails its test, not the suite


@pytest.fixture(autouse=True)
def deadline():
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_SECONDS} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_SECONDS)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _frame_dir(root, name, n, seed, shape=(160, 240, 3)):
    d = root / name
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        cv2.imwrite(str(d / f"{i + 1:06d}.jpg"),
                    rng.integers(0, 255, shape, np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def stream_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("streams")
    return [_frame_dir(root, f"cam{s}", 8, seed=s) for s in range(2)]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    spec = zoo.get_spec("yolov7-tiny", nc=1)
    sd = random_state_dict(spec, seed=0)
    sharpen_heads(sd, spec)
    path = tmp_path_factory.mktemp("weights") / "tiny_nc1.pt"
    torch.save(sd, path)
    return str(path)


def _common(tmp_path):
    return ["--model", "yolov7-tiny", "--nc", "1", "--img_size", "160",
            "--det_capacity", "16", "--capacity", "32", "--dtype", "float32",
            "--device", "cpu", "--save_dir", str(tmp_path / "out")]


def _fids(result):
    return [fid for fid, *_ in result]


def _state_frame(state, i):
    with np.load(os.path.join(state, f"stream_{i:02d}.npz")) as z:
        return int(z["frame"])


def test_serve_two_streams(stream_dirs, tmp_path):
    results, preempted = serve.main(
        ["--streams", *stream_dirs] + _common(tmp_path))
    assert not preempted
    assert len(results) == 2
    for r in results:
        assert _fids(r) == list(range(1, 9))
    outs = sorted(os.listdir(tmp_path / "out"))
    assert len(outs) == 2 and all(o.endswith(".txt") for o in outs)


def test_serve_state_resume_continues_ids_and_appends(model_path, tmp_path):
    """A second invocation auto-resumes each stream's tracker state:
    frame numbering and track ids continue per stream, and the relaunch
    APPENDS to the result txts instead of clobbering the first run's
    rows. The resumed run equals one uninterrupted run."""
    streams = ["--streams", "synth://8x120x200?seed=1",
               "synth://8x120x200?seed=2"]
    common = _common(tmp_path) + [
        "--model_path", model_path, "--conf_thresh", "0.5"]
    whole, _ = serve.main(streams + common + [
        "--save_dir", str(tmp_path / "whole")])
    state = str(tmp_path / "state")
    resumable = common + ["--state_dir", state, "--state_ckpt_every", "2",
                          "--max_frames", "4"]
    r1, _ = serve.main(streams + resumable)
    assert sorted(os.listdir(state)) == ["stream_00.npz", "stream_01.npz"]
    txts = sorted(os.listdir(tmp_path / "out"))
    assert len(txts) == 2
    with open(tmp_path / "out" / txts[0]) as f:
        first_rows = f.read()
    assert first_rows                       # the first run tracked something
    r2, _ = serve.main(streams + resumable)
    for i in range(2):
        assert _fids(r1[i]) == [1, 2, 3, 4] and _fids(r2[i]) == [5, 6, 7, 8]
        assert max(max(ids) for _, ids, *_ in r1[i] if ids) >= 1
        for (wf, wids, wtlwh, _), (f, ids, tlwh, _) in zip(whole[i],
                                                           r1[i] + r2[i]):
            assert (wf, wids) == (f, ids)
            np.testing.assert_allclose(np.reshape(tlwh, (-1, 4)),
                                       np.reshape(wtlwh, (-1, 4)), atol=1e-4)
    with open(tmp_path / "out" / txts[0]) as f:
        both = f.read()
    assert both.startswith(first_rows) and len(both) > len(first_rows)
    assert {int(r.split(",")[0]) for r in both.splitlines()} >= {4, 5, 8}


def test_serve_resumes_a_state_file_of_the_jax_package(model_path, tmp_path):
    """A tracker state written by the JAX package's save_slab, tagged with
    the stream, resumes in the port: frames and ids go on from it."""
    cfg = JS.TrackerConfig(tracker="bytetrack", conf_thresh=0.5, capacity=32,
                           det_capacity=16)
    step, cfg = j_build(cfg)
    slab = JS.init_slab(cfg)
    boxes = np.array([[10, 10, 60, 80], [100, 20, 160, 90]], np.float32)
    for _ in range(3):
        slab, _ = step(slab, JS.make_det_slab(
            cfg, boxes, np.array([0.9, 0.8]), np.zeros(2), np.ones(2, bool)))
    stream = "synth://5x120x200?seed=3"
    state = tmp_path / "state"
    state.mkdir()
    JS.save_slab(str(state / "stream_00.npz"), slab, cfg, tag=stream)
    results, _ = serve.main(
        ["--streams", stream, "--state_dir", str(state), "--model_path",
         model_path, "--conf_thresh", "0.5"] + _common(tmp_path))
    assert _fids(results[0]) == [4, 5]       # 3 frames skipped, then 4 and 5
    ids = [i for _, ids, *_ in results[0] for i in ids]
    assert any(i > int(slab.next_id) for i in ids)   # births go on from it
    assert _state_frame(str(state), 0) == 5


def test_jax_package_resumes_a_state_file_of_the_port(model_path, tmp_path):
    stream = "synth://4x120x200?seed=4"
    state = str(tmp_path / "state")
    serve.main(["--streams", stream, "--state_dir", state, "--model_path",
                model_path, "--conf_thresh", "0.5"] + _common(tmp_path))
    cfg = JS.TrackerConfig(tracker="bytetrack", conf_thresh=0.5, capacity=32,
                           det_capacity=16)
    step, cfg = j_build(cfg)
    path = os.path.join(state, "stream_00.npz")
    slab = JS.load_slab(path, cfg, expect_tag=stream)
    mine = TS.load_slab(path, TS.TrackerConfig(**vars(cfg)), "cpu",
                        expect_tag=stream)
    for a, b in zip(slab, mine):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(slab.frame) == 4 and int(slab.next_id) >= 1
    slab, _ = step(slab, JS.make_det_slab(
        cfg, np.array([[10, 10, 60, 80]], np.float32), np.array([0.9]),
        np.zeros(1), np.ones(1, bool)))
    assert int(slab.frame) == 5
    with pytest.raises(ValueError, match="different stream"):
        JS.load_slab(path, cfg, expect_tag="synth://4x120x200?seed=5")


@pytest.fixture(scope="module")
def reid_path(tmp_path_factory):
    """A seeded OSNet x0_25 checkpoint (the width read from its name)."""
    from yolov7_tracker_tpu_torch.reid import (build_reid,
                                               random_reid_state_dict)

    path = tmp_path_factory.mktemp("reid") / "osnet_x0_25_seeded.pth"
    torch.save(random_reid_state_dict(build_reid("osnet_x0_25")[0], seed=5),
               path)
    return str(path)


def _reid_flags(model_path, reid_path):
    return ["--model_path", model_path, "--conf_thresh", "0.5", "--tracker",
            "strongsort", "--reid_model_path", reid_path, "--reid_capacity",
            "8"]


def test_serve_with_reid_resume_equals_one_run(model_path, reid_path,
                                               tmp_path):
    """The counterpart of tests/test_serve.py::test_serve_with_reid:
    strongsort with a seeded OSNet on two cameras. The state files carry
    the track features, and a run resumed from them equals one
    uninterrupted run."""
    streams = ["--streams", "synth://6x120x200?seed=1",
               "synth://6x120x200?seed=2"]
    common = _common(tmp_path) + _reid_flags(model_path, reid_path)
    whole, _ = serve.main(streams + common + [
        "--save_dir", str(tmp_path / "whole")])
    state = str(tmp_path / "state")
    resumable = common + ["--state_dir", state, "--max_frames", "3"]
    r1, _ = serve.main(streams + resumable)
    with np.load(os.path.join(state, "stream_00.npz")) as z:
        feature, occupied = z["feature"], z["occupied"]
    assert feature.shape == (32, 512) and occupied.any()
    assert np.abs(feature[occupied]).max() > 0
    r2, _ = serve.main(streams + resumable)
    rows = 0
    for i in range(2):
        assert _fids(r1[i]) == [1, 2, 3] and _fids(r2[i]) == [4, 5, 6]
        for (wf, wids, wtlwh, _), (f, ids, tlwh, _) in zip(whole[i],
                                                           r1[i] + r2[i]):
            assert (wf, wids) == (f, ids)
            np.testing.assert_allclose(np.reshape(tlwh, (-1, 4)),
                                       np.reshape(wtlwh, (-1, 4)), atol=1e-4)
            rows += len(ids)
    assert rows >= 12


def test_serve_with_reid_resumes_a_state_file_of_the_jax_package(
        model_path, reid_path, tmp_path):
    """A strongsort state with 512-d features written by the JAX package's
    save_slab resumes in the port's serve CLI with ReID: the features come
    back as saved, and frames and ids go on from it."""
    cfg = JS.TrackerConfig(tracker="strongsort", conf_thresh=0.5,
                           capacity=32, det_capacity=16, feature_dim=512)
    step, cfg = j_build(cfg)
    slab = JS.init_slab(cfg)
    boxes = np.array([[10, 10, 60, 80], [100, 20, 160, 90]], np.float32)
    feats = np.random.default_rng(0).standard_normal((2, 512)).astype(
        np.float32)
    for _ in range(3):
        slab, _ = step(slab, JS.make_det_slab(
            cfg, boxes, np.array([0.9, 0.8]), np.zeros(2), np.ones(2, bool),
            feature=feats))
    stream = "synth://5x120x200?seed=3"
    state = tmp_path / "state"
    state.mkdir()
    path = str(state / "stream_00.npz")
    JS.save_slab(path, slab, cfg, tag=stream)
    mine = TS.load_slab(path, TS.TrackerConfig(**vars(cfg)), "cpu",
                        expect_tag=stream)
    np.testing.assert_array_equal(mine.feature.numpy(),
                                  np.asarray(slab.feature))
    assert np.abs(np.asarray(slab.feature)).max() > 0
    results, _ = serve.main(
        ["--streams", stream, "--state_dir", str(state)]
        + _common(tmp_path) + _reid_flags(model_path, reid_path))
    assert _fids(results[0]) == [4, 5]
    ids = [i for _, ids, *_ in results[0] for i in ids]
    assert any(i > int(slab.next_id) for i in ids)
    assert _state_frame(str(state), 0) == 5


def test_serve_reordered_streams_rejected(stream_dirs, tmp_path):
    state = str(tmp_path / "state_swap")
    common = _common(tmp_path) + ["--state_dir", state]
    serve.main(["--streams", *stream_dirs, "--max_frames", "2"] + common)
    with pytest.raises(ValueError, match="different stream"):
        serve.main(["--streams", *reversed(stream_dirs), "--max_frames", "2"]
                   + common)


def test_serve_dead_stream_state_frozen(stream_dirs, tmp_path):
    """A stream that ends early must not keep advancing: its checkpoint
    is frozen at its last real frame while other streams continue."""
    short = _frame_dir(tmp_path, "short", 3, seed=1)
    state = str(tmp_path / "state_dead")
    results, _ = serve.main(
        ["--streams", short, stream_dirs[0], "--state_dir", state]
        + _common(tmp_path))
    assert _fids(results[0]) == [1, 2, 3]
    assert _fids(results[1]) == list(range(1, 9))
    assert _state_frame(state, 0) == 3      # frozen at death, not dragged on
    assert _state_frame(state, 1) == 8


def test_serve_skips_unreadable_frame(tmp_path):
    d = _frame_dir(tmp_path, "dump", 6, seed=2)
    with open(os.path.join(d, "000003.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    with pytest.warns(UserWarning, match="unreadable frame"):
        results, _ = serve.main(["--streams", d] + _common(tmp_path))
    assert _fids(results[0]) == [1, 2, 3, 4, 5]


def test_serve_sigterm_checkpoints_and_flags(stream_dirs, tmp_path,
                                             monkeypatch):
    """SIGTERM mid-serve (raised while the reader thread pulls stream 0's
    3rd frame) checkpoints every stream's state and returns
    preempted=True. The observing tick completes (every stream emits the
    SAME count), the checkpoint matches that count, and the handlers are
    restored."""
    orig = serve._open_source

    def wrapped(obj, max_frames):
        def gen():
            for k, f in enumerate(orig(obj, max_frames)):
                if k == 2 and obj == stream_dirs[0]:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield f
        return gen()

    monkeypatch.setattr(serve, "_open_source", wrapped)
    before = signal.getsignal(signal.SIGTERM)
    state = str(tmp_path / "state_sig")
    results, preempted = serve.main(
        ["--streams", *stream_dirs, "--state_dir", state,
         "--prefetch_depth", "1"] + _common(tmp_path))
    assert preempted
    counts = {len(r) for r in results}
    assert len(counts) == 1         # stop only between ticks: no skew
    n_done = counts.pop()
    assert 1 <= n_done <= 4
    assert sorted(os.listdir(state)) == ["preempted.json", "stream_00.npz",
                                         "stream_01.npz"]
    assert _state_frame(state, 0) == _state_frame(state, 1) == n_done
    assert signal.getsignal(signal.SIGTERM) == before


def test_serve_mismatched_resolution(stream_dirs, tmp_path):
    odd = _frame_dir(tmp_path, "odd", 1, seed=3, shape=(120, 200, 3))
    with pytest.raises(SystemExit, match="resolution"):
        serve.main(["--streams", stream_dirs[0], odd] + _common(tmp_path))


def test_serve_resume_past_exhausted_stream(stream_dirs, tmp_path):
    """A relaunch where one stream's source was already fully consumed
    before the checkpoint serves the remaining streams: the exhausted
    stream is dead on arrival (state frozen), the others resume."""
    short = _frame_dir(tmp_path, "short", 3, seed=4)
    state = str(tmp_path / "state_exh")
    common = _common(tmp_path) + ["--state_dir", state]
    streams = ["--streams", short, stream_dirs[0]]
    r1, _ = serve.main(streams + ["--max_frames", "5"] + common)
    assert _fids(r1[0]) == [1, 2, 3]        # exhausted at 3
    assert _fids(r1[1]) == [1, 2, 3, 4, 5]
    r2, _ = serve.main(streams + common)
    assert r2[0] == []
    assert _fids(r2[1]) == [6, 7, 8]
    assert _state_frame(state, 0) == 3      # still frozen at death


def test_serve_fresh_run_truncates_stale_txt(stream_dirs, tmp_path):
    """A fresh (non-resumed) run into a save_dir holding a previous run's
    txts truncates them: appending would mix two runs' id spaces."""
    args = ["--streams", stream_dirs[0], "--max_frames", "3"] \
        + _common(tmp_path)
    serve.main(args)
    txts = sorted(os.listdir(tmp_path / "out"))
    assert len(txts) == 1
    stale = "500,999,1.00,1.00,8.00,8.00,1.0,-1,-1,-1\n"
    with open(tmp_path / "out" / txts[0], "a") as f:
        f.write(stale)
    serve.main(args)  # no --state_dir: fresh id space
    path = tmp_path / "out" / txts[0]
    if path.exists():
        with open(path) as f:
            assert stale not in f.read()


def _hiccup(monkeypatch, slow, pause):
    """Make source ``slow`` wait on ``pause`` before its 2nd frame."""
    orig = serve._open_source

    def wrapped(obj, max_frames):
        src = orig(obj, max_frames)
        if obj != slow:
            return src

        def gen():
            for k, f in enumerate(src):
                if k == 1:
                    pause()
                yield f
        return gen()

    monkeypatch.setattr(serve, "_open_source", wrapped)


def test_serve_stalled_stream_does_not_block_others(tmp_path, monkeypatch):
    """One stream that hangs after its first frame must not block the
    other stream's ticks. The hung stream's state freezes at its last
    real step while the healthy stream serves all its frames."""
    fast = _frame_dir(tmp_path, "fast", 12, seed=7)
    slow = _frame_dir(tmp_path, "slow", 4, seed=8)
    release = threading.Event()
    _hiccup(monkeypatch, slow, lambda: release.wait(TEST_SECONDS))
    state = str(tmp_path / "state_stall")
    try:
        results, preempted = serve.main(
            ["--streams", fast, slow, "--max_frames", "12",
             "--state_dir", state, "--stall_timeout", "0.1"]
            + _common(tmp_path))
    finally:
        release.set()
    assert not preempted
    assert _fids(results[0]) == list(range(1, 13))
    assert _fids(results[1]) == [1]
    assert _state_frame(state, 0) == 12
    # frozen at its last REAL step: phantom coasting ticks while stalled
    # must not advance the checkpointed state
    assert _state_frame(state, 1) == 1


def test_serve_stalled_stream_rejoins_without_corruption(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """A stream that stalls once and then catches up rejoins the tick loop
    with its frozen state restored: its checkpointed frame counter equals
    the frames it actually served."""
    fast = _frame_dir(tmp_path, "fast_r", 30, seed=9)
    slow = _frame_dir(tmp_path, "slow_r", 5, seed=10)
    _hiccup(monkeypatch, slow, lambda: threading.Event().wait(1.0))
    state = str(tmp_path / "state_rejoin")
    results, preempted = serve.main(
        ["--streams", fast, slow, "--state_dir", state,
         "--stall_timeout", "0.1", "--prefetch_depth", "1"]
        + _common(tmp_path))
    assert not preempted
    assert _fids(results[0]) == list(range(1, 31))
    assert _fids(results[1]) == list(range(1, 6))
    assert _state_frame(state, 0) == 30
    assert _state_frame(state, 1) == 5      # restored on rejoin, then stepped
    out = capsys.readouterr().out
    if "stalled" in out:  # fast ticks may observe the stall...
        assert "rejoined after stall" in out  # ...then must rejoin


def test_unsupported_sources_name_the_gap(tmp_path, monkeypatch):
    """Video files, webcams and RTSP/HTTP URLs open through
    cv2.VideoCapture, as in the JAX package (a live source with
    --max_frames, and no resume fast-forward); a source that does not
    open names itself, and a bad synth spec says what it wants."""
    opened = []

    class Closed:
        def __init__(self, src):
            opened.append(src)

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoCapture", Closed)
    for src, want in (("rtsp://cam/1", "rtsp://cam/1"), ("0", 0),
                      (str(tmp_path / "clip.mp4"), str(tmp_path /
                                                        "clip.mp4"))):
        with pytest.raises(OSError, match="cannot open"):
            serve.main(["--streams", src] + _common(tmp_path))
        assert opened[-1] == want
    assert serve._is_live("0") and serve._is_live("http://cam/x")
    assert not serve._is_live("synth://2x8x8") and not serve._is_live(
        str(tmp_path))
    with pytest.raises(ValueError, match="synth spec"):
        SynthFrames("synth://nonsense")


def test_stream_readers_under_contention():
    """32 reader threads (more than cores) with depth-1 queues and a short
    switch interval: every frame arrives once, in order, then "done"; and
    close() ends a reader that is blocked on a full queue."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [serve._StreamReader(iter(range(k * 1000, k * 1000 + 200)),
                                       skip=k % 3, depth=1)
                   for k in range(32)]
        got = [[] for _ in readers]
        live = set(range(32))
        while live:
            for k in sorted(live):
                status, f = readers[k].get(timeout=5.0)
                assert status != "stalled", k
                if status == "done":
                    live.discard(k)
                else:
                    got[k].append(f)
        for k, frames in enumerate(got):
            assert frames == list(range(k * 1000 + k % 3, k * 1000 + 200))
        blocked = serve._StreamReader(iter(range(10)), depth=1)
        assert blocked.get(timeout=5.0) == ("frame", 0)
        blocked.close(timeout=5.0)
        assert not blocked._t.is_alive()
        for r in readers:
            r.close(timeout=5.0)
            assert not r._t.is_alive()
    finally:
        sys.setswitchinterval(old)
