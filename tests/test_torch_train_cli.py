"""The port's training CLI (yolov7_tracker_tpu_torch/cli/train.py) end to
end on the CPU, the counterparts of tests/test_preempt.py and
tests/test_train_smoke.py's CLI tests: two epochs on a tiny image dir
write the JAX CLI's run-dir layout with ``last.pt`` / ``best.pt`` (which
cli/track.py's --model_path and cli/test.py's --weights load);
--preempt_after checkpoints mid-epoch and ``--resume auto`` finishes the
run; ``_find_latest_ckpt`` skips other fingerprints and half-written
saves; a real SIGTERM makes ``python -m ...cli.train`` exit 75; an
``--resume artifact:`` round trip extends the lineage; a saved train
state loads back bit for bit; and without a card the CLIs refuse to run
unless --device cpu is given."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import one_torch_thread  # noqa: F401
from yolov7_tracker_tpu_torch.cli import test as test_cli
from yolov7_tracker_tpu_torch.cli import train as train_cli
from yolov7_tracker_tpu_torch.models import zoo
from yolov7_tracker_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("ds")
    img_dir = root / "images" / "train"
    lab_dir = root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 255, (96, 96, 3), np.uint8)
        cx, cy = rng.uniform(0.3, 0.7, 2)
        w, h = rng.uniform(0.2, 0.4, 2)
        cv2.rectangle(
            img,
            (int((cx - w / 2) * 96), int((cy - h / 2) * 96)),
            (int((cx + w / 2) * 96), int((cy + h / 2) * 96)),
            (255, 255, 255), -1,
        )
        cv2.imwrite(str(img_dir / f"{i:03d}.jpg"), img)
        with open(lab_dir / f"{i:03d}.txt", "w") as f:
            f.write(f"0 {cx:.4f} {cy:.4f} {w:.4f} {h:.4f}\n")
    return str(img_dir)


def _common(tiny_dataset, tmp_path, val=False):
    data_yaml = tmp_path / "data.yaml"
    cfg = {"train": tiny_dataset, "nc": 2}
    if val:
        cfg["val"] = tiny_dataset
    yaml.safe_dump(cfg, open(data_yaml, "w"))
    return [
        "--model", "yolov7-tiny",
        "--data", str(data_yaml),
        "--img", "96",
        "--batch", "2",
        "--max_labels", "16",
        "--ckpt_dir", str(tmp_path / "runs"),
        "--eval_every", "1" if val else "0",
        "--device", "cpu",
    ]


def _next_second():
    """Run dirs are named by the second (as in the JAX CLI): start the
    next run in a new one."""
    time.sleep(1.05 - time.time() % 1.0)


def test_train_two_epochs_writes_last_and_best(tiny_dataset, tmp_path):
    from yolov7_tracker_tpu_torch.models.convert import load_detector_weights
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

    handler = signal.getsignal(signal.SIGTERM)
    run = train_cli.main(_common(tiny_dataset, tmp_path, val=True)
                         + ["--epochs", "2"])
    assert signal.getsignal(signal.SIGTERM) == handler     # restored
    files = set(os.listdir(run))
    assert {"last.pt", "best.pt", "metrics.jsonl", "step_4", "step_8",
            "train_batch0.jpg", "train_batch1.jpg",
            "train_batch2.jpg"} <= files
    for d in ("step_4", "step_8"):
        assert sorted(os.listdir(os.path.join(run, d))) == ["meta.json",
                                                            "state.pt"]
    meta = json.load(open(os.path.join(run, "step_8", "meta.json")))
    assert meta["epoch"] == 1 and meta["model"] == "yolov7-tiny"
    assert meta["img"] == 96 and meta["nc"] == 2
    rows = [json.loads(l) for l in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows if "train/loss" in r] == [4, 8]
    assert all(np.isfinite(r["train/loss"]) for r in rows
               if "train/loss" in r)

    # last.pt is the EMA weights with the live BN statistics of step 8
    spec = zoo.get_spec("yolov7-tiny", nc=2)
    sd = load_detector_weights(os.path.join(run, "last.pt"), spec)
    state = torch.load(os.path.join(run, "step_8", "state.pt"),
                       weights_only=True)
    for k, v in sd.items():
        want = state["ema"].get(k, state["model"][k])
        assert torch.equal(v, want), k
    # ... which cli/track.py's --model_path loader and the pipeline take
    pipe = TrackingPipeline(
        PipelineConfig(model="yolov7-tiny", nc=2, img_size=96,
                       detector_batch=2, dtype="float32"),
        TrackerConfig(tracker="bytetrack", conf_thresh=0.5, capacity=16,
                      det_capacity=8),
        state_dict=sd, device="cpu")
    boxes, *_ = pipe.detect_batch(np.zeros((2, 96, 96, 3), np.uint8))
    assert boxes.shape[0] == 2
    # and cli/test.py scores best.pt
    res = test_cli.main(["--model", "yolov7-tiny", "--weights",
                         os.path.join(run, "best.pt"), "--data",
                         str(tmp_path / "data.yaml"), "--img", "96",
                         "--batch", "4", "--device", "cpu"])
    assert 0.0 <= res["map50"] <= 1.0


def test_preempt_and_auto_resume(tiny_dataset, tmp_path):
    common = _common(tiny_dataset, tmp_path)
    run1 = train_cli.main(common + ["--epochs", "2", "--preempt_after", "1"])
    pre = json.load(open(os.path.join(run1, "preempted.json")))
    assert pre["epoch"] == 0 and pre["step"] == 1
    meta = json.load(open(os.path.join(pre["ckpt"], "meta.json")))
    # epoch-1 in meta => resume restarts the interrupted epoch
    assert meta["preempted"] and meta["epoch"] == -1
    assert not os.path.isfile(os.path.join(run1, "last.pt"))

    _next_second()
    run2 = train_cli.main(common + ["--epochs", "2", "--resume", "auto"])
    assert run2 != run1
    assert not os.path.isfile(os.path.join(run2, "preempted.json"))
    assert os.path.isfile(os.path.join(run2, "last.pt"))
    # both epochs completed after the restart, counting on from step 1
    steps = sorted(d for d in os.listdir(run2) if d.startswith("step_"))
    assert steps == ["step_5", "step_9"]
    last_meta = json.load(open(os.path.join(run2, "step_9", "meta.json")))
    assert last_meta["epoch"] == 1


def test_resume_auto_fresh_start(tiny_dataset, tmp_path):
    run = train_cli.main(_common(tiny_dataset, tmp_path)
                         + ["--epochs", "1", "--resume", "auto"])
    assert os.path.isfile(os.path.join(run, "last.pt"))


def _fake_ckpt(root, run, step, meta, suffix=""):
    d = root / run / f"step_{step}{suffix}"
    d.mkdir(parents=True)
    if meta is not None:
        with open(d / "meta.json", "w") as f:
            json.dump(meta, f)
    return str(d)


def test_resume_auto_skips_incompatible_ckpts(tmp_path):
    want_fp = {"model": "yolov7-tiny", "img": 160, "nc": 1}
    older = _fake_ckpt(tmp_path, "run_a", 10, {"epoch": 0, **want_fp})
    time.sleep(0.01)
    # newest by mtime, but from a different model config
    _fake_ckpt(tmp_path, "run_b", 99,
               {"epoch": 5, "model": "yolov7-w6", "img": 1088, "nc": 80})
    assert train_cli._find_latest_ckpt(str(tmp_path), want_fp) == older
    # no fingerprint: newest wins
    assert train_cli._find_latest_ckpt(str(tmp_path)).endswith("step_99")
    # a legacy checkpoint without fingerprint keys stays eligible
    time.sleep(0.01)
    legacy = _fake_ckpt(tmp_path, "run_c", 120, {"epoch": 7})
    assert train_cli._find_latest_ckpt(str(tmp_path), want_fp) == legacy


def test_resume_auto_skips_half_written_saves(tmp_path):
    """A kill mid-save leaves the temporary sibling (the port's
    step_N.partial-<pid>, or orbax's step_N.orbax-checkpoint-tmp-*); the
    resume scan never picks it."""
    fp = {"model": "yolov7-tiny", "img": 160, "nc": 1}
    good = _fake_ckpt(tmp_path, "run_a", 10, {"epoch": 1, **fp})
    time.sleep(0.01)
    part = _fake_ckpt(tmp_path, "run_a", 42, None,
                      suffix=f"{checkpoint.PARTIAL}1755")
    with open(os.path.join(part, "state.pt"), "wb") as f:
        f.write(b"\x00")
    time.sleep(0.01)
    _fake_ckpt(tmp_path, "run_a", 43, None,
               suffix=".orbax-checkpoint-tmp-1756")
    assert train_cli._find_latest_ckpt(str(tmp_path), fp) == good
    assert train_cli._find_latest_ckpt(str(tmp_path)) == good


def test_sigterm_checkpoints_and_exits_75(tiny_dataset, tmp_path):
    """A real SIGTERM mid-run lands in the installed handler: the process
    checkpoints, writes preempted.json and exits 75 (EX_TEMPFAIL), the
    supervisor's cue to relaunch with --resume auto."""
    runs = tmp_path / "runs"
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolov7_tracker_tpu_torch.cli.train"]
        + _common(tiny_dataset, tmp_path) + ["--epochs", "200"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    try:
        deadline = time.time() + 240
        while time.time() < deadline and proc.poll() is None:
            done = [d for r in (os.listdir(runs) if runs.is_dir() else ())
                    for d in os.listdir(runs / r) if d == "step_4"]
            if done:
                break
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read().decode()
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=240)[0].decode()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, out
    (run,) = os.listdir(runs)
    pre = json.load(open(runs / run / "preempted.json"))
    assert pre["step"] >= 4 and os.path.isdir(pre["ckpt"])
    assert "preempted" in out


def test_artifact_resume_round_trip(tiny_dataset, tmp_path):
    """train -> resume-from-artifact: the second run restores the
    checkpoint through the store, continues at the next epoch with the
    restored best_fitness, and extends the lineage chain."""
    from yolov7_tracker_tpu_torch.utils.artifacts import ArtifactStore

    store_dir = str(tmp_path / "store")
    common = _common(tiny_dataset, tmp_path) + [
        "--artifacts", store_dir, "--run_name", "tiny"]
    run1 = train_cli.main(common + ["--epochs", "1"])
    store = ArtifactStore(store_dir)
    v1 = store.versions("tiny-ckpt")
    assert len(v1) == 1 and v1[0]["metadata"]["epoch"] == 0
    events = [json.loads(l) for l in open(os.path.join(run1,
                                                       "metrics.jsonl"))]
    assert {"dataset", "checkpoint"} <= {e["kind"] for e in events
                                         if e.get("event")}
    ckpt_dir = store.resolve("tiny-ckpt:latest")
    meta = json.load(open(os.path.join(ckpt_dir, "meta.json")))
    meta["best_fitness"] = 0.7
    json.dump(meta, open(os.path.join(ckpt_dir, "meta.json"), "w"))

    _next_second()
    run2 = train_cli.main(common + ["--epochs", "2", "--resume",
                                    "artifact:tiny-ckpt:latest"])
    v2 = store.versions("tiny-ckpt")
    assert len(v2) == 2 and v2[-1]["metadata"]["epoch"] == 1
    ref = f"tiny-ckpt:{v2[-1]['digest'][:12]}"
    run2_meta = json.load(open(os.path.join(store.resolve(ref),
                                            "meta.json")))
    assert run2_meta["best_fitness"] == 0.7
    chain = store.lineage(ref)
    assert any(c.startswith("tiny-data:") for c in chain)
    assert f"tiny-ckpt:{v1[0]['digest'][:12]}" in chain
    assert os.path.isfile(os.path.join(run2, "last.pt"))


def test_train_state_round_trip_is_bit_exact(tmp_path):
    """save_train_state / load_train_state: every tensor, the step and
    the EMA count come back bit for bit, gradient sum included."""
    from tests.torch_parity import narrow_aux_cfg, seeded_batch
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
    from yolov7_tracker_tpu_torch.parallel import train_step as ts

    spec = parse_yaml_cfg(narrow_aux_cfg(), name="aux")
    cfg = ts.OptConfig(batch_size=16)
    state = ts.make_train_state(spec, cfg, seed=3, device="cpu")
    step = ts.make_train_step(spec, img_size=128, opt_cfg=cfg)
    state.step = 1001                       # accumulate 4: 1001 carries
    step(state, *(torch.tensor(x) for x in seeded_batch(0)))
    path = checkpoint.save_train_state(str(tmp_path), state, state.step,
                                       {"epoch": 0})
    assert sorted(os.listdir(tmp_path)) == ["step_1002"]
    fresh = ts.make_train_state(spec, cfg, seed=4, device="cpu")
    loaded = checkpoint.load_train_state(path, fresh).state_dict()
    want = state.state_dict()
    assert (loaded["step"], loaded["ema_count"]) == (1002, want["ema_count"])
    for sec in ("model", "ema", "momentum", "grad_acc"):
        for k, v in want[sec].items():
            assert torch.equal(loaded[sec][k], v), (sec, k)
    assert any(float(v.abs().max()) > 0 for v in want["grad_acc"].values())


def test_clis_need_a_card_unless_cpu(tiny_dataset, tmp_path, monkeypatch):
    """On a machine without a GPU the CLIs refuse to run unless --device
    cpu is given; more card ranks than cards and the DetectV8 head are
    refused; --n_devices 2 --device cpu trains on two gloo ranks and
    leaves one run dir, rank 0's."""
    from yolov7_tracker_tpu_torch.parallel import train_step as ts

    args = [a for a in _common(tiny_dataset, tmp_path) if a not in (
        "--device", "cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(args + ["--epochs", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_cli.main(["--weights", "x.pt", "--data",
                           str(tmp_path / "data.yaml")])
    with pytest.raises(NotImplementedError, match="DetectV8"):
        ts.make_train_state(zoo.get_spec("yolov8n", nc=2), device="cpu")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="2 card ranks asked for"):
            train_cli.main(args + ["--epochs", "1", "--n_devices", "2"])
    assert not os.path.isdir(tmp_path / "runs")
    run = train_cli.main(_common(tiny_dataset, tmp_path)
                         + ["--epochs", "1", "--n_devices", "2"])
    assert os.listdir(tmp_path / "runs") == [os.path.basename(run)]
    assert {"last.pt", "step_4", "metrics.jsonl"} <= set(os.listdir(run))
