"""The PyTorch port stands alone: importing every module of
yolov7_tracker_tpu_torch (and chip_smoke.py) pulls in neither JAX, Flax,
optax, orbax, msgpack nor the JAX package, and its entry points refuse to run without a
device on a machine without a GPU instead of falling back to the CPU."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **env})


def test_port_imports_no_jax():
    proc = _run("""
        import importlib, pkgutil, sys
        import yolov7_tracker_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "msgpack", "optax", "orbax",
                                            "yolov7_tracker_tpu"))
        assert len(names) >= 50, names
        for new in ("ops.auction_square", "ops.cuda_build", "cli.serve",
                    "trackers.sort", "trackers.appearance",
                    "trackers.c_biou", "trackers.uavmot", "trackers.botsort",
                    "trackers.deepsort", "trackers.strongsort",
                    "trackers.gmc", "reid", "reid.osnet",
                    "reid.deepsort_cnn", "reid.extractor", "reid.dhn",
                    "reid.aflink", "trackers.deepmot",
                    "trackers.aflink_post", "utils.flax_msgpack",
                    "eval", "eval.rle", "eval.data", "eval.metrics",
                    "eval.readers", "eval.evaluator", "eval.motmetrics_lite",
                    "eval.cocoeval_lite", "eval.baselines", "eval.plotting",
                    "cli.evaluate", "cli.track_demo", "data.detections",
                    "train", "train.loss", "train.datasets",
                    "train.metrics", "parallel", "parallel.train_step",
                    "utils.checkpoint", "utils.logging",
                    "utils.artifacts", "utils.trace", "cli.train",
                    "cli.test", "models.ibin", "train.rank_losses",
                    "train.dhn_train", "train.autoanchor",
                    "train.evolve", "cli.detect", "data.converters",
                    "models.tta", "models.export", "models.quant",
                    "parallel.mesh", "parallel.tracking",
                    "parallel.spatial", "native"):
            assert "yolov7_tracker_tpu_torch." + new in names, new
        assert callable(pkg.load_pipeline)
        print("BAD", bad)
    """)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_entry_points_need_a_device():
    proc = _run("""
        import pytest
        from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                       TrackingPipeline)
        from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig
        from yolov7_tracker_tpu_torch.cli import serve, track
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrackingPipeline(PipelineConfig(), TrackerConfig("bytetrack"))
        from yolov7_tracker_tpu_torch import load_pipeline
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pipeline()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            track.main(["--dataset", "mot17", "--config_dir",
                        "yolov7_tracker_tpu/configs", "--track_eval",
                        "false"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            # the package's own configs/ by default, mot.yaml among them
            track.main(["--dataset", "mot", "--track_eval", "false"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--streams", "synth://2x64x64"])
        from yolov7_tracker_tpu_torch.cli import track_demo
        with pytest.raises(RuntimeError, match="no CUDA device"):
            track_demo.main(["--obj", "0"])
        from yolov7_tracker_tpu_torch.cli import test, train
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--data", "data/coco.yaml", "--epochs", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test.main(["--data", "data/coco.yaml", "--weights", "x.pt"])
        from yolov7_tracker_tpu_torch.cli import detect
        with pytest.raises(RuntimeError, match="no CUDA device"):
            detect.main(["--source", "data", "--save_dir", "unused"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            track.main(["--dataset", "mot", "--track_eval", "false",
                        "--quant", "int8"])
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def test_loaders_need_a_device(tmp_path):
    """The loaders and converters that put weights or state on a device
    default to the card as the entry points do: without a GPU and without
    a device they raise, before reading anything."""
    proc = _run("""
        import numpy as np, pytest
        from yolov7_tracker_tpu_torch.models import quant
        from yolov7_tracker_tpu_torch.models.from_jax import slab_from_numpy
        from yolov7_tracker_tpu_torch.models.zoo import get_spec
        from yolov7_tracker_tpu_torch.parallel.train_step import (
            train_state_from_jax)
        from yolov7_tracker_tpu_torch.reid.aflink import load_postlinker
        from yolov7_tracker_tpu_torch.reid.dhn import load_dhn
        from yolov7_tracker_tpu_torch.train import dhn_train
        from yolov7_tracker_tpu_torch.trackers.registry import build_tracker
        from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig
        calls = [
            lambda: load_dhn("weights/dhn_h32.msgpack", "gru", 32),
            lambda: load_postlinker("no_such_file.msgpack"),
            lambda: build_tracker(TrackerConfig("sort")),
            lambda: slab_from_numpy([np.zeros(1)] * 3),
            lambda: train_state_from_jax(None, get_spec("yolov7-tiny")),
            lambda: dhn_train.build_trainer("sinkhorn"),
            lambda: dhn_train.main(["--steps", "1", "--arch", "sinkhorn",
                                    "--out", "unused.msgpack"]),
            lambda: quant.calibrate(get_spec("yolov7-tiny"), {}, []),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def test_chip_smoke_train2_only_fails_without_a_card():
    """The phase-11 run of chip_smoke.py (the rest of training) needs the
    card as the full run does."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--train2-only"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the package, it fails too
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_square_only_fails_without_a_card():
    """The short K1/K3 run of chip_smoke.py needs the card as the full run
    does."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--square-only"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout


def test_chip_smoke_k2_only_fails_without_a_card():
    """The short K2 run of chip_smoke.py needs the card as the full run
    does."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--k2-only"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout


def test_chip_smoke_train_only_fails_without_a_card():
    """The phase-10 run of chip_smoke.py (training and the detector test)
    needs the card as the full run does."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--train-only"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout


def test_chip_smoke_models_only_fails_without_a_card():
    """The phase-12 run of chip_smoke.py (int8 serving, TTA, ensembles,
    export, the zoo's tail, the detection loop) needs the card as the full
    run does."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--models-only"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout
