"""The PyTorch port stands alone: importing every module of
yolov7_tracker_tpu_torch (and chip_smoke.py) pulls in neither JAX, Flax,
msgpack nor the JAX package, and its entry points refuse to run without a
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
                                            "msgpack", "yolov7_tracker_tpu"))
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
                    "cli.evaluate", "cli.track_demo", "data.detections"):
            assert "yolov7_tracker_tpu_torch." + new in names, new
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
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


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
