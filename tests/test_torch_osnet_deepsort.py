"""OSNet x1_0 as DeepSORT's appearance network, on the CPU with seeded
weights: the port's module against the benchmark's plain reference
(perfbench/reference/models/osnet_x1_0.py) on one state dict, the
pipeline's embeddings against the reference's crops and network, the
checkpoint rule that picks OSNet for deepsort by the file's name, the
tracer's spans and counter inside the ReID layer and the benchmark's
metrics that read them, and cli/track.py on either network."""

import os

import numpy as np
import pytest
import torch
import yaml

from perfbench.harness import manifest, trace as bench_trace
from perfbench.reference.reid import Embedder, network
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu_torch.reid import (
    build_reid, random_reid_state_dict, resolve_reid,
)
from yolov7_tracker_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OSNET_SPANS = ("reid.osnet.stem", "reid.osnet.conv2", "reid.osnet.conv3",
               "reid.osnet.conv4", "reid.osnet.head")


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def _seeded(seed=3):
    return random_reid_state_dict(build_reid("osnet_x1_0")[0], seed=seed)


def _pipe(reid, sd=None):
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

    return TrackingPipeline(
        PipelineConfig(model="yolov7-tiny", nc=8, img_size=64,
                       detector_batch=1, dtype="float32", max_det=8,
                       reid=reid),
        TrackerConfig(tracker="deepsort", capacity=8, det_capacity=8),
        reid_state_dict=sd, device="cpu")


def _frame_and_boxes():
    rng = np.random.default_rng(7)
    frame = torch.from_numpy(rng.integers(0, 255, (96, 160, 3), np.uint8))
    xy = rng.uniform(0, 110, (5, 2))
    tlbr = torch.from_numpy(np.c_[xy, xy + rng.uniform(12, 50, (5, 2))]
                            .astype(np.float32))
    return frame, tlbr


def test_reference_has_the_ports_state_dict():
    ref = network("osnet_x1_0").Net().state_dict()
    port = build_reid("osnet_x1_0")[0].state_dict()
    assert list(ref) == list(port)
    assert all(ref[k].shape == port[k].shape for k in ref)
    assert sum(v.numel() for k, v in ref.items()
               if v.is_floating_point() and "running" not in k) == 2169508


def test_reference_comes_out_in_eval_mode():
    assert not network("osnet_x1_0").Net().training


def test_port_equals_reference_on_one_state_dict():
    arch = network("osnet_x1_0")
    sd = _seeded()
    ref = arch.Net()
    ref.load_state_dict(sd)
    port = build_reid("osnet_x1_0")[0]
    port.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 3) + arch.CROP_HW).astype(np.float32))
    with torch.no_grad():
        want, got = ref(x), port.eval()(x)
    assert got.shape == (3, arch.FEATURE_DIM) and want.norm() > 0
    assert _rel(got, want) < 1e-5


def test_embed_dets_equals_the_reference_embedder():
    sd = _seeded(4)
    pipe = _pipe("osnet_x1_0", sd)
    frame, tlbr = _frame_and_boxes()
    got = pipe.embed_dets(frame, tlbr)
    want = Embedder(sd, "cpu", "osnet_x1_0")(frame, tlbr)
    assert got.shape == want.shape == (5, 512)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("tracker,file,name", [
    ("deepsort", "osnet_x1_0_msmt17.pth", "osnet_x1_0"),
    ("deepsort", "osnet_x0_25_market1501.pth", "osnet_x0_25"),
    ("deepsort", "ckpt.t7", "deepsort_cnn"),
    ("strongsort", "osnet_x1_0_msmt17.pth", "osnet_x1_0"),
    ("strongsort", "reid.pth", "osnet_x0_25"),
])
def test_resolve_reid_reads_the_width_from_the_file_name(
        tmp_path, tracker, file, name):
    model = build_reid(name)[0]
    sd = random_reid_state_dict(model, seed=2)
    torch.save({"net_dict": sd} if name == "deepsort_cnn" else sd,
               tmp_path / file)
    got, loaded = resolve_reid(tracker, str(tmp_path / file))
    assert got == name
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def _parents():
    """{span name: its parent's name} of every recorded span."""
    recs = trace.TRACER.records
    return {r[0]: (recs[r[1]][0] if r[1] >= 0 else None) for r in recs}


def test_osnet_spans_nest_in_the_cnn_span_and_crops_count():
    pipe = _pipe("osnet_x1_0", _seeded(5))
    frame, tlbr = _frame_and_boxes()
    trace.reset()
    try:
        with trace.recording():
            pipe.embed_dets(frame, tlbr)
        parents, counts = _parents(), trace.counters()
        totals = trace.totals()
    finally:
        trace.reset()
    assert parents["reid.crops"] == parents["reid.cnn"] == "reid"
    assert all(parents[s] == "reid.cnn" for s in OSNET_SPANS)
    assert counts["reid.crops"] == 5
    assert all(totals[s]["count"] == 1 for s in OSNET_SPANS)


def test_the_benchmarks_osnet_metrics_read_the_spans():
    pipe = _pipe("osnet_x1_0", _seeded(6))
    frame, tlbr = _frame_and_boxes()
    cell = manifest.load(ROOT, "w6-deepsort-osnet.video")
    reading = bench_trace.TraceReading(
        config=cell.config, traffic=cell.traffic, frames=1, window_s=1.0,
        spans={}, detected=1, detections=5, device_ops={}, kernels=0,
        busy_s=0.0, idle_gaps={})
    trace.reset()
    try:
        with trace.recording():
            pipe.embed_dets(frame, tlbr)
        got = {m: manifest.metric(ROOT, m).read(reading) for m in (
            "reid_crops_ms_per_frame", "osnet_blocks_ms_per_frame",
            "osnet_blocks_roofline")}
    finally:
        trace.reset()
    assert all(v is not None and v > 0 for v in got.values()), got
    # without the spans the readers give nothing, as on a program that
    # lacks them
    assert all(manifest.metric(ROOT, m).read(reading) is None for m in got)


def test_osnet_blocks_roofline_counts_the_published_stages():
    roofline = manifest.metric(ROOT, "osnet_blocks_roofline")
    assert roofline.stage_flops("osnet_x1_0") == (
        936386560 + 596527104 + 203063296)


@pytest.mark.parametrize("file,osnet", [("osnet_x1_0_msmt17.pth", True),
                                        ("ckpt.t7", False)])
def test_track_cli_deepsort_runs_the_network_the_file_names(
        tmp_path, file, osnet):
    import cv2

    from yolov7_tracker_tpu_torch.cli import track

    rng = np.random.default_rng(0)
    seq_dir = tmp_path / "data" / "images" / "test" / "SYN-01" / "img1"
    seq_dir.mkdir(parents=True)
    for t in range(3):
        cv2.imwrite(str(seq_dir / f"{t + 1:06d}.png"),
                    rng.integers(0, 255, (96, 160, 3), np.uint8))
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    with open(cfg_dir / "synth.yaml", "w") as fh:
        yaml.safe_dump({"DATASET_ROOT": str(tmp_path / "data")}, fh)
    model = build_reid("osnet_x1_0" if osnet else "deepsort_cnn")[0]
    sd = random_reid_state_dict(model, seed=8)
    torch.save(sd if osnet else {"net_dict": sd}, tmp_path / file)
    trace.reset()
    try:
        with trace.recording():
            folder = track.main([
                "--dataset", "synth", "--config_dir", str(cfg_dir),
                "--tracker", "deepsort",
                "--reid_model_path", str(tmp_path / file),
                "--reid_capacity", "2", "--model", "yolov7-tiny", "--nc", "8",
                "--img_size", "64", "--detector_batch", "3",
                "--capacity", "8", "--det_capacity", "8",
                "--dtype", "float32", "--track_eval", "false",
                "--device", "cpu", "--output_dir", str(tmp_path / "out")])
        totals, counts = trace.totals(), trace.counters()
    finally:
        trace.reset()
    assert os.path.isfile(os.path.join(folder, "SYN-01.txt"))
    assert counts["reid.crops"] == 3 * 2
    assert totals["reid.cnn"]["count"] == 3
    assert all((s in totals) == osnet for s in OSNET_SPANS)
