"""The yardstick's counts from shapes: the detector's operations against
FlopCounterMode on the program's unfused model, and a solve's bytes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import yardstick
from perfbench.reference.detector import Yolo, architecture
from perfbench.reference.reid import network

W6 = architecture("yolov7-w6")
# at 80 classes; 10 classes drop 3 anchors x 70 outputs of each lead
# head's 1x1 conv (inputs 256, 512, 768, 1024 on grids of 96 x 160,
# 48 x 80, 24 x 40, 12 x 20)
FLOPS_NC80 = 215_830_364_160
FLOPS_NC10 = FLOPS_NC80 - 2 * 3 * 70 * (256 * 15360 + 512 * 3840
                                        + 768 * 960 + 1024 * 240)


def _counted(model, x):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.eval()(x)
    return counter.get_total_flops()


def test_w6_flops_equal_flop_counter_on_the_unfused_port_model():
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.models.yolo import YoloV7

    port = YoloV7(zoo.get_spec("yolov7-w6", nc=2), fused=False)
    assert yardstick.conv_flops(Yolo(W6, 2), (1, 3, 128, 192)) == _counted(
        port, torch.zeros(1, 128, 192, 3))


def test_deepsort_cnn_flops_equal_flop_counter_on_the_port_model():
    from yolov7_tracker_tpu_torch.reid.deepsort_cnn import DeepSortCNN

    assert yardstick.conv_flops(network("deepsort_cnn").Net(),
                                (1, 3, 128, 64)) == \
        _counted(DeepSortCNN(), torch.zeros(1, 3, 128, 64))


@pytest.mark.parametrize("nc,flops", [(80, FLOPS_NC80), (10, FLOPS_NC10)])
def test_w6_flops_at_the_cells_canvas(nc, flops):
    # 1080 x 1920 letterboxed to 1280 sits on a 768 x 1280 canvas; the
    # cells' heads carry VisDrone's 10 classes
    assert yardstick.conv_flops(Yolo(W6, nc), (1, 3, 768, 1280)) == flops


def test_solve_bytes_and_bound():
    t, d = 256, 300
    # float32 cost, bool masks, float32 threshold; int32 results
    assert yardstick.solve_bytes(t, d) == (4 * t * d + t + d + 4
                                           + 4 * t + 4 * d)
    assert yardstick.solve_flops(t, d) == 2 * t * d
    assert yardstick.solve_bound_s(t, d) == (
        yardstick.solve_bytes(t, d) / 3.35e12)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mfu_counts_each_part_at_its_peak_and_only_valid_crops(dtype):
    from perfbench.harness import manifest, trace
    from perfbench.reference.detector import letterbox_geometry
    from perfbench_tiny import ROOT, tiny

    cell = tiny("w6-deepsort.video")
    cell.config["pipeline"]["dtype"] = dtype
    reading = trace.TraceReading(
        config=cell.config, traffic=cell.traffic, frames=8, window_s=2.0,
        spans={}, detected=8, detections=100, device_ops={}, kernels=0,
        busy_s=0.0, idle_gaps={})
    canvas, _, _ = letterbox_geometry((192, 320), 320, 64)
    det = yardstick.conv_flops(Yolo(W6, 2), (1, 3) + tuple(canvas))
    crop = yardstick.conv_flops(network("deepsort_cnn").Net(),
                                (1, 3, 128, 64))
    peak = 989e12 if dtype == "bfloat16" else 67e12
    want = 100.0 * (det * 8 / peak + crop * 100 / 67e12) / 2.0
    got = manifest.metric(ROOT, "mfu_pct").read(reading)
    assert got == pytest.approx(want, rel=1e-12)
    # no frame through the detector: nothing to read
    reading.detected = 0
    assert manifest.metric(ROOT, "mfu_pct").read(reading) is None
