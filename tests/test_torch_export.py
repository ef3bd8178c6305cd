"""Model export in the port (models/export.py): the torch.export program
of the fused detector's inference forward equals the eager module on the
CPU, survives a save / load round trip, and its stats carry the JAX keys
(flops from FlopCounterMode > 1e6 for yolov7-tiny at 64 px; -1.0 for
what torch cannot give, as the JAX package reports a missing
cost-analysis key)."""

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu_torch.models import export, zoo
from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
from yolov7_tracker_tpu_torch.models.yolo import (YoloV7, decoded,
                                                  random_state_dict)


def _fused(name):
    spec = zoo.get_spec(name, nc=4)
    model = YoloV7(spec, fused=True).eval()
    model.load_state_dict(fuse_state_dict(random_state_dict(spec, seed=1)))
    return model


@pytest.mark.parametrize("name", ["yolov7-tiny", "yolov8n"])
def test_exported_program_equals_eager(name, tmp_path):
    model = _fused(name)
    path = export.export_program(model, (64, 96), str(tmp_path / "m.pt2"),
                                 batch=2)
    program = export.load_program(path)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 96, 3)).astype(np.float32))
    with torch.no_grad():
        got, want = program(x), decoded(model, x)
    assert got.shape == want.shape == (2, want.shape[1], 5 + 4)
    assert torch.equal(got, want)


def test_export_stats_keys_and_flops():
    stats = export.export_compiled_stats(_fused("yolov7-tiny"), (64, 64))
    assert set(stats) == {"flops", "bytes_accessed", "memory_mb"}
    assert stats["flops"] > 1e6
    assert stats["bytes_accessed"] == -1.0
    assert stats["memory_mb"] == -1.0          # no card here
    # twice the pixels, twice the conv flops
    wide = export.export_compiled_stats(_fused("yolov7-tiny"), (64, 128))
    assert wide["flops"] == pytest.approx(2 * stats["flops"], rel=1e-9)
