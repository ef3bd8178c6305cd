"""ReID in the port's streaming modes against the JAX package on the CPU:
``process_multistream`` and ``step_frame`` with strongsort and a seeded
OSNet x0_25, over three cameras and one, with and without the caller's
camera warps (the narrowed yolov7-w6 of tests/test_torch_gmc.py at 128
px, float32; the features of the S frames embedded by one crop gather
and one forward in the port, stream by stream in JAX). Ids and integer
state exact, boxes within 1e-3 px, track features within 1e-4 of their
scale. The port's strongsort solves its fused stages with the square
auction here, as the JAX package does on the CPU (the random detector's
overlapping boxes and the random OSNet's look-alike features make them
dense)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_reid import flax_variables
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    narrow_w6_cfg, one_torch_thread, random_variables, sharpen_heads,
)
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg
from yolov7_tracker_tpu.pipeline import PipelineConfig as JPipelineConfig
from yolov7_tracker_tpu.pipeline import TrackingPipeline as JPipeline
from yolov7_tracker_tpu.reid.osnet import build_osnet as j_build_osnet
from yolov7_tracker_tpu.trackers.slab import TrackerConfig as JTrackerConfig
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models.from_jax import (
    jax_variables_to_torch, osnet_variables_to_torch, slab_to_numpy,
)
from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
from yolov7_tracker_tpu_torch.pipeline import PipelineConfig, TrackingPipeline
from yolov7_tracker_tpu_torch.reid import build_reid
from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

N_STREAMS = 3
N_TICKS = 5
PIPE = dict(model="yolov7-w6", nc=8, img_size=128, detector_batch=3,
            dtype="float32", max_det=64, reid="osnet_x0_25",
            reid_capacity=8)
TRACK = dict(tracker="strongsort", conf_thresh=0.5, capacity=32,
             det_capacity=64)


@pytest.fixture(scope="module")
def weights():
    spec = parse_yaml_cfg(narrow_w6_cfg())
    return (spec, sharpen_heads(random_variables(spec, seed=1), spec,
                                obj_boost=7.0, levels=(0,)),
            flax_variables(j_build_osnet("osnet_x0_25"), (128, 256), 4))


@pytest.fixture(autouse=True)
def square_auction_stages(monkeypatch):
    from yolov7_tracker_tpu_torch.trackers import strongsort

    monkeypatch.setattr(strongsort, "solve_assignment", masked_assignment)


def _pipes(weights, **pipe_kw):
    spec, det_vars, reid_vars = weights
    jpipe = JPipeline(JPipelineConfig(wpack=False, **PIPE),
                      JTrackerConfig(**TRACK),
                      variables=jax.tree.map(jnp.asarray, det_vars),
                      spec=spec, reid_variables=reid_vars)
    t_spec = tspec.parse_yaml_cfg(narrow_w6_cfg())
    port = TrackingPipeline(
        PipelineConfig(**{**PIPE, **pipe_kw}),
        TrackerConfig(**TRACK),
        state_dict=jax_variables_to_torch(det_vars, t_spec), spec=t_spec,
        device="cpu", reid_state_dict=osnet_variables_to_torch(
            reid_vars, build_reid("osnet_x0_25")[0]))
    return jpipe, port


def _frames():
    """(N_TICKS, N_STREAMS, 96, 160, 3): bright blocks on a dark ground,
    each camera's own, moving 3 px a tick."""
    out = []
    for s in range(N_STREAMS):
        rng = np.random.default_rng(10 + s)
        base = rng.integers(0, 96, (96, 160, 3), np.uint8)
        for _ in range(6):
            y, x = rng.integers(0, 72), rng.integers(0, 136)
            base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
        out.append([np.roll(base, 3 * t, axis=1) for t in range(N_TICKS)])
    return np.stack([np.stack(f) for f in zip(*out)])


def _warps(t):
    """A small turn, zoom and shift a camera and tick."""
    a = 1e-3 * (t + 1)
    return np.stack([np.float32([[1 + a, -a * s, 1.5 * s - t],
                                 [a * s, 1 + a, 0.5 * t]])
                     for s in range(N_STREAMS)])


def _assert_match(t_slab, t_out, j_slab, j_out, where):
    tv = t_out.valid.numpy()
    np.testing.assert_array_equal(tv, np.asarray(j_out.valid), err_msg=where)
    np.testing.assert_array_equal(t_out.track_id.numpy()[tv],
                                  np.asarray(j_out.track_id)[tv],
                                  err_msg=where)
    np.testing.assert_allclose(t_out.tlwh.numpy()[tv],
                               np.asarray(j_out.tlwh)[tv], atol=1e-3,
                               rtol=0, err_msg=where)
    t_np = slab_to_numpy(t_slab)
    for name, a, b in zip(t_np._fields, t_np, j_slab):
        b = np.asarray(b)
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {name}")
    occ = np.asarray(j_slab.occupied)
    feat = np.asarray(j_slab.feature)[occ]
    np.testing.assert_allclose(t_np.feature[occ], feat, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(feat).max()),
                               err_msg=f"{where} feature")
    return int(tv.sum())


@pytest.mark.parametrize("warped", [False, True])
def test_process_multistream_with_reid_matches_jax(weights, warped):
    jpipe, port = _pipes(weights)
    frames = _frames()
    j_slabs = jpipe.init_multistream(N_STREAMS)
    t_slabs = port.init_multistream(N_STREAMS)
    rows = 0
    for t in range(N_TICKS):
        warps = _warps(t) if warped else None
        j_slabs, j_out = jpipe.process_multistream(j_slabs, frames[t],
                                                   warps=warps)
        t_slabs, t_out = port.process_multistream(t_slabs, frames[t],
                                                  warps=warps)
        rows += _assert_match(t_slabs, t_out, j_slabs, j_out, f"tick {t}")
    assert rows >= 2 * N_TICKS * N_STREAMS
    assert float(t_slabs.feature.abs().max()) > 0      # ReID reached slabs


def test_step_frame_with_reid_matches_jax(weights):
    jpipe, port = _pipes(weights)
    frames = _frames()[:, 0]
    j_slab, t_slab = jpipe.init_tracker(), port.init_tracker()
    rows = 0
    for t in range(N_TICKS):
        warp = _warps(t)[0] if t % 2 else None
        j_slab, j_out = jpipe.step_frame(j_slab, frames[t], warp=warp)
        t_slab, t_out = port.step_frame(t_slab, frames[t], warp=warp)
        rows += _assert_match(t_slab, t_out, j_slab, j_out, f"frame {t}")
    assert rows >= 2 * N_TICKS
    # one stream through step_frame == lane 0 of process_multistream
    slabs = port.init_multistream(1)
    for t in range(N_TICKS):
        warp = _warps(t)[:1] if t % 2 else None
        slabs, outs = port.process_multistream(slabs, frames[t][None],
                                               warps=warp)
    assert torch.equal(slabs.track_id[0], t_slab.track_id)
    torch.testing.assert_close(slabs.feature[0], t_slab.feature, rtol=1e-5,
                               atol=1e-5)


def test_streaming_modes_refuse_the_pipelines_own_gmc(weights):
    _, port = _pipes(weights, gmc_method="ecc")
    frames = _frames()[0]
    with pytest.raises(NotImplementedError, match="GMC"):
        port.process_multistream(port.init_multistream(N_STREAMS), frames)
    with pytest.raises(NotImplementedError, match="GMC"):
        port.step_frame(port.init_tracker(), frames[0])
