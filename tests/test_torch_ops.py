"""Ops of the PyTorch port against the JAX package on the same numpy
inputs: box conversions and IoUs and the four Kalman formats within 1e-5,
NMS pick sets identical, the device letterbox within 1e-4 on [0, 1]."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.data import letterbox as jlb
from yolov7_tracker_tpu.ops import boxes as jboxes
from yolov7_tracker_tpu.ops import kalman as jkf
from yolov7_tracker_tpu.ops import nms as jnms
from yolov7_tracker_tpu_torch.data import letterbox as tlb
from yolov7_tracker_tpu_torch.ops import boxes as tboxes
from yolov7_tracker_tpu_torch.ops import kalman as tkf
from yolov7_tracker_tpu_torch.ops import nms as tnms


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _tlwh(rng, n):
    return np.concatenate([rng.uniform(0, 500, (n, 2)),
                           rng.uniform(5, 120, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("fn", [
    "tlbr_to_tlwh", "tlwh_to_tlbr", "tlwh_to_xyah", "xyah_to_tlwh",
    "tlwh_to_xyar", "xyar_to_cxcywh", "tlwh_to_xywh", "xywh_to_tlwh",
    "xywh_to_tlbr", "xywh_to_xyxy"])
def test_box_conversions(fn):
    x = _tlwh(np.random.default_rng(0), 64)
    x[:5, :2] -= 600.0  # negative corners exercise the clamp and floors
    _close(getattr(tboxes, fn)(torch.from_numpy(x)),
           getattr(jboxes, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("fn", ["iou_matrix", "iou_matrix_xyxy",
                                "iou_distance"])
def test_pairwise_iou(fn):
    rng = np.random.default_rng(1)
    a = jboxes.tlwh_to_tlbr(jnp.asarray(_tlwh(rng, 40)))
    b = jboxes.tlwh_to_tlbr(jnp.asarray(_tlwh(rng, 30)))
    a, b = np.array(a), np.array(b)
    b[:10] = a[:10] + rng.normal(0, 3, (10, 4)).astype(np.float32)
    _close(getattr(tboxes, fn)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jboxes, fn)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("fmt", ["default", "naive", "botsort",
                                 "strongsort"])
def test_kalman_formats(fmt):
    rng = np.random.default_rng(2)
    tlwh = _tlwh(rng, 16)
    meas = np.array(jkf.measurement_from_tlwh(fmt, jnp.asarray(tlwh)))
    _close(tkf.measurement_from_tlwh(fmt, torch.from_numpy(tlwh)), meas)
    jm, jc = jkf.initiate(fmt, jnp.asarray(meas))
    tm, tc = tkf.initiate(fmt, torch.from_numpy(meas))
    _close(tm, jm)
    _close(tc, jc)
    for _ in range(3):
        jm, jc = jkf.predict(fmt, jm, jc)
        tm, tc = tkf.predict(fmt, tm, tc)
    _close(tm, jm)
    _close(tc, jc)
    _close(tkf.tlwh_from_mean(fmt, tm), jkf.tlwh_from_mean(fmt, jm))
    new = (meas + rng.normal(0, 2, meas.shape)).astype(np.float32)
    conf = rng.uniform(0.3, 0.9, 16).astype(np.float32)
    jm2, jc2 = jkf.update(fmt, jm, jc, jnp.asarray(new), jnp.asarray(conf))
    tm2, tc2 = tkf.update(fmt, tm, tc, torch.from_numpy(new),
                          torch.from_numpy(conf))
    _close(tm2, jm2)
    _close(tc2, jc2)
    tracked = rng.random(16) < 0.5
    _close(tkf.zero_stale_velocity(fmt, tm2, torch.from_numpy(tracked)),
           jkf.zero_stale_velocity(fmt, jm2, jnp.asarray(tracked)))
    for only_pos in (False, True):
        np.testing.assert_allclose(
            tkf.gating_distance(fmt, tm2, tc2, torch.from_numpy(new),
                                only_position=only_pos).numpy(),
            np.asarray(jkf.gating_distance(fmt, jm2, jc2, jnp.asarray(new),
                                           only_position=only_pos)),
            rtol=1e-4, atol=1e-4)


def _raw_levels(rng, b=2, nc=6):
    """Random pre-sigmoid head levels (B, ny, nx, na, no) with a spread of
    objectness so NMS has real work, plus anchors and strides."""
    shapes = [(16, 20), (8, 10), (4, 5)]
    levels = []
    for ny, nx in shapes:
        p = rng.normal(0, 1.5, (b, ny, nx, 3, 5 + nc)).astype(np.float32)
        p[..., 4] += 1.0
        levels.append(p)
    anchors = np.asarray([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                          [116, 90, 156, 198, 373, 326]],
                         np.float32).reshape(3, 3, 2)
    return levels, anchors, (8, 16, 32)


def _same_picks(t_out, j_out):
    t_dets, t_cnt = t_out
    j_dets, j_cnt = (np.asarray(x) for x in j_out)
    np.testing.assert_array_equal(t_cnt.numpy(), j_cnt)
    for b in range(len(j_cnt)):
        n = int(j_cnt[b])
        assert n > 20
        np.testing.assert_array_equal(t_dets[b, :n, 5].numpy(),
                                      j_dets[b, :n, 5])
        np.testing.assert_allclose(t_dets[b, :n, :5].numpy(),
                                   j_dets[b, :n, :5], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("max_det,top_k", [(300, 4096), (40, 4096),
                                           (300, 256)])
def test_nms_from_raw_same_picks(max_det, top_k):
    levels, anchors, strides = _raw_levels(np.random.default_rng(3))
    j = jnms.nms_from_raw([jnp.asarray(x) for x in levels],
                          jnp.asarray(anchors), strides, 0.25, 0.45,
                          max_det=max_det, top_k=top_k)
    t = tnms.nms_from_raw([torch.from_numpy(x) for x in levels], anchors,
                          strides, 0.25, 0.45, max_det=max_det,
                          top_k=top_k)
    _same_picks(t, j)


def test_nms_decoded_same_picks():
    rng = np.random.default_rng(4)
    n, nc = 600, 5
    xy = rng.uniform(0, 300, (2, n, 2))
    wh = rng.uniform(10, 60, (2, n, 2))
    pred = np.concatenate([xy, wh, rng.uniform(0, 1, (2, n, 1 + nc))],
                          -1).astype(np.float32)
    # ties in score across boxes: lax.top_k order must be kept
    pred[:, 100:110, 4:] = pred[:, 100:101, 4:]
    j = jnms.nms(jnp.asarray(pred), 0.25, 0.45, max_det=100)
    t = tnms.nms(torch.from_numpy(pred), 0.25, 0.45, max_det=100)
    _same_picks(t, j)


@pytest.mark.parametrize("src_hw,img", [((120, 160), 96), ((90, 200), 128),
                                        ((64, 48), 160)])
def test_device_preprocess(src_hw, img):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (2,) + src_hw + (3,), np.uint8)
    r, (uw, uh), (dw, dh) = tlb.letterbox_params(src_hw, (img, img),
                                                 stride=32)
    assert (r, (uw, uh), (dw, dh)) == jlb.letterbox_params(
        src_hw, (img, img), stride=32)
    out_hw = (uh + int(round(dh - 0.1)) + int(round(dh + 0.1)),
              uw + int(round(dw - 0.1)) + int(round(dw + 0.1)))
    j_img, j_meta = jlb.device_preprocess(jnp.asarray(frames), src_hw,
                                          out_hw, unpad_hw=(uh, uw))
    t_img, t_meta = tlb.device_preprocess(torch.from_numpy(frames), src_hw,
                                          out_hw, unpad_hw=(uh, uw))
    assert t_meta == j_meta
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-4,
                               rtol=0)
    boxes = np.concatenate([rng.uniform(-10, 80, (50, 2)),
                            rng.uniform(80, 200, (50, 2))],
                           1).astype(np.float32)
    np.testing.assert_allclose(
        tlb.scale_coords_device(torch.from_numpy(boxes), out_hw,
                                src_hw).numpy(),
        np.asarray(jlb.scale_coords_device(jnp.asarray(boxes), out_hw,
                                           src_hw)), atol=1e-4, rtol=0)
