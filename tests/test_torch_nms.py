"""ops/nms's batched tail (``suppress``) on the CPU: both entries
(``nms`` and ``nms_from_raw``) end in it; its result equals
``greedy_suppress`` run on each image, the JAX package's
``greedy_suppress`` (the oracle), and a host model of K6's walk
(csrc/nms.cu: chunks of 128 candidates, the kept list, each chunk's
suppression masks resolved by the fixpoint), bit for bit, on tied
scores, a float32 order that is not the bf16 pre-order, more survivors
than max_det, no candidate over the threshold, class-agnostic and
multi-label suppression, at B = 1 and 8."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.ops import nms as jnms
from yolov7_tracker_tpu_torch.ops import boxes as boxops
from yolov7_tracker_tpu_torch.ops import nms as tnms

ANCHORS = torch.tensor([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                        [116, 90, 156, 198, 373, 326]],
                       dtype=torch.float32).reshape(3, 3, 2)
STRIDES = (8, 16, 32)
K6_CHUNK = 128               # csrc/nms.cu kChunk


def _levels(rng, b, dtype=torch.float32, nc=6):
    out = []
    for s in (32, 16, 8):
        p = rng.normal(0, 1.5, (b, s, s, 3, 5 + nc)).astype(np.float32)
        p[..., 4] += 1.0
        out.append(torch.from_numpy(p).to(dtype))
    return out


def _decoded(rng, b, n, nc, wh=(10, 60)):
    return np.concatenate([rng.uniform(0, 300, (b, n, 2)),
                           rng.uniform(*wh, (b, n, 2)),
                           rng.uniform(0, 1, (b, n, 1 + nc))],
                          -1).astype(np.float32)


def _run(case, b, rng):
    """(the case's entry called, its max_det, iou_thres)."""
    if case == "ties":
        pred = _decoded(rng, b, 600, 5)
        pred[:, [100, 200], 4:6] = 0.9           # over conf_thres
        pred[:, 100:140] = pred[:, 100:101]      # the same box and score
        pred[:, 200:260, 4:] = pred[:, 200:201, 4:]   # the same score
        return lambda: tnms.nms(torch.from_numpy(pred), 0.25, 0.45,
                                max_det=100), 100, 0.45
    if case == "bf16_order":
        levels = _levels(rng, b, torch.bfloat16)
        return lambda: tnms.nms_from_raw(levels, ANCHORS, STRIDES, 0.25,
                                         0.45, max_det=300,
                                         top_k=1024), 300, 0.45
    if case == "over_max_det":
        pred = _decoded(rng, b, 400, 3, wh=(2, 6))
        return lambda: tnms.nms(torch.from_numpy(pred), 0.1, 0.45,
                                max_det=20), 20, 0.45
    if case == "below_threshold":
        levels = _levels(rng, b)
        return lambda: tnms.nms_from_raw(levels, ANCHORS, STRIDES, 0.9999,
                                         0.45, max_det=50), 50, 0.45
    if case == "agnostic":
        levels = _levels(rng, b)
        return lambda: tnms.nms_from_raw(levels, ANCHORS, STRIDES, 0.25,
                                         0.5, max_det=300, top_k=512,
                                         agnostic=True), 300, 0.5
    assert case == "multi_label"
    pred = _decoded(rng, b, 300, 6)
    pred[:, 1::7] = pred[:, 0::7][:, :pred[:, 1::7].shape[1]]
    return lambda: tnms.nms(torch.from_numpy(pred), 0.001, 0.65,
                            multi_label=True, top_k=1024), 300, 0.65


def _k6_model(sel_box, off_box, score, cls_id, max_det, iou_thres):
    """K6's walk on the host: the stable sort, then chunks of K6_CHUNK
    candidates, each tested against the kept boxes and its own earlier
    ones, its keep set the fixpoint of the suppression masks from the
    alive set, appended up to max_det; the walk stops after a chunk that
    holds a score <= 0 or fills max_det."""
    b, k = score.shape
    out = torch.zeros((b, max_det, 6))
    counts = torch.zeros((b,), dtype=torch.int64)
    vals, order = tnms.sorted_top_k(score, k)
    lower = torch.ones((K6_CHUNK, K6_CHUNK), dtype=torch.bool).triu(1)
    for i in range(b):
        kept, n, p = [], 0, 0
        more = k > 0 and max_det > 0 and not bool(torch.isnan(vals[i, 0]))
        while more:
            s = torch.full((K6_CHUNK,), -1.0)
            idx = torch.zeros((K6_CHUNK,), dtype=torch.int64)
            m = min(K6_CHUNK, k - p)
            s[:m], idx[:m] = vals[i, p:p + m], order[i, p:p + m]
            box = off_box[i, idx]
            alive = s > 0
            if kept:
                hit = boxops.iou_matrix_xyxy(off_box[i, kept], box)
                alive &= ~(hit > iou_thres).any(0)
            sup = (boxops.iou_matrix_xyxy(box, box) > iou_thres) & lower
            kb = alive
            while True:
                nb = alive & ~(kb[:, None] & sup).any(0)
                if torch.equal(nb, kb):
                    break
                kb = nb
            for j in kb.nonzero()[:, 0][:max_det - n].tolist():
                out[i, n, :4], out[i, n, 4] = sel_box[i, idx[j]], s[j]
                out[i, n, 5] = cls_id[i, idx[j]]
                kept.append(int(idx[j]))
                n += 1
            more = n < max_det and bool(s[-1] > 0)
            p += K6_CHUNK
        counts[i] = n
    return out, counts


@functools.lru_cache(maxsize=None)
def _jax_suppress(max_det, iou_thres):
    return jax.jit(jax.vmap(functools.partial(
        jnms.greedy_suppress, max_det=max_det, iou_thres=iou_thres)))


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("case", ["ties", "bf16_order", "over_max_det",
                                  "below_threshold", "agnostic",
                                  "multi_label"])
def test_batched_tail_equals_each_image_jax_and_k6s_walk(case, b,
                                                         monkeypatch):
    seen = []
    plain = tnms.suppress

    def recorded(*args, **kw):
        seen.append(args)
        return plain(*args, **kw)

    monkeypatch.setattr(tnms, "suppress", recorded)
    entry, max_det, iou_thres = _run(case, b, np.random.default_rng(7))
    dets, counts = entry()
    (sel_box, off_box, score, cls_id), = seen
    assert score.shape[0] == b and dets.shape == (b, max_det, 6)
    assert counts.dtype == torch.int64

    for i in range(b):
        want = tnms.greedy_suppress(sel_box[i], off_box[i], score[i],
                                    cls_id[i], max_det=max_det,
                                    iou_thres=iou_thres)
        assert torch.equal(dets[i], want[0]) and int(counts[i]) == int(want[1])
    model = _k6_model(sel_box, off_box, score, cls_id, max_det, iou_thres)
    assert torch.equal(dets, model[0]) and torch.equal(counts, model[1])
    jd, jc = _jax_suppress(max_det, iou_thres)(
        *(jnp.asarray(t.numpy()) for t in (sel_box, off_box, score, cls_id)))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(dets.numpy(), np.asarray(jd))

    live = score > 0
    if case == "below_threshold":
        assert not live.any() and not counts.any() and not dets.any()
        return
    assert (counts > 0).all()
    if case == "ties":
        srt = tnms.sorted_top_k(score, score.shape[1])[0]
        assert ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] > 0)).any(1).all()
    elif case == "bf16_order":
        # the candidates come in the bf16 score's order; the keep set is
        # walked in the float32 order, which differs
        order = tnms.sorted_top_k(score, score.shape[1])[1]
        assert (order != torch.arange(score.shape[1])).any(1).all()
    elif case == "over_max_det":
        assert (counts == max_det).all() and (live.sum(1) > max_det).all()
    elif case == "agnostic":
        assert torch.equal(off_box, sel_box)
        assert (dets[:, :, 5].amax(1) > 0).all()  # more than one class kept
    elif case == "multi_label":
        # the same box kept under two classes
        assert (cls_id[:, 0::6] != cls_id[:, 1::6]).any()
        assert (counts > K6_CHUNK).all()
