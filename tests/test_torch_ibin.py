"""The IBin head in the port against the JAX package: an IBin model built
from the zoo's yolov7-tiny rows with the head kind of the last row set to
"IBin" (the reference ships no IBin cfg; its own IBin models are made so),
at width 0.25 and 128 px, nc = 8, through each package's parse_yaml_cfg.

- sigmoid_bin_decode on the same sigmoided inputs, ties included;
- the raw levels of the forward (weights through models/from_jax, fused
  and unfused) within 1e-3, float32, and the decoded output within 1e-3
  where the argmax bin agrees (a bin differs only at a near tie of the
  JAX bin values, 1e-4);
- the pipeline's detect_batch through the decoded-path NMS: the same
  boxes, scores and classes (heads with a clear best bin, so no near tie
  moves a box);
- models/convert.py on an IBin reference layout, bit for bit as JAX's
  converter carried over;
- simota_assign(bin_wh=True) with the same assignments and
  compute_loss_bin_ota's value and parts within 1e-5 relative and its
  gradient within 1e-4 of each level's largest;
- the train step: JAX's sends IBin to the anchor loss, which raises for
  nc > 1 and reads a bin logit as objectness at nc = 1; the port's
  make_train_state refuses IBin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_convert import _assert_same, _jax_way, to_reference
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables)
from yolov7_tracker_tpu import pipeline as j_pipeline
from yolov7_tracker_tpu.models import ibin as j_ibin
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models import zoo as jzoo
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu.train import loss as jloss
from yolov7_tracker_tpu_torch.models import convert
from yolov7_tracker_tpu_torch.models import ibin as t_ibin
from yolov7_tracker_tpu_torch.models import zoo as tzoo
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg as t_parse
from yolov7_tracker_tpu_torch.models.yolo import (YoloV7, decode_levels,
                                                  obj_index, sharpen_heads)
from yolov7_tracker_tpu_torch.parallel import train_step as tts
from yolov7_tracker_tpu_torch.pipeline import PipelineConfig, TrackingPipeline
from yolov7_tracker_tpu_torch.trackers import slab as TS
from yolov7_tracker_tpu_torch.train import loss as tloss

IMG = 128
NC = 8
N_BIN = 22                 # BIN_COUNT + 1
RAW_TOL = 1e-3
TIE_TOL = 1e-4
PART_RTOL = 1e-5
GRAD_TOL = 1e-4            # of the largest |gradient| of the level


def _cfg(zoo_mod, nc=NC):
    rows = zoo_mod.yolov7_tiny_rows()
    f, n, _, args = rows[-1]
    rows[-1] = [f, n, "IBin", args]
    return {"nc": nc, "depth_multiple": 1.0, "width_multiple": 0.25,
            "anchors": zoo_mod.ANCHORS_P5_TINY, "backbone": rows,
            "head": []}


def _specs(nc=NC):
    return (j_parse(_cfg(jzoo, nc), name="tiny-ibin"),
            t_parse(_cfg(tzoo, nc), name="tiny-ibin"))


@pytest.fixture(scope="module")
def jax_forward():
    j_spec, t_spec = _specs()
    assert j_spec.head_kind == t_spec.head_kind == "IBin"
    assert j_spec.no == t_spec.no == NC + 3 + 2 * N_BIN
    variables = random_variables(j_spec, seed=4)
    x = np.random.default_rng(1).uniform(0, 1, (2, IMG, IMG, 3)).astype(
        np.float32)
    pred, raw = jax.jit(lambda v, x: jyolo.YoloV7(j_spec).apply(
        v, x, training=False))(jax.tree.map(jnp.asarray, variables),
                               jnp.asarray(x))
    return (t_spec, variables, x, np.asarray(pred),
            [np.asarray(r) for r in raw])


def test_sigmoid_bin_decode_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (64, 5, N_BIN)).astype(np.float32)
    # exact ties: the first maximum wins in both packages
    pred[:8, :, 3] = pred[:8, :, 9] = 1.0
    pred[8:16, :, 1:] = 0.5
    got = t_ibin.sigmoid_bin_decode(torch.from_numpy(pred)).numpy()
    want = np.asarray(j_ibin.sigmoid_bin_decode(jnp.asarray(pred)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t_ibin.bin_centers().numpy(),
                                  np.asarray(j_ibin.bin_centers()))
    assert t_ibin._STEP == j_ibin._STEP and t_ibin.BIN_MAX == j_ibin.BIN_MAX


def _assert_decodes_match(got, want, want_raw):
    """got / want (B, N, nc + 5) decoded outputs within RAW_TOL, but for w
    or h where the argmax bin differs: there the best two JAX bin values
    (sigmoided, float64) lie within TIE_TOL, in under 1% of the rows."""
    raw = np.concatenate([r.reshape(r.shape[0], -1, r.shape[-1])
                          for r in want_raw], axis=1).astype(np.float64)
    bad = np.abs(got - want) > RAW_TOL
    assert not bad[..., [0, 1] + list(range(4, got.shape[-1]))].any()
    for col in (2, 3):
        rows = bad[..., col]
        k = col - 2
        sig = 1.0 / (1.0 + np.exp(-raw[..., 3 + k * N_BIN:
                                          2 + (k + 1) * N_BIN]))
        top2 = np.sort(sig, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0])[rows].max(initial=0) <= TIE_TOL
        assert rows.mean() < 0.01


@pytest.mark.parametrize("fused", [False, True])
def test_ibin_forward_and_decode_match_jax(jax_forward, fused):
    spec, variables, x, want_pred, want_raw = jax_forward
    sd = jax_variables_to_torch(variables, spec)
    if fused:
        sd = fuse_state_dict(sd)
        assert not any("head_i" in k or ".bn." in k for k in sd)
    model = YoloV7(spec, fused=fused).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        raw = model(torch.from_numpy(x))
        pred = decode_levels(raw, spec)
    assert len(raw) == len(want_raw) == 3
    for t, j in zip(raw, want_raw):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, atol=RAW_TOL, rtol=0)
        assert float(t.std()) > 1e-3
    assert pred.dtype == torch.float32
    assert tuple(pred.shape) == want_pred.shape == (
        2, sum((IMG // s) ** 2 * 3 for s in spec.strides), NC + 5)
    _assert_decodes_match(pred.numpy(), want_pred, want_raw)
    # the decode itself on JAX's own levels: the same to float32 rounding
    exact = decode_levels([torch.tensor(r) for r in want_raw], spec)
    np.testing.assert_allclose(exact.numpy(), want_pred, atol=1e-5,
                               rtol=1e-6)


def test_ibin_heads_init_and_sharpen_at_the_shifted_slots():
    """No bias prior on IBin (as in JAX); sharpening raises objectness at
    46 and the class logits from 47, not the bins at 4 and 5."""
    _, spec = _specs()
    assert obj_index(spec) == 2 + 2 * N_BIN
    assert obj_index(tzoo.get_spec("yolov7-tiny", nc=NC)) == 4
    sd = {k: v.clone() for k, v in YoloV7(spec).state_dict().items()}
    for i in range(spec.nl):
        sd[f"head_m_{i}.bias"].zero_()
    sharpen_heads(sd, spec, obj_boost=6.0, jitter=0.0)
    b = sd["head_m_0.bias"].view(spec.na, spec.no)
    assert torch.all(b[:, :46] == 0)
    assert torch.all(b[:, 46:] == 6.0)
    j_spec, _ = _specs()
    prior = jyolo.init_head_biases(
        {"params": random_variables(j_spec)["params"]}, j_spec)
    assert not np.asarray(prior["params"]["head_m_0"]["bias"]).any()


def _pipeline_variables(j_spec):
    """Seeded variables whose bin logits have a clear best bin per anchor
    (w and h), so that no near tie moves a decoded box between the
    packages, and raised objectness / class logits."""
    variables = random_variables(j_spec, seed=8)
    rng = np.random.default_rng(9)
    params = dict(variables["params"])
    for i in range(j_spec.nl):
        v = dict(params[f"head_m_{i}"])
        b = v["bias"].reshape(j_spec.na, j_spec.no).copy()
        for k in (0, 1):
            b[np.arange(j_spec.na),
              3 + k * N_BIN + rng.integers(0, N_BIN - 1, j_spec.na)] += 6.0
        b[:, 46] += 2.0
        b[:, 47:] += 1.0
        v["bias"] = b.reshape(-1).astype(np.float32)
        params[f"head_m_{i}"] = v
    return {"params": params, "batch_stats": variables["batch_stats"]}


def test_ibin_pipeline_detections_match_jax():
    """detect_batch on IBin: the decoded-path NMS in both packages (float32,
    BN and ia / im folded), the same boxes, scores and classes."""
    j_spec, t_spec = _specs()
    variables = _pipeline_variables(j_spec)
    kw = dict(model="tiny-ibin", nc=NC, img_size=IMG, detector_batch=2,
              conf_thres=0.3)
    port = TrackingPipeline(
        PipelineConfig(dtype="float32", **kw),
        TS.TrackerConfig(tracker="sort", det_capacity=300),
        state_dict=jax_variables_to_torch(variables, t_spec), spec=t_spec,
        device="cpu")
    jpipe = j_pipeline.TrackingPipeline(
        j_pipeline.PipelineConfig(dtype="float32", wpack=False, **kw),
        JS.TrackerConfig(tracker="sort", det_capacity=300),
        variables=jax.tree.map(jnp.asarray, variables), spec=j_spec)
    frames = np.random.default_rng(3).integers(
        0, 255, (2, 96, 160, 3), dtype=np.uint8)
    got = [x.numpy() for x in port.detect_batch(frames)]
    want = [np.asarray(x) for x in jpipe.detect_batch(frames)]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].min() > 5
    for b, n in enumerate(got[3]):
        left = list(range(n))
        for i in range(n):
            j = next(j for j in left
                     if abs(got[1][b, i] - want[1][b, j]) <= 1e-5
                     and np.abs(got[0][b, i] - want[0][b, j]).max() <= 1e-3
                     and got[2][b, i] == want[2][b, j])
            left.remove(j)


def test_convert_ibin_reference_layout():
    """An IBin reference state_dict (m, ia, im as IDetect's) converts as the
    JAX converter carried over by from_jax, bit for bit, and runs."""
    j_spec, t_spec = _specs()
    ref_sd = to_reference(random_variables(j_spec, seed=5), j_spec)
    assert any(".ia.0.implicit" in k for k in ref_sd)
    got = convert.convert_state_dict(ref_sd, t_spec)
    _assert_same(got, _jax_way(ref_sd, j_spec))
    YoloV7(t_spec).load_state_dict(got)


def _targets(rng, bsz, n, t_cap=16):
    t = np.zeros((bsz, t_cap, 5), np.float32)
    m = np.zeros((bsz, t_cap), bool)
    t[:, :n, 0] = rng.integers(0, NC, (bsz, n))
    t[:, :n, 1:3] = rng.uniform(0.1, 0.9, (bsz, n, 2))
    t[:, :n, 3:5] = rng.uniform(0.03, 0.6, (bsz, n, 2))
    t[:, 4] = t[:, 0]                          # a tied pair of costs
    m[:, :n] = True
    return t, m


@pytest.fixture(scope="module")
def bin_case():
    j_spec, t_spec = _specs()
    rng = np.random.default_rng(11)
    preds = [rng.normal(0, 1.5, (2, IMG // s, IMG // s, j_spec.na,
                                  j_spec.no)).astype(np.float32)
             for s in j_spec.strides]
    targets, tmask = _targets(rng, 2, 7)
    hyp = jloss.Hyp(label_smoothing=0.1)

    def total(ps, t, m):
        return jloss.compute_loss_bin_ota(ps, t, m, j_spec, IMG, hyp)

    (loss, parts), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [jnp.asarray(p) for p in preds], jnp.asarray(targets),
        jnp.asarray(tmask))
    want = {"total": float(loss), **{k: float(v) for k, v in parts.items()},
            "grads": [np.asarray(g) for g in grads]}
    return j_spec, t_spec, preds, targets, tmask, want


def test_simota_assign_bin_wh_matches_jax(bin_case):
    j_spec, t_spec, preds, targets, tmask, _ = bin_case
    hyp = jloss.Hyp()
    flat, metas = jloss._flatten_preds([jnp.asarray(p) for p in preds])
    anchors = jnp.asarray(j_spec.anchors_per_level())
    want = jax.jit(jax.vmap(lambda pf, t, m: jloss.simota_assign(
        pf, metas, j_spec.strides, anchors, t, m, IMG, NC, hyp,
        bin_wh=True)))(flat, jnp.asarray(targets), jnp.asarray(tmask))
    t_flat, t_metas = tloss._flatten_preds([torch.from_numpy(p)
                                            for p in preds])
    got = tloss.simota_assign(
        t_flat, t_metas, t_spec.strides, tloss._anchors(t_spec, "cpu"),
        torch.from_numpy(targets), torch.from_numpy(tmask), IMG, NC,
        tloss.Hyp(), bin_wh=True)
    assert int(want["matched"].sum()) > 10
    for k in ("matched", "gi", "gj"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    m = np.asarray(want["matched"])
    np.testing.assert_array_equal(got["matched_gt"].numpy()[m],
                                  np.asarray(want["matched_gt"])[m])


def test_compute_loss_bin_ota_matches_jax(bin_case):
    _, spec, preds, targets, tmask, want = bin_case
    tp = [torch.tensor(p, requires_grad=True) for p in preds]
    loss, parts = tloss.compute_loss_bin_ota(
        tp, torch.tensor(targets), torch.tensor(tmask), spec, IMG,
        tloss.Hyp(label_smoothing=0.1))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want["total"],
                               rtol=PART_RTOL)
    for k in ("box", "obj", "cls", "loss"):
        np.testing.assert_allclose(float(parts[k].detach()), want[k],
                                   rtol=PART_RTOL, err_msg=k)
    for li, (p, g) in enumerate(zip(tp, want["grads"])):
        np.testing.assert_allclose(p.grad.numpy(), g,
                                   atol=GRAD_TOL * np.abs(g).max(), rtol=0,
                                   err_msg=f"level {li}")
        # the bins, objectness and class channels all receive gradient
        assert np.abs(g[..., 2:2 * N_BIN + 2]).max() > 0
        assert np.abs(p.grad[..., 46:].numpy()).max() > 0


def test_train_step_on_ibin_as_jax_shows_it():
    """JAX's train step sends a non-aux head to compute_loss_ota (the OTA
    default): on IBin levels its class cost meets nc + 42 columns and
    raises for nc > 1; at nc = 1 it runs, reading the first w-bin logit
    (channel 4) as objectness and never IBin's objectness at 46. The
    port's make_train_state refuses IBin."""
    j_spec, t_spec = _specs()
    rng = np.random.default_rng(2)
    preds = [rng.normal(0, 1, (1, IMG // s, IMG // s, 3, j_spec.no)).astype(
        np.float32) for s in j_spec.strides]
    targets, tmask = _targets(rng, 1, 3)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jloss.compute_loss_ota([jnp.asarray(p) for p in preds], targets,
                               tmask, j_spec, IMG)
    j1, t1 = _specs(nc=1)
    targets[..., 0] = 0
    preds = [rng.normal(0, 1, (1, IMG // s, IMG // s, 3, j1.no)).astype(
        np.float32) for s in j1.strides]

    obj = jax.jit(lambda ps: jloss.compute_loss_ota(
        ps, targets, tmask, j1, IMG)[1]["obj"])

    def obj_part(ps):
        return float(obj([jnp.asarray(p) for p in ps]))

    base = obj_part(preds)
    for ch, moves in ((4, True), (46, False)):
        bumped = [p.copy() for p in preds]
        for p in bumped:
            p[..., ch] += 2.0
        assert (obj_part(bumped) != base) == moves, ch
    for spec in (t_spec, t1):
        with pytest.raises(NotImplementedError, match="compute_loss_bin_ota"):
            tts.make_train_state(spec, device="cpu")
