"""The port's SimOTA losses (yolov7_tracker_tpu_torch/train/loss.py)
against the JAX package's on the same seeded raw head levels: the
assignments equal (tied costs from duplicate targets and two matches on
one objectness cell included), the loss parts of compute_loss,
compute_loss_ota and compute_loss_aux_ota within 1e-5 relative, and the
gradients with respect to the raw preds within 1e-4 of the largest."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import one_torch_thread  # noqa: F401
from yolov7_tracker_tpu.models import zoo as jzoo
from yolov7_tracker_tpu.train import loss as jloss
from yolov7_tracker_tpu_torch.models import zoo as tzoo
from yolov7_tracker_tpu_torch.train import loss as tloss

IMG = 64
PART_RTOL = 1e-5
GRAD_TOL = 1e-4      # of the largest |gradient| of the level


def _targets(rng, bsz, n, t_cap=16, nc=8, dup=False):
    """(B, T, 5) normalised targets with n valid rows an image; dup=True
    repeats rows 0 and 1 as rows 2 and 3 (tied costs) and puts row 4 on
    row 0's centre at a smaller size (two matches on one cell)."""
    t = np.zeros((bsz, t_cap, 5), np.float32)
    m = np.zeros((bsz, t_cap), bool)
    for b in range(bsz):
        t[b, :n, 0] = rng.integers(0, nc, n)
        t[b, :n, 1:3] = rng.uniform(0.1, 0.9, (n, 2))
        t[b, :n, 3:5] = rng.uniform(0.05, 0.6, (n, 2))
        if dup:
            t[b, 2:4] = t[b, 0:2]
            t[b, 4, :3] = t[b, 0, :3]
            t[b, 4, 3:5] = t[b, 0, 3:5] * 0.8
        m[b, :n] = True
    return t, m


def _preds(rng, spec, bsz, n_heads):
    return [rng.normal(0, 1.5, (bsz, IMG // s, IMG // s, spec.na, spec.no)
                       ).astype(np.float32)
            for s in (list(spec.strides) * 2)[:n_heads]]


def _specs(name):
    return jzoo.get_spec(name, nc=8), tzoo.get_spec(name, nc=8)


CASES = {   # name: (model, loss function, n_targets, duplicates)
    "ota": ("yolov7-tiny", "compute_loss_ota", 6, False),
    "ota_ties": ("yolov7-tiny", "compute_loss_ota", 6, True),
    "plain": ("yolov7-tiny", "compute_loss", 6, False),
    "aux": ("yolov7-w6", "compute_loss_aux_ota", 7, True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    model, fn, n, dup = CASES[request.param]
    j_spec, t_spec = _specs(model)
    rng = np.random.default_rng(len(request.param))
    n_heads = 2 * j_spec.nl if fn == "compute_loss_aux_ota" else j_spec.nl
    preds = _preds(rng, j_spec, 2, n_heads)
    targets, tmask = _targets(rng, 2, n, dup=dup)
    hyp = jloss.Hyp(label_smoothing=0.1)

    def total(ps, t, m):
        return getattr(jloss, fn)(ps, t, m, j_spec, IMG, hyp)

    (loss, parts), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [jnp.asarray(p) for p in preds], jnp.asarray(targets),
        jnp.asarray(tmask))
    want = {"total": float(loss), **{k: float(v) for k, v in parts.items()},
            "grads": [np.asarray(g) for g in grads]}
    return request.param, fn, t_spec, preds, targets, tmask, want


def test_loss_parts_and_grads_match_jax(case):
    name, fn, spec, preds, targets, tmask, want = case
    tp = [torch.tensor(p, requires_grad=True) for p in preds]
    hyp = tloss.Hyp(label_smoothing=0.1)
    loss, parts = getattr(tloss, fn)(tp, torch.tensor(targets),
                                     torch.tensor(tmask), spec, IMG, hyp)
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


def _jax_assign(spec, preds, targets, tmask, topk, g):
    hyp = jloss.Hyp()
    flat, metas = jloss._flatten_preds([jnp.asarray(p) for p in preds])
    anchors = jnp.asarray(spec.anchors_per_level())
    out = jax.vmap(lambda pf, t, m: jloss.simota_assign(
        pf, metas, spec.strides, anchors, t, m, IMG, spec.nc, hyp,
        topk=topk, g=g))(flat, jnp.asarray(targets), jnp.asarray(tmask))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("topk,g", [(10, 0.5), (20, 1.0)])
def test_simota_assign_matches_jax_with_ties(topk, g):
    """Duplicate targets tie their costs row for row (the min-cost GT of
    a shared candidate is the first); target 4 shares target 0's centre,
    so two matched slots land on one objectness cell, where the loss keeps
    the larger IoU."""
    j_spec, t_spec = _specs("yolov7-w6")
    rng = np.random.default_rng(7)
    preds = _preds(rng, j_spec, 2, j_spec.nl)
    targets, tmask = _targets(rng, 2, 7, dup=True)
    want = _jax_assign(j_spec, preds, targets, tmask, topk, g)
    flat, metas = tloss._flatten_preds([torch.tensor(p) for p in preds])
    got = tloss.simota_assign(
        flat, metas, t_spec.strides, tloss._anchors(t_spec, "cpu"),
        torch.tensor(targets), torch.tensor(tmask), IMG, t_spec.nc,
        tloss.Hyp(), topk=topk, g=g)
    for k in ("matched", "matched_gt", "gi", "gj"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    m = want["matched"]
    assert m.any()
    # both duplicates of a pair claim candidates; the second never wins one
    mgt = np.where(m, want["matched_gt"], -1)
    assert ((mgt == 0).any() or (mgt == 1).any())
    assert not (mgt == 2).any() and not (mgt == 3).any()
    # two matched slots on one (level, cell, anchor) of one image
    a_ids = np.arange(j_spec.na)[None, :, None]
    shared = False
    for b in range(2):
        for li, (ny, nx, _) in enumerate(metas):
            cell = (want["gj"][b, :, li] * nx + want["gi"][b, :, li]
                    ) * j_spec.na + a_ids
            cells = cell[m[b, :, li]]
            shared |= len(cells) > len(np.unique(cells))
    assert shared


def test_candidate_grid_matches_jax():
    j_spec, t_spec = _specs("yolov7-w6")
    rng = np.random.default_rng(3)
    targets, tmask = _targets(rng, 2, 9)
    metas = [(IMG // s, IMG // s, 0) for s in j_spec.strides]
    anchors = jnp.asarray(j_spec.anchors_per_level())
    for g in (0.5, 1.0):
        want = [jax.vmap(lambda t, m: jloss._candidate_grid(
            metas, j_spec.strides, anchors, t[:, 1:5] * IMG, m,
            jloss.Hyp(), g)[i])(jnp.asarray(targets), jnp.asarray(tmask))
            for i in range(4)]
        got = tloss._candidate_grid(
            metas, t_spec.strides, tloss._anchors(t_spec, "cpu"),
            torch.tensor(targets)[..., 1:5] * IMG, torch.tensor(tmask),
            tloss.Hyp(), g)
        for w, t in zip(want, got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_bce_variants_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (64,)).astype(np.float32)
    t = rng.uniform(0, 1, (64,)).astype(np.float32)
    xt, tt = torch.tensor(x), torch.tensor(t)
    pairs = [
        (jloss._bce(x, t, 1.5), tloss._bce(xt, tt, 1.5)),
        (jloss.focal_bce(x, t, 1.5), tloss.focal_bce(xt, tt, 1.5)),
        (jloss.qfocal_bce(x, t, 1.5), tloss.qfocal_bce(xt, tt, 1.5)),
        (jloss.bce_blur(x, t), tloss.bce_blur(xt, tt)),
    ]
    for j, p in pairs:
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    assert tloss.smooth_bce(0.1) == jloss.smooth_bce(0.1)
    for nl in (3, 4, 5):
        assert tloss._balance(nl) == jloss._balance(nl)
