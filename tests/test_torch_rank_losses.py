"""The port's ranking losses (train/rank_losses.py: RankSort, aLRP and AP as
torch.autograd.Functions) against the JAX package's custom_vjps on the
same seeded (N,) logits, targets and masks, at N = 64 to 512 over several
seeds: binary targets, soft ones (RankSort's IoU targets; for aLRP and AP
values between 0 and 1 that are neither positive nor background), no
positive at all, and everything masked out. Values within 1e-5 relative
(1e-6 absolute) and gradients within 1e-5 of the largest |gradient|,
float32: the port sums its (N, N) rows by matrix-vector products and AP's
scan by a running max, in another order than JAX. The backward scales by
the first output's cotangent only, as the JAX bwds do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import one_torch_thread  # noqa: F401
from yolov7_tracker_tpu.train import rank_losses as jrl
from yolov7_tracker_tpu_torch.train import rank_losses as trl

VAL_RTOL, VAL_ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5            # of the largest |gradient|

# kind: (N, seeds)
KINDS = {"binary": (64, (0, 1, 2)), "soft": (200, (3, 4)),
         "binary_512": (512, (5, 6)), "soft_512": (512, (7,)),
         "no_positive": (128, (8,)), "all_masked": (96, (9,))}


def _inputs(kind, loss, n, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, n).astype(np.float32)
    pos = rng.uniform(0, 1, n) < 0.15
    t = np.zeros(n, np.float32)
    if kind.startswith("soft"):
        if loss == "rank_sort":
            t[pos] = rng.uniform(0.1, 1.0, pos.sum())
        else:
            t[pos] = 1.0
            soft = (rng.uniform(0, 1, n) < 0.1) & ~pos
            t[soft] = rng.uniform(0.2, 0.9, soft.sum())
    elif kind != "no_positive":
        t[pos] = 1.0 if loss != "rank_sort" else rng.uniform(
            0.5, 1.0, pos.sum())
    valid = rng.uniform(0, 1, n) < 0.9
    if kind == "all_masked":
        valid[:] = False
    reg = rng.uniform(0, 1, n).astype(np.float32)
    return logits, t, valid, reg


def _jax_run(loss, logits, t, valid, reg):
    """JAX's outputs and d/dlogits of 2 * out[0] + 3 * out[1] (out[1]'s
    cotangent is ignored by the custom_vjp)."""
    t, valid, reg = jnp.asarray(t), jnp.asarray(valid), jnp.asarray(reg)
    if loss == "rank_sort":
        f = lambda l: jrl.rank_sort_loss(l, t, valid)           # noqa: E731
    elif loss == "alrp":
        f = lambda l: jrl.alrp_loss(l, t, reg, valid)           # noqa: E731
    else:
        f = lambda l: (jrl.ap_loss(l, t, valid),)              # noqa: E731

    def obj(l):
        out = f(l)
        return 2.0 * out[0] + (3.0 * jnp.sum(out[1]) if len(out) > 1
                               else 0.0)

    outs = jax.jit(f)(jnp.asarray(logits))
    grad = jax.jit(jax.grad(obj))(jnp.asarray(logits))
    return [np.asarray(o) for o in outs], np.asarray(grad)


def _port_run(loss, logits, t, valid, reg):
    lt = torch.tensor(logits, requires_grad=True)
    args = (torch.tensor(t), torch.tensor(valid))
    if loss == "rank_sort":
        out = trl.rank_sort_loss(lt, *args)
    elif loss == "alrp":
        out = trl.alrp_loss(lt, args[0], torch.tensor(reg), args[1])
    else:
        out = (trl.ap_loss(lt, *args),)
    obj = 2.0 * out[0] + (3.0 * out[1].sum() if len(out) > 1 else 0.0)
    obj.backward()
    return [o.detach().numpy() for o in out], lt.grad.numpy()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("loss", ["rank_sort", "alrp", "ap"])
def test_rank_loss_matches_jax(loss, kind):
    n, seeds = KINDS[kind]
    for seed in seeds:
        inputs = _inputs(kind, loss, n, seed)
        want, want_g = _jax_run(loss, *inputs)
        got, got_g = _port_run(loss, *inputs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=VAL_RTOL, atol=VAL_ATOL,
                                       err_msg=f"{loss} {kind} {seed}")
        scale = np.abs(want_g).max()
        np.testing.assert_allclose(got_g, want_g, rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-30),
                                   err_msg=f"{loss} {kind} {seed}")
        if kind in ("no_positive", "all_masked"):
            assert not got_g.any()
        else:
            assert scale > 0


@pytest.mark.parametrize("loss", ["rank_sort", "alrp", "ap"])
def test_rank_losses_are_autograd_functions(loss):
    """Each is a torch.autograd.Function; delta is a constant (changing it
    changes the function, and no gradient reaches it), targets, masks and
    aLRP's reg_losses get none."""
    cls = {"rank_sort": trl.RankSortLoss, "alrp": trl.ALRPLoss,
           "ap": trl.APLoss}[loss]
    assert issubclass(cls, torch.autograd.Function)
    logits, t, valid, reg = _inputs("binary", loss, 64, 0)
    tt = torch.tensor(t, requires_grad=True)
    rt = torch.tensor(reg, requires_grad=True)
    lt = torch.tensor(logits, requires_grad=True)
    vt = torch.tensor(valid)
    out = (trl.rank_sort_loss(lt, tt, vt) if loss == "rank_sort" else
           trl.alrp_loss(lt, tt, rt, vt) if loss == "alrp" else
           (trl.ap_loss(lt, tt, vt),))
    out[0].backward()
    assert tt.grad is None and rt.grad is None and lt.grad.abs().max() > 0
    other = (trl.rank_sort_loss(lt, tt, vt, 0.25) if loss == "rank_sort"
             else trl.alrp_loss(lt, tt, rt, vt, 0.5) if loss == "alrp"
             else (trl.ap_loss(lt, tt, vt, 0.5),))
    assert float(other[0].detach()) != float(out[0].detach())
