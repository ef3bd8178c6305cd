"""The port's train step (yolov7_tracker_tpu_torch/parallel/train_step.py)
against the JAX package's on a narrow four-level IAuxDetect model
(tests/torch_parity.narrow_aux_cfg, 128 px, batch 2, the aux SimOTA
loss) with gradient accumulation to the nominal batch (batch 16, nominal
64): one step from a fresh converted state, and three steps from ni =
1002, where accumulate is 4 (carry, carry, apply). Parameters, EMA,
momentum buffers, the gradient sum and the BatchNorm statistics stay
within 1e-4 of each tensor's largest value. Also: the schedules (the
three LR groups, momentum, accumulate over ni = 0..3000) equal to JAX's,
torch's SGD against JAX's update, Flax's biased running variance, and
remat equal to no remat."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (jax_train_runs, narrow_aux_cfg,  # noqa: F401
                                one_torch_thread, random_variables,
                                seeded_batch, state_within)
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu.parallel import train_step as jts
from yolov7_tracker_tpu.train import loss as jloss
from yolov7_tracker_tpu_torch.models import blocks
from yolov7_tracker_tpu_torch.models.from_jax import (
    flax_leaf_name, jax_variables_to_torch)
from yolov7_tracker_tpu_torch.models.yolo import YoloV7
from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg as t_parse
from yolov7_tracker_tpu_torch.parallel import train_step as tts
from yolov7_tracker_tpu_torch.train import loss as tloss

IMG = 128
TOL = 1e-4           # of each tensor's largest |value|
LOSS_RTOL = 1e-4
OPT = dict(batch_size=16, nominal_batch=64, epochs=2, steps_per_epoch=4)
HYP = dict(label_smoothing=0.05)


def _specs():
    cfg = narrow_aux_cfg()
    return j_parse(cfg, name="aux"), t_parse(cfg, name="aux")


@pytest.fixture(scope="module")
def reference():
    j_spec, t_spec = _specs()
    batches = [seeded_batch(s, img=IMG) for s in range(3)]
    fresh, runs = jax_train_runs(j_spec, jts.OptConfig(**OPT),
                                 jloss.Hyp(**HYP), IMG, batches,
                                 [(0, 1), (1002, 3)])
    return t_spec, fresh, batches, runs


def _run(t_spec, fresh, batches, start, **kw):
    cfg = tts.OptConfig(**OPT)
    state = tts.train_state_from_jax(fresh._replace(step=np.int32(start)),
                                     t_spec, cfg, "cpu")
    step = tts.make_train_step(t_spec, img_size=IMG, hyp=tloss.Hyp(**HYP),
                               opt_cfg=cfg, **kw)
    out = []
    for b in batches:
        metrics = step(state, *(torch.tensor(x) for x in b))
        out.append(({k: {n: t.clone() for n, t in v.items()}
                     if isinstance(v, dict) else v
                     for k, v in state.state_dict().items()},
                    {k: float(v) for k, v in metrics.items()}))
    return state, out


def _want(t_spec, jax_state):
    return tts.train_state_from_jax(jax_state, t_spec,
                                    tts.OptConfig(**OPT), "cpu").state_dict()


def test_converted_state_round_trip(reference):
    t_spec, fresh, _, _ = reference
    state = tts.train_state_from_jax(fresh, t_spec, tts.OptConfig(**OPT),
                                     "cpu")
    sd = state.state_dict()
    assert sd["step"] == 0 and sd["ema_count"] == 0
    assert all(float(v.abs().max()) == 0 for v in sd["momentum"].values())
    assert all(float(v.abs().max()) == 0 for v in sd["grad_acc"].values())
    for n, p in state.model.named_parameters():
        assert torch.equal(p, sd["ema"][n])


def test_one_step_matches_jax(reference):
    t_spec, fresh, batches, runs = reference
    _, out = _run(t_spec, fresh, batches[:1], 0)
    (jstate, jmetrics), = runs[0]
    sd, metrics = out[0]
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert sd["ema_count"] == 1
    state_within(sd, _want(t_spec, jstate), TOL)


def test_three_steps_with_accumulation_match_jax(reference):
    """ni = 1002, 1003, 1004 with accumulate 4: the first two carry the
    gradient sum, the third applies it."""
    t_spec, fresh, batches, runs = reference
    assert [tts.accumulate_schedule(tts.OptConfig(**OPT), ni)
            for ni in (1002, 1003, 1004)] == [4.0, 4.0, 4.0]
    _, out = _run(t_spec, fresh, batches, 1002)
    for i, ((sd, metrics), (jstate, jmetrics)) in enumerate(zip(out,
                                                                runs[1])):
        for k, v in jmetrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        state_within(sd, _want(t_spec, jstate), TOL)
    assert [sd["ema_count"] for sd, _ in out] == [0, 0, 1]
    assert float(out[1][0]["grad_acc"]["layer1.conv.weight"].abs().max()) > 0
    assert all(float(v.abs().max()) == 0
               for v in out[2][0]["grad_acc"].values())


def test_remat_matches_no_remat(reference):
    """Recomputing the forward in the backward changes memory, not math;
    the BN statistics are updated once."""
    t_spec, fresh, batches, _ = reference
    _, plain = _run(t_spec, fresh, batches[:2], 0)
    _, remat = _run(t_spec, fresh, batches[:2], 0, remat=True)
    for (a, ma), (b, mb) in zip(plain, remat):
        assert ma == mb
        state_within(b, a, 1e-6)


def test_schedules_match_jax():
    """The bias group's and the other groups' LR, the momentum and the
    accumulate count at every ni of 0..3000, for two configurations."""
    ni = np.arange(3001)
    for kw in (OPT, dict(batch_size=8, nominal_batch=64, epochs=300,
                         steps_per_epoch=250, lrf=0.2)):
        jc, tc = jts.OptConfig(**kw), tts.OptConfig(**kw)
        steps = jnp.asarray(ni, jnp.int32)
        want = {
            "bias": np.asarray(jax.vmap(jts.one_cycle_lr(
                jc, jc.warmup_bias_lr))(steps)),
            "rest": np.asarray(jax.vmap(jts.one_cycle_lr(jc, 0.0))(steps)),
            "momentum": np.asarray(jax.vmap(jts.momentum_schedule(jc))(
                steps)),
            "accumulate": np.asarray(jax.vmap(jts.accumulate_schedule(jc))(
                steps)),
        }
        got = {
            "bias": [tts.one_cycle_lr(tc, i, tc.warmup_bias_lr) for i in ni],
            "rest": [tts.one_cycle_lr(tc, i) for i in ni],
            "momentum": [tts.momentum_schedule(tc, i) for i in ni],
            "accumulate": [tts.accumulate_schedule(tc, i) for i in ni],
        }
        np.testing.assert_array_equal(got["accumulate"], want["accumulate"])
        for k in ("bias", "rest", "momentum"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-9, err_msg=k)
        # the EMA decay as apply_update computes it, in float32
        n_upd = jnp.asarray([1, 10, 2000, 10 ** 6], jnp.int32)
        want_ema = np.asarray(jc.ema_decay * (
            1.0 - jnp.exp(-n_upd.astype(jnp.float32) / 2000.0)))
        # within a float32 ulp of 1: XLA's exp and numpy's differ in the
        # last bit, which 1 - exp(-n / 2000) at n = 1 makes 1e-4 relative
        np.testing.assert_allclose(
            [tts.ema_decay(tc, int(n)) for n in n_upd], want_ema, rtol=1e-6,
            atol=float(np.finfo(np.float32).eps))


def test_sgd_groups_and_update_match_jax(reference):
    """torch.optim.SGD(nesterov=True), with lr and momentum set before the
    step and zero buffers from the start, computes JAX's update for each
    of the three groups (weight decay on kernels only)."""
    t_spec, fresh, _, _ = reference
    kw = dict(OPT, batch_size=8)
    jc, tc = jts.OptConfig(**kw), tts.OptConfig(**kw)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(
        lambda p: rng.normal(0, 1, p.shape).astype(np.float32),
        fresh.params)
    bufs = jax.tree.map(
        lambda p: rng.normal(0, 0.1, p.shape).astype(np.float32),
        fresh.params)
    ni = 500
    tx = jts.make_optimizer(jc)
    upd, new_bufs = tx.update(grads, bufs, fresh.params, step=ni)
    want_params = jax.tree.map(lambda p, u: np.asarray(p + u),
                               fresh.params, upd)
    state = tts.train_state_from_jax(
        fresh._replace(opt_state=bufs), t_spec, tc, "cpu")
    named = dict(state.model.named_parameters())
    from yolov7_tracker_tpu_torch.models.from_jax import jax_params_to_torch
    for name, g in jax_params_to_torch(grads).items():
        named[name].grad = g
    tts.set_schedule(state.optimizer, tc, ni)
    state.optimizer.step()
    labels = jax.tree_util.tree_leaves_with_path(jts._group_labels(
        fresh.params))
    by_group = {g["name"]: {id(p) for p in g["params"]}
                for g in state.optimizer.param_groups}
    for name, p in named.items():
        leaf = flax_leaf_name(name, p)
        group = "kernel" if leaf == "kernel" else (
            "bias" if leaf == "bias" else "rest")
        assert id(p) in by_group[group], name
    assert len(labels) == len(named)
    for name, want in jax_params_to_torch(want_params).items():
        np.testing.assert_allclose(named[name].detach().numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, want in jax_params_to_torch(new_bufs).items():
        np.testing.assert_allclose(
            state.optimizer.state[named[name]]["momentum_buffer"].numpy(),
            want.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_running_variance_is_flax_biased():
    """Flax updates the running variance with the biased batch variance;
    torch's own BatchNorm2d would use the unbiased one, a factor n / (n -
    1) = 8 / 7 larger at n = 8 values a channel."""
    from flax import linen as fnn

    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 2.0, (2, 2, 2, 5)).astype(np.float32)   # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want = np.asarray(upd["batch_stats"]["var"])
    m = blocks.BatchNorm2d(5, eps=1e-5).train()
    sink = []
    with blocks.batch_stats_sink(sink):
        m(torch.tensor(x).permute(0, 3, 1, 2))
    blocks.update_running_stats(sink)
    np.testing.assert_allclose(m.running_var.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    unbiased = 0.9 + 0.1 * x.reshape(-1, 5).var(0, ddof=1)
    assert np.abs(m.running_var.numpy() - unbiased).max() > 1e-2


def test_training_forward_matches_jax():
    """The training call: all 2 * nl raw levels (lead, then aux; the aux
    heads' layers computed too) within 1e-4 of each level's largest value,
    and the BN running statistics Flax's training call leaves, biased
    variance included, within 1e-5 relative."""
    j_spec, t_spec = _specs()
    variables = random_variables(j_spec, seed=3)
    x = seeded_batch(5, img=IMG)[0]
    raw, upd = jax.jit(lambda v, x: jyolo.YoloV7(j_spec).apply(
        v, x, training=True, mutable=["batch_stats"]))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    model = YoloV7(t_spec)
    model.load_state_dict(jax_variables_to_torch(variables, t_spec))
    model.train()
    sink = []
    with torch.no_grad(), blocks.batch_stats_sink(sink):
        out = model(torch.tensor(x), training=True)
    blocks.update_running_stats(sink)
    assert len(out) == len(raw) == 2 * t_spec.nl
    for a, b in zip(out, raw):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    want = jax_variables_to_torch(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])},
        t_spec)
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == len(sink) * 2
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
