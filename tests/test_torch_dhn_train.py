"""The port's DHN trainer (train/dhn_train.py) and its Flax msgpack writer
(utils/flax_msgpack.dumps / save_variables, models/from_jax.dhn_variables)
against the JAX package on the CPU:

- make_problem and a step's batch byte-equal to JAX's from one seed,
  plain and padded;
- weighted_focal_bce within 1e-6 relative;
- one Adam step of each arch (GRU at hidden 8, Sinkhorn) from JAX's init:
  the loss within 1e-5 relative and every gradient within 1e-5 of its
  tensor's largest |value| (float32) against jax.value_and_grad; the
  parameters after optax.adam's step within 1e-6 absolute (lr 3e-4)
  wherever |g| is above 1e-3 of its tensor's largest (Adam's first step
  is about lr * sign(g): a component near zero may take either sign);
- the GRU's r / z hidden biases still zero after steps, the exported tree
  round-tripping;
- eval_dhn on JAX's weights equal to JAX's;
- the writer byte for byte against flax.serialization.to_bytes, the file
  read by JAX's checkpoint.load_variables and the JAX DHN, and a JAX file
  read back by the port;
- ``main --device cpu`` writing a file that load_dhn reads and the port's
  deepmot runs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from tests.test_torch_trackers import BASE, feature_stream
from tests.torch_parity import one_torch_thread  # noqa: F401
from yolov7_tracker_tpu.reid import dhn as jdhn
from yolov7_tracker_tpu.train import dhn_train as jtrain
from yolov7_tracker_tpu.utils import checkpoint as jckpt
from yolov7_tracker_tpu_torch.models.from_jax import (dhn_state_dict,
                                                      dhn_variables)
from yolov7_tracker_tpu_torch.reid import dhn as tdhn
from yolov7_tracker_tpu_torch.train import dhn_train as ttrain
from yolov7_tracker_tpu_torch.trackers import slab as TS
from yolov7_tracker_tpu_torch.trackers.registry import build_tracker
from yolov7_tracker_tpu_torch.utils import flax_msgpack

LR = 3e-4
SIZE = 5
HIDDEN = 8
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
PARAM_ATOL = 1e-6
MOVED = 1e-3               # |g| above this share of its tensor's largest


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_make_problem_and_batches_match_jax():
    for pad in (None, (7, 6)):
        for seed in range(3):
            a = ttrain.make_problem(np.random.default_rng(seed), 4, 6, pad)
            b = jtrain.make_problem(np.random.default_rng(seed), 4, 6, pad)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.float32
                assert x.tobytes() == y.tobytes()
    # a padded training step's batch, drawn as JAX's train_dhn draws it
    rng = np.random.default_rng(4)
    d, y = ttrain.sample_batch(rng, 6, 6, pad_train=True, batch=3)
    rng = np.random.default_rng(4)
    want = []
    for _ in range(3):
        hv, wv = int(rng.integers(1, 7)), int(rng.integers(1, 7))
        want.append(jtrain.make_problem(rng, hv, wv, pad_to=(6, 6)))
    assert d.tobytes() == np.stack([w[0] for w in want]).tobytes()
    assert y.tobytes() == np.stack([w[1] for w in want]).tobytes()
    assert (d == 1.0).any() and y.sum() > 0


def test_weighted_focal_bce_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (3, 6, 5)).astype(np.float32)
    pred[0, 0, :2] = (0.0, 1.0)                   # clipped
    _, y = ttrain.sample_batch(rng, 6, 5, batch=3)
    y[2] = 0.0                                    # no positive
    got = ttrain.weighted_focal_bce(torch.from_numpy(pred),
                                    torch.from_numpy(y)).numpy()
    want = np.array([float(jtrain.weighted_focal_bce(jnp.asarray(p),
                                                     jnp.asarray(t)))
                     for p, t in zip(pred, y)])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _jax_step(arch, variables, d, y):
    """JAX's train_dhn step: value_and_grad of the batch-mean loss, then
    optax.adam. Returns (loss, grads, new variables), numpy."""
    model = jdhn.build_dhn(arch, HIDDEN)
    tx = optax.adam(LR)

    def loss_fn(v):
        return jnp.mean(jax.vmap(lambda di, yi: jtrain.weighted_focal_bce(
            model.apply(v, di), yi))(d, y))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    updates, _ = tx.update(grads, tx.init(variables))
    return (float(loss), _np_tree(grads),
            _np_tree(optax.apply_updates(variables, updates)))


@pytest.fixture(scope="module", params=["gru", "sinkhorn"])
def jax_init(request):
    arch = request.param
    variables = jax.jit(jdhn.build_dhn(arch, HIDDEN).init)(
        jax.random.PRNGKey(0), jnp.zeros((SIZE, SIZE)))
    return arch, _np_tree(variables)


def test_one_adam_step_matches_jax(jax_init):
    arch, variables = jax_init
    d, y = ttrain.sample_batch(np.random.default_rng(0), SIZE, SIZE,
                               pad_train=True, batch=2)
    loss, grads, after = _jax_step(arch, variables, jnp.asarray(d),
                                   jnp.asarray(y))
    model, opt = ttrain.build_trainer(
        arch, HIDDEN, LR, device="cpu",
        state_dict=dhn_state_dict(variables, arch))
    got = ttrain.train_step(model, opt, torch.from_numpy(d),
                            torch.from_numpy(y))
    np.testing.assert_allclose(float(got), loss, rtol=LOSS_RTOL)
    want_g = dhn_state_dict({"params": grads["params"]}, arch)
    want_p = dhn_state_dict(after, arch)
    n_moved = 0
    for name, p in model.named_parameters():
        g, wg = p.grad.numpy(), want_g[name].numpy()
        scale = np.abs(wg).max()
        np.testing.assert_allclose(g, wg, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)
        moved = np.abs(wg) > MOVED * scale
        np.testing.assert_allclose(p.detach().numpy()[moved],
                                   want_p[name].numpy()[moved], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        n_moved += int(moved.sum())
    assert n_moved > 50


def test_rz_hidden_biases_stay_zero_and_export_round_trips(tmp_path):
    model = ttrain.train_dhn(steps=4, h=SIZE, w=SIZE, hidden=HIDDEN,
                             pad_train=True, batch=2, log_every=0,
                             device="cpu")
    sd = model.state_dict()
    hh = [k for k in sd if "bias_hh" in k]
    assert len(hh) == 8
    for k in hh:
        assert not sd[k][:2 * HIDDEN].any(), k
        assert sd[k][2 * HIDDEN:].abs().max() > 0, k     # hn moved
    assert sd["lstm_row.bias_ih_l0"][:2 * HIDDEN].abs().max() > 0
    path = ttrain.save_dhn(str(tmp_path / "dhn.msgpack"), model, "gru")
    back = dhn_state_dict(flax_msgpack.load_variables(path), "gru")
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    bad = {k: v.clone() for k, v in sd.items()}
    bad["lstm_col.bias_hh_l1"][0] = 1.0
    with pytest.raises(ValueError, match="r / z hidden biases"):
        dhn_variables(bad, "gru")


def test_init_follows_flax_distributions():
    """Zero biases, lecun-normal input kernels (truncated at 2 std),
    orthogonal recurrent gate blocks; the Sinkhorn temperatures kept."""
    model = ttrain.init_dhn(tdhn.build_dhn("gru", 64), seed=3)
    w_hh = model.lstm_row.weight_hh_l0.detach()
    for j in range(3):
        blk = w_hh[j * 64:(j + 1) * 64]
        torch.testing.assert_close(blk @ blk.T, torch.eye(64), atol=1e-5,
                                   rtol=0)
    w_ih = model.lstm_col.weight_ih_l1.detach()          # fan_in 128
    std = (1.0 / 128) ** 0.5
    assert abs(float(w_ih.std()) / std - 1.0) < 0.05
    assert float(w_ih.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert all(not p.any() for n, p in model.named_parameters()
               if "bias" in n)
    sk = ttrain.init_dhn(tdhn.build_dhn("sinkhorn"), seed=3)
    torch.testing.assert_close(sk.log_tau.detach(),
                               torch.log(torch.tensor((0.02, 0.05, 0.15))))


def test_eval_dhn_matches_jax(jax_init):
    arch, variables = jax_init
    model = tdhn.build_dhn(arch, HIDDEN)
    model.load_state_dict(dhn_state_dict(variables, arch))
    got = ttrain.eval_dhn(model, n=6, h=SIZE, w=SIZE)
    want = jtrain.eval_dhn(jax.tree.map(jnp.asarray, variables), arch=arch,
                           hidden=HIDDEN, n=6, h=SIZE, w=SIZE)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert model.training             # eval_dhn restores the mode


def test_msgpack_writer_against_flax(jax_init, tmp_path):
    arch, variables = jax_init
    model = tdhn.build_dhn(arch, HIDDEN)
    model.load_state_dict(dhn_state_dict(variables, arch))
    tree = dhn_variables(model.state_dict(), arch)
    assert flax_msgpack.dumps(tree) == serialization.to_bytes(tree)
    path = flax_msgpack.save_variables(str(tmp_path / "p.msgpack"), tree)
    loaded = jckpt.load_variables(path)
    assert jax.tree.structure(loaded) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    d = np.random.default_rng(1).uniform(0, 1, (SIZE, SIZE)).astype(
        np.float32)
    want = np.asarray(jdhn.build_dhn(arch, HIDDEN).apply(
        jax.tree.map(jnp.asarray, loaded), jnp.asarray(d)))
    with torch.no_grad():
        got = tdhn.load_dhn(path, arch, HIDDEN, "cpu")(
            torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # and back: a file the JAX package writes
    jpath = jckpt.save_variables(str(tmp_path / "j.msgpack"), variables)
    back = dhn_state_dict(flax_msgpack.load_variables(jpath), arch)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("leaf", [1.5, None, True, [1, 2]])
def test_msgpack_writer_refuses_what_a_variable_tree_never_holds(leaf):
    with pytest.raises(TypeError):
        flax_msgpack.dumps({"params": {"x": leaf}})


def test_main_on_the_cpu_feeds_deepmot(tmp_path, capsys):
    out = tmp_path / "dhn_cli.msgpack"
    ttrain.main(["--steps", "3", "--size", "6", "--hidden", str(HIDDEN),
                 "--pad_train", "--batch", "2", "--device", "cpu",
                 "--out", str(out)])
    text = capsys.readouterr().out
    assert "eval: {'cell_acc':" in text and f"saved {out}" in text
    cfg = TS.TrackerConfig(**BASE, tracker="deepmot", track_buffer=6,
                           dhn_weights=str(out), dhn_hidden=HIDDEN)
    step, cfg = build_tracker(cfg, "cpu")
    calls = []
    dhn = step.keywords["dhn"]
    dhn.register_forward_hook(lambda *a: calls.append(1))
    slab = TS.init_slab(cfg, "cpu")
    ids = set()
    for tlbr, score, valid, _, warp in feature_stream(3, n_frames=6):
        slab, out_ = step(slab, TS.make_det_slab(
            cfg, tlbr, score, np.zeros_like(score), valid, "cpu", warp=warp))
        ids |= set(out_.track_id[out_.valid].tolist())
    assert len(calls) >= 5 and len(ids) >= 4
