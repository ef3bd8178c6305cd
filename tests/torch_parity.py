"""Shared inputs for the tests that hold the PyTorch port
(yolov7_tracker_tpu_torch) against the JAX package: a narrowed yolov7-w6
spec and seeded numpy weights for it, and a fixture that runs a test
module's torch ops on one thread."""

import numpy as np
import pytest
import torch

import jax

from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models import zoo as jzoo

from tests.torch_train_cfgs import (narrow_aux_cfg,  # noqa: F401
                                   narrow_idetect_cfg, seeded_batch)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers at once. The port's CPU paths
    are many small ops, which slow down tenfold when every worker also
    runs one torch thread per core; a test module that imports this
    fixture runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_w6_cfg(nc=8):
    """yolov7-w6 rows at width_multiple 0.125 (channels 8..128)."""
    return {"nc": nc, "depth_multiple": 1.0, "width_multiple": 0.125,
            "anchors": jzoo.ANCHORS_P6, "backbone": jzoo.yolov7_w6_rows(),
            "head": []}


def random_variables(spec, seed=0):
    """Unfused Flax variables as numpy: lecun-normal kernels, random BN
    affine terms and statistics, implicit vectors near 0 / 1, zero head
    biases plus the head prior. Shapes come from the JAX model (zeros
    init, no tracing of random ops)."""
    _, zeros = jyolo.build_model(spec, img_size=64, init="zeros")
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = path[-1].key
        top = path[0].key
        shape = x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "implicit":
            base = 0.0 if top.startswith("head_ia") else 1.0
            return (base + 0.02 * rng.standard_normal(shape)).astype(
                np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "bias" and not top.startswith("head_m"):
            return rng.normal(0, 0.05, shape).astype(np.float32)
        return np.zeros(shape, np.float32)

    variables = {
        "params": jax.tree_util.tree_map_with_path(fill, zeros["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            fill, zeros["batch_stats"]),
    }
    prior = jyolo.init_head_biases({"params": dict(variables["params"])},
                                   spec)["params"]
    return {"params": jax.tree.map(np.asarray, prior),
            "batch_stats": variables["batch_stats"]}


def sharpen_heads(variables, spec, sharpen=8.0, obj_boost=6.0, jitter=3.0,
                  seed=1, levels=None):
    """bench.py:46-72's head sharpening on a numpy variable tree, so
    random weights give a real detection load. ``levels``: the head
    levels to sharpen (default all)."""
    rng = np.random.default_rng(seed)
    params = dict(variables["params"])
    for k in sorted(params):
        if not k.startswith("head_m"):
            continue
        if levels is not None and int(k.rsplit("_", 1)[1]) not in levels:
            continue
        v = dict(params[k])
        v["kernel"] = v["kernel"] * sharpen
        b = v["bias"].reshape(spec.na, spec.no).copy()
        b[:, 4] += obj_boost
        b[:, 5:] += obj_boost + rng.uniform(-jitter, jitter,
                                            (spec.na, spec.no - 5))
        v["bias"] = b.reshape(-1).astype(np.float32)
        params[k] = v
    return {"params": params, "batch_stats": variables["batch_stats"]}


def jax_train_runs(j_spec, opt_cfg, hyp, img, batches, starts):
    """Run the JAX package's train step (one step function, data_mesh(1))
    from a seeded fresh state: for each ``(start_step, n_steps)`` of
    ``starts``, n_steps steps over ``batches`` from the fresh state with
    ``step`` set to start_step. Returns (fresh state, [[(state, metrics)
    after each step] per start]) with numpy leaves."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from yolov7_tracker_tpu.parallel import train_step as jts
    from yolov7_tracker_tpu.parallel.mesh import data_mesh, shard_batch

    mesh = data_mesh(1)
    fresh = jts.make_train_state(j_spec, img_size=img, opt_cfg=opt_cfg,
                                 mesh=mesh, rng=jax.random.PRNGKey(0))
    fresh = jax.tree.map(np.asarray, fresh)
    step = jts.make_train_step(j_spec, mesh, img_size=img, hyp=hyp,
                               opt_cfg=opt_cfg)
    runs = []
    for start, n in starts:
        state = jax.device_put(fresh._replace(step=np.int32(start)),
                               NamedSharding(mesh, P()))
        out = []
        for b in batches[:n]:
            state, metrics = step(state, *shard_batch(mesh, b))
            out.append((jax.tree.map(np.asarray, state),
                        {k: float(v) for k, v in metrics.items()}))
        runs.append(out)
    return fresh, runs


def state_within(got, want, tol):
    """Every float tensor of the port's TrainState.state_dict() ``got``
    within ``tol`` of each ``want`` tensor's largest |value| (sections
    model, ema, momentum, grad_acc). Returns the worst ratio."""
    worst = 0.0
    for sec in ("model", "ema", "momentum", "grad_acc"):
        if want[sec] is None:
            assert got[sec] is None, sec
            continue
        for k, w in want[sec].items():
            if not w.is_floating_point():
                continue
            err = (got[sec][k] - w).abs().max().item()
            scale = w.abs().max().item()
            assert err <= tol * scale or err == 0.0, (sec, k, err, scale)
            worst = max(worst, err / scale if scale else 0.0)
    assert got["step"] == want["step"]
    assert got["ema_count"] == want["ema_count"]
    return worst
