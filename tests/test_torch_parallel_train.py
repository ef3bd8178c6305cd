"""The port's data-parallel train step (parallel/train_step.py with a
mesh: global BatchNorm, global loss normalisers, one gradient all_reduce)
on 2 CPU ranks over gloo against the JAX package's step on data_mesh(2)
of its 8-device virtual CPU mesh: tests/torch_train_cfgs.py's narrow
IAuxDetect model at 128 px, global batch 4, the aux SimOTA loss, from one
converted state. The first batch leaves the second rank's shard without
a target, so per-rank normalisation (torch DDP's) would part from JAX
there. One step from ni = 0, and three from ni = 1002 with accumulation
(carry, carry, apply): parameters, EMA, momentum, the gradient sum and
the BatchNorm statistics within 1e-4 of each tensor's largest value, the
loss parts within 1e-4 relative, as tests/test_torch_train_step.py holds
the one-card step; and both ranks' states equal bit for bit."""

import datetime

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_parallel_ranks as ranks
from tests.torch_parity import (narrow_aux_cfg,  # noqa: F401 (autouse)
                                one_torch_thread, seeded_batch, state_within)
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu.parallel import mesh as jmesh
from yolov7_tracker_tpu.parallel import train_step as jts
from yolov7_tracker_tpu.train import loss as jloss
from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg as t_parse
from yolov7_tracker_tpu_torch.parallel import mesh as M
from yolov7_tracker_tpu_torch.parallel import train_step as tts

IMG = 128
TOL = 1e-4           # of each tensor's largest |value|
LOSS_RTOL = 1e-4
OPT = dict(batch_size=16, nominal_batch=64, epochs=2, steps_per_epoch=4)
HYP = dict(label_smoothing=0.05)
STARTS = [(0, 1), (1002, 3)]
TIMEOUT = datetime.timedelta(seconds=120)


def _batches():
    """Global batches of 4; in the first, images 2 and 3 (the second
    rank's shard) have no targets."""
    batches = [seeded_batch(s, img=IMG) for s in range(3)]
    batches[0][2][2:] = False
    return batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = narrow_aux_cfg()
    j_spec, t_spec = j_parse(cfg, name="aux"), t_parse(cfg, name="aux")
    batches = _batches()
    mesh = jmesh.data_mesh(2)
    opt = jts.OptConfig(**OPT)
    fresh = jax.tree.map(np.asarray, jts.make_train_state(
        j_spec, img_size=IMG, opt_cfg=opt, mesh=mesh,
        rng=jax.random.PRNGKey(0)))
    step = jts.make_train_step(j_spec, mesh, img_size=IMG,
                               hyp=jloss.Hyp(**HYP), opt_cfg=opt)
    want, port_runs = [], []
    for start, n in STARTS:
        state = jax.device_put(fresh._replace(step=np.int32(start)),
                               NamedSharding(mesh, P()))
        out = []
        for b in batches[:n]:
            state, metrics = step(state, *jmesh.shard_batch(mesh, b))
            out.append((tts.train_state_from_jax(
                jax.tree.map(np.asarray, state), t_spec,
                tts.OptConfig(**OPT), "cpu").state_dict(),
                {k: float(v) for k, v in metrics.items()}))
        want.append(out)
        sd = tts.train_state_from_jax(fresh._replace(step=np.int32(start)),
                                      t_spec, tts.OptConfig(**OPT),
                                      "cpu").state_dict()
        port_runs.append((sd, batches[:n]))
    root = tmp_path_factory.mktemp("parallel_train")
    torch.save({"spec_cfg": cfg, "opt": OPT, "hyp": HYP, "img": IMG,
                "runs": port_runs}, str(root / "case.pt"))
    M.launch(ranks.train_steps, 2, "cpu", str(root / "case.pt"), str(root),
             timeout=TIMEOUT)
    got = [torch.load(str(root / f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    return want, got


def _check(got_run, want_run):
    for i, ((sd, metrics), (wsd, wmetrics)) in enumerate(zip(got_run,
                                                             want_run)):
        for k, v in wmetrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        state_within(sd, wsd, TOL)


def test_one_step_matches_jax_data_mesh(runs):
    """ni = 0: the batch whose second shard has no targets."""
    want, got = runs
    _check(got[0]["runs"][0], want[0])
    assert got[0]["runs"][0][0][0]["ema_count"] == 1


def test_three_steps_with_accumulation_match_jax_data_mesh(runs):
    """ni = 1002, 1003, 1004 with accumulate 4: the first two carry the
    global gradient sum, the third applies it."""
    want, got = runs
    _check(got[0]["runs"][1], want[1])
    assert [sd["ema_count"] for sd, _ in got[0]["runs"][1]] == [0, 0, 1]
    assert float(got[0]["runs"][1][1][0]["grad_acc"][
        "layer1.conv.weight"].abs().max()) > 0


def test_replicas_stay_bit_identical(runs):
    """After every step the two ranks hold the same parameters, BatchNorm
    statistics, EMA, momentum and gradient sum, bit for bit, and neither
    rank imported JAX."""
    _, got = runs
    for run0, run1 in zip(got[0]["runs"], got[1]["runs"]):
        for (sd0, m0), (sd1, m1) in zip(run0, run1):
            assert m0 == m1
            for sec in ("model", "ema", "momentum", "grad_acc"):
                if sd0[sec] is None:
                    assert sd1[sec] is None
                    continue
                for k, v in sd0[sec].items():
                    assert torch.equal(v, sd1[sec][k]), (sec, k)
    assert got[0]["jax_modules"] == got[1]["jax_modules"] == []
