"""The port's train step against the JAX package's without gradient
accumulation (batch 64 = the nominal batch: every batch is an optimizer
step, no gradient sum kept) on a narrow three-level IDetect model
(tests/torch_parity.narrow_idetect_cfg, 128 px, batch 4, the SimOTA
loss): three steps from a fresh converted state and one from ni = 1500,
past the warmup. Parameters, EMA, momentum buffers and the BatchNorm
statistics within 1e-4 of each tensor's largest value."""

import numpy as np
import pytest
import torch

from tests.torch_parity import (jax_train_runs,  # noqa: F401
                                narrow_idetect_cfg, one_torch_thread,
                                seeded_batch, state_within)
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu.parallel import train_step as jts
from yolov7_tracker_tpu.train import loss as jloss
from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg as t_parse
from yolov7_tracker_tpu_torch.parallel import train_step as tts
from yolov7_tracker_tpu_torch.train import loss as tloss

IMG = 128
TOL = 1e-4           # of each tensor's largest |value|
LOSS_RTOL = 1e-4
OPT = dict(batch_size=64, nominal_batch=64, epochs=3, steps_per_epoch=500)


@pytest.fixture(scope="module")
def reference():
    cfg = narrow_idetect_cfg()
    j_spec, t_spec = j_parse(cfg, name="idet"), t_parse(cfg, name="idet")
    batches = [seeded_batch(10 + s, img=IMG) for s in range(3)]
    fresh, runs = jax_train_runs(j_spec, jts.OptConfig(**OPT), jloss.Hyp(),
                                 IMG, batches, [(0, 3), (1500, 1)])
    return t_spec, fresh, batches, runs


@pytest.mark.parametrize("run", [0, 1])
def test_steps_without_accumulation_match_jax(reference, run):
    t_spec, fresh, batches, runs = reference
    start = (0, 1500)[run]
    cfg = tts.OptConfig(**OPT)
    assert not tts.accumulating(cfg)
    state = tts.train_state_from_jax(fresh._replace(step=np.int32(start)),
                                     t_spec, cfg, "cpu")
    assert state.grad_acc() is None
    step = tts.make_train_step(t_spec, img_size=IMG, hyp=tloss.Hyp(),
                               opt_cfg=cfg)
    for i, (jstate, jmetrics) in enumerate(runs[run]):
        metrics = step(state, *(torch.tensor(x) for x in batches[i]))
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        want = tts.train_state_from_jax(jstate, t_spec, cfg,
                                        "cpu").state_dict()
        state_within(state.state_dict(), want, TOL)
        assert state.ema_count == i + 1
        assert all(p.grad is None for p in state.model.parameters())
