"""Test-time augmentation (models/tta.py) and the output-space ensemble
(models/yolo.ensemble_apply) in the port against the JAX package's:
_scale_img within 1e-5 of JAX's at 0.83 and 0.67, odd sizes included
(jax.image.resize antialiases when it shrinks; the port builds its weight
matrices); forward_tta and each ensemble_apply mode within 1e-3 of
JAX's, on seeded yolov7-tiny (nc 4) variables, unfused and fused."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables)
from yolov7_tracker_tpu.models import tta as j_tta
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models import zoo as j_zoo
from yolov7_tracker_tpu_torch.models import tta
from yolov7_tracker_tpu_torch.models import zoo as t_zoo
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
from yolov7_tracker_tpu_torch.models.yolo import YoloV7, ensemble_apply


@pytest.mark.parametrize("ratio", [0.83, 0.67])
@pytest.mark.parametrize("shape", [(1, 128, 128, 3), (2, 127, 93, 3),
                                   (1, 101, 77, 3), (1, 64, 200, 3)])
def test_scale_img_matches_jax(shape, ratio):
    x = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(
        np.float32)
    want = np.asarray(j_tta._scale_img(jnp.asarray(x), ratio))
    got = tta._scale_img(torch.from_numpy(x), ratio).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _model(seed, fused):
    j_spec = j_zoo.get_spec("yolov7-tiny", nc=4)
    t_spec = t_zoo.get_spec("yolov7-tiny", nc=4)
    variables = random_variables(j_spec, seed=seed)
    sd = jax_variables_to_torch(variables, t_spec)
    if fused:
        sd = fuse_state_dict(sd)
    model = YoloV7(t_spec, fused=fused).eval()
    model.load_state_dict(sd)
    return (jyolo.YoloV7(j_spec), jax.tree.map(jnp.asarray, variables)), \
        model


@pytest.mark.parametrize("fused", [False, True])
def test_forward_tta_matches_jax(fused):
    (jm, jv), model = _model(0, fused)
    x = np.random.default_rng(1).uniform(0, 1, (2, 128, 160, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: j_tta.forward_tta(jm, v, x))(
        jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tta.forward_tta(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("mode", ["nms", "mean", "max"])
def test_ensemble_apply_matches_jax(mode):
    members = [_model(seed, fused=seed == 7) for seed in (0, 7)]
    x = np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    want = np.asarray(jyolo.ensemble_apply(
        [m for m, _ in members], jnp.asarray(x), mode=mode))
    with torch.no_grad():
        got = ensemble_apply([t for _, t in members], torch.from_numpy(x),
                             mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_ensemble_apply_refuses_an_unknown_mode():
    _, model = _model(0, fused=True)
    with pytest.raises(ValueError, match="unknown ensemble mode"):
        ensemble_apply([model], torch.zeros(1, 64, 64, 3), "median")
