"""Detector parity: the JAX YoloV7 variables go through the weight bridge
(models/from_jax.py) and the port's BN/implicit fold, and the port's
forward matches ``YoloV7.apply`` (unfused, wpack off) on the raw head
levels of a narrowed yolov7-w6 (width_multiple 0.125, 128 px, float32)
within 1e-3."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    narrow_w6_cfg, one_torch_thread, random_variables,
)
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models import zoo as jzoo
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models import zoo as tzoo
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
from yolov7_tracker_tpu_torch.models.yolo import YoloV7


@pytest.fixture(scope="module")
def jax_reference():
    spec = parse_yaml_cfg(narrow_w6_cfg())
    variables = random_variables(spec)
    x = np.random.default_rng(1).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    apply = jax.jit(lambda v, x: jyolo.YoloV7(spec).apply(
        v, x, training=False)[1])
    raw = apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    return variables, x, [np.asarray(r) for r in raw]


def test_spec_copy_matches_jax():
    for name in ("yolov7-w6", "yolov7-tiny", "yolov7", "yolov5s"):
        assert (dataclasses.asdict(tzoo.get_spec(name, nc=80))
                == dataclasses.asdict(jzoo.get_spec(name, nc=80)))
    assert (dataclasses.asdict(tspec.parse_yaml_cfg(narrow_w6_cfg()))
            == dataclasses.asdict(parse_yaml_cfg(narrow_w6_cfg())))


@pytest.mark.parametrize("fused", [True, False])
def test_w6_forward_matches_jax(jax_reference, fused):
    variables, x, j_raw = jax_reference
    spec = tspec.parse_yaml_cfg(narrow_w6_cfg())
    sd = jax_variables_to_torch(variables, spec)
    if fused:
        sd = fuse_state_dict(sd)
        assert not any(".bn." in k or "head_i" in k for k in sd)
    model = YoloV7(spec, fused=fused).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        t_raw = model(torch.from_numpy(x))
    assert len(t_raw) == spec.nl == 4
    for t, j in zip(t_raw, j_raw):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, atol=1e-3, rtol=0)
    # the head really sees signal: raw levels are not constant
    assert all(float(t.std()) > 1e-3 for t in t_raw)


def test_bridge_rejects_mismatched_spec(jax_reference):
    variables, _, _ = jax_reference
    other = tspec.parse_yaml_cfg(narrow_w6_cfg(nc=3))
    with pytest.raises(ValueError):
        jax_variables_to_torch(variables, other)


def test_random_state_dict_gain_scales_the_kernels_below_the_head():
    """gain multiplies the std of every conv kernel but the head's, so a
    deep random detector can be made to pass its signal to the heads."""
    from yolov7_tracker_tpu_torch.models.yolo import random_state_dict

    spec = tzoo.get_spec("yolov7-tiny", nc=2)
    base = random_state_dict(spec, seed=3)
    wide = random_state_dict(spec, seed=3, gain=2.0)
    assert base.keys() == wide.keys()
    below, heads = [], 0
    for k, v in base.items():
        if v.dim() == 4 and not k.startswith("head_m"):
            below.append(float(wide[k].std() / v.std()))
        elif k.startswith("head_m"):
            heads += 1
            assert float(wide[k].std()) == pytest.approx(float(v.std()),
                                                         rel=0.2)
    assert heads and len(below) > 20
    assert np.median(below) == pytest.approx(2.0, rel=0.05)
