"""The port's reference-checkpoint converter (models/convert.py) against the
JAX package's: a reference-layout state_dict, made from seeded Flax
variables by ``to_reference`` (the JAX converter's inverse, held first),
converted by the port equals the JAX conversion carried over by
models/from_jax.py, tensor for tensor and bit for bit, for every block
the port builds (the narrow cfgs of tests/test_torch_zoo.py, yolov7 and
yolov3-spp), with RepConv in training form and in deploy form
(``rbr_reparam``). The clean-room v5 / v8 modules of
tests/test_v5v8_models.py are a second source of reference keys."""

import re

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_zoo import _specs
from tests.test_v5v8_models import _build_torch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables)
from yolov7_tracker_tpu.models import convert as j_convert
from yolov7_tracker_tpu.models import zoo as jzoo
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu_torch.models import convert, from_jax
from yolov7_tracker_tpu_torch.models import zoo as tzoo
from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg as t_parse
from yolov7_tracker_tpu_torch.models.yolo import YoloV7

_RBR = {"rbr_dense_conv": "rbr_dense.0", "rbr_dense_bn": "rbr_dense.1",
        "rbr_1x1_conv": "rbr_1x1.0", "rbr_1x1_bn": "rbr_1x1.1"}


def _ref_prefix(path, head_idx):
    """A Flax module path -> the reference's module name."""
    top = path[0]
    m = re.fullmatch(r"head_(m2?|ia|im)_(\d+)", top)
    if m:
        return f"{head_idx}.{m[1]}.{m[2]}"
    m = re.fullmatch(r"head_(cv[23])_(\d+)_(\d+)", top)
    if m:
        return f"{head_idx}.{m[1]}.{m[2]}.{m[3]}" + "".join(
            f".{p}" for p in path[1:])
    parts = [top[len("layer"):]]
    for p in path[1:]:
        rep = re.fullmatch(r"m(\d+)_(cv\d)", p)        # Bottleneck n > 1
        inner = re.fullmatch(r"m(\d+)", p)              # CSP / C3 / C2f
        if rep:
            parts += [rep[1], rep[2]]
        elif inner:
            parts += ["m", inner[1]]
        else:
            parts.append(_RBR.get(p, p))
    return ".".join(parts)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def to_reference(variables, spec):
    """Flax variables (numpy) -> the state_dict the reference's Model would
    hold: OIHW kernels, (1, C, 1, 1) implicit vectors, ``model.`` keys."""
    head_idx = spec.layers[-1].index
    sd = {}
    leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "implicit": "implicit"}
    for path, v in _flatten(variables["params"]):
        key = f"model.{_ref_prefix(path[:-1], head_idx)}.{leaf_name[path[-1]]}"
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1)
        elif path[-1] == "implicit":
            v = v.reshape(1, -1, 1, 1)
        sd[key] = torch.tensor(v)
    for path, v in _flatten(variables["batch_stats"]):
        base = f"model.{_ref_prefix(path[:-1], head_idx)}"
        sd[f"{base}.running_{path[-1]}"] = torch.tensor(v)
        sd[f"{base}.num_batches_tracked"] = torch.tensor(7)
    return sd


def to_deploy(ref_sd, spec):
    """Reference keys with every RepConv in deploy form: the port's fold
    written back as ``rbr_reparam``."""
    port = fuse_state_dict(convert.convert_state_dict(ref_sd, spec))
    out = {k: v for k, v in ref_sd.items()
           if not re.search(r"\.rbr_(dense|1x1|identity)\.", k)}
    for k, v in port.items():
        if ".rbr_reparam." in k:
            out["model." + _ref_prefix(tuple(k.split(".")[:-2]),
                                       spec.layers[-1].index)
                + ".rbr_reparam." + k.split(".")[-1]] = v
    return out


def _jax_way(ref_sd, spec):
    jax_vars = j_convert.convert_state_dict(ref_sd, spec)
    return from_jax.jax_variables_to_torch(
        jax.tree.map(np.asarray, jax_vars), spec)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


NAMES = ["rep", "csp", "e6e", "yolov5n", "yolov8n", "yolov7", "yolov3-spp"]


def _spec_pair(name):
    """The zoo's yolov7 and yolov3-spp rows at width 0.25, or a cfg of
    tests/test_torch_zoo.py."""
    rows = {"yolov7": jzoo.yolov7_rows, "yolov3-spp": jzoo.yolov3_spp_rows}
    if name not in rows:
        return _specs(name)
    cfg = {"nc": 4, "depth_multiple": 1.0, "width_multiple": 0.25,
           "anchors": jzoo.ANCHORS_P5, "backbone": rows[name](), "head": []}
    return j_parse(cfg, name=name), t_parse(cfg, name=name)


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    j_spec, t_spec = _spec_pair(request.param)
    variables = random_variables(j_spec, seed=5)
    return request.param, j_spec, t_spec, variables, to_reference(
        variables, j_spec)


def test_to_reference_inverts_the_jax_converter(case):
    _, j_spec, _, variables, ref_sd = case
    back = j_convert.convert_state_dict(ref_sd, j_spec)
    want = dict(_flatten({"params": variables["params"],
                          "batch_stats": variables["batch_stats"]}))
    got = dict(_flatten(jax.tree.map(np.asarray, back)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_convert_equals_jax_then_bridge(case):
    _, j_spec, t_spec, _, ref_sd = case
    _assert_same(convert.convert_state_dict(ref_sd, t_spec),
                 _jax_way(ref_sd, j_spec))
    # the module.-wrapped form of a DataParallel checkpoint
    wrapped = {"module." + k: v for k, v in ref_sd.items()}
    _assert_same(convert.convert_state_dict(wrapped, t_spec),
                 _jax_way(ref_sd, j_spec))


@pytest.mark.parametrize("name", ["rep", "yolov7"])
def test_deploy_repconv(name, monkeypatch):
    """Deploy-form RepConvs convert as the JAX converter does (dense branch
    = rbr_reparam, identity BN around it, zero 1x1 branch); where the
    module has an identity branch, which the JAX converter leaves out, the
    port adds a zero identity BN. The converted model computes what the
    training form computes."""
    j_spec, t_spec = _spec_pair(name)
    ref_sd = to_reference(random_variables(j_spec, seed=6), j_spec)
    deploy = to_deploy(ref_sd, t_spec)
    assert any(".rbr_reparam." in k for k in deploy)
    assert not any(".rbr_dense." in k for k in deploy)
    got = convert.convert_state_dict(deploy, t_spec)
    # the JAX conversion lacks those identity BNs: bridge it unchecked
    monkeypatch.setattr(from_jax, "check_state_dict", lambda sd, spec: None)
    want = _jax_way(deploy, j_spec)
    identity = sorted(k for k in got if k not in want)
    assert all(".rbr_identity." in k for k in identity)
    assert bool(identity) == (name == "rep")
    for k in identity:
        if k.endswith(".weight"):
            assert not got[k].any()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    train = YoloV7(t_spec).eval()
    train.load_state_dict(convert.convert_state_dict(ref_sd, t_spec))
    folded = YoloV7(t_spec).eval()
    folded.load_state_dict(got)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(train(x), folded(x)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                       rtol=0)


@pytest.mark.parametrize("name", ["yolov5n", "yolov8n"])
def test_clean_room_v5_v8_modules(name):
    """The clean-room v5 / v8 modules' own state_dict (nn.Sequential and
    ModuleList names) converts as the JAX converter converts it; the v8
    module and the port compute the same decoded predictions."""
    j_spec = jzoo.get_spec(name, nc=8)
    t_spec = tzoo.get_spec(name, nc=8)
    torch.manual_seed(0)
    oracle = _build_torch(j_spec).float().eval()
    gen = torch.Generator().manual_seed(1)
    for m in oracle.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(0.1 * torch.randn(m.num_features,
                                                   generator=gen))
            m.running_var.copy_(1.0 + 0.1 * torch.rand(m.num_features,
                                                       generator=gen))
    sd = oracle.state_dict()
    got = convert.convert_state_dict(sd, t_spec)
    _assert_same(got, _jax_way(sd, j_spec))
    if name == "yolov8n":
        model = YoloV7(t_spec).eval()
        model.load_state_dict(got)
        img = np.random.default_rng(0).random((1, 128, 96, 3), np.float32)
        with torch.no_grad():
            want = oracle(torch.from_numpy(img.transpose(0, 3, 1, 2)))
            np.testing.assert_allclose(model(torch.from_numpy(img)).numpy(),
                                       want.numpy(), atol=2e-4, rtol=0)


def test_layout_detection_and_errors():
    spec = tzoo.get_spec("yolov5n", nc=8)
    with torch.device("meta"):
        port_keys = YoloV7(spec).state_dict()
    assert not convert.is_reference_layout(port_keys)
    ref = {f"model.{i}.conv.weight": None for i in range(3)}
    assert convert.is_reference_layout(ref)
    assert convert.is_reference_layout({"module.model.0.bn.bias": None})
    assert convert.is_reference_layout({"0.cv1.conv.weight": None})
    with pytest.raises(KeyError):
        convert.convert_state_dict({"model.0.conv.weight": torch.zeros(
            16, 3, 6, 6)}, spec)
