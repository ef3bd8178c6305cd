"""The tail of the detector zoo in the port against the JAX package: seeded
Flax variables go through the weight bridge (models/from_jax.py), and the
port's YoloV7, fused and unfused, matches the JAX YoloV7 (unfused) on
narrow cfgs of every block the tail adds: GhostConv, Ghost at stride 1 and
2, GhostSPPCSPC and the GhostCSP A/B/C inner, Contract / Expand, the Swin
v1 / v2 blocks with and without their width conv and the six ST(2)CSP
wrappers (at a size that is a window multiple and one that is not, so the
pad and the shift mask both run), RepConv_OREPA with and without its
identity branch, RobustConv(2), Chuncat and Foldcut. Raw levels within
1e-3, float32. The reference-layout converter (models/convert.py) equals
the JAX converter then the bridge, bit for bit, and refuses deploy-form
OREPA as JAX does. The blocks that no cfg reaches (CrossConv, Sum,
MixConv2d, TransformerBlock, Classify) are held at block level, as the JAX
package holds them."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_convert import _assert_same, _jax_way
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.models import blocks as jblocks
from yolov7_tracker_tpu.models import convert as j_convert
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu_torch.models import blocks as tblocks
from yolov7_tracker_tpu_torch.models import convert
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models.from_jax import (jax_params_to_torch,
                                                      jax_variables_to_torch)
from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
from yolov7_tracker_tpu_torch.models.yolo import YoloV7

ANCHORS_2 = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]]

GHOST_ROWS = [
    [-1, 1, "Focus", [16, 3]],                 # 0 /2
    [-1, 1, "DWConv", [24, 3, 2]],             # 1 /4
    [-1, 1, "GhostConv", [32, 1, 1]],          # 2
    [-1, 1, "Ghost", [32, 3, 1]],              # 3 identity shortcut
    [-1, 1, "Ghost", [48, 3, 2]],              # 4 /8 depthwise shortcut
    [-1, 2, "GhostCSPA", [48]],                # 5
    [-1, 1, "Conv", [48, 3, 2]],               # 6 /16
    [-1, 1, "Contract", [2]],                  # 7 /32
    [-1, 1, "Conv", [64, 1, 1]],               # 8
    [-1, 1, "Expand", [2]],                    # 9 /16
    [-1, 1, "Conv", [32, 1, 1]],               # 10
    [-1, 1, "GhostSPPCSPC", [32]],             # 11
    [-1, 2, "GhostCSPB", [32]],                # 12
    [-1, 1, "GhostCSPC", [32]],                # 13
    [5, 1, "Conv", [32, 1, 1]],                # 14 /8
    [[14, 13], 1, "Detect", ["nc", "anchors"]],
]

SWIN_ROWS = [
    [-1, 1, "Conv", [32, 3, 2]],               # 0 /2
    [-1, 1, "Conv", [64, 3, 2]],               # 1 /4
    [-1, 2, "STCSPA", [64]],                   # 2
    [-1, 1, "Conv", [64, 3, 2]],               # 3 /8
    [-1, 2, "ST2CSPC", [64]],                  # 4
    [-1, 1, "SwinTransformerBlock", [64, 2, 2]],     # 5
    [-1, 1, "SwinTransformer2Block", [64, 2, 1]],    # 6
    [-1, 2, "STCSPB", [64]],                   # 7
    [-1, 1, "SwinTransformerBlock", [96, 3, 2]],     # 8 width conv
    [-1, 1, "ST2CSPA", [96]],                  # 9
    [-1, 2, "ST2CSPB", [64]],                  # 10
    [-1, 1, "STCSPC", [64]],                   # 11
    [[2, 11], 1, "Detect", ["nc", "anchors"]],
]

OREPA_ROWS = [
    [-1, 1, "Conv", [32, 3, 2]],               # 0
    [-1, 1, "RepConv_OREPA", [32, 3, 1]],      # 1 identity branch
    [-1, 1, "RepConv_OREPA", [64, 3, 2]],      # 2 none
    [-1, 1, "Conv", [64, 1, 1]],               # 3
    [1, 1, "RepConv_OREPA", [48, 3, 1]],       # 4 width change, none
    [[4, 3], 1, "Detect", ["nc", "anchors"]],
]

ROBUST_ROWS = [
    [-1, 1, "Conv", [32, 3, 2]],               # 0
    [-1, 1, "RobustConv", [32, 7, 1]],         # 1
    [-1, 1, "Conv", [32, 3, 2]],               # 2
    [-1, 1, "RobustConv2", [32, 5, 2]],        # 3
    [[-1, -2], 1, "Chuncat", [1]],             # 4
    [-1, 1, "Foldcut", [1]],                   # 5
    [-1, 1, "Conv", [64, 1, 1]],               # 6
    [1, 1, "RobustConv", [48, 5, 2]],          # 7 strided, width change
    [[7, 6], 1, "Detect", ["nc", "anchors"]],
]

CFGS = {"ghost": (GHOST_ROWS, 128), "swin": (SWIN_ROWS, 64),
        "orepa": (OREPA_ROWS, 64), "robust": (ROBUST_ROWS, 64)}


def _cfg(rows):
    return {"nc": 4, "depth_multiple": 1.0, "width_multiple": 1.0,
            "anchors": ANCHORS_2, "backbone": rows, "head": []}


def _specs(name):
    cfg = _cfg(CFGS[name][0])
    return j_parse(cfg, name=name), tspec.parse_yaml_cfg(cfg, name=name)


def fill(tree, seed):
    """Seeded values for every leaf of a Flax variables tree, by leaf name,
    at scales that carry the image through the tail's blocks: LayerScale
    gamma near 1 (not 1e-6), OREPA's vector around its init rows, Swin v2
    temperatures on both sides of the log(100) clamp."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, top = path[-1].key, path[0].key
        shape = x.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "qkv_kernel":
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name == "in_proj_weight" or name.startswith("weight_rbr_"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name == "vector":
            base = np.asarray([0.25, 0.25, 0.0, 0.5, 0.5]
                              + [0.0] * (shape[0] - 5))
            v = base[:, None] + 0.1 * rng.standard_normal(shape)
        elif name == "relative_position_bias_table":
            v = 0.5 * rng.standard_normal(shape)
        elif name == "logit_scale":
            v = rng.uniform(1.5, 6.0, shape)
        elif name == "gamma":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            v = rng.normal(0, 0.1, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "implicit":
            v = (0.0 if top.startswith("head_ia") else 1.0) + \
                0.02 * rng.standard_normal(shape)
        elif name in ("bias", "q_bias", "v_bias", "in_proj_bias", "w"):
            v = (np.zeros(shape) if top.startswith("head_m")
                 else rng.normal(0, 0.1, shape))
        else:
            raise AssertionError(f"no filler for {name}")
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


_SHAPES = {}


def model_variables(j_spec, seed=0):
    """Filled variables of a tail cfg. The shapes come from an eager init
    (once per cfg): the JAX Swin layer builds its shift mask with numpy
    from a traced array, so it runs only outside jit and eval_shape (as
    the JAX package's own Swin test runs it)."""
    if j_spec.name not in _SHAPES:
        _SHAPES[j_spec.name] = jax.tree.map(np.asarray, jyolo.YoloV7(
            j_spec).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                         training=False))
    shapes = _SHAPES[j_spec.name]
    v = fill({"params": shapes["params"],
              "batch_stats": shapes["batch_stats"]}, seed)
    prior = jyolo.init_head_biases({"params": dict(v["params"])},
                                   j_spec)["params"]
    return {"params": jax.tree.map(np.asarray, prior),
            "batch_stats": v["batch_stats"]}


def _jax_raw(j_spec, variables, x):
    """The JAX model's raw lead levels, eagerly (see model_variables)."""
    _, raw = jyolo.YoloV7(j_spec).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), training=False)
    return [np.asarray(r) for r in raw]


@pytest.fixture(scope="module", params=sorted(CFGS))
def reference(request):
    name = request.param
    j_spec, t_spec = _specs(name)
    variables = model_variables(j_spec)
    size = CFGS[name][1]
    x = np.random.default_rng(1).uniform(0, 1, (2, size, size, 3)).astype(
        np.float32)
    return name, t_spec, variables, x, _jax_raw(j_spec, variables, x)


def _port_raw(spec, sd, x, fused):
    if fused:
        sd = fuse_state_dict(sd)
    model = YoloV7(spec, fused=fused).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.from_numpy(x)), model


@pytest.mark.parametrize("fused", [False, True])
def test_tail_forward_matches_jax(reference, fused):
    name, spec, variables, x, want = reference
    got, model = _port_raw(spec, jax_variables_to_torch(variables, spec), x,
                           fused)
    if fused:   # every BN folded but OREPA's, which has no fused form
        assert all(".rbr_dense.bn." in k or "rbr_1x1_bn" in k
                   or "rbr_identity" in k
                   for k in model.state_dict() if "bn" in k)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, atol=1e-3, rtol=0)
        assert float(t.std()) > 1e-3       # the heads see signal


def test_swin_off_the_window_grid():
    """At 88 px the Swin maps (22 at stride 4, 11 at stride 8) are no
    multiple of 8 or 7: the pad before norm1, the cut after, and the shift
    mask of the padded map all run."""
    j_spec, t_spec = _specs("swin")
    variables = model_variables(j_spec, seed=2)
    x = np.random.default_rng(88).uniform(0, 1, (1, 88, 88, 3)).astype(
        np.float32)
    want = _jax_raw(j_spec, variables, x)
    got, _ = _port_raw(t_spec, jax_variables_to_torch(variables, t_spec), x,
                       fused=True)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-3, rtol=0)


def test_tail_cfgs_hold_each_form():
    """The cfgs build what they claim: both OREPA forms (and the unused
    sixth vector row), both Ghost strides, the Swin width conv."""
    orepa = YoloV7(_specs("orepa")[1])
    assert orepa.layer1.rbr_identity is not None
    assert orepa.layer1.rbr_dense.vector.shape[0] == 6
    assert orepa.layer2.rbr_identity is None
    assert orepa.layer2.rbr_dense.vector.shape[0] == 5
    ghost = YoloV7(_specs("ghost")[1])
    assert not hasattr(ghost.layer3, "shortcut0")
    assert hasattr(ghost.layer4, "shortcut0")
    swin = YoloV7(_specs("swin")[1])
    assert hasattr(swin.layer8, "conv") and not hasattr(swin.layer5, "conv")
    assert swin.layer6.blocks0.ws == 7 and swin.layer5.blocks1.shift == 4


def test_contract_expand_order_and_inverse():
    """contract then expand is the identity, and the port's NCHW contract
    orders channels as (i_sh * gain + i_sw) * C + c, as the JAX NHWC one."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 8, 6, 12)).astype(np.float32)   # NCHW
    t = torch.from_numpy(x)
    c = tblocks.contract(t, 2)
    assert torch.equal(tblocks.expand(c, 2), t)
    want = np.asarray(jblocks.contract(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       2)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(c.numpy(), want)
    want_e = np.asarray(jblocks.expand(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       2)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(tblocks.expand(t, 2).numpy(), want_e)
    # channel (i_sh * 2 + i_sw) * C + c holds x[c, 2 h + i_sh, 2 w + i_sw]
    assert c[0, (1 * 2 + 0) * 8 + 5, 1, 2] == t[0, 5, 3, 4]


# --- the reference-layout converter ----------------------------------------

_PART = {"conv0": "conv.0", "conv1": "conv.1", "conv2": "conv.2",
         "shortcut0": "shortcut.0", "shortcut1": "shortcut.1",
         "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2",
         "cpb_fc1": "cpb_mlp.0", "cpb_fc2": "cpb_mlp.2",
         "rbr_1x1_conv": "rbr_1x1.conv", "rbr_1x1_bn": "rbr_1x1.bn"}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def to_reference_tail(variables, spec):
    """Flax variables of a tail cfg -> the reference Model's state_dict
    (the inverse of the JAX converter's tail branches, held first)."""
    head_idx = spec.layers[-1].index

    def prefix(path):
        m = re.fullmatch(r"head_m_(\d+)", path[0])
        if m:
            return f"{head_idx}.m.{m[1]}"
        parts = [path[0][len("layer"):]]
        for p in path[1:]:
            m = re.fullmatch(r"(m|blocks)(\d+)", p)
            parts.append(f"{m[1]}.{m[2]}" if m else _PART.get(p, p))
        return ".".join(parts)

    sd = {}
    for path, v in _flat(variables["params"]):
        leaf = path[-1]
        key = f"model.{prefix(path[:-1])}"
        if leaf == "kernel":
            if path[-2] == "conv_deconv":            # (kh, kw, in, out)
                v = v.transpose(2, 3, 0, 1)
            else:
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            key += ".weight"
        elif leaf == "qkv_kernel":
            v, key = v.T, key + ".qkv.weight"
        elif leaf == "scale":
            key += ".weight"
        else:
            key += f".{leaf}"
        sd[key] = torch.tensor(np.ascontiguousarray(v))
    for path, v in _flat(variables["batch_stats"]):
        base = f"model.{prefix(path[:-1])}"
        sd[f"{base}.running_{path[-1]}"] = torch.tensor(v)
        sd[f"{base}.num_batches_tracked"] = torch.tensor(3)
    return sd


@pytest.mark.parametrize("name", sorted(CFGS))
def test_convert_tail_equals_jax_then_bridge(name):
    j_spec, t_spec = _specs(name)
    variables = model_variables(j_spec, seed=4)
    ref_sd = to_reference_tail(variables, j_spec)
    back = j_convert.convert_state_dict(ref_sd, j_spec)
    want = dict(_flat({"params": variables["params"],
                       "batch_stats": variables["batch_stats"]}))
    got = dict(_flat(jax.tree.map(np.asarray, back)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    _assert_same(convert.convert_state_dict(ref_sd, t_spec),
                 _jax_way(ref_sd, j_spec))


def test_deploy_form_orepa_is_refused():
    j_spec, t_spec = _specs("orepa")
    ref_sd = to_reference_tail(model_variables(j_spec), j_spec)
    ref_sd["model.1.rbr_reparam.weight"] = torch.zeros(32, 32, 3, 3)
    ref_sd["model.1.rbr_reparam.bias"] = torch.zeros(32)
    with pytest.raises(NotImplementedError, match="deploy-form"):
        j_convert.convert_state_dict(ref_sd, j_spec)
    with pytest.raises(NotImplementedError, match="deploy-form"):
        convert.convert_state_dict(ref_sd, t_spec)


def test_flax_conv_transpose_reads_the_kernel_as_flax():
    """blocks.FlaxConvTranspose computes Flax's ConvTranspose (kernel =
    stride, VALID) from the bridged kernel, which torch's ConvTranspose2d
    on the same numbers does not: Flax does not flip the kernel."""
    from flax import linen as nn

    x = np.random.default_rng(0).normal(0, 1, (2, 5, 4, 6)).astype(
        np.float32)
    m = nn.ConvTranspose(3, (2, 2), strides=(2, 2), padding="VALID")
    v = fill(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = np.asarray(m.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    block = tblocks.FlaxConvTranspose(6, 3, 2)
    block.load_state_dict(jax_params_to_torch(v["params"]))
    with torch.no_grad():
        got = block(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        plain = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            block.weight.transpose(0, 1), block.bias, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert float((plain - got).abs().max()) > 1e-2


# --- blocks no cfg reaches -------------------------------------------------

def block_state_dict(variables):
    """A block's Flax variables (numpy) -> its port state_dict."""
    sd = jax_params_to_torch(variables["params"])
    for path, v in _flat(variables.get("batch_stats", {})):
        base = ".".join(path[:-1])
        sd[f"{base}.running_{path[-1]}"] = torch.tensor(v)
        sd[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


BLOCKS = {
    # name: (JAX module, port module, input NCHW shape)
    "crossconv": (lambda: jblocks.CrossConv(16, 3, 1, shortcut=True),
                  lambda: tblocks.CrossConv(16, 16, 3, 1, shortcut=True),
                  (2, 16, 10, 12)),
    "crossconv_s2": (lambda: jblocks.CrossConv(24, 3, 2, e=0.5),
                     lambda: tblocks.CrossConv(16, 24, 3, 2, e=0.5),
                     (2, 16, 10, 12)),
    "mixconv": (lambda: jblocks.MixConv2d(16, (1, 3)),
                lambda: tblocks.MixConv2d(16, 16, (1, 3)), (2, 16, 10, 12)),
    "mixconv3": (lambda: jblocks.MixConv2d(16, (1, 3, 5)),
                 lambda: tblocks.MixConv2d(16, 16, (1, 3, 5)),
                 (2, 16, 10, 12)),
    "transformer": (lambda: jblocks.TransformerBlock(32, 4, 2),
                    lambda: tblocks.TransformerBlock(24, 32, 4, 2),
                    (2, 24, 8, 6)),
    "transformer_same": (lambda: jblocks.TransformerBlock(32, 2, 1),
                         lambda: tblocks.TransformerBlock(32, 32, 2, 1),
                         (2, 32, 5, 7)),
    "classify": (lambda: jblocks.Classify(10),
                 lambda: tblocks.Classify(32, 10), (3, 32, 12, 9)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_unreached_blocks_match_jax(name):
    make_j, make_t, shape = BLOCKS[name]
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    jm = make_j()
    variables = fill(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), _nhwc(x))), 3)
    want = np.asarray(jm.apply(variables, _nhwc(x)))
    if want.ndim == 4:
        want = want.transpose(0, 3, 1, 2)
    tm = make_t().eval()
    tm.load_state_dict(block_state_dict(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("weight", [False, True])
def test_sum_matches_jax(weight):
    rng = np.random.default_rng(1)
    xs = [rng.normal(0, 1, (2, 5, 4, 3)).astype(np.float32)
          for _ in range(3)]
    jm = jblocks.Sum(3, weight=weight)
    variables = jm.init(jax.random.PRNGKey(0), [jnp.asarray(v) for v in xs])
    want = np.asarray(jm.apply(variables, [jnp.asarray(v) for v in xs]))
    tm = tblocks.Sum(3, weight=weight)
    tm.load_state_dict(jax_params_to_torch(
        jax.tree.map(np.asarray, variables.get("params", {}))))
    got = tm([torch.from_numpy(v) for v in xs]).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
