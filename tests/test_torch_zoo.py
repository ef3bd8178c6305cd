"""The rest of the detector zoo in the port against the JAX package: seeded
Flax variables go through the weight bridge (models/from_jax.py), and the
port's YoloV7, fused and unfused, matches the JAX YoloV7 (unfused, wpack
off) on narrow cfgs built from every block the port adds: RepConv (with
and without its identity branch), DownC and Shortcut in an e6e-shaped row
set with the four-level IAuxDetect head, every CSP variant with a
bottleneck, res, rep_bottleneck or rep_res inner stack, Bottleneck with
n > 1, SPP, Stem, Focus, DWConv, and yolov5n / yolov8n (C3, C2f, SPPF,
Detect and DetectV8). Raw levels of the anchor heads and the decoded
predictions of DetectV8 within 1e-3, float32. Every zoo name builds, and
its parameter count equals the JAX spec's and the published one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables)
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models import zoo as jzoo
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models import zoo as tzoo
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
from yolov7_tracker_tpu_torch.models.yolo import (YoloV7, random_state_dict,
                                                  sharpen_heads)

# ultralytics' published counts (tests/test_v5v8_models.py), v8 less its 16
# fixed DFL weights, which the decode holds as a constant
PUBLISHED = {
    "yolov5n": 1_872_157, "yolov5s": 7_235_389, "yolov5m": 21_190_557,
    "yolov5l": 46_563_709, "yolov5x": 86_749_405,
    "yolov8n": 3_157_200 - 16, "yolov8s": 11_166_560 - 16,
    "yolov8m": 25_902_640 - 16, "yolov8l": 43_691_520 - 16,
    "yolov8x": 68_229_648 - 16,
}

ANCHORS_2 = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]]


def sharpen_v8_heads(variables, spec, sharpen=8.0, obj_boost=6.0,
                     jitter=3.0, seed=1, levels=None):
    """tests/torch_parity.sharpen_heads for DetectV8 (no objectness), on a
    numpy variable tree: the box and class output kernels of the
    ``levels`` (default all) are scaled, the class logits raised by
    ``obj_boost`` and jittered, as the port's ``sharpen_heads`` does."""
    rng = np.random.default_rng(seed)
    params = dict(variables["params"])
    for i in range(spec.nl):
        if levels is not None and i not in levels:
            continue
        for br in ("cv2", "cv3"):
            v = dict(params[f"head_{br}_{i}_2"])
            v["kernel"] = v["kernel"] * sharpen
            if br == "cv3":
                v["bias"] = (v["bias"] + obj_boost + rng.uniform(
                    -jitter, jitter, spec.nc)).astype(np.float32)
            params[f"head_{br}_{i}_2"] = v
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _rep_rows():
    """RepConv with the identity branch (c -> c, s 1), changing the width
    and at stride 2, and the RepConv CSP family; IDetect head."""
    return [
        [-1, 1, "Conv", [64, 3, 2]],                  # 0 /2
        [-1, 1, "RepConv", [64, 3, 1]],               # 1 identity branch
        [-1, 1, "RepConv", [128, 3, 2]],              # 2 /4
        [-1, 1, "RepBottleneckCSPA", [128]],          # 3
        [-1, 2, "RepBottleneckCSPB", [128]],          # 4
        [-1, 1, "RepBottleneckCSPC", [128]],          # 5
        [-1, 1, "Conv", [256, 3, 2]],                 # 6 /8
        [-1, 1, "RepResCSPA", [256]],                 # 7
        [-1, 2, "RepResCSPB", [256]],                 # 8
        [-1, 1, "RepResCSPC", [256]],                 # 9
        [-1, 1, "RepResXCSPA", [256]],                # 10 groups 32
        [-1, 1, "RepResXCSPB", [256]],                # 11
        [-1, 1, "RepResXCSPC", [256]],                # 12
        [-1, 1, "Conv", [256, 3, 2]],                 # 13 /16
        [-1, 1, "RepConv", [256, 3, 1]],              # 14 identity branch
        [9, 1, "RepConv", [128, 3, 1]],               # 15 width change
        [[15, 14], 1, "IDetect", ["nc", "anchors"]],
    ]


def _csp_rows():
    """Focus, Stem, DWConv, Bottleneck (n = 1 and n > 1, with and without
    the residual), the Bottleneck / Res / ResX CSP family, SPP; Detect."""
    return [
        [-1, 1, "Focus", [32, 3]],                    # 0 /2
        [-1, 1, "Stem", [64]],                        # 1 /8
        [-1, 1, "DWConv", [96, 3, 1]],                # 2 groups gcd 32
        [-1, 1, "Bottleneck", [96]],                  # 3
        [-1, 3, "Bottleneck", [96]],                  # 4 m{j}_cv1
        [-1, 1, "Bottleneck", [128, False]],          # 5
        [-1, 2, "BottleneckCSPA", [128]],             # 6
        [-1, 2, "BottleneckCSPB", [128]],             # 7
        [-1, 2, "BottleneckCSPC", [128]],             # 8
        [-1, 1, "ResCSPA", [128]],                    # 9
        [-1, 2, "ResCSPB", [128]],                    # 10
        [-1, 1, "ResCSPC", [128]],                    # 11
        [-1, 1, "Conv", [256, 3, 2]],                 # 12 /16
        [-1, 1, "ResXCSPA", [256]],                   # 13 groups 32
        [-1, 1, "ResXCSPB", [256]],                   # 14
        [-1, 1, "ResXCSPC", [256]],                   # 15
        [-1, 1, "SPP", [256, [5, 9, 13]]],            # 16
        [[11, 16], 1, "Detect", ["nc", "anchors"]],
    ]


def _e6e_rows():
    """The e6e pattern at a small size: ReOrg stem, DownC downsamples, a
    twin branch merged by Shortcut, SPPCSPC, four lead and four auxiliary
    head inputs (the auxiliary ones feed only the aux heads)."""
    return [
        [-1, 1, "ReOrg", []],                         # 0 /2
        [-1, 1, "Conv", [32, 3, 1]],                  # 1
        [-1, 1, "DownC", [64]],                       # 2 /4
        [-1, 1, "Conv", [64, 1, 1]],                  # 3 branch a
        [-1, 1, "Conv", [64, 3, 1]],                  # 4
        [2, 1, "Conv", [64, 1, 1]],                   # 5 branch b
        [-1, 1, "Conv", [64, 3, 1]],                  # 6
        [[6, 4], 1, "Shortcut", [1]],                 # 7
        [-1, 1, "DownC", [128]],                      # 8 /8
        [-1, 1, "Conv", [128, 3, 1]],                 # 9
        [-1, 1, "DownC", [128]],                      # 10 /16
        [-1, 1, "Conv", [128, 3, 1]],                 # 11
        [-1, 1, "DownC", [256]],                      # 12 /32
        [-1, 1, "SPPCSPC", [128]],                    # 13
        [-1, 1, "DownC", [128]],                      # 14 /64
        [-1, 1, "Conv", [128, 3, 1]],                 # 15
        [9, 1, "Conv", [64, 3, 1]],                   # 16 lead
        [11, 1, "Conv", [64, 3, 1]],                  # 17
        [13, 1, "Conv", [64, 3, 1]],                  # 18
        [15, 1, "Conv", [64, 3, 1]],                  # 19
        [8, 1, "Conv", [32, 3, 1]],                   # 20 aux
        [10, 1, "Conv", [32, 3, 1]],                  # 21
        [12, 1, "Conv", [32, 3, 1]],                  # 22
        [14, 1, "Conv", [32, 3, 1]],                  # 23
        [[16, 17, 18, 19, 20, 21, 22, 23], 1, "IAuxDetect",
         ["nc", "anchors"]],
    ]


def _cfg(rows, anchors, width=0.25):
    return {"nc": 8, "depth_multiple": 1.0, "width_multiple": width,
            "anchors": anchors, "backbone": rows, "head": []}


CFGS = {
    "rep": (_cfg(_rep_rows(), ANCHORS_2), 64),
    "csp": (_cfg(_csp_rows(), ANCHORS_2), 128),
    "e6e": (_cfg(_e6e_rows(), jzoo.ANCHORS_P6), 128),
    "yolov5n": ("yolov5n", 128),
    "yolov8n": ("yolov8n", 128),
}


def _specs(name):
    cfg, _ = CFGS[name]
    if isinstance(cfg, str):
        return jzoo.get_spec(cfg, nc=8), tzoo.get_spec(cfg, nc=8)
    return j_parse(cfg, name=name), tspec.parse_yaml_cfg(cfg, name=name)


def _jax_outputs(name):
    """(variables, x, JAX outputs): the decoded predictions for DetectV8,
    else the raw lead levels, as numpy."""
    j_spec, _ = _specs(name)
    variables = random_variables(j_spec)
    size = CFGS[name][1]
    x = np.random.default_rng(1).uniform(0, 1, (2, size, size, 3)).astype(
        np.float32)
    pred, raw = jax.jit(lambda v, x: jyolo.YoloV7(j_spec).apply(
        v, x, training=False))(jax.tree.map(jnp.asarray, variables),
                               jnp.asarray(x))
    out = ([np.asarray(pred)] if j_spec.head_kind == "DetectV8"
           else [np.asarray(r) for r in raw])
    return variables, x, out


@pytest.fixture(scope="module", params=sorted(CFGS))
def reference(request):
    return (request.param,) + _jax_outputs(request.param)


@pytest.mark.parametrize("fused", [False, True])
def test_zoo_forward_matches_jax(reference, fused):
    name, variables, x, want = reference
    _, spec = _specs(name)
    sd = jax_variables_to_torch(variables, spec)
    if fused:
        sd = fuse_state_dict(sd)
        assert not any(".bn." in k or "_bn." in k or "rbr_identity" in k
                       or "head_i" in k for k in sd)
    model = YoloV7(spec, fused=fused).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    got = [got] if spec.head_kind == "DetectV8" else got
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, atol=1e-3, rtol=0)
        assert float(t.std()) > 1e-3       # the heads see signal


def test_rep_cfg_has_both_repconv_forms():
    """The rep cfg really holds RepConvs with and without the identity
    branch, and a grouped (ResX) RepConv with one."""
    model = YoloV7(_specs("rep")[1])
    assert model.layer1.rbr_identity is not None
    assert model.layer2.rbr_identity is None
    assert model.layer14.rbr_identity is not None
    assert model.layer15.rbr_identity is None
    grouped = model.layer10.m0.cv2
    assert grouped.rbr_dense_conv.groups == 32
    assert grouped.rbr_identity is not None


def test_aux_only_layers_are_skipped():
    """The e6e rows' auxiliary head inputs (20-23) are not run: the lead
    outputs do not depend on them."""
    model = YoloV7(_specs("e6e")[1])
    assert not {20, 21, 22, 23} & model._needed
    assert {16, 17, 18, 19, 7, 4, 6} <= model._needed


def test_v8_decode_layout():
    """DetectV8's decoded rows: one per cell of the three levels, positive
    widths, obj exactly 1, class scores in (0, 1), centres within 7.5
    strides of their cell (the largest DFL expectation is 15 bins)."""
    spec = tzoo.get_spec("yolov8n", nc=8)
    model = YoloV7(spec).eval()
    model.load_state_dict(random_state_dict(spec, seed=2))
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (1, 128, 96, 3)).astype(np.float32))
    with torch.no_grad():
        pred = model(x).numpy()
    assert pred.shape == (1, 16 * 12 + 8 * 6 + 4 * 3, 5 + 8)
    assert (pred[..., 2:4] > 0).all() and (pred[..., 4] == 1.0).all()
    assert ((pred[..., 5:] > 0) & (pred[..., 5:] < 1)).all()
    cx = (np.arange(12) + 0.5) * 8                # level 0, first row
    assert (np.abs(pred[0, :12, 0] - cx) <= 7.5 * 8).all()


@pytest.mark.parametrize("name", ["yolov8n", "yolov7"])
def test_random_state_dict_heads(name):
    """The bias prior and the sharpening reach the v8 head's output convs
    (head_cv*_2) as they reach head_m_* of the anchor heads."""
    spec = tzoo.get_spec(name, nc=4)
    sd = random_state_dict(spec, seed=0, gain=1.5)
    before = {k: v.clone() for k, v in sd.items()}
    sharpen_heads(sd, spec)
    changed = sorted(k for k in sd if not torch.equal(sd[k], before[k]))
    if spec.head_kind == "DetectV8":
        assert changed == sorted(
            [f"head_cv2_{i}_2.weight" for i in range(3)]
            + [f"head_cv3_{i}_2.{leaf}" for i in range(3)
               for leaf in ("weight", "bias")])
        for i, s in enumerate(spec.strides):
            assert torch.all(before[f"head_cv2_{i}_2.bias"] == 1.0)
            np.testing.assert_allclose(
                before[f"head_cv3_{i}_2.bias"].numpy(),
                np.log(5.0 / 4 / (640.0 / s) ** 2), rtol=1e-6)
    else:
        assert changed == sorted(f"head_m_{i}.{leaf}" for i in range(3)
                                 for leaf in ("weight", "bias"))


@pytest.mark.parametrize("name", sorted(jzoo._ZOO))
def test_zoo_builds_with_jax_and_published_counts(name):
    """Every zoo name builds, unfused and fused (on the meta device: no
    memory); the unfused parameter count equals the JAX spec's (from an
    abstract init) and, for v5 / v8, ultralytics' published one."""
    spec = tzoo.get_spec(name, nc=80)
    with torch.device("meta"):
        n = sum(p.numel() for p in YoloV7(spec).parameters())
        fused = sum(p.numel() for p in YoloV7(spec, fused=True).parameters())
    j_spec = jzoo.get_spec(name, nc=80)
    shapes = jax.eval_shape(lambda: jyolo.YoloV7(j_spec).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=False))
    assert n == sum(int(np.prod(x.shape))
                    for x in jax.tree.leaves(shapes["params"]))
    if name in PUBLISHED:
        assert n == PUBLISHED[name]
    assert 0 < fused < n


@pytest.mark.parametrize("name", ["yolov5n", "yolov7-tiny", "yolov8n"])
def test_phase9_weights_standardise_the_heads(name):
    """chip_smoke phase 9's seeded weights: after calibrate_detector_bn,
    each BN's weight is ``scale`` and its statistics those of one batch;
    after standardize_heads, each head output conv channel has mean prior
    + boost and std ``spread`` there (objectness and class channels; the
    box channels mean prior, std 1). output_parts cuts the output into
    parts that cover it (DetectV8's constant objectness column aside)."""
    import chip_smoke

    spec = tzoo.get_spec(name, nc=5)
    sd = random_state_dict(spec, seed=3)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 64, 96, 3)).astype(
        np.float32))
    cal = chip_smoke.calibrate_detector_bn(spec, sd, img, 0.2)
    bn = [k[:-len(".running_var")] for k in cal if k.endswith("running_var")]
    assert bn and all(
        float(cal[f"{k}.weight"].max()) == pytest.approx(0.2)
        and float(cal[f"{k}.weight"].min()) == pytest.approx(0.2)
        and int(cal[f"{k}.num_batches_tracked"]) == 1 for k in bn)
    out = chip_smoke.standardize_heads(spec, cal, img, 7.0, -3.0)
    model = YoloV7(spec, fused=False)
    model.load_state_dict(out)
    model.eval()
    seen = {}
    for n, m in model.named_children():
        if n.startswith(("head_m_", "head_cv")) and isinstance(
                m, torch.nn.Conv2d):
            m.register_forward_hook(lambda m, i, o, n=n: seen.__setitem__(
                n, (o.mean((0, 2, 3)), o.std((0, 2, 3)))))
    with torch.no_grad():
        y = model(img)
    assert sorted(seen) == sorted(
        [f"head_m_{i}" for i in range(spec.nl)] if name != "yolov8n" else
        [f"head_cv{b}_{i}_2" for b in (2, 3) for i in range(spec.nl)])
    for n, (mean, std) in seen.items():
        b = sd[f"{n}.bias"]
        scored = ((torch.arange(b.numel()) % spec.no) >= 4
                  if n.startswith("head_m_") else
                  torch.full_like(b, n.startswith("head_cv3_"), dtype=bool))
        torch.testing.assert_close(mean, b - 3.0 * scored, atol=1e-3,
                                   rtol=1e-4)
        torch.testing.assert_close(std, 1.0 + 6.0 * scored.float(),
                                   atol=1e-3, rtol=1e-4)
    y = y if isinstance(y, list) else [y]
    parts = chip_smoke.output_parts(y, spec, (64, 96))
    covered = sum(p.numel() for p in parts)
    assert covered == sum(o.numel() for o in y) - (
        y[0].shape[0] * y[0].shape[1] if name == "yolov8n" else 0)
