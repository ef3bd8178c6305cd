"""W8A8 static PTQ in the port (models/quant.py, blocks.QuantConv,
PipelineConfig.quant, cli/track.py --quant) against the JAX package's:

- given the JAX absmax, quantize_state_dict makes the JAX int8 kernels
  exactly and the JAX scales and biases float32-equal;
- calibrate's absmax is within 1e-6 relative of JAX's on the same
  batches (default_calib_batches within 1e-6 of JAX's too);
- one quantized conv's accumulation equals JAX's int32 conv exactly at a
  width (3 x 3 x 640) where a float32 conv is not exact;
- the int8 forward is within 1e-3 of each part of JAX's, the int8 model
  keeps JAX's fidelity bounds against the fused float32 one (correlation
  > 0.999, confidence within 5e-2), and the heads stay float;
- cli/track.py --quant int8 --device cpu writes the JAX CLI's MOT rows.

The JAX side is built directly (its own tests of the module are marked
slow); yolov7-tiny and yolov7-w6's rows at width 0.125 (the ReOrg stem,
IAuxDetect) stand in for the full models."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tests.test_torch_cli import (  # noqa: F401 (jax_float32: fixture)
    N_FRAMES, _results, _yolo_split_dataset, jax_float32)
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    narrow_w6_cfg, one_torch_thread, random_variables, sharpen_heads)
from yolov7_tracker_tpu.cli import track as j_track
from yolov7_tracker_tpu.models import quant as j_quant
from yolov7_tracker_tpu.models import yolo as jyolo
from yolov7_tracker_tpu.models import zoo as j_zoo
from yolov7_tracker_tpu.models.fuse import fuse_variables
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu.utils.checkpoint import save_variables
from yolov7_tracker_tpu_torch.cli import track as t_track
from yolov7_tracker_tpu_torch.models import blocks, quant
from yolov7_tracker_tpu_torch.models import spec as tspec
from yolov7_tracker_tpu_torch.models import zoo as t_zoo
from yolov7_tracker_tpu_torch.models.from_jax import jax_params_to_torch
from yolov7_tracker_tpu_torch.models.yolo import YoloV7, decoded

MODELS = {"tiny": 160, "w6": 128}


def _specs(name):
    if name == "tiny":
        return (j_zoo.get_spec("yolov7-tiny", nc=8),
                t_zoo.get_spec("yolov7-tiny", nc=8))
    cfg = narrow_w6_cfg()
    return j_parse(cfg, name="w6"), tspec.parse_yaml_cfg(cfg, name="w6")


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """JAX: fused variables, synthetic calibration batches, absmax and
    the quantized variables; the port's fused state_dict is the JAX
    fused tree carried over by the bridge."""
    name = request.param
    size = MODELS[name]
    j_spec, t_spec = _specs(name)
    variables = random_variables(j_spec, seed=3)
    fused = fuse_variables(jax.tree.map(jnp.asarray, variables))
    batches = j_quant.default_calib_batches(np.random.default_rng(0), n=2,
                                            batch=1, size=size)
    absmax = j_quant.calibrate(j_spec, fused, batches)
    qvars = j_quant.quantize_variables(j_spec, fused, absmax=absmax)
    fused_sd = jax_params_to_torch(jax.tree.map(np.asarray,
                                                fused["params"]))
    return dict(name=name, size=size, j_spec=j_spec, t_spec=t_spec,
                fused=fused, batches=[np.asarray(b) for b in batches],
                absmax={".".join(k): v for k, v in absmax.items()},
                qvars=qvars, fused_sd=fused_sd)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_quantized_state_equals_jax(case):
    sd = quant.quantize_state_dict(case["t_spec"], case["fused_sd"],
                                   absmax=case["absmax"], device="cpu")
    leaves = dict(_flat(case["qvars"]["params"]))
    nodes = sorted({p[:-1] for p in leaves if p[-1] == "w_scale"})
    for node in nodes:
        name = ".".join(node)
        for leaf in ("kernel", "w_scale", "bias", "a_scale"):
            want = leaves[node + (leaf,)]
            if leaf == "kernel":
                want = want.transpose(3, 2, 0, 1)
            got = sd[f"{name}.{'weight' if leaf == 'kernel' else leaf}"]
            assert got.numpy().dtype == want.dtype, (name, leaf)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name}.{leaf}")
    model = YoloV7(case["t_spec"], fused="int8")
    assert len(nodes) == sum(isinstance(m, blocks.QuantConv)
                             for m in model.modules())
    model.load_state_dict(sd)          # the tree fits the int8 model


def test_calibration_matches_jax(case):
    batches = quant.default_calib_batches(np.random.default_rng(0), n=2,
                                          batch=1, size=case["size"])
    for b, want in zip(batches, case["batches"]):
        np.testing.assert_allclose(b.numpy(), want, atol=1e-6, rtol=0)
    got = quant.calibrate(case["t_spec"], case["fused_sd"], case["batches"],
                          device="cpu")
    assert sorted(got) == sorted(case["absmax"])
    for k, want in case["absmax"].items():
        assert got[k] == pytest.approx(want, rel=1e-6, abs=0), k


def test_int32_accumulation_is_exact():
    """A 3x3 conv over 640 int8 channels near +127: sums near 9e7, past
    2^24, where float32 steps by 8. The port's float64 accumulation gives
    JAX's int32 conv bit for bit; a float32 conv of the same does not."""
    rng = np.random.default_rng(0)
    q = rng.integers(100, 128, (2, 640, 6, 7)).astype(np.float32)
    w = rng.integers(100, 128, (8, 640, 3, 3)).astype(np.int8)
    w[::2] *= -1
    got = blocks.quant_accumulate(torch.from_numpy(q), torch.from_numpy(w),
                                  1, 1, 1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(q.transpose(0, 2, 3, 1).astype(np.int8)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got.to(torch.int32).numpy(), want)
    f32 = torch.nn.functional.conv2d(torch.from_numpy(q),
                                     torch.from_numpy(w).float(), None, 1, 1)
    assert (f32.double() != got).any()


def _rel_parts(a, b, spec, hw):
    return chip_smoke.parts_rel(chip_smoke.output_parts(a, spec, hw),
                                chip_smoke.output_parts(b, spec, hw))


def test_int8_forward_matches_jax(case):
    """Raw lead levels of the int8 model within 1e-3 of each part of JAX's
    (the same int8 state, from the JAX absmax)."""
    spec, size = case["t_spec"], case["size"]
    x = case["batches"][1]
    _, raw = jax.jit(lambda v, x: jyolo.YoloV7(
        case["j_spec"], fused="int8").apply(v, x, training=False))(
        case["qvars"], jnp.asarray(x))
    want = [torch.from_numpy(np.asarray(r)) for r in raw]
    model = YoloV7(spec, fused="int8").eval()
    model.load_state_dict(quant.quantize_state_dict(
        spec, case["fused_sd"], absmax=case["absmax"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert _rel_parts(got, want, spec, (size, size)) <= 1e-3


def test_int8_tracks_fused_float32_and_keeps_heads_float(case):
    """JAX's own fidelity bounds (tests/test_quant.py) for the port's int8
    model against its fused float32 model, calibrated by the port; heads
    stay float, the backbone's first conv is int8 with per-channel scales
    within half a step of the float kernel."""
    spec = case["t_spec"]
    sd = quant.quantize_state_dict(spec, case["fused_sd"],
                                   calib_batches=case["batches"],
                                   device="cpu")
    x = torch.from_numpy(case["batches"][0])
    fmodel = YoloV7(spec, fused=True).eval()
    fmodel.load_state_dict(case["fused_sd"])
    qmodel = YoloV7(spec, fused="int8").eval()
    qmodel.load_state_dict(sd)
    with torch.no_grad():
        y_ref = decoded(fmodel, x).double().numpy()
        y_q = decoded(qmodel, x).double().numpy()
    assert np.corrcoef(y_ref.ravel(), y_q.ravel())[0, 1] > 0.999
    np.testing.assert_allclose(y_q[..., 4], y_ref[..., 4], atol=5e-2)
    heads = [k for k in sd if k.startswith("head_m")]
    assert heads and all(sd[k].dtype == torch.float32 for k in heads)
    assert {f"head_m_{i}.weight" for i in range(spec.nl)} <= set(heads)
    assert all(k.endswith((".weight", ".bias")) for k in heads)
    first = "layer0.conv" if case["name"] == "tiny" else "layer1.conv"
    k, s = sd[f"{first}.weight"], sd[f"{first}.w_scale"]
    assert k.dtype == torch.int8 and s.shape == (k.shape[0],)
    err = (k.float() * s[:, None, None, None]
           - case["fused_sd"][f"{first}.weight"]).abs()
    assert bool((err <= s[:, None, None, None] / 2 + 1e-7).all())
    assert float(sd[f"{first}.a_scale"]) != 1.0


def test_pipeline_int8_needs_fuse_and_keeps_float32():
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

    tcfg = TrackerConfig(tracker="bytetrack", capacity=16, det_capacity=32)
    with pytest.raises(ValueError, match="requires fuse=True"):
        TrackingPipeline(PipelineConfig(img_size=64, fuse=False,
                                        quant="int8"), tcfg, device="cpu")
    pipe = TrackingPipeline(
        PipelineConfig(img_size=64, detector_batch=2, quant="int8",
                       max_det=32),
        tcfg, device="cpu",
        quant_calib=quant.default_calib_batches(np.random.default_rng(0),
                                                n=1, size=64))
    assert pipe.model.fused == "int8"
    assert all(p.dtype == torch.float32 for p in pipe.model.parameters())
    frames = np.random.default_rng(0).integers(0, 255, (2, 48, 80, 3),
                                               dtype=np.uint8)
    assert len(pipe.run_sequence(iter(frames))) == 2


def test_track_cli_quant_int8_equals_jax(jax_float32, tmp_path, monkeypatch):
    """cli/track.py --quant int8 on an image dir (yolov7-tiny, sharpened
    heads, calibrated on the first 4 frames): the same MOT rows as the
    JAX CLI's. Two float32 calibrations part in the last bits of most
    absmax values (41 of 55 here, by up to 5.5e-7), and each such
    difference moves q's rounding boundaries, after which the rows part by
    hundredths of a pixel. So the port's CLI calibrates, its absmax is
    held within 1e-6 of the JAX CLI's, and then both quantize with the
    JAX CLI's."""
    seen = {}
    j_calibrate, t_calibrate = j_quant.calibrate, quant.calibrate

    def jax_calibrate(spec, fused, batches):
        seen.update(j_calibrate(spec, fused, batches))
        return dict(seen)

    def port_calibrate(spec, sd, batches, device=None):
        got = t_calibrate(spec, sd, batches, device)
        want = {".".join(k): v for k, v in seen.items()}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6, abs=0), k
        return want

    monkeypatch.setattr(j_quant, "calibrate", jax_calibrate)
    monkeypatch.setattr(quant, "calibrate", port_calibrate)
    spec = j_zoo.get_spec("yolov7-tiny", nc=1)
    variables = sharpen_heads(random_variables(spec, seed=3), spec,
                              sharpen=32.0, obj_boost=4.0, levels=(0,))
    msgpack = str(tmp_path / "w.msgpack")
    save_variables(msgpack, variables)
    common = (_yolo_split_dataset(tmp_path / "data")
              + ["--model", "yolov7-tiny", "--nc", "1", "--img_size", "160",
                 "--model_path", msgpack, "--tracker", "bytetrack",
                 "--conf_thresh", "0.5", "--capacity", "32",
                 "--det_capacity", "64", "--detector_batch", "4",
                 "--quant", "int8"])
    j_folder = j_track.main(common + ["--output_dir", str(tmp_path / "j")])
    t_folder = t_track.main(common + ["--output_dir", str(tmp_path / "t"),
                                      "--dtype", "float32", "--device",
                                      "cpu"])
    got, want = _results(t_folder), _results(j_folder)
    assert got == want
    rows = got["SYN-01.txt"].splitlines()
    assert {int(r.split(b",")[0]) for r in rows} == set(
        range(1, N_FRAMES + 1))


def test_int8_tail_cfg_promotes_float_layers():
    """An int8 model whose layers keep float parameters (RobustConv's
    pointwise conv and LayerScale): those layers and the heads take their
    input promoted to float32 from a bf16 activation, as Flax promotes a
    bf16 input against float32 parameters; the model runs on a bf16
    input and its float32 output stays near the float32 input's."""
    nc, anchors, rows = chip_smoke.TAIL_CFGS["robust"]
    spec = tspec.parse_yaml_cfg({"nc": nc, "depth_multiple": 1.0,
                                 "width_multiple": 1.0, "anchors": anchors,
                                 "backbone": rows, "head": []})
    from yolov7_tracker_tpu_torch.models.fuse import fuse_state_dict
    from yolov7_tracker_tpu_torch.models.yolo import random_state_dict

    fused = fuse_state_dict(random_state_dict(spec, seed=0))
    x = quant.default_calib_batches(np.random.default_rng(0), n=1,
                                    size=64)[0]
    model = YoloV7(spec, fused="int8").eval()
    model.load_state_dict(quant.quantize_state_dict(spec, fused, [x],
                                                    device="cpu"))
    assert model._float_in == {1, 3}
    with torch.no_grad():
        y16 = model(x.to(torch.bfloat16))
        y32 = model(x)
    assert all(a.dtype == torch.float32 for a in y16)
    assert _rel_parts(y16, y32, spec, (64, 64)) < 0.1
