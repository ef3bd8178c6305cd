"""Reference checkpoint -> the port's state_dict (port of
yolov7_tracker_tpu/models/convert.py).

``convert_state_dict`` maps a state_dict in the reference's names
(``model.{i}.<block-internal>``, with or without a ``module.`` prefix)
onto the port's UNFUSED state_dict, in the port's names (the Flax tree's,
see models/yolo.py). Both sides are torch, so kernels keep their (O, I,
H, W) layout and implicit vectors only lose their (1, C, 1, 1) shape. It
covers the kinds the port builds:

- Conv / DWConv (conv, bn), DownC (cv1..cv3), SPPCSPC (cv1..cv7), SPP,
  SPPF, Focus, Stem;
- Bottleneck, whose n > 1 repeats parse_model wraps in an nn.Sequential
  (``{i}.{j}.cv1`` -> ``m{j}_cv1``), and the CSP family, C3 and C2f
  (``{i}.m.{j}.cv1`` -> ``m{j}.cv1``);
- RepConv in training form (rbr_dense / rbr_1x1 / rbr_identity) and in
  deploy form (rbr_reparam), which is folded back into the dense branch
  with an identity BN, a zero 1x1 branch and, where the module has an
  identity branch, a zero identity BN;
- the Detect / IDetect / IAuxDetect / IBin heads (m, m2, ia, im) and
  DetectV8 (cv2 / cv3 towers);
- the zoo's tail (JAX convert.py:237-293): GhostConv (cv1, cv2), Ghost
  (conv.0 / conv.2, and conv.1 / shortcut.0 / shortcut.1 at stride 2),
  GhostSPPCSPC and the GhostCSP inner, the Swin v1 / v2 blocks and their
  ST(2)CSP wrappers (Linear weights stay (out, in); v2's ``qkv.weight``
  becomes the Flax-layout ``qkv_kernel``), RepConv_OREPA in training form
  (deploy form raises, as in JAX), RobustConv and RobustConv2. JAX reads
  the reference's ConvTranspose2d weight (in, out, kh, kw) as a Flax
  (kh, kw, in, out) kernel, which Flax applies unflipped, i.e. flipped
  in torch's terms; the port converts it the same way, so it computes
  what the JAX package computes for such a checkpoint.

``state_dict_from_reference_ckpt`` unpickles a full reference checkpoint
(``{'model' | 'ema': nn.Module}``, what the reference's train.py writes),
which needs the reference repository importable (``PYTHONPATH``).
``load_detector_weights`` reads any of the files the CLIs' --model_path
takes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .from_jax import check_state_dict
from .spec import CSP_KINDS, ModelSpec

BN_EPS = 1e-5
_HEADS = ("Detect", "IDetect", "IAuxDetect", "IBin")
_STCSP = ("STCSPA", "STCSPB", "STCSPC", "ST2CSPA", "ST2CSPB", "ST2CSPC")
_OREPA_LEAVES = ("weight_rbr_origin", "weight_rbr_avg_conv",
                 "weight_rbr_pfir_conv", "weight_rbr_1x1_kxk_idconv1",
                 "weight_rbr_1x1_kxk_conv2", "weight_rbr_gconv_dw",
                 "weight_rbr_gconv_pw", "vector")


def _strip(key: str) -> str:
    for p in ("module.", "model."):
        if key.startswith(p):
            key = key[len(p):]
    return key


def convert_state_dict(sd: Mapping[str, torch.Tensor], spec: ModelSpec
                       ) -> Dict[str, torch.Tensor]:
    """A reference-layout state_dict -> the state_dict of ``YoloV7(spec,
    fused=False)`` (float32; BN batch counters 0). Raises KeyError on a
    missing key, ValueError if the result does not fit the spec."""
    src = {_strip(k): v.detach().to("cpu", torch.float32)
           for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def bn(dst, s):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = src[f"{s}.{leaf}"].clone()
        out[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    def const_bn(dst, c, scale):
        out[f"{dst}.weight"] = torch.full((c,), scale)
        out[f"{dst}.bias"] = torch.zeros(c)
        out[f"{dst}.running_mean"] = torch.zeros(c)
        out[f"{dst}.running_var"] = torch.full((c,), 1.0 - BN_EPS)
        out[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    def conv_bn(dst, s):
        out[f"{dst}.conv.weight"] = src[f"{s}.conv.weight"].clone()
        bn(f"{dst}.bn", f"{s}.bn")

    def rep_conv(dst, s, identity):
        """``identity``: the port's module has the identity branch."""
        if f"{s}.rbr_reparam.weight" in src:
            w = src[f"{s}.rbr_reparam.weight"]
            c2 = w.shape[0]
            out[f"{dst}.rbr_dense_conv.weight"] = w.clone()
            const_bn(f"{dst}.rbr_dense_bn", c2, 1.0)
            out[f"{dst}.rbr_dense_bn.bias"] = src[
                f"{s}.rbr_reparam.bias"].clone()
            out[f"{dst}.rbr_1x1_conv.weight"] = torch.zeros(
                w.shape[:2] + (1, 1))
            const_bn(f"{dst}.rbr_1x1_bn", c2, 1.0)
            if identity:
                const_bn(f"{dst}.rbr_identity", c2, 0.0)
            return
        out[f"{dst}.rbr_dense_conv.weight"] = src[
            f"{s}.rbr_dense.0.weight"].clone()
        bn(f"{dst}.rbr_dense_bn", f"{s}.rbr_dense.1")
        out[f"{dst}.rbr_1x1_conv.weight"] = src[
            f"{s}.rbr_1x1.0.weight"].clone()
        bn(f"{dst}.rbr_1x1_bn", f"{s}.rbr_1x1.1")
        if f"{s}.rbr_identity.weight" in src:
            bn(f"{dst}.rbr_identity", f"{s}.rbr_identity")

    def ghost_conv(dst, s):
        conv_bn(f"{dst}.cv1", f"{s}.cv1")
        conv_bn(f"{dst}.cv2", f"{s}.cv2")

    def ghost_block(dst, s):
        ghost_conv(f"{dst}.conv0", f"{s}.conv.0")
        ghost_conv(f"{dst}.conv2", f"{s}.conv.2")
        if f"{s}.conv.1.conv.weight" in src:          # stride 2
            conv_bn(f"{dst}.conv1", f"{s}.conv.1")
            conv_bn(f"{dst}.shortcut0", f"{s}.shortcut.0")
            conv_bn(f"{dst}.shortcut1", f"{s}.shortcut.1")

    def copy(dst, s, *leaves):
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = src[f"{s}.{leaf}"].clone()

    def swin_block(dst, s, n_layers, v2):
        if f"{s}.conv.conv.weight" in src:
            conv_bn(f"{dst}.conv", f"{s}.conv")
        for j in range(n_layers):
            d, b = f"{dst}.blocks{j}", f"{s}.blocks.{j}"
            for norm in ("norm1", "norm2"):
                copy(f"{d}.{norm}", f"{b}.{norm}", "weight", "bias")
            copy(f"{d}.mlp_fc1", f"{b}.mlp.fc1", "weight", "bias")
            copy(f"{d}.mlp_fc2", f"{b}.mlp.fc2", "weight", "bias")
            copy(f"{d}.attn.proj", f"{b}.attn.proj", "weight", "bias")
            if v2:
                out[f"{d}.attn.qkv_kernel"] = src[
                    f"{b}.attn.qkv.weight"].T.contiguous()
                copy(f"{d}.attn", f"{b}.attn", "q_bias", "v_bias",
                     "logit_scale")
                copy(f"{d}.attn.cpb_fc1", f"{b}.attn.cpb_mlp.0", "weight",
                     "bias")
                copy(f"{d}.attn.cpb_fc2", f"{b}.attn.cpb_mlp.2", "weight")
            else:
                copy(f"{d}.attn.qkv", f"{b}.attn.qkv", "weight", "bias")
                copy(f"{d}.attn", f"{b}.attn",
                     "relative_position_bias_table")

    def orepa(dst, s):
        if f"{s}.rbr_reparam.weight" in src:
            raise NotImplementedError(
                f"{s}: deploy-form RepConv_OREPA checkpoints are not "
                "supported (nor in the JAX converter)")
        copy(f"{dst}.rbr_dense", f"{s}.rbr_dense", *_OREPA_LEAVES)
        bn(f"{dst}.rbr_dense.bn", f"{s}.rbr_dense.bn")
        copy(f"{dst}.rbr_1x1_conv", f"{s}.rbr_1x1.conv", "weight")
        bn(f"{dst}.rbr_1x1_bn", f"{s}.rbr_1x1.bn")
        if f"{s}.rbr_identity.weight" in src:
            bn(f"{dst}.rbr_identity", f"{s}.rbr_identity")

    for l in spec.layers:
        i, k = l.index, l.kind
        name, pre = f"layer{i}", f"{i}"
        c1 = spec.layers[l.frm[0]].c_out if i > 0 else 3
        if k in ("Conv", "DWConv"):
            conv_bn(name, pre)
        elif k == "RepConv":
            rep_conv(name, pre, c1 == l.c_out and l.args[1] == 1)
        elif k in ("DownC", "SPPCSPC", "SPP", "SPPF", "Stem"):
            cvs = {"DownC": 3, "SPPCSPC": 7, "SPP": 2, "SPPF": 2,
                   "Stem": 4}[k]
            for j in range(1, cvs + 1):
                conv_bn(f"{name}.cv{j}", f"{pre}.cv{j}")
        elif k == "Focus":
            conv_bn(f"{name}.conv", f"{pre}.conv")
        elif k == "Bottleneck":
            n = l.args[0]
            for j in range(n):
                for cv in ("cv1", "cv2"):
                    if n > 1:   # parse_model's nn.Sequential of repeats
                        conv_bn(f"{name}.m{j}_{cv}", f"{pre}.{j}.{cv}")
                    else:
                        conv_bn(f"{name}.{cv}", f"{pre}.{cv}")
        elif k in CSP_KINDS:
            variant, inner = CSP_KINDS[k][:2]
            for j in range(1, 5 if variant == "c" else 4):
                conv_bn(f"{name}.cv{j}", f"{pre}.cv{j}")
            for j in range(l.args[0]):
                d, s = f"{name}.m{j}", f"{pre}.m.{j}"
                if inner == "ghost":
                    ghost_block(d, s)
                    continue
                conv_bn(f"{d}.cv1", f"{s}.cv1")
                if inner == "bottleneck":
                    conv_bn(f"{d}.cv2", f"{s}.cv2")
                elif inner == "res":
                    conv_bn(f"{d}.cv2", f"{s}.cv2")
                    conv_bn(f"{d}.cv3", f"{s}.cv3")
                elif inner == "rep_bottleneck":   # RepConv c_ // 2 -> c_
                    rep_conv(f"{d}.cv2", f"{s}.cv2", False)
                else:                             # rep_res: c -> c
                    rep_conv(f"{d}.cv2", f"{s}.cv2", True)
                    conv_bn(f"{d}.cv3", f"{s}.cv3")
        elif k in ("C3", "C2f"):
            for j in range(1, 4 if k == "C3" else 3):
                conv_bn(f"{name}.cv{j}", f"{pre}.cv{j}")
            for j in range(l.args[0]):
                for cv in ("cv1", "cv2"):
                    conv_bn(f"{name}.m{j}.{cv}", f"{pre}.m.{j}.{cv}")
        elif k == "DetectV8":
            for br in ("cv2", "cv3"):
                for h in range(spec.nl):
                    for j in (0, 1):
                        conv_bn(f"head_{br}_{h}_{j}", f"{pre}.{br}.{h}.{j}")
                    for leaf in ("weight", "bias"):
                        out[f"head_{br}_{h}_2.{leaf}"] = src[
                            f"{pre}.{br}.{h}.2.{leaf}"].clone()
        elif k in _HEADS:
            for h in range(len(spec.head_from)):
                aux = h >= spec.nl
                s = f"{pre}.{'m2' if aux else 'm'}.{h % spec.nl}"
                d = f"head_m{'2' if aux else ''}_{h % spec.nl}"
                for leaf in ("weight", "bias"):
                    out[f"{d}.{leaf}"] = src[f"{s}.{leaf}"].clone()
            if k != "Detect":
                for h in range(spec.nl):
                    for imp in ("ia", "im"):
                        out[f"head_{imp}_{h}.implicit"] = src[
                            f"{pre}.{imp}.{h}.implicit"].reshape(-1).clone()
        elif k == "GhostConv":
            ghost_conv(name, pre)
        elif k == "Ghost":
            ghost_block(name, pre)
        elif k == "GhostSPPCSPC":
            for j in range(1, 8):
                ghost_conv(f"{name}.cv{j}", f"{pre}.cv{j}")
        elif k in ("SwinTransformerBlock", "SwinTransformer2Block"):
            swin_block(name, pre, l.args[1], k == "SwinTransformer2Block")
        elif k in _STCSP:
            for j in range(1, 5 if k.endswith("C") else 4):
                conv_bn(f"{name}.cv{j}", f"{pre}.cv{j}")
            swin_block(f"{name}.m", f"{pre}.m", l.args[0],
                       k.startswith("ST2"))
        elif k == "RepConv_OREPA":
            orepa(name, pre)
        elif k == "RobustConv":
            conv_bn(f"{name}.conv_dw", f"{pre}.conv_dw")
            copy(f"{name}.conv1x1", f"{pre}.conv1x1", "weight", "bias")
            copy(name, pre, "gamma")
        elif k == "RobustConv2":
            conv_bn(f"{name}.conv_strided", f"{pre}.conv_strided")
            # (in, out, kh, kw) read as Flax's (kh, kw, in, out), then
            # the bridge's (out, in, kh, kw)
            out[f"{name}.conv_deconv.weight"] = src[
                f"{pre}.conv_deconv.weight"].permute(1, 0, 2, 3).contiguous()
            copy(f"{name}.conv_deconv", f"{pre}.conv_deconv", "bias")
            copy(name, pre, "gamma")
        elif k not in ("MP", "SP", "ReOrg", "Upsample", "Concat",
                       "Shortcut", "Contract", "Expand", "Chuncat",
                       "Foldcut"):
            raise NotImplementedError(f"layer {i}: unknown kind {k!r}")
    check_state_dict(out, spec)
    return out


def is_reference_layout(sd: Mapping[str, torch.Tensor]) -> bool:
    """True when ``sd``'s keys are the reference's (``model.0.conv.weight``,
    ``0.conv.weight``, ``module.model.0...``), False when they are the
    port's (``layer0.conv.weight``, ``head_m_0.weight`` ...)."""
    return bool(sd) and all(_strip(k).split(".", 1)[0].isdigit()
                            for k in sd)


def state_dict_from_reference_ckpt(path: str):
    """Unpickle a reference .pt (``{'ema' | 'model': nn.Module}``, as
    attempt_load reads it) and return the module's float32 state_dict.
    The pickle names the reference's classes (models.yolo.Model ...), so
    the reference repository must be importable (``PYTHONPATH=<its
    checkout>``). Unpickling runs code from the file: pass only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ((ckpt.get("ema") or ckpt.get("model"))
             if isinstance(ckpt, dict) else ckpt)
    if not isinstance(model, torch.nn.Module):
        raise ValueError(f"{path}: no 'ema' or 'model' module in the "
                         "checkpoint")
    return model.float().state_dict()


def load_detector_weights(path: str, spec: ModelSpec,
                          unpickle: bool = False) -> Dict[str, torch.Tensor]:
    """--model_path as an unfused state_dict in the port's names. A Flax
    variables file (.msgpack / .npz, what the JAX CLI saves) goes through
    models/from_jax; any other file is read with torch.load: a state_dict
    in the reference's names (``model.0.conv.weight`` ...) is converted,
    one in the port's names is taken as it is. A pickled reference
    checkpoint (``{'model' | 'ema': module}``, as the reference's train.py
    saves it) is read through ``state_dict_from_reference_ckpt`` only when
    ``unpickle`` is set (--trust_model_path of cli.track and cli.serve),
    since that runs code from the file; else it raises."""
    if path.endswith((".msgpack", ".npz")):
        from ..utils.flax_msgpack import load_variables
        from .from_jax import jax_variables_to_torch

        return jax_variables_to_torch(load_variables(path), spec)
    import pickle

    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:     # not tensors alone: a module
        if not unpickle:
            raise ValueError(
                f"{path} is a pickled checkpoint, not a state_dict: "
                "unpickling it runs code from the file. If you trust it, "
                "load it with unpickle=True (cli.track's and cli.serve's "
                "--trust_model_path), with the reference repository on "
                "PYTHONPATH.") from e
        sd = state_dict_from_reference_ckpt(path)
    if is_reference_layout(sd):
        sd = convert_state_dict(sd, spec)
    return sd
