"""Weight bridge: the JAX model's variables -> the port's state_dict.

``jax_variables_to_torch`` takes the Flax ``{"params", "batch_stats"}``
tree of ``yolov7_tracker_tpu.models.yolo.build_model`` as NUMPY arrays,
before ``fuse_variables``, and returns the unfused state_dict of
``YoloV7(spec, fused=False)``: Flax (kh, kw, cin, cout) kernels become
(cout, cin, kh, kw) (a ConvTranspose's (kh, kw, in, out) too:
blocks.FlaxConvTranspose reads it so), Dense (in, out) kernels torch's
(out, in), BN and LayerNorm scale/bias/mean/var and the implicit vectors
carry across under the same module path, and raw parameters keep their
name and layout (OREPA's OIHW branch kernels and ``vector``, Swin's
``qkv_kernel``, ``q_bias``, ``v_bias``, ``logit_scale`` and bias table,
LayerScale ``gamma``, MultiheadAttention's ``in_proj_*``). The port then folds them
itself (models/fuse.py), so both packages compute the same detector.
``slab_from_numpy`` / ``slab_to_numpy`` carry tracker state across: the
two packages' TrackSlabs have the same fields, so a slab of numpy leaves
(``jax.tree.map(np.asarray, jax_slab)``) becomes the port's and back.
``osnet_variables_to_torch`` and ``deepsort_cnn_variables_to_torch`` map
the Flax ReID models' variables onto the torchreid / reference parameter
names of reid/osnet.py and reid/deepsort_cnn.py; ``dhn_state_dict`` and
``postlinker_state_dict`` do the same for the DHN (reid/dhn.py) and the
AFLink PostLinker (reid/aflink.py).
Nothing here imports JAX: the caller hands in numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..trackers.slab import TrackSlab
from .spec import ModelSpec
from .yolo import YoloV7

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "implicit": "implicit"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_params_to_torch(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax ``params`` tree (numpy) -> {port parameter name: tensor}: the
    parameters, or any tree of their shape (EMA, momentum buffers, a
    gradient sum)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params_np):
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        leaf_name = _PARAM_LEAF.get(path[-1], path[-1])
        sd[".".join(path[:-1] + (leaf_name,))] = torch.tensor(arr)
    return sd


def flax_leaf_name(name: str, param: torch.Tensor) -> str:
    """The Flax leaf name a port parameter maps to (the inverse of the
    renaming above): a conv's weight is a ``kernel``, a BatchNorm's a
    ``scale``; ``bias`` and ``implicit`` keep their names."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight":
        return "kernel" if param.dim() > 1 else "scale"
    return leaf


def jax_variables_to_torch(variables_np: Mapping, spec: ModelSpec
                           ) -> Dict[str, torch.Tensor]:
    sd = jax_params_to_torch(variables_np["params"])
    for path, leaf in _flatten(variables_np.get("batch_stats", {})):
        base = ".".join(path[:-1])
        sd[f"{base}.{_STAT_LEAF[path[-1]]}"] = torch.tensor(
            np.asarray(leaf, np.float32))
        sd[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    check_state_dict(sd, spec)
    return sd


def check_state_dict(sd: Mapping[str, torch.Tensor], spec: ModelSpec
                     ) -> None:
    """Raise ValueError unless ``sd`` has exactly the keys and shapes of
    ``YoloV7(spec, fused=False)`` (built on the meta device: no memory)."""
    with torch.device("meta"):
        want = YoloV7(spec, fused=False).state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(
            f"weights do not match the spec: missing {missing[:5]}, "
            f"unexpected {extra[:5]}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)} != "
                             f"{tuple(v.shape)}")


def slab_from_numpy(slab_np, device=None) -> TrackSlab:
    """A TrackSlab (or any tuple in its field order) of numpy leaves, e.g.
    the JAX package's slab fetched to the host, as the port's TrackSlab on
    ``device`` (None: the card; raises without one)."""
    from .. import resolve_device

    device = resolve_device(device)
    leaves = tuple(slab_np)
    if len(leaves) != len(TrackSlab._fields):
        raise ValueError(f"expected {len(TrackSlab._fields)} slab fields, "
                         f"got {len(leaves)}")
    return TrackSlab(*(torch.tensor(np.asarray(x), device=device)
                       for x in leaves))


def slab_to_numpy(slab: TrackSlab) -> TrackSlab:
    """The port's slab with numpy leaves, in the JAX TrackSlab's field
    order (``JaxTrackSlab(*slab_to_numpy(slab))`` on the JAX side)."""
    return TrackSlab(*(x.detach().cpu().numpy() for x in slab))


def _reid_variables_to_torch(variables_np: Mapping, model, flax_path
                             ) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s state_dict from Flax variables: ``flax_path(key)``
    names the Flax module path of each torch parameter prefix."""
    params = dict(_flatten(variables_np["params"]))
    stats = dict(_flatten(variables_np.get("batch_stats", {})))
    sd = {}
    for key, want in model.state_dict().items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            sd[key] = torch.zeros((), dtype=torch.long)
            continue
        path = flax_path(prefix)
        if leaf in ("running_mean", "running_var"):
            arr = stats[path + (leaf[len("running_"):],)]
        elif leaf == "bias":
            arr = params[path + ("bias",)]
        elif want.dim() == 1:                    # a norm's scale
            arr = params[path + ("scale",)]
        else:
            arr = params[path + ("kernel",)]
            arr = np.asarray(arr).transpose(
                (3, 2, 0, 1) if want.dim() == 4 else (1, 0))
        arr = np.asarray(arr, np.float32)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        sd[key] = torch.tensor(arr)
    return sd


def _osnet_flax_path(prefix: str) -> tuple:
    """torchreid module path -> the JAX OSNet's: conv2.0.conv2b.1 ->
    (conv2_0, conv2b_1), conv2.2.0 (transition) -> (conv2_t,),
    fc.0 -> (fc_0,)."""
    parts = prefix.split(".")
    out = []
    if parts[0] in ("conv2", "conv3", "conv4"):
        if int(parts[1]) < 2:
            out.append(f"{parts[0]}_{parts[1]}")
            parts = parts[2:]
        else:
            out.append(f"{parts[0]}_t")
            parts = parts[3:]
    elif parts[0] == "fc":
        return (f"fc_{parts[1]}",)
    while parts:
        if len(parts) > 1 and parts[1].isdigit():
            out.append(f"{parts[0]}_{parts[1]}")
            parts = parts[2:]
        else:
            out.append(parts.pop(0))
    return tuple(out)


def osnet_variables_to_torch(variables_np: Mapping, model
                             ) -> Dict[str, torch.Tensor]:
    """The JAX OSNet's variables (numpy) -> the state_dict of the port's
    OSNet ``model`` of the same width."""
    return _reid_variables_to_torch(variables_np, model, _osnet_flax_path)


def _deepsort_flax_path(prefix: str) -> tuple:
    """reference Net path -> the JAX DeepSortCNN's: conv.0 -> conv0,
    conv.1 -> bn0, layer2.0.downsample.1 -> (block2, down_bn)."""
    parts = prefix.split(".")
    if parts[0] == "conv":
        return ("conv0" if parts[1] == "0" else "bn0",)
    block = f"block{(int(parts[0][len('layer'):]) - 1) * 2 + int(parts[1])}"
    if parts[2] == "downsample":
        return (block, "down_conv" if parts[3] == "0" else "down_bn")
    return (block, parts[2])


def deepsort_cnn_variables_to_torch(variables_np: Mapping, model
                                    ) -> Dict[str, torch.Tensor]:
    """The JAX DeepSortCNN's variables (numpy) -> the state_dict of the
    port's DeepSortCNN."""
    return _reid_variables_to_torch(variables_np, model, _deepsort_flax_path)


def _linear(sd, name, leaf):
    sd[f"{name}.weight"] = torch.tensor(
        np.asarray(leaf["kernel"], np.float32).T.copy())
    sd[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))


def _gru_cell(sd, cell, gru, suffix):
    """One Flax GRUCell -> one layer and direction of nn.GRU. Flax gates
    r = s(x W_ir + b_ir + h W_hr), z likewise, n = tanh(x W_in + b_in +
    r * (h W_hn + b_hn)); torch's gates in the order (r, z, n) with b_hr =
    b_hz = 0."""
    f32 = lambda x: np.asarray(x, np.float32)            # noqa: E731
    w_ih = np.concatenate([f32(cell[f"i{g}"]["kernel"]) for g in "rzn"], 1)
    w_hh = np.concatenate([f32(cell[f"h{g}"]["kernel"]) for g in "rzn"], 1)
    b_hn = f32(cell["hn"]["bias"])
    sd[f"{gru}.weight_ih{suffix}"] = torch.tensor(w_ih.T.copy())
    sd[f"{gru}.weight_hh{suffix}"] = torch.tensor(w_hh.T.copy())
    sd[f"{gru}.bias_ih{suffix}"] = torch.tensor(np.concatenate(
        [f32(cell[f"i{g}"]["bias"]) for g in "rzn"]))
    sd[f"{gru}.bias_hh{suffix}"] = torch.tensor(np.concatenate(
        [np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn]))


def dhn_state_dict(variables_np: Mapping, arch: str
                   ) -> Dict[str, torch.Tensor]:
    """The JAX DHN's variables (numpy) -> the state_dict of the port's
    ``reid.dhn.build_dhn(arch)``: 'gru' (each BiGRU's four GRUCells,
    l{layer}_{fwd,bwd}, as the layers and directions of one nn.GRU) or
    'sinkhorn'."""
    params = variables_np["params"]
    sd: Dict[str, torch.Tensor] = {}
    if arch == "sinkhorn":
        sd["log_tau"] = torch.tensor(np.asarray(params["log_tau"],
                                                np.float32))
        for name in ("cell_1", "cell_2", "cell_out"):
            _linear(sd, name, params[name])
        return sd
    if arch != "gru":
        raise ValueError(f"unknown dhn arch {arch!r}; have gru|sinkhorn")
    for name in ("hidden2tag_1", "hidden2tag_2", "hidden2tag_3"):
        _linear(sd, name, params[name])
    for gru in ("lstm_row", "lstm_col"):
        for layer in (0, 1):
            for way, tail in (("fwd", ""), ("bwd", "_reverse")):
                _gru_cell(sd, params[gru][f"l{layer}_{way}"], gru,
                          f"_l{layer}{tail}")
    return sd


def _dense(sd, name) -> dict:
    return {"bias": sd[f"{name}.bias"].detach().cpu().numpy().astype(
                np.float32),
            "kernel": sd[f"{name}.weight"].detach().cpu().numpy().astype(
                np.float32).T.copy()}


def _flax_gru_cell(sd, gru, suffix) -> dict:
    """One layer and direction of nn.GRU -> one Flax GRUCell (the inverse
    of ``_gru_cell``). Raises if the r / z hidden biases are not zero:
    Flax's GRUCell has none."""
    f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    w_ih = f32(sd[f"{gru}.weight_ih{suffix}"]).T        # (in, 3H), r z n
    w_hh = f32(sd[f"{gru}.weight_hh{suffix}"]).T
    b_ih = f32(sd[f"{gru}.bias_ih{suffix}"])
    b_hh = f32(sd[f"{gru}.bias_hh{suffix}"])
    h = b_hh.shape[0] // 3
    if b_hh[:2 * h].any():
        raise ValueError(f"{gru}.bias_hh{suffix}: the r / z hidden biases "
                         "are not zero, which a Flax GRUCell cannot hold")
    cell = {}
    for j, g in enumerate("rzn"):
        cell[f"i{g}"] = {"bias": b_ih[j * h:(j + 1) * h].copy(),
                         "kernel": w_ih[:, j * h:(j + 1) * h].copy()}
        cell[f"h{g}"] = {"kernel": w_hh[:, j * h:(j + 1) * h].copy()}
    cell["hn"]["bias"] = b_hh[2 * h:].copy()
    return {k: dict(sorted(cell[k].items())) for k in sorted(cell)}


def dhn_variables(state_dict: Mapping, arch: str) -> dict:
    """The port's DHN state_dict -> the JAX DHN's variables {"params": ...}
    with numpy leaves (the inverse of ``dhn_state_dict``), in the key order
    of the JAX module's init; ``utils/flax_msgpack.save_variables`` writes
    them as the JAX package's ``checkpoint.save_variables`` does."""
    if arch == "sinkhorn":
        params = {"log_tau": state_dict["log_tau"].detach().cpu().numpy()
                  .astype(np.float32)}
        for name in ("cell_1", "cell_2", "cell_out"):
            params[name] = _dense(state_dict, name)
        return {"params": params}
    if arch != "gru":
        raise ValueError(f"unknown dhn arch {arch!r}; have gru|sinkhorn")
    params = {}
    for gru in ("lstm_row", "lstm_col"):
        params[gru] = {
            f"l{layer}_{way}": _flax_gru_cell(state_dict, gru,
                                              f"_l{layer}{tail}")
            for layer in (0, 1)
            for way, tail in (("fwd", ""), ("bwd", "_reverse"))}
    for name in ("hidden2tag_1", "hidden2tag_2", "hidden2tag_3"):
        params[name] = _dense(state_dict, name)
    return {"params": params}


def _postlinker_flax_path(prefix: str) -> tuple:
    """reid/aflink.py module path -> the JAX PostLinker's: m1.t0.bnf ->
    (m1_t0, bnf), m2.fuse.conv -> (m2_fuse, conv), fc1 -> (fc1,)."""
    parts = prefix.split(".")
    if len(parts) == 1:
        return (parts[0],)
    return (f"{parts[0]}_{parts[1]}", parts[2])


def postlinker_state_dict(variables_np: Mapping, model
                          ) -> Dict[str, torch.Tensor]:
    """The JAX PostLinker's variables (params and batch_stats, numpy) ->
    the state_dict of the port's PostLinker: Flax's NHWC conv kernels
    become NCHW ones here, once."""
    return _reid_variables_to_torch(variables_np, model,
                                    _postlinker_flax_path)
