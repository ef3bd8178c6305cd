"""Weight bridge: the JAX model's variables -> the port's state_dict.

``jax_variables_to_torch`` takes the Flax ``{"params", "batch_stats"}``
tree of ``yolov7_tracker_tpu.models.yolo.build_model`` as NUMPY arrays,
before ``fuse_variables``, and returns the unfused state_dict of
``YoloV7(spec, fused=False)``: Flax (kh, kw, cin, cout) kernels become
(cout, cin, kh, kw), BN scale/bias/mean/var and the implicit vectors
carry across under the same module path. The port then folds them
itself (models/fuse.py), so both packages compute the same detector.
``slab_from_numpy`` / ``slab_to_numpy`` carry tracker state across: the
two packages' TrackSlabs have the same fields, so a slab of numpy leaves
(``jax.tree.map(np.asarray, jax_slab)``) becomes the port's and back.
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


def jax_variables_to_torch(variables_np: Mapping, spec: ModelSpec
                           ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables_np["params"]):
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        sd[".".join(path[:-1] + (_PARAM_LEAF[path[-1]],))] = torch.tensor(arr)
    for path, leaf in _flatten(variables_np.get("batch_stats", {})):
        base = ".".join(path[:-1])
        sd[f"{base}.{_STAT_LEAF[path[-1]]}"] = torch.tensor(
            np.asarray(leaf, np.float32))
        sd[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    want = YoloV7(spec, fused=False).state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(
            f"variables do not match the spec: missing {missing[:5]}, "
            f"unexpected {extra[:5]}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)} != "
                             f"{tuple(v.shape)}")
    return sd


def slab_from_numpy(slab_np, device="cpu") -> TrackSlab:
    """A TrackSlab (or any tuple in its field order) of numpy leaves, e.g.
    the JAX package's slab fetched to the host, as the port's TrackSlab."""
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
