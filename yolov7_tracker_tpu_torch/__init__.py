"""PyTorch + CUDA port of yolov7_tracker_tpu (the JAX package beside it).

The layout mirrors the JAX package (ops/, models/, trackers/, data/,
pipeline.py, cli/) so each module has an obvious counterpart; public
functions keep the JAX layouts (frames (B, H, W, 3) uint8, raw head
levels (B, ny, nx, na, no), slab fields of trackers/slab.py) so the two
packages can be compared on the same numpy inputs. This package never
imports jax, flax or yolov7_tracker_tpu.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU and no device given they raise instead of falling back.
``load_pipeline`` is the one-call loader (the JAX package's hubconf-style
``load_pipeline``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU. A CUDA device
    must exist: without one this raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "on the CPU")
    return dev


def load_pipeline(model: str = "yolov7-tiny", tracker: str = "bytetrack",
                  img_size: int = 640, nc: int = 80, weights: str = "",
                  device=None, **tracker_kw):
    """A ready TrackingPipeline in one call (the JAX package's
    ``load_pipeline``, yolov7_tracker_tpu/__init__.py:26, the reference's
    hubconf.py): the zoo's ``model`` with ``nc`` classes at ``img_size``,
    the ``tracker`` with ``tracker_kw`` as TrackerConfig fields, on the
    card unless ``device`` says otherwise. ``weights``: a ``.pt`` file is a
    reference checkpoint or state_dict (models/convert: a pickled
    checkpoint is unpickled, which runs code from the file, as the JAX
    loader does; reference names are converted), any other file a Flax
    variables msgpack (utils/flax_msgpack); none gives seeded random
    weights."""
    from .models import zoo
    from .pipeline import PipelineConfig, TrackingPipeline
    from .trackers.slab import TrackerConfig

    spec = zoo.get_spec(model, nc=nc)
    state_dict = None
    if weights:
        if weights.endswith(".pt"):
            from .models.convert import load_detector_weights

            state_dict = load_detector_weights(weights, spec, unpickle=True)
        else:
            from .models.from_jax import jax_variables_to_torch
            from .utils.flax_msgpack import load_variables

            state_dict = jax_variables_to_torch(load_variables(weights), spec)
    return TrackingPipeline(
        PipelineConfig(model=model, nc=nc, img_size=img_size),
        TrackerConfig(tracker=tracker, **tracker_kw),
        state_dict=state_dict, spec=spec, device=device)
