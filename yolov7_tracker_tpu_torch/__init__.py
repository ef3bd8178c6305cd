"""PyTorch + CUDA port of yolov7_tracker_tpu (the JAX package beside it).

The layout mirrors the JAX package (ops/, models/, trackers/, data/,
pipeline.py, cli/) so each module has an obvious counterpart; public
functions keep the JAX layouts (frames (B, H, W, 3) uint8, raw head
levels (B, ny, nx, na, no), slab fields of trackers/slab.py) so the two
packages can be compared on the same numpy inputs. This package never
imports jax, flax or yolov7_tracker_tpu.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU and no device given they raise instead of falling back.
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
