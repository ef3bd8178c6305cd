"""SigmoidBin decode for the IBin head (port of
yolov7_tracker_tpu/models/ibin.py; reference utils/loss.py:33-118,
models/yolo.py:161-233).

The head predicts, per value (w or h), 1 regression logit + BIN_COUNT bin
logits over [BIN_MIN, BIN_MAX]; the decoded value is the centre of the
argmax bin plus the scaled regression residual (the reference's
use_fw_regression=True path, loss.py:70-80). Inputs are already
sigmoided, as the head's ``y = x.sigmoid()``.
"""

from __future__ import annotations

import torch

from .spec import BIN_COUNT

BIN_MIN, BIN_MAX = 0.0, 4.0
_SCALE = BIN_MAX - BIN_MIN
_STEP = _SCALE / BIN_COUNT
_REG_SCALE = 2.0


def bin_centers(device=None) -> torch.Tensor:
    """(BIN_COUNT,) float32 bin centres."""
    start = BIN_MIN + _SCALE / 2.0 / BIN_COUNT
    return start + _STEP * torch.arange(BIN_COUNT, dtype=torch.float32,
                                        device=device)


def sigmoid_bin_decode(pred: torch.Tensor) -> torch.Tensor:
    """pred (..., BIN_COUNT + 1) sigmoided -> the decoded value (...,).
    The residual is computed in pred's dtype and the sum promotes to
    float32 (or pred's wider dtype), as in JAX; argmax takes the first
    maximum, as jnp.argmax does."""
    reg = (pred[..., 0] * _REG_SCALE - _REG_SCALE / 2.0) * _STEP
    idx = torch.argmax(pred[..., 1:], dim=-1)
    return bin_centers(pred.device)[idx] + reg
