"""Model export (port of yolov7_tracker_tpu/models/export.py). The JAX
package writes the StableHLO text of its jitted inference graph and the
compiled executable's cost analysis; the port's counterparts are a
``torch.export`` program of the detector's inference forward (decoded
output), saved with ``torch.export.save``, and the same three stats:

- ``flops``: torch.utils.flop_counter.FlopCounterMode over one forward
  (2 per multiply-add, as XLA counts them);
- ``memory_mb``: the card's peak allocation over one forward, above what
  was allocated before it, in MB of 1e6 bytes;
- ``bytes_accessed``: torch gives no such count, so -1.0, as the JAX
  package reports a cost-analysis key it lacks (and ``memory_mb`` is -1.0
  on the CPU).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
from torch import nn

from .yolo import YoloV7, decoded


class Decoded(nn.Module):
    """The detector's inference output: (B, N, no) decoded predictions."""

    def __init__(self, model: YoloV7):
        super().__init__()
        self.model = model

    def forward(self, x):
        return decoded(self.model, x)


def _example(model: YoloV7, img_hw: Tuple[int, int], batch: int, dtype):
    p = next(model.parameters())
    return torch.zeros((batch, img_hw[0], img_hw[1], 3), dtype=dtype,
                       device=p.device)


def export_program(model: YoloV7, img_hw: Tuple[int, int], out_path: str,
                   batch: int = 1, dtype=torch.float32) -> str:
    """``torch.export`` the inference forward of ``model`` (as it stands:
    device, dtype and fusion) at a static (batch, H, W, 3) input of
    ``dtype`` and write it to ``out_path`` (a .pt2 archive)."""
    program = torch.export.export(
        Decoded(model).eval(), (_example(model, img_hw, batch, dtype),))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    return out_path


def load_program(path: str) -> nn.Module:
    """A saved program as a callable module (x -> decoded predictions)."""
    return torch.export.load(path).module()


@torch.no_grad()
def export_compiled_stats(model: YoloV7, img_hw: Tuple[int, int],
                          batch: int = 1, dtype=torch.float32) -> dict:
    """{'flops', 'bytes_accessed', 'memory_mb'} of one inference forward
    of ``model`` at (batch, H, W, 3); a value torch cannot give is -1.0."""
    from torch.utils.flop_counter import FlopCounterMode

    x = _example(model, img_hw, batch, dtype)
    wrapped = Decoded(model).eval()
    counter = FlopCounterMode(display=False)
    with counter:
        wrapped(x)
    memory_mb = -1.0
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
        base = torch.cuda.memory_allocated(x.device)
        torch.cuda.reset_peak_memory_stats(x.device)
        wrapped(x)
        torch.cuda.synchronize(x.device)
        memory_mb = (torch.cuda.max_memory_allocated(x.device) - base) / 1e6
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": -1.0, "memory_mb": memory_mb}
