"""Peaks of the card and the work a solve needs, from shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (no sparsity), at the
full 700 W power limit: 989 TFLOP/s bf16 and fp16, 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
              "float32": FP32_FLOPS}


def peak_flops(dtype: str) -> float:
    """The dense peak of a network computed in ``dtype`` (float32 with
    TF32 off runs outside the tensor cores)."""
    return PEAK_FLOPS[dtype]


def solve_bytes(rows: int, cols: int) -> int:
    """One masked assignment read once and written once: the float32
    cost (rows x cols), the bool row and column masks, the float32
    threshold; the int32 row-to-column and column-to-row results."""
    return 4 * rows * cols + rows + cols + 4 + 4 * (rows + cols)


def solve_flops(rows: int, cols: int) -> int:
    """One pass over the cost: 2 float32 operations a cell."""
    return 2 * rows * cols


def solve_bound_s(rows: int, cols: int) -> float:
    """The least time the card could take for one solve: the larger of
    its bytes over HBM bandwidth and its operations over float32 peak."""
    return max(solve_bytes(rows, cols) / HBM_BYTES_PER_S,
               solve_flops(rows, cols) / FP32_FLOPS)


def conv_flops(model: nn.Module, input_shape: Sequence[int]) -> int:
    """Operations of one forward of ``model`` at ``input_shape``, 2 k^2
    Cin Cout H W / groups a conv it runs, from the shapes alone (meta
    tensors): the published architecture's work, whatever computes it."""
    model = model.to("meta")
    total = [0]

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        total[0] += (2 * k * m.in_channels * m.out_channels
                     * out.shape[-2] * out.shape[-1] // m.groups)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            model(torch.empty(tuple(input_shape), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return total[0]
