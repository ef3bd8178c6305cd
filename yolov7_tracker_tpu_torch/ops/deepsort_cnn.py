"""K5: the DeepSORT CNN's forward with its BatchNorms folded, as
hand-written float32 kernels for Hopper (``csrc/deepsort_cnn.cu``), and
its plain version.

``fold(model)`` folds each BatchNorm of a ``reid.deepsort_cnn.
DeepSortCNN`` into its convolution, in float64 and then cast to float32:
weight * s and (bias - mean) * s + beta with s = gamma / sqrt(var + eps).
The weights are laid out as the kernels read them: a 3x3 conv's rows in
the order of K5's K steps, (c_in / 16, kh, kw, 16) x c_out (``K_STEP``
channels of one tap a step, the 9 taps of a chunk in turn), and the second
conv of each downsampling block carries the block's 1x1 projection as
extra rows, its bias added to the conv's: that conv is relu(W2 * y + Wd *
x + b2 + bd). The module stays the owner of the state dict (checkpoints
load into it as before); fold again after changing its weights.

``forward(folded, crops)`` takes (N, 128, 64, 3) normalised crops, the
layout ``reid.extractor.extract_crops`` produces, and returns (N, 512)
L2-normalised embeddings. On a CUDA tensor it launches K5, 18 launches
whatever N (the stem, the 16 convolutions, the head), each counted as
``launches.k5`` while utils/trace.py records, or raises; on a CPU tensor
it runs ``forward_plain``, the same folded arithmetic with F.conv2d (the
projection as a second conv summed in). Both compute in float32 with
float32 sums; they differ from the module's eager forward only by where
the rounding falls (relative 1e-6 on the embeddings).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..utils import trace
from .cuda_build import build_library

CROP_HW = (128, 64)          # csrc/deepsort_cnn.cu: the stem's width is 64
K_STEP = 16                  # csrc/deepsort_cnn.cu BK: channels a K step
FEATURE_DIM = 512            # the head's channels

_LIB = None
BUILD_SECONDS = None
BUILD_LOG = ""               # nvcc's -Xptxas -v report


class FoldedConv(NamedTuple):
    weight: torch.Tensor     # (9 c_in [+ c_in of the projection], c_out),
    #                          the 3x3's rows in K step order (_k_steps)
    bias: torch.Tensor       # (c_out,)
    c_in: int                # of the 3x3 conv
    stride: int              # of the 3x3 conv
    project: bool            # rows after 9 c_in: the block's 1x1 projection


class FoldedDeepSort(NamedTuple):
    stem_weight: torch.Tensor            # (27, 64)
    stem_bias: torch.Tensor              # (64,)
    convs: Tuple[FoldedConv, ...]        # conv1, conv2 of each block


def _k_steps(w, inverse=False):
    """A 3x3 conv's (kh kw c_in, c_out) rows to K5's K step order (c_in /
    K_STEP, kh, kw, K_STEP), or back with ``inverse``."""
    c_in, c_out = w.shape[0] // 9, w.shape[1]
    if c_in % K_STEP:        # the stem's 3 channels: one tap a row
        return w
    shape = ((c_in // K_STEP, 9, K_STEP, c_out) if inverse
             else (9, c_in // K_STEP, K_STEP, c_out))
    return w.reshape(shape).transpose(0, 1).reshape(9 * c_in, c_out)


def _scaled(conv_w, conv_b, bn):
    """conv (c_out, c_in, kh, kw) + BN in eval mode -> float64 weight
    (kh, kw, c_in, c_out) flattened to (kh kw c_in, c_out) and bias."""
    w = conv_w.detach().double()
    s = bn.weight.detach().double() / torch.sqrt(
        bn.running_var.detach().double() + bn.eps)
    b = (conv_b.detach().double() if conv_b is not None
         else torch.zeros_like(s))
    b = (b - bn.running_mean.detach().double()) * s + bn.bias.detach().double()
    w = (w * s[:, None, None, None]).permute(2, 3, 1, 0)
    return w.reshape(-1, w.shape[-1]), b


def _f32(w, b):
    return w.float().contiguous(), b.float().contiguous()


def fold(model) -> FoldedDeepSort:
    """The folded weights of a DeepSortCNN, on the module's device."""
    conv0, bn0 = model.conv[0], model.conv[1]
    stem_w, stem_b = _f32(*_scaled(conv0.weight, conv0.bias, bn0))
    convs = []
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in layer:
            w1, b1 = _scaled(blk.conv1.weight, None, blk.bn1)
            w1, b1 = _f32(_k_steps(w1), b1)
            convs.append(FoldedConv(w1, b1, blk.conv1.in_channels,
                                    blk.conv1.stride[0], False))
            w2, b2 = _scaled(blk.conv2.weight, None, blk.bn2)
            w2 = _k_steps(w2)
            if blk.downsample is not None:
                wd, bd = _scaled(blk.downsample[0].weight, None,
                                 blk.downsample[1])
                w2, b2 = torch.cat([w2, wd]), b2 + bd
            w2, b2 = _f32(w2, b2)
            convs.append(FoldedConv(w2, b2, blk.conv2.in_channels, 1,
                                    blk.downsample is not None))
    return FoldedDeepSort(stem_w, stem_b, tuple(convs))


def forward(folded: FoldedDeepSort, crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) float32 crops -> (N, 512) embeddings: K5 on a CUDA
    tensor, the plain version on a CPU one."""
    if crops.is_cuda:
        return forward_cuda(folded, crops)
    return forward_plain(folded, crops)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _conv_plain(x, conv: FoldedConv, shortcut):
    """relu(conv3x3(x) + b + (projection of / identity) shortcut), NCHW."""
    c_out = conv.weight.shape[1]
    k3 = _k_steps(conv.weight[:9 * conv.c_in], inverse=True).reshape(
        3, 3, conv.c_in, c_out)
    y = F.conv2d(x, k3.permute(3, 2, 0, 1), stride=conv.stride, padding=1)
    if conv.project:
        proj = conv.weight[9 * conv.c_in:].t()[:, :, None, None]
        y = y + F.conv2d(shortcut, proj, stride=2)
    y = y + conv.bias[:, None, None]
    if shortcut is not None and not conv.project:
        y = y + shortcut
    return torch.relu(y)


def forward_plain(folded: FoldedDeepSort, crops: torch.Tensor
                  ) -> torch.Tensor:
    """K5's arithmetic in PyTorch ops, on any device and crop size."""
    x = crops.permute(0, 3, 1, 2)
    stem = folded.stem_weight.reshape(3, 3, 3, -1).permute(3, 2, 0, 1)
    x = torch.relu(F.conv2d(x, stem, folded.stem_bias, padding=1))
    x = F.max_pool2d(x, 3, 2, padding=1)
    convs = folded.convs
    for conv1, conv2 in zip(convs[0::2], convs[1::2]):
        y = _conv_plain(x, conv1, None)
        x = _conv_plain(y, conv2, x)
    x = x.mean(dim=(2, 3))
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def load_library():
    """Build csrc/deepsort_cnn.cu (see ops/cuda_build.py) at first use and
    bind it with ctypes."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_SECONDS, BUILD_LOG = build_library("deepsort_cnn.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k5_stem_launch.argtypes = [ptr, i32, i32, ptr, ptr, ptr, ptr]
    lib.k5_conv_launch.argtypes = [
        ptr, i32, i32, i32, i32, i32,     # x, N, H, W, C, stride
        ptr, i32,                         # xs (projection input), Cs
        ptr, ptr, ptr, i32,               # res, w, b, Cout
        ptr, ptr]                         # out, stream
    lib.k5_head_launch.argtypes = [ptr, i32, i32, ptr, ptr]
    for fn in (lib.k5_stem_launch, lib.k5_conv_launch, lib.k5_head_launch):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"K5 {what} launch failed: CUDA error {err}")
    # counted while utils/trace.py records: the tests, chip_smoke.py and a
    # traced benchmark run read that the path went through the kernel
    trace.count("launches.k5")


def forward_cuda(folded: FoldedDeepSort, crops: torch.Tensor
                 ) -> torch.Tensor:
    """Launch K5 on (N, 128, 64, 3) float32 crops on the card."""
    if not crops.is_cuda:
        raise ValueError("K5 needs a CUDA tensor")
    if (crops.dtype != torch.float32 or crops.dim() != 4
            or tuple(crops.shape[1:]) != CROP_HW + (3,)):
        raise ValueError(f"K5 takes (N, {CROP_HW[0]}, {CROP_HW[1]}, 3) "
                         f"float32 crops, got {tuple(crops.shape)} "
                         f"{crops.dtype}")
    for t in (folded.stem_weight,) + tuple(c.weight for c in folded.convs):
        if t.device != crops.device:
            raise ValueError("the folded weights are not on the crops' "
                             "device: fold the model after moving it")
    n = crops.shape[0]
    out = torch.empty((n, FEATURE_DIM), dtype=torch.float32,
                      device=crops.device)
    lib = load_library()
    stream = torch.cuda.current_stream(crops.device).cuda_stream
    crops = crops.contiguous()
    h, w = CROP_HW[0] // 2, CROP_HW[1] // 2
    x = torch.empty((n, h, w, folded.stem_bias.shape[0]),
                    dtype=torch.float32, device=crops.device)
    _check(lib.k5_stem_launch(crops.data_ptr(), n, CROP_HW[0],
                              folded.stem_weight.data_ptr(),
                              folded.stem_bias.data_ptr(), x.data_ptr(),
                              stream), "stem")
    convs = folded.convs
    for conv1, conv2 in zip(convs[0::2], convs[1::2]):
        c_out = conv1.weight.shape[1]
        ho, wo = (h - 1) // conv1.stride + 1, (w - 1) // conv1.stride + 1
        y = torch.empty((n, ho, wo, c_out), dtype=torch.float32,
                        device=crops.device)
        _check(lib.k5_conv_launch(
            x.data_ptr(), n, h, w, conv1.c_in, conv1.stride, None, 0, None,
            conv1.weight.data_ptr(), conv1.bias.data_ptr(), c_out,
            y.data_ptr(), stream), "conv")
        z = torch.empty_like(y)
        project = conv2.project
        _check(lib.k5_conv_launch(
            y.data_ptr(), n, ho, wo, conv2.c_in, 1,
            x.data_ptr() if project else None,
            x.shape[-1] if project else 0,
            None if project else x.data_ptr(),
            conv2.weight.data_ptr(), conv2.bias.data_ptr(), c_out,
            z.data_ptr(), stream), "conv")
        x, h, w = z, ho, wo
    if x.shape[-1] != FEATURE_DIM:
        raise ValueError(f"K5's head takes {FEATURE_DIM} channels, the "
                         f"network ends with {x.shape[-1]}")
    _check(lib.k5_head_launch(x.data_ptr(), n, h * w, out.data_ptr(),
                              stream), "head")
    return out
