"""Height-sharded detection of one frame over the ranks of a mesh (port of
yolov7_tracker_tpu/parallel/spatial.py).

The JAX package splits a frame's rows over the mesh and lets GSPMD
partition every conv, inserting the halo exchanges itself. Here each rank
runs the detector on its band of the letterboxed rows, and every op that
reads rows beyond a band's edge takes them from the ranks that hold them:

- each ``nn.Conv2d`` whose kernel has more than one row (RepConv, DownC,
  CrossConv's (k, 1), Ghost, MixConv2d ...) in a shallow copy of the
  model that shares its weights, its row padding replaced by the
  neighbours' rows (zeros only beyond the image);
- ``blocks.max_pool``, through ``blocks.row_halo`` (-inf beyond the
  image).

A halo may be wider than a neighbour's band (SPPCSPC's k = 13 pool reads
6 rows; yolov7-w6 at 1088 has 10 rows at P6), so each exchange gathers
every rank's edge rows and a band takes its halo from as many ranks as it
spans. The band edges are multiples of the model's largest stride, so
every op with a row stride (strided convs and pools, ``reorg``, Focus,
Contract) starts a band on an even row and the row-local ops (1x1 convs,
``upsample_nearest``, Expand, the transposed conv of RobustConv2) need no
rows from a neighbour at all. The bands are as even as that allows; a
frame needs at least one stride-row a rank (``H / max_stride >= n``),
where the JAX package would pad inside XLA. The head levels are gathered
along ny in rank order (``YoloV7.level_hook``), before DetectV8's grid
decode, so every rank ends with the unsharded model's output.

Blocks that mix rows globally have no halo rule here and are refused:
the Swin and transformer blocks, Classify's global pool, and the
functional convs of RepConv_OREPA and of the int8 QuantConv.
"""

from __future__ import annotations

import copy
import itertools
from typing import Callable, List

import torch
import torch.nn.functional as F
from torch import nn

from ..models import blocks
from ..models.yolo import YoloV7
from .mesh import DataMesh, gather_tensor

_NO_HALO_RULE = (blocks.SwinBlock, blocks.SwinTransformerLayer,
                 blocks.STCSP, blocks.TransformerBlock,
                 blocks.TransformerLayer, blocks.Classify,
                 blocks.RepConvOREPA, blocks.QuantConv)


def bands(height: int, max_stride: int, n: int) -> List[int]:
    """The n bands' heights in rows: multiples of ``max_stride``, as even
    as possible (the first ones one stride-row taller)."""
    if height % max_stride:
        raise ValueError(f"height {height} is not a multiple of the largest "
                         f"stride {max_stride}")
    rows = height // max_stride
    if rows < n:
        raise ValueError(
            f"H / max_stride = {height} / {max_stride} = {rows} rows of the "
            f"coarsest level for {n} ranks: height-sharding needs one a rank")
    base, extra = divmod(rows, n)
    return [(base + (r < extra)) * max_stride for r in range(n)]


class _Halo:
    """The exchanges of one rank's band: ``heights`` are every band's
    heights in input rows."""

    def __init__(self, mesh: DataMesh, heights: List[int]):
        self.mesh = mesh
        self.heights = heights

    def sizes(self, x) -> List[int]:
        """Every band's height at ``x``'s level."""
        s, rem = divmod(self.heights[self.mesh.rank], x.shape[2])
        if rem or any(h % s for h in self.heights):
            raise ValueError(f"a map of {x.shape[2]} rows does not tile "
                             f"the bands {self.heights}")
        return [h // s for h in self.heights]

    def gather(self, x):
        """The whole level along rows, in rank order."""
        return gather_tensor(self.mesh, x, 2, self.sizes(x))

    def __call__(self, x, top: int, bottom: int, fill: float):
        """x (B, C, h, W) with ``top`` rows above and ``bottom`` below:
        the nearest rows of the ranks above and below, ``fill`` beyond the
        image."""
        if top == 0 and bottom == 0:
            return x
        sizes, r = self.sizes(x), self.mesh.rank
        h = x.shape[2]
        tail = x[:, :, max(h - top, 0):]
        head = x[:, :, :bottom]
        edge = torch.cat([_pad_rows(tail, top), _pad_rows(head, bottom)], 2)
        edges = gather_tensor(self.mesh, edge, 0)
        edges = edges.reshape((self.mesh.size,) + edge.shape)
        above, need = [], top
        for q in range(r - 1, -1, -1):
            if need == 0:
                break
            have = min(top, sizes[q])
            take = min(need, have)
            above.insert(0, edges[q][:, :, have - take:have])
            need -= take
        if need:
            above.insert(0, _rows_of(x, need, fill))
        below, need = [], bottom
        for q in range(r + 1, self.mesh.size):
            if need == 0:
                break
            take = min(need, sizes[q])
            below.append(edges[q][:, :, top:top + take])
            need -= take
        if need:
            below.append(_rows_of(x, need, fill))
        return torch.cat(above + [x] + below, 2)


def _pad_rows(x, n: int):
    """x's first n rows, zero rows after them when it has fewer."""
    if x.shape[2] >= n:
        return x[:, :, :n]
    return torch.cat([x, _rows_of(x, n - x.shape[2], 0.0)], 2)


def _rows_of(x, n: int, fill: float):
    return x.new_full((x.shape[0], x.shape[1], n, x.shape[3]), fill)


class _HaloConv(nn.Module):
    """``conv`` (shared, not copied) with its row padding taken from the
    neighbouring bands."""

    def __init__(self, conv: nn.Conv2d, halo: _Halo):
        super().__init__()
        if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise NotImplementedError(f"no halo rule for {conv}")
        self.conv = conv
        self.halo = halo
        (kh, _), (sh, _) = conv.kernel_size, conv.stride
        self.rows = blocks.halo_rows(kh, sh, conv.padding[0],
                                     conv.dilation[0])

    def forward(self, x):
        c = self.conv
        h = x.shape[2]
        y = F.conv2d(self.halo(x, *self.rows, 0.0), c.weight, c.bias,
                     c.stride, (0, c.padding[1]), c.dilation, c.groups)
        return y[:, :, :h // c.stride[0]]


def _with_halos(model: YoloV7, halo: _Halo) -> YoloV7:
    """A shallow copy of ``model`` (the same parameters and buffers) whose
    row-mixing convs take halos and whose head levels are gathered."""
    for name, m in model.named_modules():
        if isinstance(m, _NO_HALO_RULE):
            raise NotImplementedError(
                f"{type(m).__name__} ({name}) has no halo rule: it mixes "
                "rows across the whole map; height-sharding cannot run it")
    shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                model.buffers())}
    copied = copy.deepcopy(model, shared)
    for m in list(copied.modules()):
        for name, child in list(m.named_children()):
            if (isinstance(child, nn.Conv2d)
                    and (child.kernel_size[0] > 1 or child.stride[0] > 1)):
                setattr(m, name, _HaloConv(child, halo))
    copied.level_hook = halo.gather
    return copied


def make_spatial_detector(model: YoloV7, mesh: DataMesh) -> Callable:
    """forward(imgs (B, H, W, 3), the whole letterboxed batch on every
    rank) -> the model's output (raw levels, or DetectV8's decoded rows)
    for the whole frame on every rank, each rank computing its band of
    rows. H must be a multiple of the largest stride with ``H /
    max_stride >= mesh.size``. Every rank must call it (the halos and the
    gathers are collectives)."""
    stride = max(model.spec.strides)
    halo = _Halo(mesh, [])
    sharded = _with_halos(model, halo)

    def forward(imgs):
        heights = bands(imgs.shape[1], stride, mesh.size)
        halo.heights = heights
        top = sum(heights[:mesh.rank])
        band = imgs[:, top:top + heights[mesh.rank]]
        with blocks.row_halo(halo):
            return sharded(band)

    return forward
