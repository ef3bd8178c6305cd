"""Sequence-parallel tracking over the ranks of a mesh (port of
yolov7_tracker_tpu/parallel/tracking.py).

The reference's per-sequence loop (track.py:123) is embarrassingly
parallel: tracker state never crosses sequences. Each rank steps its
contiguous block of the S streams through the frames with the loop of
``track_scan_multi`` (trackers/registry.scan_streams: stage 1 by the
square auction, kernel K3 on a card; stages 2 + 3 as one launch of kernel
K4), with no collective inside the frame loop; the slabs and outputs are
gathered back in stream order.
"""

from __future__ import annotations

from typing import Callable

from ..trackers import slab as S
from ..trackers.registry import scan_streams
from .mesh import DataMesh, gather, shard_batch


def make_sharded_tracker(pipe_or_step, mesh: DataMesh) -> Callable:
    """(slabs (S, ...), det_streams: every field (T, S, D, ...), the warp
    (T, S, 2, 3) or one (2, 3)) -> (slabs (S, ...), FrameOutput (T, S,
    ...)), every rank holding the whole result. ``pipe_or_step``: a
    TrackingPipeline or a tracker step (trackers/registry.build_tracker).
    S must divide by the world size, as JAX's sharding requires. Every
    rank must call it (the gathers are collectives)."""
    step = getattr(pipe_or_step, "step", pipe_or_step)

    def run(slabs: S.TrackSlab, det_streams: S.DetSlab):
        warp = det_streams.warp
        if warp.dim() > 2:
            warp = shard_batch(mesh, warp, axis=1)
        mine, outs = scan_streams(step, shard_batch(mesh, slabs), S.DetSlab(
            *shard_batch(mesh, tuple(det_streams[:-1]), axis=1), warp))
        return gather(mesh, mine), gather(mesh, outs, axis=1)

    return run


def stack_slabs(cfg: S.TrackerConfig, n: int, device=None) -> S.TrackSlab:
    """n fresh slabs stacked on a leading sequence axis, on ``device``
    (None: the card)."""
    from .. import resolve_device

    return S.stacked([S.init_slab(cfg, resolve_device(device))] * n)
