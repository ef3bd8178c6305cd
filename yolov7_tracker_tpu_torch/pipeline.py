"""End-to-end tracking pipeline: frames -> detections -> tracks (port of
yolov7_tracker_tpu/pipeline.py).

  uint8 frames --> device_preprocess --> YoloV7 --> nms_from_raw
      --> scale_coords --> DetSlab --> ByteTrack slab step --> FrameOutput

The detector runs on batches of ``detector_batch`` frames; the tracker
then steps through the batch frame by frame (the JAX ``lax.scan`` as a
Python loop). Everything stays on the device except the NMS loop
conditions and the packed per-batch outputs.

Two solvers serve stage 1 of the tracker step. The sequence modes
(``run_sequence*``, ``process_batch``, ``track_frames``) keep the
private-dummy auction (kernel K2), the JAX package's TPU choice. The
streaming modes (``step_frame``, ``process_multistream``,
``track_scan_multi``) take the exact square auction (kernels K1 and K3),
which is what the JAX package's streaming entry points run on every
backend but a TPU: a wrong pairing in a crowded many-camera scene costs
an id switch, and the same algorithm as the reference lets the two
packages be held against each other through ties.

Not in the port yet: GMC, ReID, int8, the width-packed front, spatial
sharding and detect_per_frame skipping.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .data import letterbox
from .models import zoo
from .models.fuse import fuse_state_dict
from .models.yolo import YoloV7, random_state_dict
from .ops import nms as nms_mod
from .ops.assignment import masked_assignment
from .trackers import slab as S
from .trackers.registry import build_tracker


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    model: str = "yolov7-tiny"
    nc: int = 80
    img_size: int = 640            # letterbox target (square budget)
    conf_thres: float = 0.01       # NMS conf (post_process_v7)
    iou_thres: float = 0.45
    max_det: int = 300
    nms_top_k: int = 2048
    detector_batch: int = 8
    dtype: str = "bfloat16"        # detector compute dtype
    fuse: bool = True              # fold BN (and ia/im) into the convs


def pack_frame_output(outs: S.FrameOutput) -> torch.Tensor:
    """FrameOutput -> one (..., T, 8) float32 tensor. Track ids ride
    BIT-cast (int32 viewed as float32): float32 is exact only to 2^24."""
    return torch.cat([
        outs.track_id.to(torch.int32).view(torch.float32)[..., None],
        outs.tlwh.float(),
        outs.score.float()[..., None],
        outs.cls.float()[..., None],
        outs.valid.float()[..., None],
    ], dim=-1)


class TrackingPipeline:
    """Detector + tracker on one device.

    state_dict: the detector's UNFUSED weights (models/from_jax.py layout);
    None means seeded random weights (``seed``). device: None = the GPU
    (raises if there is none); pass "cpu" to run on the CPU.
    """

    def __init__(self, pcfg: PipelineConfig, tcfg: S.TrackerConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 spec=None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.spec = spec or zoo.get_spec(pcfg.model, nc=pcfg.nc)
        if state_dict is None:
            state_dict = random_state_dict(self.spec, seed)
        if pcfg.fuse:
            state_dict = fuse_state_dict(state_dict)
        self.dtype = (torch.bfloat16 if pcfg.dtype == "bfloat16"
                      else torch.float32)
        model = YoloV7(self.spec, fused=pcfg.fuse)
        model.load_state_dict(state_dict)
        model = model.to(self.device, self.dtype).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.step, self.tcfg = build_tracker(tcfg)
        if self.tcfg.det_capacity < pcfg.max_det:
            warnings.warn(
                f"det_capacity={self.tcfg.det_capacity} < max_det="
                f"{pcfg.max_det}: frames with more NMS survivors keep only "
                "the top-scoring ones, dropping the low-confidence "
                "detections ByteTrack's second stage uses.", stacklevel=2)
        self._anchors = torch.as_tensor(self.spec.anchors_per_level(),
                                        device=self.device)
        self._geometry_cache: Dict[Tuple[int, int], tuple] = {}

    # ------------------------------------------------------------------
    # detector
    # ------------------------------------------------------------------

    def _geometry(self, src_hw: Tuple[int, int]):
        """(canvas (h, w), unpadded resize (h, w)) for one resolution."""
        if src_hw not in self._geometry_cache:
            _, (uw, uh), (dw, dh) = letterbox.letterbox_params(
                src_hw, (self.pcfg.img_size, self.pcfg.img_size),
                stride=max(self.spec.strides))
            top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
            left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
            self._geometry_cache[src_hw] = (
                (uh + top + bottom, uw + left + right), (uh, uw))
        return self._geometry_cache[src_hw]

    def _frames(self, frames_u8) -> torch.Tensor:
        if not isinstance(frames_u8, torch.Tensor):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        return frames_u8.to(self.device, non_blocking=True)

    @torch.no_grad()
    def detect_batch(self, frames_u8):
        """(B, H, W, 3) uint8 -> (boxes (B, max_det, 4) tlbr in frame
        pixels, score (B, max_det), cls (B, max_det), counts (B,))."""
        frames = self._frames(frames_u8)
        src_hw = tuple(frames.shape[1:3])
        out_hw, unpad_hw = self._geometry(src_hw)
        imgs, _ = letterbox.device_preprocess(
            frames, src_hw, out_hw, unpad_hw=unpad_hw, dtype=self.dtype)
        raw = self.model(imgs)
        dets, counts = nms_mod.nms_from_raw(
            raw, self._anchors, tuple(self.spec.strides),
            self.pcfg.conf_thres, self.pcfg.iou_thres,
            max_det=self.pcfg.max_det, top_k=self.pcfg.nms_top_k)
        boxes = letterbox.scale_coords_device(dets[..., :4], out_hw, src_hw)
        return boxes, dets[..., 4], dets[..., 5], counts

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------

    def init_tracker(self) -> S.TrackSlab:
        return S.init_slab(self.tcfg, self.device)

    def save_tracker_state(self, slab: S.TrackSlab, path: str,
                           tag: str = "") -> None:
        """Checkpoint mid-sequence tracker state to ``path`` (npz, the JAX
        package's layout). ``tag`` (e.g. the stream source) guards against
        resuming another stream's state."""
        S.save_slab(path, slab, self.tcfg, tag=tag)

    def load_tracker_state(self, path: str,
                           expect_tag: str = "") -> S.TrackSlab:
        """Resume state saved by :meth:`save_tracker_state` (or by the JAX
        package); raises ValueError on a config- or tag-incompatible
        checkpoint."""
        return S.load_slab(path, self.tcfg, self.device,
                           expect_tag=expect_tag)

    def dets_to_slab(self, boxes, score, cls, count) -> S.DetSlab:
        """Detector outputs of one frame, or of S frames with a leading
        stream axis, cut to det_capacity."""
        d = self.tcfg.det_capacity
        boxes = boxes[..., :d, :].float()
        return S.DetSlab(
            tlbr=boxes, score=score[..., :d].float(),
            cls=cls[..., :d].float(),
            valid=(torch.arange(d, device=boxes.device)
                   < torch.as_tensor(count, device=boxes.device)[..., None]),
            feature=torch.zeros(boxes.shape[:-1] + (self.tcfg.feature_dim,),
                                device=boxes.device))

    def track_frames(self, slab: S.TrackSlab, det_slabs):
        """Step the tracker through a list of DetSlabs; returns (slab,
        FrameOutput stacked over the frames)."""
        outs = []
        for det in det_slabs:
            slab, out = self.step(slab, det)
            outs.append(out)
        return slab, S.FrameOutput(*(torch.stack(f) for f in zip(*outs)))

    def process_batch(self, slab: S.TrackSlab, frames_u8):
        """Detect + track a batch of frames; returns (slab, FrameOutput
        with a leading frame axis)."""
        boxes, score, cls, counts = self.detect_batch(frames_u8)
        return self.track_frames(slab, [
            self.dets_to_slab(boxes[b], score[b], cls[b], counts[b])
            for b in range(boxes.shape[0])])

    # ------------------------------------------------------------------
    # streaming: S independent streams advance one frame each per call,
    # or one stream one frame. Stage 1 is solved by the exact square
    # auction (see the module docstring): K3 for S streams, K1 for one.
    # ------------------------------------------------------------------

    def init_multistream(self, n_streams: int) -> S.TrackSlab:
        """A fresh slab per stream, stacked on a leading stream axis."""
        slab = self.init_tracker()
        return S.TrackSlab(*(
            x[None].repeat((n_streams,) + (1,) * x.dim()) for x in slab))

    def track_scan_multi(self, slabs: S.TrackSlab, det_streams: S.DetSlab):
        """slabs: stacked over S streams; det_streams: every field
        (T, S, D, ...). Steps all streams together through the T frames;
        returns (slabs, FrameOutput (T, S, ...))."""
        outs = []
        for t in range(det_streams.valid.shape[0]):
            slabs, out = self.step(
                slabs, S.DetSlab(*(x[t] for x in det_streams)),
                solve_stage1=masked_assignment)
            outs.append(out)
        return slabs, S.FrameOutput(*(torch.stack(f) for f in zip(*outs)))

    def process_multistream(self, slabs: S.TrackSlab, frames_u8):
        """One frame for each of S independent streams: ONE detector batch
        over the streams' frames (S, H, W, 3), then one tracker step over
        the stacked slabs (no scan: the streams advance together, so the
        step's small launches are paid once for S frames)."""
        boxes, score, cls, counts = self.detect_batch(frames_u8)
        return self.step(slabs, self.dets_to_slab(boxes, score, cls, counts),
                         solve_stage1=masked_assignment)

    def step_frame(self, slab: S.TrackSlab, frame):
        """Detect + associate one (H, W, 3) frame of one stream: the
        latency-oriented streaming mode."""
        if not isinstance(frame, torch.Tensor):
            frame = torch.from_numpy(np.ascontiguousarray(frame))
        boxes, score, cls, counts = self.detect_batch(frame[None])
        return self.step(
            slab, self.dets_to_slab(boxes[0], score[0], cls[0], counts[0]),
            solve_stage1=masked_assignment)

    # ------------------------------------------------------------------
    # output packing: one D2H transfer per batch
    # ------------------------------------------------------------------

    @staticmethod
    def pack_output(outs: S.FrameOutput) -> torch.Tensor:
        return pack_frame_output(outs)

    @staticmethod
    def unpack_output(arr) -> S.FrameOutput:
        """Host-side inverse of pack_output (numpy leaves)."""
        arr = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr)
        return S.FrameOutput(
            track_id=np.ascontiguousarray(arr[..., 0],
                                          dtype=np.float32).view(np.int32),
            tlwh=arr[..., 1:5], score=arr[..., 5], cls=arr[..., 6],
            valid=arr[..., 7] > 0.5)

    @staticmethod
    def _emit(results, outs: S.FrameOutput, first_frame: int) -> None:
        for b in range(outs.valid.shape[0]):
            v = outs.valid[b]
            results.append((first_frame + b, outs.track_id[b][v].tolist(),
                            list(outs.tlwh[b][v]),
                            outs.cls[b][v].astype(int).tolist()))

    # ------------------------------------------------------------------
    # sequences
    # ------------------------------------------------------------------

    def run_sequence_detections(self, dets_by_frame, n_frames: int):
        """Track from external detections {frame (1-based): (N, 6)
        [x1, y1, x2, y2, score, cls]}; returns [(frame_id, ids, tlwhs,
        clses)]."""
        d = self.tcfg.det_capacity
        slab = self.init_tracker()
        results = []
        for f in range(1, n_frames + 1):
            rows = np.asarray(dets_by_frame.get(f, np.zeros((0, 6))),
                              np.float32).reshape(-1, 6)
            if rows.shape[0] > d:
                rows = rows[np.argsort(-rows[:, 4], kind="stable")[:d]]
            det = S.make_det_slab(self.tcfg, rows[:, :4], rows[:, 4],
                                  rows[:, 5], np.ones(len(rows), bool),
                                  self.device)
            slab, out = self.step(slab, det)
            packed = self.pack_output(S.FrameOutput(
                *(x[None] for x in out)))
            self._emit(results, self.unpack_output(packed), f)
        return results

    def run_sequence(self, frames: Iterable[np.ndarray]):
        """Track a sequence of uint8 HWC frames; returns per-frame
        [(frame_id, ids, tlwhs, clses)]."""
        results, _ = self.run_sequence_stateful(frames)
        return results

    def run_sequence_stateful(self, frames: Iterable[np.ndarray],
                              initial_slab: Optional[S.TrackSlab] = None):
        """:meth:`run_sequence` from ``initial_slab`` (frame numbering
        continues from its counter); returns (results, final slab)."""
        slab = initial_slab if initial_slab is not None \
            else self.init_tracker()
        frame_id = int(slab.frame)
        results = []
        batch = []

        def flush(slab):
            nonlocal frame_id
            slab, outs = self.process_batch(slab, np.stack(batch))
            self._emit(results, self.unpack_output(self.pack_output(outs)),
                       frame_id + 1)
            frame_id += len(batch)
            batch.clear()
            return slab

        for f in frames:
            batch.append(f)
            if len(batch) == self.pcfg.detector_batch:
                slab = flush(slab)
        if batch:
            slab = flush(slab)
        return results, slab
