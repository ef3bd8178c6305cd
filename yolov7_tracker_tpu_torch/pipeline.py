"""End-to-end tracking pipeline: frames -> detections -> tracks (port of
yolov7_tracker_tpu/pipeline.py).

  uint8 frames --> device_preprocess --> YoloV7 --> nms_from_raw (the
      anchor heads) or nms (IBin's and DetectV8's decoded boxes)
      --> scale_coords --> DetSlab (+ ReID features: device crops and the DeepSORT CNN,
      BN folded, as kernel K5, or OSNet; + the GMC warp: ECC on the device or ORB on
      the host)
      --> tracker slab step --> FrameOutput

Every entry takes one frame path: the detector body ``_detect`` (on
batches of ``detector_batch`` frames in the sequence modes), the DetSlab
of ``_det_slab`` (trackers/slab.make_det_slab's layout, the warp, the
ReID features), and the tracker's steps (trackers/registry.scan, the JAX
``lax.scan`` as a Python loop). Everything stays on the device except the
packed per-batch outputs: on the card NMS's keep set is kernel K6, one
launch a batch (on the CPU its plain version reads its loop conditions).
The sequence modes
(``run_sequence*``, ``process_batch``, ``track_frames``) solve stage 1
with the trackers' solver (kernel K4), the streaming modes
(``step_frame``, ``process_multistream``, ``track_scan_multi``) with
trackers/registry.stream_step's exact square auction (K1 and K3).

With ``detect_per_frame`` = k > 1 the sequence modes detect on every
k-th frame of the slab's global frame counter and step the others with
the predict-only step (``registry.build_predict_only``), as the JAX
package does.

Every tracker runs in every mode, deepmot with its DHN, and ReID too: in
the streaming modes one crop gather and one ReID forward serve the S
frames of a tick. GMC differs between the modes: the sequence modes take
the warps from the pipeline's own estimator (ECC or ORB); the streaming
modes take the caller's warps (identity by default) and refuse a pipeline
with its own GMC, which the JAX package would ignore there.

``quant="int8"`` serves the W8A8 detector (models/quant.py), calibrated
on ``quant_calib`` (synthetic batches when None); its float parameters
stay float32 whatever ``dtype`` says, as in the JAX pipeline. Not in the
port: the width-packed front (a TPU layout). ``detect_batch_spatial``
height-shards the detector over the ranks of a mesh
(parallel/spatial.py).

Every public entry is a span ``pipeline`` of utils/trace.py, and the
layers under it open theirs (``pipeline.frames_in``, ``detector``,
``detector.letterbox``, ``nms``, ``reid``, ``reid.crops``, ``reid.cnn``
and OSNet's ``reid.osnet.*`` inside it, ``tracker``, ``tracker.kalman``,
``tracker.solve``, ``pipeline.rows_out``); each read from the device on
this path counts as ``host_syncs.<site>``, each crop a ReID forward
embeds as ``reid.crops``. They
record only while the tracer does (a ``recording()`` block, or a
profiler collecting).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .data import letterbox, writer
from .models import zoo
from .models.fuse import fuse_state_dict
from .models.yolo import YoloV7, decode_levels, random_state_dict
from .ops import deepsort_cnn as k5
from .ops import nms as nms_mod
from .reid import (build_reid, float32_exact, load_reid_state_dict,
                   random_reid_state_dict)
from .reid import extractor
from .reid.deepsort_cnn import DeepSortCNN
from .trackers import slab as S
from .trackers.gmc import GMC
from .trackers.registry import (build_predict_only, build_tracker, scan,
                                scan_streams, stream_step)
from .utils import trace


def _on_device(self, *args, **kwargs):
    """Where a method's span times its work: the pipeline's device."""
    return self.device


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
    gmc_method: str = "none"       # camera-motion warp: none | orb | ecc
    reid: str = "none"             # appearance model for the feature
                                   # trackers: "deepsort_cnn" (128h x 64w
                                   # crops) or an OSNet name (128h x 256w);
                                   # float32, on the device
    reid_capacity: int = 0         # embed only the top-K score-ordered
                                   # dets of a frame (0 = all
                                   # det_capacity); the rest get zero
                                   # features ("no appearance evidence")
    detect_per_frame: int = 1      # detect on every k-th frame of the
                                   # sequence modes; the others run the
                                   # predict-only step
    quant: str = "none"            # "none" | "int8": W8A8 static-PTQ
                                   # detector (models/quant.py); needs
                                   # fuse=True


class TrackingPipeline:
    """Detector + tracker on one device.

    state_dict: the detector's UNFUSED weights (models/from_jax.py layout);
    None means seeded random weights (``seed``). reid_state_dict: the
    ReID model's weights (a torchreid / reference checkpoint's state_dict,
    loaded by reid.load_reid_state_dict); None means seeded random
    weights. device: None = the GPU (raises if there is none); pass "cpu"
    to run on the CPU. quant_calib: the int8 mode's calibration batches,
    (B, H, W, 3) float images in [0, 1].
    """

    def __init__(self, pcfg: PipelineConfig, tcfg: S.TrackerConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 spec=None, device=None, seed: int = 0,
                 reid_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 quant_calib=None):
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.spec = spec or zoo.get_spec(pcfg.model, nc=pcfg.nc)
        if state_dict is None:
            state_dict = random_state_dict(self.spec, seed)
        if pcfg.fuse:
            state_dict = fuse_state_dict(state_dict)
        self.dtype = (torch.bfloat16 if pcfg.dtype == "bfloat16"
                      else torch.float32)
        if pcfg.quant not in ("none", "int8"):
            raise ValueError(f"unknown quant {pcfg.quant!r}; have none|int8")
        fused = pcfg.fuse
        params_dtype = self.dtype
        if pcfg.quant == "int8":
            if not pcfg.fuse:
                raise ValueError("quant='int8' requires fuse=True")
            from .models import quant as quant_mod

            state_dict = quant_mod.quantize_state_dict(
                self.spec, state_dict, calib_batches=quant_calib,
                device=self.device)
            fused, params_dtype = "int8", torch.float32
        model = YoloV7(self.spec, fused=fused)
        model.load_state_dict(state_dict)
        model = model.to(self.device, params_dtype).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.step, self.tcfg = build_tracker(tcfg, self.device)
        self.predict_only = build_predict_only(self.tcfg)
        if self.tcfg.det_capacity < pcfg.max_det:
            warnings.warn(
                f"det_capacity={self.tcfg.det_capacity} < max_det="
                f"{pcfg.max_det}: frames with more NMS survivors keep only "
                "the top-scoring ones, dropping the low-confidence "
                "detections ByteTrack's second stage uses.", stacklevel=2)
        self._anchors = torch.as_tensor(self.spec.anchors_per_level(),
                                        device=self.device)
        self._geometry_cache: Dict[Tuple[int, int], tuple] = {}
        self._spatial: Dict[tuple, object] = {}
        self.reid_model, self.reid_hw = None, None
        if pcfg.reid != "none":
            if self.tcfg.feature_dim <= 0:
                raise ValueError(
                    f"reid={pcfg.reid!r} but tracker {self.tcfg.tracker!r} "
                    "resolves feature_dim=0; pass TrackerConfig("
                    "feature_dim=512) to fuse appearance in this tracker")
            reid_model, self.reid_hw = build_reid(pcfg.reid)
            load_reid_state_dict(
                reid_model, reid_state_dict if reid_state_dict is not None
                else random_reid_state_dict(reid_model, seed))
            reid_model = reid_model.to(self.device).eval()
            if self.device.type == "cuda":
                reid_model = reid_model.to(memory_format=torch.channels_last)
            self.reid_model = reid_model
        self.reid_folded = None
        self.fold_reid()
        self.gmc = (GMC(pcfg.gmc_method) if pcfg.gmc_method != "none"
                    else None)

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

    @trace.traced("pipeline.frames_in", _on_device)
    def _frames(self, frames_u8) -> torch.Tensor:
        if not isinstance(frames_u8, torch.Tensor):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        return frames_u8.to(self.device, non_blocking=True)

    def _detect(self, frames_u8, forward):
        """The detector's body: ``forward`` maps the letterboxed batch to
        the head's output; then NMS and the rescale to frame pixels."""
        frames = self._frames(frames_u8)
        src_hw = tuple(frames.shape[1:3])
        out_hw, unpad_hw = self._geometry(src_hw)
        with trace.span("detector.letterbox", frames):
            imgs, _ = letterbox.device_preprocess(
                frames, src_hw, out_hw, unpad_hw=unpad_hw, dtype=self.dtype)
        dets, counts = self.nms(forward(imgs))
        boxes = letterbox.scale_coords_device(dets[..., :4], out_hw, src_hw)
        return boxes, dets[..., 4], dets[..., 5], counts

    @torch.no_grad()
    @trace.traced("detector", _on_device)
    def detect_batch(self, frames_u8):
        """(B, H, W, 3) uint8 -> (boxes (B, max_det, 4) tlbr in frame
        pixels, score (B, max_det), cls (B, max_det), counts (B,))."""
        return self._detect(frames_u8, self.model)

    @torch.no_grad()
    @trace.traced("detector", _on_device)
    def detect_batch_spatial(self, frames_u8, mesh):
        """``detect_batch`` with the detector's forward height-sharded over
        the ranks of ``mesh`` (parallel/spatial.py): the low-latency mode
        when cards outnumber streams. Every rank passes the same frames,
        letterboxes them alike, computes its band of rows with the others'
        halos, and gets the whole frame's head levels back, then the same
        NMS and rescale as ``detect_batch``; the contract and the outputs
        are ``detect_batch``'s. The JAX package's spatial mode takes its
        decoded-path NMS (pipeline.py:280); the port keeps its own NMS by
        head kind here too, so both modes give the same detections."""
        from .parallel.spatial import make_spatial_detector

        key = (id(mesh.group), mesh.size, mesh.rank)
        if key not in self._spatial:
            self._spatial = {key: make_spatial_detector(self.model, mesh)}
        return self._detect(frames_u8, self._spatial[key])

    @trace.traced("nms", _on_device)
    def nms(self, out):
        """The detector's output -> (dets (B, max_det, 6), counts (B,)),
        by head kind as in the JAX pipeline: the raw levels of Detect,
        IDetect and IAuxDetect through the score-first ``nms_from_raw``;
        IBin's levels decoded (``decode_levels``: bin-decoded w, h) and
        DetectV8's decoded predictions, both cast to float32, through
        ``nms``."""
        p = self.pcfg
        if self.spec.head_kind in ("IBin", "DetectV8"):
            if self.spec.head_kind == "IBin":
                out = decode_levels(out, self.spec)
            return nms_mod.nms(out.float(), p.conf_thres, p.iou_thres,
                               max_det=p.max_det, top_k=p.nms_top_k)
        return nms_mod.nms_from_raw(
            out, self._anchors, tuple(self.spec.strides), p.conf_thres,
            p.iou_thres, max_det=p.max_det, top_k=p.nms_top_k)

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------

    def init_tracker(self) -> S.TrackSlab:
        return S.init_slab(self.tcfg, self.device)

    def save_tracker_state(self, slab: S.TrackSlab, path: str,
                           tag: str = "") -> None:
        """Checkpoint mid-sequence tracker state to ``path`` (npz, the JAX
        package's layout), with the GMC's previous-frame state under
        ``gmc_*`` keys, so that a resumed sequence computes the same first
        warp. ``tag`` (e.g. the stream source) guards against resuming
        another stream's state."""
        aux = None
        if self.gmc is not None:
            aux = {"gmc_" + k: v for k, v in self.gmc.get_state().items()}
        S.save_slab(path, slab, self.tcfg, tag=tag, aux=aux)

    def load_tracker_state(self, path: str,
                           expect_tag: str = "") -> S.TrackSlab:
        """Resume state saved by :meth:`save_tracker_state` (or by the JAX
        package), the GMC's with it; raises ValueError on a config- or
        tag-incompatible checkpoint."""
        slab, aux = S.load_slab(path, self.tcfg, self.device,
                                expect_tag=expect_tag, with_aux=True)
        if self.gmc is not None:
            self.gmc.set_state({k[len("gmc_"):]: v for k, v in aux.items()
                                if k.startswith("gmc_")})
        return slab

    @torch.no_grad()
    @trace.traced("reid", _on_device)
    def embed_dets(self, frame_u8, tlbr):
        """(H, W, 3) uint8 frame + (D, 4) det boxes, both on the device ->
        (D, F) float32 ReID features: the top reid_capacity boxes (NMS
        emits them in score order) are cropped and embedded, the rest get
        zero features. With a leading stream axis, (S, H, W, 3) frames and
        (S, D, 4) boxes -> (S, D, F): one crop gather and one ReID forward
        over the S frames' boxes."""
        d = tlbr.shape[-2]
        k = self.pcfg.reid_capacity
        sub = tlbr[..., :k, :] if 0 < k < d else tlbr
        with trace.span("reid.crops", frame_u8):
            crops = extractor.extract_crops(frame_u8, sub, self.reid_hw)
        feats = self.reid_forward(crops.reshape((-1,) + crops.shape[-3:]))
        feats = feats.reshape(sub.shape[:-1] + feats.shape[-1:])
        if feats.shape[-2] < d:
            feats = torch.cat([feats, feats.new_zeros(
                feats.shape[:-2] + (d - feats.shape[-2], feats.shape[-1]))],
                dim=-2)
        return feats

    @torch.no_grad()
    def fold_reid(self):
        """Fold the DeepSORT CNN's BatchNorms into the weights K5 reads
        (ops/deepsort_cnn.fold); done when the pipeline is built, and to be
        done again after changing ``reid_model``'s weights in place."""
        if isinstance(self.reid_model, DeepSortCNN):
            self.reid_folded = k5.fold(self.reid_model)

    @torch.no_grad()
    @trace.traced("reid.cnn", _on_device)
    def reid_forward(self, crops):
        """(N, h, w, 3) normalised crops -> (N, F) ReID features, in
        float32. The DeepSORT CNN runs folded, as K5 on the card (its
        plain version on the CPU); OSNet runs as the module, TF32 off
        (reid.float32_exact). Counts the crops as ``reid.crops``."""
        trace.count("reid.crops", crops.shape[0])
        if isinstance(self.reid_model, DeepSortCNN):
            return k5.forward(self.reid_folded, crops)
        with float32_exact():
            return self.reid_model(crops.permute(0, 3, 1, 2)).float()

    def dets_to_slab(self, boxes, score, cls, count) -> S.DetSlab:
        """Detector outputs of one frame, or of S frames with a leading
        stream axis, as the step's DetSlab on their device
        (trackers/slab.make_det_slab)."""
        return S.make_det_slab(self.tcfg, boxes, score, cls, count,
                               boxes.device)

    def _det_slab(self, frames, boxes, score, cls, count,
                  warp=None) -> S.DetSlab:
        """The step's DetSlab of one frame ((H, W, 3) on the device and its
        detector outputs) or of S stacked frames: ``dets_to_slab``, the
        camera warp ((2, 3) or (S, 2, 3); identity when None) sent to the
        device, and the ReID features of the kept boxes."""
        det = self.dets_to_slab(boxes, score, cls, count)
        if warp is not None:
            det = det._replace(warp=torch.as_tensor(
                warp, dtype=torch.float32).to(self.device, non_blocking=True))
        if self.reid_model is not None:
            det = det._replace(feature=self.embed_dets(frames, det.tlbr))
        return det

    @trace.traced("pipeline", _on_device)
    def track_frames(self, slab: S.TrackSlab, det_slabs):
        """Step the tracker through a list of DetSlabs; returns (slab,
        FrameOutput stacked over the frames)."""
        return scan(self.step, slab, det_slabs)

    @trace.traced("pipeline", _on_device)
    def process_batch(self, slab: S.TrackSlab, frames_u8):
        """Detect + track a batch of frames; returns (slab, FrameOutput
        with a leading frame axis). The frames' camera warps come from the
        pipeline's GMC (identity without one). The frames cross to the
        device once: the detector, the ReID crops and ECC all read that
        copy (ORB reads the host's frames and its warp is sent after)."""
        frames = self._frames(frames_u8)
        out = self.detect_batch(frames)
        dets = []
        for b in range(frames.shape[0]):
            warp = None if self.gmc is None else self.gmc.apply(
                frames[b] if self.gmc.method == "ecc" else frames_u8[b])
            dets.append(self._det_slab(frames[b], *(x[b] for x in out),
                                       warp))
        return self.track_frames(slab, dets)

    # ------------------------------------------------------------------
    # streaming: S independent streams advance one frame each per call,
    # or one stream one frame. Stage 1 is solved by the exact square
    # auction (see the module docstring): K3 for S streams, K1 for one.
    # ------------------------------------------------------------------

    def init_multistream(self, n_streams: int) -> S.TrackSlab:
        """A fresh slab per stream, stacked on a leading stream axis."""
        from .parallel.tracking import stack_slabs

        return stack_slabs(self.tcfg, n_streams, self.device)

    def _streaming(self):
        if self.gmc is not None:
            raise NotImplementedError(
                "the pipeline's own GMC does not run in the streaming modes; "
                "pass the frames' warps (warps= / warp=) or use run_sequence*")

    @trace.traced("pipeline", _on_device)
    def track_scan_multi(self, slabs: S.TrackSlab, det_streams: S.DetSlab):
        """slabs: stacked over S streams; det_streams: every field
        (T, S, D, ...), the warp (T, S, 2, 3) or one (2, 3) for all. Steps
        all streams together through the T frames; returns (slabs,
        FrameOutput (T, S, ...))."""
        return scan_streams(self.step, slabs, det_streams)

    @trace.traced("pipeline", _on_device)
    def process_multistream(self, slabs: S.TrackSlab, frames_u8,
                            warps=None):
        """One frame for each of S independent streams: ONE detector batch
        over the streams' frames (S, H, W, 3), with ReID one crop gather
        and one forward over the S frames' boxes, then one tracker step
        over the stacked slabs (no scan: the streams advance together, so
        the step's small launches are paid once for S frames). ``warps``:
        the frames' camera warps (S, 2, 3), identity when None; the
        pipeline's own GMC does not run here (the JAX package ignores it
        in this mode; the port refuses a pipeline with one)."""
        self._streaming()
        frames = self._frames(frames_u8)
        return stream_step(self.step, slabs, self._det_slab(
            frames, *self.detect_batch(frames), warps))

    @trace.traced("pipeline", _on_device)
    def step_frame(self, slab: S.TrackSlab, frame, warp=None):
        """Detect + associate one (H, W, 3) frame of one stream: the
        latency-oriented streaming mode. ``warp``: the frame's (2, 3)
        camera warp, identity when None (the pipeline's own GMC does not
        run here, as in process_multistream)."""
        self._streaming()
        frames = self._frames(frame[None])
        out = self.detect_batch(frames)
        return stream_step(self.step, slab, self._det_slab(
            frames[0], *(x[0] for x in out), warp))

    # ------------------------------------------------------------------
    # output packing: one D2H transfer per batch
    # ------------------------------------------------------------------

    @staticmethod
    @trace.traced("pipeline.rows_out", lambda outs: outs.valid)
    def pack_output(outs: S.FrameOutput) -> torch.Tensor:
        """FrameOutput -> one (..., T, 8) float32 tensor. Track ids ride
        BIT-cast (int32 viewed as float32): float32 is exact only to
        2^24."""
        return torch.cat([
            outs.track_id.to(torch.int32).view(torch.float32)[..., None],
            outs.tlwh.float(),
            outs.score.float()[..., None],
            outs.cls.float()[..., None],
            outs.valid.float()[..., None],
        ], dim=-1)

    @staticmethod
    @trace.traced("pipeline.rows_out", trace.first_tensor)
    def unpack_output(arr) -> S.FrameOutput:
        """Host-side inverse of pack_output (numpy leaves)."""
        if isinstance(arr, torch.Tensor):
            trace.count("host_syncs.rows_out")
            arr = arr.cpu()
        arr = np.asarray(arr)
        return S.FrameOutput(
            track_id=np.ascontiguousarray(arr[..., 0],
                                          dtype=np.float32).view(np.int32),
            tlwh=arr[..., 1:5], score=arr[..., 5], cls=arr[..., 6],
            valid=arr[..., 7] > 0.5)

    @staticmethod
    @trace.traced("pipeline.rows_out")
    def _emit(results, outs: S.FrameOutput, first_frame: int) -> None:
        results.extend(writer.frame_row(first_frame + b, outs, b)
                       for b in range(outs.valid.shape[0]))

    # ------------------------------------------------------------------
    # sequences
    # ------------------------------------------------------------------

    @trace.traced("pipeline", _on_device)
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
                # numpy's default sort, as the JAX package cuts: with tied
                # scores across the cut it keeps the same rows
                rows = rows[np.argsort(-rows[:, 4])[:d]]
            det = S.make_det_slab(self.tcfg, rows[:, :4], rows[:, 4],
                                  rows[:, 5], np.ones(len(rows), bool),
                                  self.device)
            slab, out = self.step(slab, det)
            packed = self.pack_output(S.FrameOutput(
                *(x[None] for x in out)))
            self._emit(results, self.unpack_output(packed), f)
        return results

    @trace.traced("pipeline", _on_device)
    def run_sequence(self, frames: Iterable[np.ndarray]):
        """Track a sequence of uint8 HWC frames; returns per-frame
        [(frame_id, ids, tlwhs, clses)]."""
        results, _ = self.run_sequence_stateful(frames)
        return results

    @trace.traced("pipeline", _on_device)
    def run_sequence_stateful(self, frames: Iterable[np.ndarray],
                              initial_slab: Optional[S.TrackSlab] = None):
        """:meth:`run_sequence` from ``initial_slab`` (frame numbering
        continues from its counter); returns (results, final slab).

        With ``detect_per_frame`` = k > 1 only the frames whose global
        index (the slab's counter, so a resumed stream detects on the same
        frames as one run) is a multiple of k are detected; the others run
        the predict-only step, after the pending detector batch has been
        flushed so that rows come out in frame order. The GMC estimates
        on detected frames only."""
        slab = initial_slab if initial_slab is not None \
            else self.init_tracker()
        trace.count("host_syncs.frame_counter")
        frame_id = int(slab.frame)
        k_det = max(1, self.pcfg.detect_per_frame)
        results = []
        batch = []

        def flush(slab):
            nonlocal frame_id
            with trace.span("pipeline.frames_in"):
                frames_u8 = np.stack(batch)
            slab, outs = self.process_batch(slab, frames_u8)
            self._emit(results, self.unpack_output(self.pack_output(outs)),
                       frame_id + 1)
            frame_id += len(batch)
            batch.clear()
            return slab

        phase0 = frame_id
        for i, f in enumerate(frames):
            if k_det > 1 and (phase0 + i) % k_det != 0:
                if batch:
                    slab = flush(slab)
                slab, out = self.predict_only(slab)
                frame_id += 1
                self._emit(results, self.unpack_output(self.pack_output(
                    S.FrameOutput(*(x[None] for x in out)))), frame_id)
                continue
            batch.append(f)
            if len(batch) == self.pcfg.detector_batch:
                slab = flush(slab)
        if batch:
            slab = flush(slab)
        return results, slab
