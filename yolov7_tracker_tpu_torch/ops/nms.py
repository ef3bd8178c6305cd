"""Fixed-shape class-offset NMS (port of yolov7_tracker_tpu/ops/nms.py).

Same semantics as the JAX module: candidates are the top-K by score
(lower index first among equal scores, as ``lax.top_k`` orders them),
class-aware suppression through the ``MAX_WH`` box offset, and the
greedy suppression that yields exactly torchvision's pick set, truncated
at ``max_det``. Both entries, ``nms`` (decoded rows) and ``nms_from_raw``
(raw head levels), decode their top-K batched over the images and end in
``suppress``: on a CUDA tensor kernel K6 (``csrc/nms.cu``), the greedy
keep set of every image in one launch with no read back to the host,
counted as ``launches.k6`` by utils/trace.py; on a CPU tensor the plain
version, ``greedy_suppress`` an image, whose JAX ``while_loop``s are
Python loops that read their condition from the device (each read
counted as ``host_syncs.nms``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..utils import trace
from . import boxes as boxops
from .cuda_build import build_library

MAX_WH = 4096.0  # class-offset stride, reference general.py:617

_LIB = None
BUILD_SECONDS = None
BUILD_LOG = ""               # nvcc's -Xptxas -v report


def sorted_top_k(x, k: int):
    """(values, indices) of the k largest along the last axis; equal
    values keep their index order (torch.topk promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def greedy_suppress(sel_box, off_box, scores, cls_id, *, max_det: int,
                    iou_thres: float, chunk: int = 128):
    """Exact greedy NMS over one image's score-masked candidates.

    sel_box (K, 4) xyxy output boxes; off_box (K, 4) class-offset boxes
    used for suppression; scores (K,), invalid < 0; cls_id (K,) float.
    Returns (out (max_det, 6) [xyxy, conf, cls], count (int)).
    """
    dev = scores.device
    k = scores.shape[0]
    chunk = min(chunk, k)
    c_lt = (torch.arange(chunk, device=dev)[:, None]
            < torch.arange(chunk, device=dev)[None, :])
    out = torch.zeros((max_det + 1, 6), dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.long, device=dev)
    s = scores
    it = 0
    while it < max_det:
        go = (count < max_det) & (s.max() > 0.0)
        trace.count("host_syncs.nms")
        if not bool(go):
            break
        top_s, idx = sorted_top_k(s, chunk)
        active = top_s > 0.0
        bb = off_box[idx]
        sup = (boxops.iou_matrix_xyxy(bb, bb) > iou_thres) & c_lt
        # the block's greedy keep set is the fixpoint of
        # kept[i] = active[i] & !any(j < i: kept[j] & sup[j, i])
        kept = active
        for _ in range(chunk):
            new = active & ~(kept[:, None] & sup).any(dim=0)
            trace.count("host_syncs.nms")
            changed = bool((new != kept).any())
            kept = new
            if not changed:
                break
        rank = torch.cumsum(kept.long(), 0) - 1
        accept = kept & (count + rank < max_det)
        pos = torch.where(accept, count + rank, max_det)
        rows6 = torch.cat(
            [sel_box[idx], top_s[:, None], cls_id[idx][:, None]], dim=1)
        out[pos] = rows6  # rejected rows land in the spare row max_det
        s = s.clone()
        s[idx] = -1.0
        # kill every remaining candidate overlapping an accepted box
        acc_boxes = torch.where(accept[:, None], bb,
                                torch.full_like(bb, -1e6))
        cross = boxops.iou_matrix_xyxy(acc_boxes, off_box)
        s = torch.where((cross > iou_thres).any(dim=0),
                        torch.full_like(s, -1.0), s)
        count = count + accept.long().sum()
        it += 1
    return out[:max_det], count


def suppress(sel_box, off_box, score, cls_id, *, max_det: int,
             iou_thres: float, chunk: int = 128):
    """The greedy keep set of every image of a batch: sel_box, off_box (B,
    K, 4), score and cls_id (B, K) float32 as ``greedy_suppress`` takes
    them an image. K6 on a CUDA tensor, the plain version on a CPU one
    (``chunk``: its block size, which changes nothing of the result).
    Returns (dets (B, max_det, 6) float32, count (B,) int64)."""
    if score.is_cuda:
        return suppress_cuda(sel_box, off_box, score, cls_id,
                             max_det=max_det, iou_thres=iou_thres)
    return suppress_plain(sel_box, off_box, score, cls_id, max_det=max_det,
                          iou_thres=iou_thres, chunk=chunk)


def suppress_plain(sel_box, off_box, score, cls_id, *, max_det: int,
                   iou_thres: float, chunk: int = 128):
    """``suppress`` by ``greedy_suppress`` on each image, on any device."""
    outs = [greedy_suppress(sel_box[b], off_box[b], score[b], cls_id[b],
                            max_det=max_det, iou_thres=iou_thres,
                            chunk=chunk)
            for b in range(score.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def load_library():
    """Build csrc/nms.cu (see ops/cuda_build.py) at first use and bind it
    with ctypes."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_SECONDS, BUILD_LOG = build_library("nms.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k6_nms_launch.argtypes = [
        ptr, ptr, ptr,               # sel_box, off_box, cls
        ptr, ptr,                    # sorted scores, their order
        i32, i32, i32,               # B, K, max_det
        ctypes.c_float,              # iou_thres
        ptr, ptr, ptr]               # out, counts, stream
    lib.k6_nms_launch.restype = ctypes.c_int
    _LIB = lib
    return lib


def suppress_cuda(sel_box, off_box, score, cls_id, *, max_det: int,
                  iou_thres: float):
    """Launch K6 on the card: one stable sort of the float32 scores (the
    plain version's visiting order), then one block an image."""
    if not score.is_cuda:
        raise ValueError("K6 needs CUDA tensors")
    b, k = score.shape
    for name, t, shape in (("sel_box", sel_box, (b, k, 4)),
                           ("off_box", off_box, (b, k, 4)),
                           ("score", score, (b, k)),
                           ("cls_id", cls_id, (b, k))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != score.device):
            raise ValueError(f"K6 takes {name} {shape} float32 on "
                             f"{score.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    dets = torch.empty((b, max_det, 6), dtype=torch.float32,
                       device=score.device)
    counts = torch.empty((b,), dtype=torch.int64, device=score.device)
    vals, order = sorted_top_k(score, k)
    _launch_k6(sel_box.contiguous(), off_box.contiguous(),
               cls_id.contiguous(), vals, order, iou_thres, dets, counts)
    # counted while utils/trace.py records: the tests, chip_smoke.py and a
    # traced benchmark run read that NMS went through the kernel
    trace.count("launches.k6")
    return dets, counts


def _launch_k6(sel_box, off_box, cls_id, vals, order, iou_thres, dets,
               counts):
    """K6 alone on contiguous CUDA tensors: the candidates (B, K, 4), (B,
    K, 4), (B, K), their scores sorted descending (B, K) and the order
    the sort gave (B, K) int64; fills dets (B, max_det, 6) and counts
    (B,) on the current stream."""
    b, k = vals.shape
    lib = load_library()
    with torch.cuda.device(vals.device):
        err = lib.k6_nms_launch(
            sel_box.data_ptr(), off_box.data_ptr(), cls_id.data_ptr(),
            vals.data_ptr(), order.data_ptr(), b, k, dets.shape[1],
            iou_thres, dets.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")


def nms(prediction, conf_thres: float = 0.25, iou_thres: float = 0.45, *,
        max_det: int = 300, top_k: int = 4096, agnostic: bool = False,
        multi_label: bool = False):
    """NMS over decoded output (B, N, 5 + nc) [xywh, obj, cls]: best class
    per box, or with ``multi_label`` (and nc > 1) one candidate per (box,
    class) pair over the threshold, in the JAX module's (box, class) order
    (JAX nms.py:117-125), which cli/test.py scores.
    Returns (dets (B, max_det, 6) float32, count (B,) int64)."""
    obj = prediction[..., 4]
    box_xyxy = boxops.xywh_to_xyxy(prediction[..., :4])
    cls_conf = prediction[..., 5:] * obj[..., None]
    nc = cls_conf.shape[-1]
    if multi_label and nc > 1:
        # candidate j is box j // nc with class j % nc (JAX repeats each box
        # nc times and tiles the class ids)
        conf = cls_conf.reshape(cls_conf.shape[0], -1)
        keep = (obj > conf_thres).repeat_interleave(nc, dim=1) & (
            conf > conf_thres)
    else:
        conf = cls_conf.max(dim=-1).values
        cls_idx = cls_conf.argmax(dim=-1)   # first maximal class
        keep = (obj > conf_thres) & (conf > conf_thres)
    score = torch.where(keep, conf, torch.full_like(conf, -1.0))
    k = min(top_k, score.shape[1])
    top_scores, top_idx = sorted_top_k(score, k)
    if multi_label and nc > 1:
        box_idx = torch.div(top_idx, nc, rounding_mode="floor")
        sel_box = torch.gather(box_xyxy, 1,
                               box_idx[..., None].expand(-1, -1, 4))
        sel_cls = (top_idx % nc).float()
    else:
        sel_box = torch.gather(box_xyxy, 1,
                               top_idx[..., None].expand(-1, -1, 4))
        sel_cls = torch.gather(cls_idx.float(), 1, top_idx)
    off_box = sel_box + (0.0 if agnostic else sel_cls[..., None] * MAX_WH)
    scores0 = torch.where(top_scores > 0, top_scores,
                          torch.full_like(top_scores, -1.0))
    return suppress(sel_box, off_box, scores0, sel_cls, max_det=max_det,
                    iou_thres=iou_thres)


def _decode_meta(shape, anchors_l, stride: float, device):
    """(ny*nx*na, 5) [grid_x, grid_y, anchor_w, anchor_h, stride] in the
    flattened (ny, nx, na) order of the raw head level."""
    ny, nx, na = shape
    gy, gx, ai = torch.meshgrid(
        torch.arange(ny, device=device), torch.arange(nx, device=device),
        torch.arange(na, device=device), indexing="ij")
    anchors_l = torch.as_tensor(anchors_l, dtype=torch.float32, device=device)
    meta = torch.stack(
        [gx.float(), gy.float(), anchors_l[ai, 0], anchors_l[ai, 1],
         torch.full(gx.shape, float(stride), device=device)], dim=-1)
    return meta.reshape(-1, 5)


def nms_from_raw(raw_levels, anchors, strides: Sequence[int],
                 conf_thres: float = 0.25, iou_thres: float = 0.45, *,
                 max_det: int = 300, top_k: int = 4096,
                 agnostic: bool = False, chunk: int = 128):
    """Score-first best-class NMS over RAW head outputs.

    raw_levels: list of nl (B, ny, nx, na, no) pre-sigmoid head outputs in
    any float dtype; anchors (nl, na, 2) pixels. Candidates are scored in
    the compute dtype, the top-K decode in float32, batched over the
    images; ``chunk`` is the plain version's block size (``suppress``).
    Returns (dets (B, max_det, 6) float32, count (B,) int64).
    """
    b = raw_levels[0].shape[0]
    no = raw_levels[0].shape[-1]
    dev = raw_levels[0].device
    scores, rows, metas = [], [], []
    for i, p in enumerate(raw_levels):
        _, ny, nx, na, _ = p.shape
        obj = torch.sigmoid(p[..., 4])
        cls_max = p[..., 5:].max(dim=-1).values
        scores.append((obj * torch.sigmoid(cls_max)).reshape(b, -1))
        rows.append(p.reshape(b, ny * nx * na, no))
        metas.append(_decode_meta((ny, nx, na), anchors[i], strides[i], dev))
    score = torch.cat(scores, dim=1)
    meta = torch.cat(metas, dim=0)
    k = min(top_k, score.shape[1])
    _, top_idx = sorted_top_k(score, k)
    sel = torch.gather(torch.cat(rows, dim=1), 1,
                       top_idx[..., None].expand(-1, -1, no)).float()

    sm = meta[top_idx]                                  # (B, K, 5)
    y = torch.sigmoid(sel)
    xy = (y[..., 0:2] * 2.0 - 0.5 + sm[..., 0:2]) * sm[..., 4:5]
    wh = (y[..., 2:4] * 2.0) ** 2 * sm[..., 2:4]
    cls_conf = y[..., 5:] * y[..., 4:5]
    conf = cls_conf.max(dim=-1).values
    cls_id = cls_conf.argmax(dim=-1).float()            # first maximal class
    sel_box = boxops.xywh_to_xyxy(torch.cat([xy, wh], dim=-1))
    off_box = sel_box + (0.0 if agnostic else cls_id[..., None] * MAX_WH)
    sc = torch.where(conf > conf_thres, conf, torch.full_like(conf, -1.0))
    return suppress(sel_box, off_box, sc, cls_id, max_det=max_det,
                    iou_thres=iou_thres, chunk=chunk)
