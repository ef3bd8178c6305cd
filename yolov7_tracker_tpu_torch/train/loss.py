"""SimOTA detection loss in batched masked form (port of
yolov7_tracker_tpu/train/loss.py; reference utils/loss.py ComputeLoss,
ComputeLossOTA, ComputeLossAuxOTA and ComputeLossBinOTA).

As in the JAX module, the candidate set is a static (T, nl, na, 5-offsets)
grid per image with a validity mask, so nothing has a data-dependent
shape and the step makes no host sync:

  1. candidate grid + anchor-ratio filter (max(r, 1/r) < anchor_t) and
     the neighbour-offset conditions (utils/loss.py:817-833);
  2. pairwise GT x candidate IoU and the OTA cost
     ``cls_bce(sqrt(sig_cls * sig_obj)) + 3 * (-log iou)`` (:710-742);
  3. dynamic-k from the sum of the top-k IoUs (:717-718), per-GT
     lowest-cost selection by rank masks (:747-751), and the min-cost GT
     keeping a candidate claimed twice (:753-757);
  4. per-layer CIoU box loss, IoU-weighted objectness BCE with the
     per-level balance, label-smoothed class BCE (:583-636).

Where the JAX arrays carry a leading vmapped batch axis, these functions
take the batch axis directly: ``simota_assign`` returns (B, T, nl, na, 5)
arrays. The assignment is discrete and is built under ``torch.no_grad``;
ranks come from stable argsorts and ties go to the lower index, as in
JAX. Two matches on one objectness cell keep the larger IoU (the JAX
module's max-scatter, ``scatter_reduce(..., "amax")`` here).

``compute_loss_bin_ota`` is the IBin head's loss: SimOTA on bin-decoded
candidate boxes, the SigmoidBin w / h losses, CIoU on the target-bin
decode and objectness / class at the shifted channels. As in JAX it is a
library function: the train step does not route to it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.ibin import (BIN_MAX, BIN_MIN, _REG_SCALE, _STEP, bin_centers,
                           sigmoid_bin_decode)
from ..models.spec import BIN_COUNT, ModelSpec
from ..ops.boxes import bbox_iou, iou_matrix_xyxy, xywh_to_xyxy


@dataclasses.dataclass(frozen=True)
class Hyp:
    """Loss hyperparameters (data/hyp.scratch.* defaults)."""

    box: float = 0.05
    cls: float = 0.3
    obj: float = 0.7
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    label_smoothing: float = 0.0
    aux_weight: float = 0.25  # ComputeLossAuxOTA aux-head scale
    loss_ota: int = 1         # 1 = SimOTA assignment, 0 = plain ComputeLoss


OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))
N_OFF = len(OFFSETS)
BIG = 1e9


def _bce(logits, targets, pos_weight=1.0):
    """BCE-with-logits, elementwise."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def smooth_bce(eps: float):
    return 1.0 - 0.5 * eps, 0.5 * eps


def focal_bce(logits, targets, gamma: float, alpha: float = 0.25,
              pos_weight: float = 1.0):
    """FocalLoss around BCE-with-logits (utils/loss.py:121-146)."""
    loss = _bce(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * (1.0 - p_t) ** gamma


def bce_blur(logits, targets, alpha: float = 0.05):
    """BCEBlurWithLogitsLoss (utils/loss.py:16-30), mean reduction."""
    loss = _bce(logits, targets)
    dx = torch.sigmoid(logits) - targets
    alpha_factor = 1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4))
    return (loss * alpha_factor).mean()


def qfocal_bce(logits, targets, gamma: float, alpha: float = 0.25,
               pos_weight: float = 1.0):
    """Quality focal loss (utils/loss.py:149-173)."""
    loss = _bce(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * torch.abs(targets - p) ** gamma


def _balance(nl: int) -> Tuple[float, ...]:
    return (4.0, 1.0, 0.4) if nl == 3 else (4.0, 1.0, 0.25, 0.06, 0.02)[:nl]


_CONSTS: Dict[tuple, torch.Tensor] = {}


def _const(key: tuple, make, device) -> torch.Tensor:
    """A constant tensor made once per device: a host-to-device copy in
    every step would be a host sync."""
    k = key + (str(torch.device(device)),)
    if k not in _CONSTS:
        _CONSTS[k] = make().to(device)
    return _CONSTS[k]


def _anchors(spec: ModelSpec, device) -> torch.Tensor:
    """(nl, na, 2) anchor sizes in pixels, float32, on ``device``."""
    return _const(("anchors", spec.anchors), lambda: torch.as_tensor(
        spec.anchors_per_level(), dtype=torch.float32), device)


def _one_hot(idx, n: int):
    """Boolean one-hot; an index outside [0, n) is all False, as in
    ``jax.nn.one_hot``."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _candidate_grid(layer_meta, strides, anchors_px, txywh, tmask, hyp,
                    g: float = 0.5):
    """The (B, T, nl, na, 5) candidate grid of ``txywh`` (B, T, 4) pixel
    boxes: the anchor-ratio filter and the neighbour-offset conditions
    (utils/loss.py:504-556, :795-846). Returns (gi, gj, valid, flat_idx),
    gi / gj / flat_idx int64."""
    dev = txywh.device
    bsz, t_cap = txywh.shape[:2]
    na = anchors_px.shape[1]
    offsets = _const(("offsets", g), lambda: torch.tensor(
        OFFSETS, dtype=torch.float32) * 0.5 * (g / 0.5), dev)
    a_ids = torch.arange(na, device=dev)[:, None]
    shape = (bsz, t_cap, na, N_OFF)
    gis, gjs, valids, flats = [], [], [], []
    for li, (ny, nx, base) in enumerate(layer_meta):
        s = float(strides[li])
        gxy = txywh[..., :2] / s                      # (B, T, 2)
        gwh = txywh[..., 2:] / s
        anchors_grid = anchors_px[li] / s             # (na, 2)
        r = gwh[..., None, :] / anchors_grid
        anchor_ok = torch.maximum(r, 1.0 / r).amax(-1) < hyp.anchor_t
        gxi = torch.stack([nx - gxy[..., 0], ny - gxy[..., 1]], dim=-1)
        j = (gxy[..., 0] % 1.0 < g) & (gxy[..., 0] > 1.0)
        k = (gxy[..., 1] % 1.0 < g) & (gxy[..., 1] > 1.0)
        l = (gxi[..., 0] % 1.0 < g) & (gxi[..., 0] > 1.0)  # noqa: E741
        m = (gxi[..., 1] % 1.0 < g) & (gxi[..., 1] > 1.0)
        off_ok = torch.stack([torch.ones_like(j), j, k, l, m], dim=-1)
        gij = torch.floor(gxy[..., None, :] - offsets).to(torch.int32)
        gi_l = torch.clamp(gij[..., 0], 0, nx - 1).long()   # (B, T, 5)
        gj_l = torch.clamp(gij[..., 1], 0, ny - 1).long()
        valids.append(tmask[..., None, None] & anchor_ok[..., None]
                      & off_ok[..., None, :])
        gis.append(gi_l[..., None, :].expand(shape))
        gjs.append(gj_l[..., None, :].expand(shape))
        flats.append(base + (gj_l[..., None, :] * nx
                             + gi_l[..., None, :]) * na + a_ids)
    return (torch.stack(gis, 2), torch.stack(gjs, 2), torch.stack(valids, 2),
            torch.stack(flats, 2))


@torch.no_grad()
def simota_costs(preds_flat, layer_meta, strides: Sequence[int],
                 anchors_px, targets, tmask, img_size: int, nc: int,
                 hyp: Hyp, topk: int = 10, g: float = 0.5,
                 bin_wh: bool = False):
    """The inputs of SimOTA's selection: the (B, T, C) cost (1e9 where a
    candidate is invalid), the (B, T) sum of the top-k IoUs whose integer
    part is dynamic-k, and the (B, T, nl, na, 5) candidate cells gi, gj.
    Arguments as ``simota_assign``."""
    preds_flat = preds_flat.detach().float()
    bsz, t_cap = targets.shape[:2]
    nl = len(layer_meta)
    na = anchors_px.shape[1]
    dev = preds_flat.device
    txywh = targets[..., 1:5] * img_size              # pixels
    tcls = targets[..., 0].to(torch.int32)

    gi, gj, valid, flat_idx = _candidate_grid(
        layer_meta, strides, anchors_px, txywh, tmask, hyp, g)
    c = t_cap * nl * na * N_OFF
    valid_f = valid.reshape(bsz, c)
    fg = torch.gather(preds_flat, 1, flat_idx.reshape(bsz, c)[..., None]
                      .expand(-1, -1, preds_flat.shape[-1]))   # (B, C, no)

    # decoded candidate boxes in pixels
    strides_t = _const(("strides", tuple(strides)), lambda: torch.tensor(
        [float(s) for s in strides], dtype=torch.float32), dev)
    stride_per_slot = strides_t[None, :, None, None].expand(
        t_cap, nl, na, N_OFF).reshape(c)
    anch_per_slot = anchors_px[None, :, :, None, :].expand(
        t_cap, nl, na, N_OFF, 2).reshape(c, 2)
    grid_per_slot = torch.stack([gi.reshape(bsz, c), gj.reshape(bsz, c)],
                                dim=-1)
    pxy = ((torch.sigmoid(fg[..., :2]) * 2.0 - 0.5 + grid_per_slot)
           * stride_per_slot[:, None])
    if bin_wh:
        n_bin = BIN_COUNT + 1
        pw, ph = (torch.clamp(sigmoid_bin_decode(torch.sigmoid(
            fg[..., 2 + k * n_bin:2 + (k + 1) * n_bin])), BIN_MIN, BIN_MAX)
            for k in (0, 1))
        pwh = torch.stack([pw, ph], dim=-1) * anch_per_slot
        obj_idx = 2 + 2 * n_bin
    else:
        pwh = (torch.sigmoid(fg[..., 2:4]) * 2.0) ** 2 * anch_per_slot
        obj_idx = 4
    pxyxy = xywh_to_xyxy(torch.cat([pxy, pwh], dim=-1))

    txyxy = xywh_to_xyxy(txywh)                       # (B, T, 4)
    ok = valid_f[:, None, :] & tmask[..., None]       # (B, T, C)
    pair_iou = torch.where(ok, iou_matrix_xyxy(txyxy, pxyxy), 0.0)
    iou_loss = -torch.log(pair_iou + 1e-8)

    top_sum = torch.topk(pair_iou, min(topk, c), dim=-1).values.sum(-1)

    obj_sig = torch.sigmoid(fg[..., obj_idx])
    cls_sig = torch.sigmoid(fg[..., obj_idx + 1:])
    y = torch.sqrt(torch.clamp(cls_sig * obj_sig[..., None],
                               1e-8, 1 - 1e-8))[:, None]   # (B, 1, C, nc)
    # one (B, T, C, nc) temporary, as in JAX: onehot * log(y) + (1 -
    # onehot) * log(1 - y) picks the same element values as this where
    cls_cost = -torch.where(_one_hot(tcls, nc)[:, :, None, :],
                            torch.log(y), torch.log(1.0 - y)).sum(-1)

    cost = torch.where(ok, cls_cost + 3.0 * iou_loss, BIG)
    return cost, top_sum, gi, gj


@torch.no_grad()
def simota_assign(preds_flat, layer_meta, strides: Sequence[int],
                  anchors_px, targets, tmask, img_size: int, nc: int,
                  hyp: Hyp, topk: int = 10, g: float = 0.5,
                  bin_wh: bool = False):
    """SimOTA over a batch (JAX ``simota_assign`` vmapped over images).

    preds_flat (B, C_total, no) all levels' flattened raw preds,
    layer_meta [(ny, nx, base)], anchors_px (nl, na, 2) float32 pixels,
    targets (B, T, 5) [cls, x, y, w, h] normalised, tmask (B, T) bool.
    bin_wh: the IBin layout (ComputeLossBinOTA build_targets,
    utils/loss.py:1017-1024): candidate w / h SigmoidBin-decoded and
    clipped to [BIN_MIN, BIN_MAX], objectness and class after the bins.
    Returns (B, T, nl, na, 5) arrays: ``matched`` (bool), ``matched_gt``
    (the target index), ``gi`` and ``gj`` (the candidate's cell)."""
    cost, top_sum, gi, gj = simota_costs(
        preds_flat, layer_meta, strides, anchors_px, targets, tmask,
        img_size, nc, hyp, topk, g, bin_wh)
    t_cap = targets.shape[1]
    dev = cost.device
    dynamic_k = torch.clamp_min(top_sum.to(torch.int32), 1)

    # per-GT lowest-cost k selection through rank masks
    order = torch.argsort(cost, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    selected = (ranks < dynamic_k[..., None]) & (cost < BIG / 2)

    # a candidate claimed by more than one GT goes to its min-cost GT
    conflict = selected.sum(1) > 1                    # (B, C)
    best_gt = cost.argmin(1)                          # first on ties
    best = torch.arange(t_cap, device=dev)[None, :, None] == best_gt[:, None]
    sel = torch.where(conflict[:, None, :], best, selected)
    matched = sel.any(1)
    matched_gt = sel.to(torch.int32).argmax(1)        # first True
    return {"matched": matched.reshape(gi.shape),
            "matched_gt": matched_gt.reshape(gi.shape),
            "gi": gi, "gj": gj}


def _flatten_preds(preds: List[torch.Tensor]):
    """Per-level (B, ny, nx, na, no) -> (B, C_total, no) + the static
    [(ny, nx, base)] of each level."""
    metas, flat, base = [], [], 0
    for p in preds:
        b, ny, nx, na, no = p.shape
        metas.append((ny, nx, base))
        base += ny * nx * na
        flat.append(p.reshape(b, ny * nx * na, no))
    return torch.cat(flat, dim=1), metas


def _bin_training(logits, target, m, n_m):
    """SigmoidBin.training_loss (utils/loss.py:90-118) of one value (w or
    h): the BCE of the BIN_COUNT bin logits against the bin nearest the
    target (argmin: the first on ties), summed over the matches, and the
    decode biased to that bin (the sigmoided residual plus its centre,
    clipped to [BIN_MIN, BIN_MAX])."""
    bins = bin_centers(logits.device)
    reg = (torch.sigmoid(logits[..., 0]) * _REG_SCALE
           - _REG_SCALE / 2.0) * _STEP
    idx = torch.argmin(torch.abs(target[..., None] - bins), dim=-1)
    bce = _bce(logits[..., 1:], _one_hot(idx, BIN_COUNT).to(logits.dtype))
    loss_sum = torch.where(m[..., None], bce, 0.0).sum()
    decoded = torch.clamp(reg + bins[idx], BIN_MIN, BIN_MAX)
    return loss_sum / (n_m * BIN_COUNT), decoded


def _layer_loss_terms(p, li, assign, targets, spec, img_size, hyp, cp, cn,
                      gr: float = 1.0, bin_wh: bool = False, n_m=None,
                      n_images=None):
    """One level's (box, objectness BCE mean, cls) terms. gr blends the
    objectness target: (1 - gr) + gr * iou (model.gr, loss.py:476).
    ``n_m`` and ``n_images``: the level's positive count and the batch
    size over every rank of a data-parallel step (``_global_counts``);
    None: this call's own.
    bin_wh: the IBin head's terms (JAX ``_layer_loss_terms_bin``,
    ComputeLossBinOTA __call__, utils/loss.py:882-950): the box term adds
    the SigmoidBin w and h losses, its CIoU takes the target-bin decode,
    and objectness and class sit after the bins."""
    na, nc, no = spec.na, spec.nc, spec.no
    obj = 2 + 2 * (BIN_COUNT + 1) if bin_wh else 4
    b, ny, nx, _, _ = p.shape
    dev = p.device
    m = assign["matched"][:, :, li]                   # (B, T, na, 5)
    mgt = assign["matched_gt"][:, :, li].long()
    gi = assign["gi"][:, :, li]
    gj = assign["gj"][:, :, li]
    anchors_grid = _anchors(spec, dev)[li] / float(spec.strides[li])
    a_ids = torch.arange(na, device=dev)[None, None, :, None]
    flat_cell = (gj * nx + gi) * na + a_ids           # (B, T, na, 5)
    flat_b = flat_cell.reshape(b, -1)
    mgt_b = mgt.reshape(b, -1)

    # matched predictions (B, T, na, 5, no) and their targets in this
    # level's grid units
    ps = torch.gather(p.reshape(b, -1, no), 1,
                      flat_b[..., None].expand(-1, -1, no)
                      ).reshape(m.shape + (no,))
    t_xywh = torch.gather(targets[:, :, 1:5], 1,
                          mgt_b[..., None].expand(-1, -1, 4)
                          ).reshape(m.shape + (4,))
    t_grid = t_xywh * img_size / float(spec.strides[li])
    grid = torch.stack([gi, gj], dim=-1).float()
    t_box = torch.cat([t_grid[..., :2] - grid, t_grid[..., 2:]], dim=-1)

    if n_m is None:
        n_m = torch.clamp_min(m.sum(), 1)
    pxy = torch.sigmoid(ps[..., :2]) * 2.0 - 0.5
    anc = anchors_grid[None, None, :, None, :]
    if bin_wh:
        n_bin = BIN_COUNT + 1
        w_loss, pw = _bin_training(ps[..., 2:2 + n_bin],
                                   t_box[..., 2] / anc[..., 0], m, n_m)
        h_loss, ph = _bin_training(ps[..., 2 + n_bin:obj],
                                   t_box[..., 3] / anc[..., 1], m, n_m)
        pwh = torch.stack([pw * anc[..., 0], ph * anc[..., 1]], dim=-1)
    else:
        pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anc
    iou = bbox_iou(torch.cat([pxy, pwh], dim=-1), t_box, xywh=True,
                   ciou=True)
    lbox_i = torch.where(m, 1.0 - iou, 0.0).sum() / n_m
    if bin_wh:
        lbox_i = w_loss + h_loss + lbox_i

    # objectness targets: the matched IoUs max-scattered into the grid
    val = torch.where(m, (1.0 - gr) + gr * torch.clamp_min(iou.detach(), 0.0),
                      0.0)
    tobj = torch.zeros((b, ny * nx * na), dtype=val.dtype, device=dev)
    tobj = tobj.scatter_reduce(1, flat_b, val.reshape(b, -1), "amax",
                               include_self=True)
    obj_bce = _bce(p[..., obj].reshape(b, -1), tobj, pos_weight=hyp.obj_pw)
    obj_i = (obj_bce.mean() if n_images is None
             else obj_bce.sum() / (n_images * obj_bce.shape[1]))

    lcls_i = 0.0
    if nc > 1:
        tcls_sel = torch.gather(targets[:, :, 0].to(torch.int32), 1,
                                mgt_b).reshape(m.shape)
        t_one = torch.where(_one_hot(tcls_sel, nc), cp, cn)
        cls_bce = _bce(ps[..., obj + 1:], t_one, pos_weight=hyp.cls_pw)
        lcls_i = torch.where(m[..., None], cls_bce, 0.0).sum() / (n_m * nc)
    return lbox_i, obj_i, lcls_i


def _global_counts(assigns, nl: int, bsz: int, group):
    """Each assignment's per-level positive counts n_m (at least 1) and
    the batch size, summed over the ranks of ``group`` (one all_reduce):
    JAX's normalisers, which its global view computes over the whole
    batch (loss.py:359, :375, :387-391). Without a group: (None, None),
    each level's own."""
    if group is None:
        return [None] * len(assigns) * nl, None
    m = [a["matched"][:, :, li].sum() for a in assigns for li in range(nl)]
    counts = torch.stack(m + [torch.as_tensor(bsz, device=m[0].device)])
    dist.all_reduce(counts, group=group)
    return list(torch.clamp_min(counts[:-1], 1)), counts[-1]


def _group(group):
    """None for no group or a one-rank one."""
    if group is None:
        return None
    return group if dist.get_world_size(group) > 1 else None


def _total(lbox, lobj, lcls, hyp: Hyp, bsz, group=None):
    """The loss times the batch size, and its parts. Under a group of
    ranks (``bsz`` the global batch) each rank's loss is its share of the
    global loss, so the ranks' gradients sum to its gradient, and the
    parts are the global ones."""
    # lcls stays the float 0.0 when nc == 1
    lcls = torch.as_tensor(lcls, dtype=lbox.dtype, device=lbox.device)
    lbox = lbox * hyp.box
    lobj = lobj * hyp.obj
    lcls = lcls * hyp.cls
    total = lbox + lobj + lcls
    parts = {"box": lbox, "obj": lobj, "cls": lcls, "loss": total}
    if group is not None:
        summed = torch.stack([v.detach() for v in parts.values()])
        dist.all_reduce(summed, group=group)
        parts = dict(zip(parts, summed))
    return total * bsz, parts


def compute_loss_ota(preds: List[torch.Tensor], targets, tmask,
                     spec: ModelSpec, img_size: int, hyp: Hyp = Hyp(),
                     group=None):
    """ComputeLossOTA. preds: nl x (B, ny, nx, na, no) raw heads (float32);
    targets (B, T, 5) normalised; tmask (B, T). Returns the total loss
    times the batch size and the (box, obj, cls, loss) parts, as the
    reference returns them (utils/loss.py:633-636). ``group``: the process
    group of a data-parallel step, whose ranks hold shards of the batch:
    the normalisers are then the global batch's (``_global_counts``,
    ``_total``); SimOTA is per image and needs none."""
    group = _group(group)
    nl = spec.nl
    anchors_px = _anchors(spec, preds[0].device)
    bsz = preds[0].shape[0]
    preds_flat, metas = _flatten_preds(preds)
    assign = simota_assign(preds_flat, metas, spec.strides, anchors_px,
                           targets, tmask, img_size, spec.nc, hyp)
    n_ms, n_img = _global_counts([assign], nl, bsz, group)
    cp, cn = smooth_bce(hyp.label_smoothing)
    balance = _balance(nl)
    lbox = lobj = lcls = 0.0
    for li, p in enumerate(preds):
        lb, ob, lc = _layer_loss_terms(p, li, assign, targets, spec,
                                       img_size, hyp, cp, cn, n_m=n_ms[li],
                                       n_images=n_img)
        lbox = lbox + lb
        lobj = lobj + ob * balance[li]
        lcls = lcls + lc
    return _total(lbox, lobj, lcls, hyp, bsz if n_img is None else n_img,
                  group)


def compute_loss(preds: List[torch.Tensor], targets, tmask,
                 spec: ModelSpec, img_size: int, hyp: Hyp = Hyp(),
                 gr: float = 1.0, group=None):
    """The plain (non-OTA) v7 loss, ComputeLoss (utils/loss.py:422-553),
    chosen by hyp loss_ota = 0: every anchor-ratio / offset candidate is a
    positive for its own GT. ``group``: as in ``compute_loss_ota``."""
    group = _group(group)
    nl, na = spec.nl, spec.na
    bsz, t_cap = targets.shape[:2]
    dev = preds[0].device
    _, metas = _flatten_preds(preds)
    with torch.no_grad():
        gi, gj, valid, _ = _candidate_grid(
            metas, spec.strides, _anchors(spec, dev),
            targets[..., 1:5] * img_size, tmask, hyp)
        own_gt = torch.arange(t_cap, device=dev)[None, :, None, None, None
                                                 ].expand(bsz, t_cap, nl, na,
                                                          N_OFF)
    assign = {"matched": valid, "matched_gt": own_gt, "gi": gi, "gj": gj}
    n_ms, n_img = _global_counts([assign], nl, bsz, group)
    cp, cn = smooth_bce(hyp.label_smoothing)
    balance = _balance(nl)
    lbox = lobj = lcls = 0.0
    for li, p in enumerate(preds):
        lb, ob, lc = _layer_loss_terms(p, li, assign, targets, spec,
                                       img_size, hyp, cp, cn, gr=gr,
                                       n_m=n_ms[li], n_images=n_img)
        lbox = lbox + lb
        lobj = lobj + ob * balance[li]
        lcls = lcls + lc
    return _total(lbox, lobj, lcls, hyp, bsz if n_img is None else n_img,
                  group)


def compute_loss_aux_ota(preds: List[torch.Tensor], targets, tmask,
                         spec: ModelSpec, img_size: int, hyp: Hyp = Hyp(),
                         group=None):
    """ComputeLossAuxOTA (utils/loss.py:1176-1290): 2 * nl heads, lead
    then aux. The lead heads are assigned with find_3_positive (g = 0.5)
    and top-20 SimOTA, the aux heads with find_5_positive (g = 1.0) and
    top-20; both assignments decode candidates from the LEAD predictions
    (:1205-1206); the aux terms weigh hyp.aux_weight. ``group``: as in
    ``compute_loss_ota``."""
    group = _group(group)
    nl = spec.nl
    anchors_px = _anchors(spec, preds[0].device)
    lead, aux = preds[:nl], preds[nl:]
    bsz = lead[0].shape[0]
    preds_flat, metas = _flatten_preds(lead)
    assign_lead = simota_assign(preds_flat, metas, spec.strides, anchors_px,
                                targets, tmask, img_size, spec.nc, hyp,
                                topk=20, g=0.5)
    assign_aux = simota_assign(preds_flat, metas, spec.strides, anchors_px,
                               targets, tmask, img_size, spec.nc, hyp,
                               topk=20, g=1.0)
    n_ms, n_img = _global_counts([assign_lead, assign_aux], nl, bsz, group)
    cp, cn = smooth_bce(hyp.label_smoothing)
    balance = _balance(nl)
    lbox = lobj = lcls = 0.0
    w_aux = hyp.aux_weight
    for li in range(nl):
        lb, ob, lc = _layer_loss_terms(lead[li], li, assign_lead, targets,
                                       spec, img_size, hyp, cp, cn,
                                       n_m=n_ms[li], n_images=n_img)
        lb_a, ob_a, lc_a = _layer_loss_terms(aux[li], li, assign_aux,
                                             targets, spec, img_size, hyp,
                                             cp, cn, n_m=n_ms[nl + li],
                                             n_images=n_img)
        lbox = lbox + lb + w_aux * lb_a
        lobj = lobj + (ob + w_aux * ob_a) * balance[li]
        lcls = lcls + lc + w_aux * lc_a
    return _total(lbox, lobj, lcls, hyp, bsz if n_img is None else n_img,
                  group)


def compute_loss_bin_ota(preds: List[torch.Tensor], targets, tmask,
                         spec: ModelSpec, img_size: int, hyp: Hyp = Hyp()):
    """ComputeLossBinOTA (utils/loss.py:849-1176) for the IBin head:
    SimOTA on bin-decoded candidate boxes, then per level the SigmoidBin
    w / h losses + CIoU + objectness and class at the shifted channels.
    preds: nl x (B, ny, nx, na, nc + 47) raw IBin levels (float32). As in
    JAX, the reference builds it from no shipped cfg and the train step
    does not route to it."""
    nl = spec.nl
    anchors_px = _anchors(spec, preds[0].device)
    bsz = preds[0].shape[0]
    preds_flat, metas = _flatten_preds(preds)
    assign = simota_assign(preds_flat, metas, spec.strides, anchors_px,
                           targets, tmask, img_size, spec.nc, hyp,
                           bin_wh=True)
    cp, cn = smooth_bce(hyp.label_smoothing)
    balance = _balance(nl)
    lbox = lobj = lcls = 0.0
    for li, p in enumerate(preds):
        lb, ob, lc = _layer_loss_terms(p, li, assign, targets, spec,
                                       img_size, hyp, cp, cn, bin_wh=True)
        lbox = lbox + lb
        lobj = lobj + ob * balance[li]
        lcls = lcls + lc
    return _total(lbox, lobj, lcls, hyp, bsz)
