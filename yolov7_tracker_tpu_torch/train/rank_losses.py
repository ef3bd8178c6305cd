"""Ranking-based classification losses: RankSort, aLRP and AP (port of
yolov7_tracker_tpu/train/rank_losses.py; reference utils/loss.py:176-420,
a torch.autograd.Function trio with hand-written gradients that no shipped
config instantiates).

As in the JAX module, each takes fixed-shape (N,) logits, targets and a
validity mask instead of boolean-filtered tensors, computes the forward
as masked (N, N) matrix passes, and carries the reference's
identity-update gradient: each is a ``torch.autograd.Function`` whose
backward scales the gradient made in the forward by the cotangent of its
first output (the JAX ``custom_vjp``s'), and gives ``targets``, ``valid``
and aLRP's ``reg_losses`` none; ``delta`` and ``eps`` are constants.

AP carries the interpolated max-precision through the positives in
ascending logit order, a ``lax.scan`` over all N in JAX. Here it is one
vectorised pass: a stable argsort of the positives' logits, the running
max of their precisions (``torch.cummax``; the carry each step reads is
the one before it, starting at 0), and the background gradient as one
weighted sum of the rows of the background relation. The sums run in
another order than the scan's, so the gradients agree to float32
rounding, not bit for bit.
"""

from __future__ import annotations

import torch

BIG = 1e9
_TINY = 1e-20


def _rel(logits, delta: float):
    """The piecewise-linear step x_ij (utils/loss.py:203-212):
    rel[i, j] = clamp((l_j - l_i) / (2 delta) + 0.5, 0, 1)."""
    diff = logits[None, :] - logits[:, None]
    if delta > 0:
        return torch.clamp(diff / (2.0 * delta) + 0.5, 0.0, 1.0)
    return (diff >= 0).to(logits.dtype)


def _fg_bg_masks(logits, targets, valid, delta: float, fg_pred):
    """The positives, and the negatives that can rank above the lowest
    positive (logit >= its logit - delta)."""
    fg = valid & fg_pred
    thr = torch.where(fg, logits, BIG).min() - delta
    bg = valid & (targets == 0) & (logits >= thr)
    return fg, bg


def _masked(rel, cols):
    """rel with the columns outside ``cols`` zeroed."""
    return torch.where(cols[None, :], rel, 0.0)


def _ranksort_fwd(logits, targets, valid, delta: float, eps: float):
    fgm, bgm = _fg_bg_masks(logits, targets, valid, delta, targets > 0.0)
    fg_num = torch.clamp_min(fgm.sum(), 1).to(logits.dtype)
    rel = _rel(logits, delta)                     # row i: against i
    R = _masked(rel, fgm)
    BR = _masked(rel, bgm)
    rank_pos = R.sum(1)                           # with itself (0.5)
    fp = BR.sum(1)
    rank = rank_pos + fp
    ranking_error = torch.where(fgm, fp / torch.clamp_min(rank, _TINY), 0.0)

    one_minus_t = torch.where(fgm, 1.0 - targets, 0.0)
    cur_sort = R @ one_minus_t / torch.clamp_min(rank_pos, _TINY)
    iou_rel = (targets[None, :] >= targets[:, None]) & fgm[None, :]
    tso = torch.where(iou_rel, R, 0.0)
    tse = tso @ one_minus_t / torch.clamp_min(tso.sum(1), _TINY)
    sorting_error = torch.where(fgm, cur_sort - tse, 0.0)

    # the identity-update gradients (utils/loss.py:241-262)
    has_fp = fp > eps
    grad = -torch.where(fgm & has_fp, ranking_error, 0.0)
    missorted = torch.where(~iou_rel & fgm[None, :], R, 0.0)
    denom = missorted.sum(1)
    has_ms = denom > eps
    grad = grad - torch.where(fgm & has_ms, sorting_error, 0.0)
    w_sort = torch.where(fgm & has_ms,
                         sorting_error / torch.clamp_min(denom, _TINY), 0.0)
    grad = grad + missorted.T @ w_sort
    w_rank = torch.where(fgm & has_fp,
                         ranking_error / torch.clamp_min(fp, _TINY), 0.0)
    bg_grad = BR.T @ w_rank
    grad = torch.where(fgm, grad, torch.where(bgm, bg_grad, 0.0)) / fg_num
    return (ranking_error.sum() / fg_num, sorting_error.sum() / fg_num), grad


class RankSortLoss(torch.autograd.Function):
    """(mean ranking error, mean sorting error) over the valid positives
    (utils/loss.py:176-273); the gradient reaches the logits only."""

    @staticmethod
    def forward(ctx, logits, targets, valid, delta, eps):
        (re, se), grad = _ranksort_fwd(logits, targets, valid, delta, eps)
        ctx.save_for_backward(grad)
        return re, se

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g1, _g2):
        (grad,) = ctx.saved_tensors
        return grad * g1, None, None, None, None


def rank_sort_loss(logits, targets, valid, delta: float = 0.5,
                   eps: float = 1e-10):
    """logits, targets (N,) float (targets: IoUs, > 0 for positives),
    valid (N,) bool -> (ranking error, sorting error)."""
    return RankSortLoss.apply(logits, targets, valid, delta, eps)


def _alrp_fwd(logits, targets, reg_losses, valid, delta: float, eps: float):
    fgm, bgm = _fg_bg_masks(logits, targets, valid, delta, targets == 1.0)
    fg_num = torch.clamp_min(fgm.sum(), 1).to(logits.dtype)
    rel = _rel(logits, delta)
    eye = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    R0 = torch.where(fgm[None, :] & ~eye, rel, 0.0)   # itself left out
    BR = _masked(rel, bgm)

    rank_pos = 1.0 + R0.sum(1)
    fp = BR.sum(1)
    rank = rank_pos + fp
    prec = torch.where(fgm, rank_pos / torch.clamp_min(rank, _TINY), 0.0)

    has_fp = fgm & (fp > eps)
    reg = torch.where(fgm, reg_losses, 0.0)
    fg_grad = torch.where(has_fp, -(R0 @ reg + fp)
                          / torch.clamp_min(rank, _TINY), 0.0)
    w = torch.where(has_fp, -fg_grad / torch.clamp_min(fp, _TINY), 0.0)
    bg_grad = BR.T @ w
    grad = torch.where(fgm, fg_grad, torch.where(bgm, bg_grad, 0.0)) / fg_num
    cls_loss = 1.0 - prec.sum() / fg_num
    return (cls_loss, torch.where(fgm, rank, 0.0)), grad


class ALRPLoss(torch.autograd.Function):
    """aLRP classification loss (utils/loss.py:275-343): (1 - mean LRP
    precision, each anchor's rank); the gradient reaches the logits
    only."""

    @staticmethod
    def forward(ctx, logits, targets, reg_losses, valid, delta, eps):
        (loss, rank), grad = _alrp_fwd(logits, targets, reg_losses, valid,
                                       delta, eps)
        ctx.save_for_backward(grad)
        return loss, rank

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g1, _g2):
        (grad,) = ctx.saved_tensors
        return grad * g1, None, None, None, None, None


def alrp_loss(logits, targets, reg_losses, valid, delta: float = 1.0,
              eps: float = 1e-5):
    """logits, targets (N,) (positives: targets == 1), reg_losses (N,) the
    per-anchor regression loss in the same layout, valid (N,) bool ->
    (classification loss, rank (N,), 0 off the positives)."""
    return ALRPLoss.apply(logits, targets, reg_losses, valid, delta, eps)


def _ap_fwd(logits, targets, valid, delta: float):
    n = logits.shape[0]
    fgm, bgm = _fg_bg_masks(logits, targets, valid, delta, targets == 1.0)
    fg_num = torch.clamp_min(fgm.sum(), 1).to(logits.dtype)
    rel = _rel(logits, delta)
    eye = torch.eye(n, dtype=torch.bool, device=logits.device)
    R0 = torch.where(fgm[None, :] & ~eye, rel, 0.0)
    BR = _masked(rel, bgm)
    rank_pos = 1.0 + R0.sum(1)
    fp = BR.sum(1)
    rank = rank_pos + fp
    cur_prec = torch.where(fgm, rank_pos / torch.clamp_min(rank, _TINY), 0.0)

    # the positives in ascending logit order, the rest after them (their
    # precision 0 leaves the running max alone)
    order = torch.argsort(torch.where(fgm, logits, BIG), stable=True)
    cp = cur_prec[order]
    new_max = torch.cummax(cp, dim=0).values      # the carry after a step
    max_prec = torch.cat([new_max.new_zeros(1), new_max[:-1]])   # before
    w = torch.where(max_prec <= cp, 1.0,
                    (1.0 - max_prec) / torch.clamp_min(1.0 - cp, _TINY))
    is_fg = fgm[order]
    weight = torch.empty_like(cp)
    weight[order] = torch.where(is_fg, w / torch.clamp_min(rank[order], _TINY),
                                0.0)
    bg_grad = BR.T @ weight
    prec = torch.empty_like(cp)
    prec[order] = torch.where(is_fg, new_max, 0.0)
    fg_grad = torch.empty_like(cp)
    fg_grad[order] = -(1.0 - new_max) * is_fg
    grad = torch.where(fgm, fg_grad, torch.where(bgm, bg_grad, 0.0)) / fg_num
    return 1.0 - prec.sum() / fg_num, grad


class APLoss(torch.autograd.Function):
    """Interpolated average-precision loss (utils/loss.py:345-420); the
    gradient reaches the logits only."""

    @staticmethod
    def forward(ctx, logits, targets, valid, delta):
        loss, grad = _ap_fwd(logits, targets, valid, delta)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g, None, None, None


def ap_loss(logits, targets, valid, delta: float = 1.0):
    """logits, targets (N,) (positives: targets == 1), valid (N,) bool ->
    the AP loss."""
    return APLoss.apply(logits, targets, valid, delta)
