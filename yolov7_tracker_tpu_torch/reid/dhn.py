"""Deep Hungarian Net, the soft-assignment scorer of DeepMOT (port of
yolov7_tracker_tpu/reid/dhn.py; the reference's tracker/deepmot.py:10-140).

``DHN``: a 2-layer bidirectional GRU over the row-major flattened cost
matrix, a second one over the column-major order of the first's outputs,
then dense layers 2h -> 256 -> 64 -> 1 and a sigmoid. Each BiGRU is one
``nn.GRU(num_layers=2, bidirectional=True)``: cuDNN's GRU on the card,
as the convs are cuDNN's (the JAX package runs it as an XLA scan of
GRUCell steps, not as a Pallas kernel).

``SinkhornDHN``: the parallel head. For three learned temperatures it
runs 20 log-domain Sinkhorn sweeps, then scores each cell from the cost,
the three transport plans and the row and column softmin gaps with a
per-cell MLP.

Both take a cost of shape (..., H, W): the leading axes (the streams of
a stacked step) are the batch. ``compact_cost`` moves the valid rows and
columns to the top-left, per stream, and pads the rest with cost 1.0;
``uncompact`` undoes the permutation.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

HIDDEN = 256


class DHN(nn.Module):
    """Cost (..., H, W) -> soft assignment scores (..., H, W) in [0, 1]."""

    def __init__(self, hidden: int = HIDDEN):
        super().__init__()
        self.hidden = hidden
        self.lstm_row = nn.GRU(1, hidden, num_layers=2, bidirectional=True,
                               batch_first=True)
        self.lstm_col = nn.GRU(2 * hidden, hidden, num_layers=2,
                               bidirectional=True, batch_first=True)
        self.hidden2tag_1 = nn.Linear(2 * hidden, 256)
        self.hidden2tag_2 = nn.Linear(256, 64)
        self.hidden2tag_3 = nn.Linear(64, 1)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        lead, (h, w) = d.shape[:-2], d.shape[-2:]
        x = d.reshape(-1, h * w, 1)
        b = x.shape[0]
        row_out, _ = self.lstm_row(x)                       # (B, HW, 2h)
        col_seq = row_out.reshape(b, h, w, -1).transpose(1, 2).reshape(
            b, w * h, -1)
        col_out, _ = self.lstm_col(col_seq)                 # (B, WH, 2h)
        feats = col_out.reshape(b, w, h, -1).transpose(1, 2)
        x = self.hidden2tag_3(self.hidden2tag_2(self.hidden2tag_1(feats)))
        return torch.sigmoid(x).reshape(lead + (h, w))


class SinkhornDHN(nn.Module):
    """Entropic-assignment potentials at learned temperatures and a
    per-cell MLP; only reductions and elementwise ops over (..., H, W)."""

    def __init__(self, iters: int = 20,
                 taus: Tuple[float, ...] = (0.02, 0.05, 0.15),
                 feat: int = 32):
        super().__init__()
        self.iters = iters
        self.log_tau = nn.Parameter(torch.log(torch.tensor(taus)))
        self.cell_1 = nn.Linear(len(taus) + 3, feat)
        self.cell_2 = nn.Linear(feat, feat)
        self.cell_out = nn.Linear(feat, 1)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        planes = [d]
        for i in range(self.log_tau.shape[0]):
            tau = torch.exp(self.log_tau[i])
            f = d.new_zeros(d.shape[:-1])
            g = d.new_zeros(d.shape[:-2] + d.shape[-1:])
            for _ in range(self.iters):
                f = -tau * torch.logsumexp((-d + g[..., None, :]) / tau,
                                           dim=-1)
                g = -tau * torch.logsumexp((-d + f[..., :, None]) / tau,
                                           dim=-2)
            planes.append(torch.exp((-d + f[..., :, None] + g[..., None, :])
                                    / tau))
        # softmin gaps: how far each cell sits above its row / column best
        planes.append(d - (-0.05) * torch.logsumexp(d / -0.05, dim=-1,
                                                    keepdim=True))
        planes.append(d - (-0.05) * torch.logsumexp(d / -0.05, dim=-2,
                                                    keepdim=True))
        x = torch.stack([p.expand(d.shape) for p in planes], dim=-1)
        x = torch.relu(self.cell_1(x))
        x = torch.relu(self.cell_2(x))
        return torch.sigmoid(self.cell_out(x)[..., 0])


def build_dhn(arch: str, hidden: int = HIDDEN) -> nn.Module:
    """The DHN by architecture name: 'gru' (the reference's Munkrs shape)
    or 'sinkhorn'."""
    if arch == "gru":
        return DHN(hidden=hidden)
    if arch == "sinkhorn":
        return SinkhornDHN()
    raise ValueError(f"unknown dhn arch {arch!r}; have gru|sinkhorn")


def _permute(mat, rperm, cperm):
    """mat (..., N, M) with its rows taken in rperm's order and its columns
    in cperm's (per leading index)."""
    mat = mat.gather(-2, rperm[..., :, None].expand(mat.shape))
    return mat.gather(-1, cperm[..., None, :].expand(mat.shape))


def compact_cost(cost: torch.Tensor, row_mask, col_mask,
                 pad_value: float = 1.0, row_key=None):
    """Permute the valid rows and columns to the top-left (stably) and pad
    the rest with ``pad_value``. cost (..., N, M), row_mask (..., N),
    col_mask (..., M); every leading axis is a stream, compacted on its
    own. Returns (compacted cost, row perm (..., N), col perm (..., M)).

    row_key: an (..., N) sort key for the valid rows in place of slot
    order. The DHN is not permutation-equivariant, so DeepMOT passes the
    reference's strack_pool order (slab.pool_order_rank) to present rows
    in the reference's sequence; invalid rows follow in slot order."""
    if row_key is not None:
        n = row_key.shape[-1]
        tail = (row_key.amax(dim=-1, keepdim=True) + 1
                + torch.arange(n, device=row_key.device))
        rperm = torch.argsort(torch.where(row_mask, row_key, tail), dim=-1,
                              stable=True)
    else:
        rperm = torch.argsort((~row_mask).to(torch.uint8), dim=-1,
                              stable=True)
    cperm = torch.argsort((~col_mask).to(torch.uint8), dim=-1, stable=True)
    c = _permute(cost, rperm, cperm)
    rv = row_mask.gather(-1, rperm)
    cv = col_mask.gather(-1, cperm)
    c = torch.where(rv[..., :, None] & cv[..., None, :], c,
                    torch.full_like(c, pad_value))
    return c, rperm, cperm


def uncompact(mat: torch.Tensor, rperm, cperm) -> torch.Tensor:
    """The inverse permutation of compact_cost."""
    rinv = torch.argsort(rperm, dim=-1)
    cinv = torch.argsort(cperm, dim=-1)
    return _permute(mat, rinv, cinv)


def load_dhn(path: str, arch: str, hidden: int = HIDDEN,
             device=None) -> nn.Module:
    """A trained DHN from a Flax msgpack file (the JAX package's
    ``save_variables`` / train/dhn_train.py output, or the port's) on
    ``device`` (None: the card; raises without one), in eval mode. Raises
    if the file is missing or its variables do not fit ``build_dhn(arch,
    hidden)``."""
    from .. import resolve_device
    from ..models.from_jax import dhn_state_dict
    from ..utils.flax_msgpack import load_variables

    device = resolve_device(device)
    model = build_dhn(arch, hidden)
    model.load_state_dict(dhn_state_dict(load_variables(path), arch))
    model = model.to(device).eval()
    for m in model.modules():
        if isinstance(m, nn.GRU):
            m.flatten_parameters()
    return model
