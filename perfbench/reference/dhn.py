"""Plain reference of DeepMOT's Deep Hungarian Net (Xu et al., "How To
Train Your Deep Multi-Object Tracker", CVPR 2020, arXiv:1906.06618; the
``Munkrs`` module of github.com/yihongXU/deepMOT as the reference tracker's
``tracker/deepmot.py:10-140`` runs it), in float64 torch on the CPU.

The network, on a cost D (H, W):

- a row BiGRU (2 layers, bidirectional, input 1, hidden h) over the
  row-major flattened cost, H * W steps;
- a column BiGRU (2 layers, bidirectional, input 2h, hidden h) over the
  column-major reordering of the row BiGRU's outputs;
- a dense head 2h -> 256 -> 64 -> 1 on each cell, then a sigmoid.

Each GRU step is PyTorch's ``nn.GRU`` cell, the state starting at zero:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

A layer's input projection is one matmul over the whole sequence; the
recurrence is a loop, both directions of a layer in one step of it. The
weights are ``Munkrs``'s state dict (``lstm_row.weight_ih_l0``, ...,
``hidden2tag_3.bias``), read from a ``.pth`` / ``.pt`` file. Nothing
here imports the program.

``compact_cost`` / ``uncompact``: the padded, compacted cost that the
tracker gives the network (the valid rows in the given key's order and
the valid columns in theirs moved to the top-left, the rest 1.0), and
back. ``dhn_flops``: the network's operations on an h x w cost.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_WEIGHTS: Dict[str, Dict[str, torch.Tensor]] = {}


def load(path: str) -> Dict[str, torch.Tensor]:
    """``Munkrs``'s state dict from ``path`` in float64 (a bare state dict
    or one under ``state_dict``; ``module.`` stripped), read once."""
    path = os.path.abspath(path)
    if path not in _WEIGHTS:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
        _WEIGHTS[path] = {k[len("module."):] if k.startswith("module.")
                          else k: v.double() for k, v in sd.items()}
    return _WEIGHTS[path]


def _bigru_layer(x: torch.Tensor, sd: dict, name: str, layer: int
                 ) -> torch.Tensor:
    """One bidirectional layer over x (B, T, I): (B, T, 2h), the forward
    direction's states then the reverse one's."""
    t = x.shape[1]
    sfx = [f"_l{layer}", f"_l{layer}_reverse"]
    w_hh_t = torch.stack([sd[f"{name}.weight_hh{s}"].T for s in sfx])
    b_hh = torch.stack([sd[f"{name}.bias_hh{s}"] for s in sfx])[:, None]
    h_dim = w_hh_t.shape[1]
    # input projections: one matmul a direction over the sequence; the
    # reverse direction's in its own time order
    gi = torch.stack([x @ sd[f"{name}.weight_ih{s}"].T
                      + sd[f"{name}.bias_ih{s}"] for s in sfx])  # (2,B,T,3h)
    gi[1] = gi[1].flip(1)
    h = x.new_zeros(2, x.shape[0], h_dim)
    out = x.new_empty(2, x.shape[0], t, h_dim)
    for k in range(t):
        g_i = gi[:, :, k]
        g_h = torch.baddbmm(b_hh, h, w_hh_t)                      # (2,B,3h)
        rz = torch.sigmoid(g_i[..., :2 * h_dim] + g_h[..., :2 * h_dim])
        n = torch.tanh(g_i[..., 2 * h_dim:]
                       + rz[..., :h_dim] * g_h[..., 2 * h_dim:])
        h = (1.0 - rz[..., h_dim:]) * n + rz[..., h_dim:] * h
        out[:, :, k] = h
    return torch.cat([out[0], out[1].flip(1)], -1)


def _bigru(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    for layer in range(2):
        x = _bigru_layer(x, sd, name, layer)
    return x


def forward(sd: Dict[str, torch.Tensor], d) -> torch.Tensor:
    """Scores (..., H, W) in [0, 1] of costs d (..., H, W), in float64;
    the leading axes are a batch of costs."""
    d = torch.as_tensor(np.asarray(d, np.float64))
    lead, (h, w) = d.shape[:-2], d.shape[-2:]
    x = d.reshape(-1, h * w, 1)
    b = x.shape[0]
    with torch.no_grad():
        row = _bigru(x, sd, "lstm_row")                          # (B,HW,2h)
        col_seq = row.reshape(b, h, w, -1).transpose(1, 2).reshape(
            b, w * h, -1)
        col = _bigru(col_seq, sd, "lstm_col")                    # (B,WH,2h)
        feats = col.reshape(b, w, h, -1).transpose(1, 2)
        for i in (1, 2, 3):
            feats = (feats @ sd[f"hidden2tag_{i}.weight"].T
                     + sd[f"hidden2tag_{i}.bias"])
        return torch.sigmoid(feats).reshape(lead + (h, w))


def dhn_flops(hidden: int, h: int, w: int) -> int:
    """Operations of one forward on an h x w cost, 2 a multiply-add: the
    row BiGRU's first layer (input 1) and second (input 2h), the column
    BiGRU's two (input 2h), each direction's three gates on the input and
    the state at every one of the h * w steps, and the head
    2h -> 256 -> 64 -> 1 on every cell."""
    gates = 3 * hidden
    row = 2 * gates * (1 + hidden) * 2 + 2 * gates * (3 * hidden) * 2
    col = 2 * (2 * gates * (3 * hidden) * 2)
    head = 2 * (2 * hidden * 256 + 256 * 64 + 64)
    return (row + col + head) * h * w


def compact_cost(cost: np.ndarray, row_mask, col_mask, row_key=None,
                 pad_value: float = 1.0):
    """The valid rows (in ascending ``row_key``, then slot order; all in
    slot order without a key) and the valid columns (in order) moved to
    the top-left of a matrix of cost's shape, the rest ``pad_value``.
    Returns (compacted cost, row order, column order): row i of the result
    is row ``rows[i]`` of ``cost``."""
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    row_mask, col_mask = np.asarray(row_mask, bool), np.asarray(col_mask,
                                                                 bool)
    key = np.arange(n) if row_key is None else np.asarray(row_key)
    valid_rows = np.flatnonzero(row_mask)
    valid_rows = valid_rows[np.argsort(key[valid_rows], kind="stable")]
    rows = np.concatenate([valid_rows, np.flatnonzero(~row_mask)])
    cols = np.concatenate([np.flatnonzero(col_mask),
                           np.flatnonzero(~col_mask)])
    out = np.full((n, m), pad_value)
    p, k = len(valid_rows), int(col_mask.sum())
    out[:p, :k] = cost[np.ix_(rows[:p], cols[:k])]
    return out, rows, cols


def uncompact(mat, rows, cols) -> np.ndarray:
    """The inverse of compact_cost's permutation: ``out[rows[i], cols[j]]
    = mat[i, j]``."""
    mat = np.asarray(mat)
    out = np.empty_like(mat)
    out[np.ix_(rows, cols)] = mat
    return out
