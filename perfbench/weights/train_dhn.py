"""The DHN weights the cell deepmot-gru-h256.video runs with
(``dhn_gru_h256.pth``), made on the benchmark's side.

DeepMOT's published ``DHN.pth`` is not public, so this script trains
``Munkrs`` (Xu et al., "How To Train Your Deep Multi-Object Tracker",
CVPR 2020, arXiv:1906.06618; github.com/yihongXU/deepMOT) by the paper's
recipe (section 4.1): distance matrices labelled by the exact Hungarian
solution, a focal binary cross-entropy per cell with the positive class
reweighted by its inverse frequency, Adam. Each problem here has a valid
size drawn uniformly in [1, size] x [1, size]: uniform background costs
in [0.3, 1), a random one-to-one set of min(h, w) pairs at [0, 0.35), the
Hungarian pairs below 0.5 labelled 1, padded to size x size with cost 1.0
and label 0, the geometry of the padded cost a tracker hands its DHN.
The network is ``Munkrs`` in plain torch (``nn.GRU``), every weight and
bias from torch's default initialisation under ``torch.manual_seed``,
all of them trained (the GRUs' r and z hidden biases too); float32 with
TF32 off. It writes ``Munkrs``'s state dict with ``torch.save``.
Nothing here imports the program.

The committed file is the output of

    python3 perfbench/weights/train_dhn.py --device cuda \\
        --out perfbench/weights/dhn_gru_h256.pth

(seed 0, 2,000 steps of 8 problems at size 16, learning rate 3e-4,
hidden 256), on an NVIDIA H100; cuDNN's training kernels are not bit
for bit repeatable, so a rerun gives close but not equal weights.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from torch import nn


class Munkrs(nn.Module):
    """DeepMOT's DHN as its module names it: a row BiGRU over the
    row-major flattened cost, a column BiGRU over the column-major
    reordering of its outputs, a dense head 2h -> 256 -> 64 -> 1 and a
    sigmoid."""

    def __init__(self, hidden: int = 256):
        super().__init__()
        self.lstm_row = nn.GRU(1, hidden, num_layers=2, bidirectional=True,
                               batch_first=True)
        self.lstm_col = nn.GRU(2 * hidden, hidden, num_layers=2,
                               bidirectional=True, batch_first=True)
        self.hidden2tag_1 = nn.Linear(2 * hidden, 256)
        self.hidden2tag_2 = nn.Linear(256, 64)
        self.hidden2tag_3 = nn.Linear(64, 1)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        b, h, w = d.shape
        row, _ = self.lstm_row(d.reshape(b, h * w, 1))
        col_in = row.reshape(b, h, w, -1).transpose(1, 2).reshape(b, w * h,
                                                                  -1)
        col, _ = self.lstm_col(col_in)
        feats = col.reshape(b, w, h, -1).transpose(1, 2)
        out = self.hidden2tag_3(self.hidden2tag_2(self.hidden2tag_1(feats)))
        return torch.sigmoid(out).reshape(b, h, w)


def problem(rng: np.random.Generator, size: int):
    """(cost, label), each (size, size) float32: one association problem
    of a random valid size, padded."""
    h, w = (int(v) for v in rng.integers(1, size + 1, 2))
    d = rng.uniform(0.3, 1.0, (h, w))
    k = min(h, w)
    d[rng.permutation(h)[:k], rng.permutation(w)[:k]] = rng.uniform(
        0.0, 0.35, k)
    r, c = linear_sum_assignment(d)
    keep = d[r, c] < 0.5
    cost = np.ones((size, size), np.float32)
    label = np.zeros((size, size), np.float32)
    cost[:h, :w] = d
    label[r[keep], c[keep]] = 1.0
    return cost, label


def batch(rng: np.random.Generator, n: int, size: int, device):
    cost, label = zip(*(problem(rng, size) for _ in range(n)))
    return (torch.from_numpy(np.stack(cost)).to(device),
            torch.from_numpy(np.stack(label)).to(device))


def focal_bce(p: torch.Tensor, y: torch.Tensor, gamma: float = 2.0):
    """The focal BCE per cell, positives and negatives each weighted by
    the inverse of their share of the problem's cells; the mean over
    cells and problems."""
    p = p.clamp(1e-7, 1.0 - 1e-7)
    cells = y.shape[-1] * y.shape[-2]
    n_pos = y.sum((-2, -1), keepdim=True).clamp_min(1.0)
    n_neg = (cells - n_pos).clamp_min(1.0)
    weight = torch.where(y > 0.5, cells / n_pos, cells / n_neg)
    loss = torch.where(y > 0.5, -(1 - p) ** gamma * torch.log(p),
                       -p ** gamma * torch.log(1 - p))
    return (weight * loss).mean()


def train(hidden: int = 256, steps: int = 2000, size: int = 16,
          n: int = 8, lr: float = 3e-4, seed: int = 0, device="cpu",
          log_every: int = 200) -> Munkrs:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(seed)
    model = Munkrs(hidden).to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        cost, label = batch(rng, n, size, device)
        opt.zero_grad(set_to_none=True)
        loss = focal_bce(model(cost), label)
        loss.backward()
        opt.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: loss {loss.item():.4f}", flush=True)
    return model.eval()


@torch.no_grad()
def evaluate(model: Munkrs, size: int = 16, problems: int = 64,
             seed: int = 1) -> dict:
    """On held-out problems: the share of cells whose score sits on the
    label's side of 0.5, and the share of Hungarian pairs scored above
    0.1 (those a tracker gating 1 - score at 0.9 keeps)."""
    dev = next(model.parameters()).device
    cost, label = batch(np.random.default_rng(seed), problems, size, dev)
    p = model(cost)
    pos = label > 0.5
    return {"cell_acc": float(((p > 0.5) == pos).float().mean()),
            "match_recall": float((p[pos] > 0.1).float().mean())}


def save(model: Munkrs, path: str) -> str:
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    t = time.time()
    model = train(device=a.device)
    print(f"trained in {time.time() - t:.1f} s; held out: "
          f"{evaluate(model)}", flush=True)
    save(model, a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
