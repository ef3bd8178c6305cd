"""DHN (Deep Hungarian Net) trainer (port of
yolov7_tracker_tpu/train/dhn_train.py).

The reference integrates DHN inference into DeepMOT (tracker/deepmot.py)
but ships neither weights nor a training script; the DeepMOT paper (Xu et
al., CVPR 2020 section 4.1) trains it as a soft-assignment regressor:
random distance matrices labelled by the exact Hungarian solution, a
weighted focal BCE per cell. This module trains the port's
``reid/dhn.build_dhn`` by that recipe with Adam and writes the weights as
a Flax msgpack file, which ``reid/dhn.load_dhn`` (``--dhn_path``) and the
JAX package's ``checkpoint.load_variables`` both read:

    python -m yolov7_tracker_tpu_torch.train.dhn_train --device cuda \\
        --steps 2000 --out dhn.msgpack

As in JAX: ``make_problem`` draws from the numpy Generator in the same
order, so one seed gives the same batches byte for byte; the seeded
initial weights follow Flax's distributions (lecun-normal input and dense
kernels, orthogonal recurrent kernels, zero biases), from torch's random
stream, not JAX's. Flax's GRUCell has no hidden bias on the r and z
gates, so those entries of ``bias_hh`` start at zero and a gradient hook
keeps them there (their gradient equals ``bias_ih``'s, and Adam would
move the effective bias twice as fast as JAX does).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
from torch import nn


def make_problem(rng: np.random.Generator, h: int, w: int, pad_to=None):
    """A synthetic association problem: a noisy block-diagonal distance
    matrix (tracks near their own detections) and its Hungarian labels.

    pad_to=(H, W): embed the h x w problem top-left in an H x W matrix
    padded with cost 1.0 / label 0, the geometry reid/dhn.compact_cost
    gives the DHN when tracking."""
    from scipy.optimize import linear_sum_assignment

    d = rng.uniform(0.3, 1.0, (h, w)).astype(np.float32)
    k = min(h, w)
    perm = rng.permutation(w)[:k]
    d[np.arange(k), perm] = rng.uniform(0.0, 0.35, k)
    rows, cols = linear_sum_assignment(d)
    y = np.zeros((h, w), np.float32)
    # only confident matches count as positives (the paper's thresholded
    # ground truth)
    ok = d[rows, cols] < 0.5
    y[rows[ok], cols[ok]] = 1.0
    if pad_to is not None:
        dp = np.full(pad_to, 1.0, np.float32)
        yp = np.zeros(pad_to, np.float32)
        dp[:h, :w] = d
        yp[:h, :w] = y
        return dp, yp
    return d, y


def sample_batch(rng: np.random.Generator, h: int, w: int,
                 pad_train: bool = False, batch: int = 1):
    """(d (batch, h, w), y (batch, h, w)) float32 numpy: ``batch``
    problems, drawn as the JAX trainer draws one step's. pad_train: each
    problem's valid size uniform in [1, h] x [1, w], padded to (h, w)."""
    def sample():
        if pad_train:
            hv = int(rng.integers(1, h + 1))
            wv = int(rng.integers(1, w + 1))
            return make_problem(rng, hv, wv, pad_to=(h, w))
        return make_problem(rng, h, w)

    ds, ys = zip(*(sample() for _ in range(batch)))
    return np.stack(ds), np.stack(ys)


def batch_to(device, d, y):
    """A host batch (numpy) on ``device``."""
    return torch.from_numpy(d).to(device), torch.from_numpy(y).to(device)


def weighted_focal_bce(pred, target, gamma: float = 2.0):
    """The focal BCE per cell with the positive class reweighted by its
    inverse frequency (DeepMOT Eq. 9), the mean over each problem's (H, W)
    cells: (..., H, W) -> (...)."""
    eps = 1e-7
    p = torch.clamp(pred, eps, 1.0 - eps)
    size = target.shape[-1] * target.shape[-2]
    n_pos_t = target.sum((-2, -1), keepdim=True)
    n_pos = torch.clamp_min(n_pos_t, 1.0)
    n_neg = torch.clamp_min(size - n_pos_t, 1.0)
    pos = target > 0.5
    w = torch.where(pos, size / n_pos, size / n_neg)
    focal = torch.where(pos, (1 - p) ** gamma, p ** gamma)
    bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    return (w * focal * bce).mean((-2, -1))


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator):
    """Flax's lecun_normal: a normal truncated at 2 std, with the std of
    the untruncated one sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


def init_dhn(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights in Flax's distributions, in place: each GRU gate's
    input kernel lecun-normal and its recurrent kernel orthogonal, every
    dense kernel lecun-normal, every bias zero (the Sinkhorn head's
    temperatures keep their values)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("log_tau"):
                continue
            if "bias" in name:
                p.zero_()
            elif "weight_hh" in name:
                h = p.shape[1]
                for j in range(3):                 # r, z, n
                    nn.init.orthogonal_(p[j * h:(j + 1) * h], generator=g)
            else:                                  # weight_ih, Linear
                _lecun_normal_(p, p.shape[1], g)
    return model


def hold_rz_hidden_bias(model: nn.Module) -> None:
    """Keep the r / z entries of every GRU ``bias_hh`` where they are (at
    zero: Flax's GRUCell has no such bias) by zeroing their gradient."""
    for name, p in model.named_parameters():
        if "bias_hh" in name:
            h = p.shape[0] // 3
            mask = torch.ones_like(p)
            mask[:2 * h] = 0.0
            p.register_hook(lambda grad, mask=mask: grad * mask)


def build_trainer(arch: str = "gru", hidden: int = 256, lr: float = 3e-4,
                  seed: int = 0, device=None, state_dict=None):
    """(model in train mode on ``device``, its Adam optimizer): seeded
    Flax-distributed weights, or ``state_dict`` (e.g. JAX's init through
    models/from_jax.dhn_state_dict). device None: the card; raises without
    one."""
    from .. import resolve_device
    from ..reid.dhn import build_dhn

    model = build_dhn(arch, hidden)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_dhn(model, seed)
    model = model.to(resolve_device(device)).train()
    hold_rz_hidden_bias(model)
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root
    return model, torch.optim.Adam(model.parameters(), lr=lr,
                                   betas=(0.9, 0.999), eps=1e-8)


def train_step(model: nn.Module, opt, d, y) -> torch.Tensor:
    """One Adam step on a batch d, y (B, H, W) on the model's device; the
    mean of the problems' losses (a device tensor, before the update)."""
    opt.zero_grad(set_to_none=True)
    loss = weighted_focal_bce(model(d), y).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def train_dhn(steps: int = 2000, h: int = 16, w: int = 16,
              lr: float = 3e-4, seed: int = 0, log_every: int = 100,
              hidden: int = 256, arch: str = "gru",
              pad_train: bool = False, batch: int = 1,
              device=None) -> nn.Module:
    """Train the DHN on synthetic Hungarian problems; returns the model.

    pad_train: sample the VALID problem size uniformly in [1, h] x [1, w]
    and pad to (h, w) with cost 1.0 / label 0, which teaches the net the
    tracking-time compact_cost geometry (random sizes also keep the
    size-agnostic sinkhorn arch from overfitting one shape)."""
    model, opt = build_trainer(arch, hidden, lr, seed, device)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    for i in range(steps):
        d, y = sample_batch(rng, h, w, pad_train, batch)
        loss = train_step(model, opt, *batch_to(dev, d, y))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: loss {float(loss):.4f}")
    return model.eval()


@torch.no_grad()
def eval_dhn(model: nn.Module, n: int = 64, h: int = 32, w: int = 32,
             seed: int = 1, pad_to=None) -> dict:
    """Held-out quality: mean per-cell accuracy at 0.5 and Hungarian match
    agreement (positives recovered with score > 0.1, the tracking
    threshold: deepmot matches on 1 - DHN(D) with cost limit 0.9)."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    rng = np.random.default_rng(seed)
    accs, recalls = [], []
    for _ in range(n):
        hv = int(rng.integers(2, h + 1)) if pad_to else h
        wv = int(rng.integers(2, w + 1)) if pad_to else w
        d, y = make_problem(rng, hv, wv, pad_to=pad_to)
        p = model(torch.from_numpy(d).to(dev)).cpu().numpy()
        accs.append(float(((p > 0.5) == (y > 0.5)).mean()))
        npos = y.sum()
        if npos:
            recalls.append(float(((p > 0.1) & (y > 0.5)).sum() / npos))
    model.train(was_training)
    return {"cell_acc": float(np.mean(accs)),
            "match_recall": float(np.mean(recalls))}


def save_dhn(path: str, model: nn.Module, arch: str) -> str:
    """The model's weights as a Flax msgpack file (the JAX DHN's variable
    tree)."""
    from ..models.from_jax import dhn_variables
    from ..utils.flax_msgpack import save_variables

    return save_variables(path, dhn_variables(model.state_dict(), arch))


def main(argv=None):
    p = argparse.ArgumentParser("dhn trainer")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--hidden", type=int, default=256,
                   help="GRU width; the reference arch is 256, small values "
                        "train fast for tests")
    p.add_argument("--arch", type=str, default="gru",
                   choices=["gru", "sinkhorn"])
    p.add_argument("--pad_train", action="store_true",
                   help="random valid sizes padded to --size (the "
                        "tracking-time compact_cost geometry)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--out", type=str, default="dhn.msgpack")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without a GPU) or cpu")
    opts = p.parse_args(argv)
    model = train_dhn(opts.steps, opts.size, opts.size, opts.lr,
                      hidden=opts.hidden, arch=opts.arch,
                      pad_train=opts.pad_train, batch=opts.batch,
                      device=opts.device)
    metrics = eval_dhn(model, h=opts.size, w=opts.size,
                       pad_to=(opts.size, opts.size)
                       if opts.pad_train else None)
    print(f"eval: {metrics}")
    save_dhn(opts.out, model, opts.arch)
    print(f"saved {opts.out}")
    return model


if __name__ == "__main__":
    main()
