#!/usr/bin/env python3
"""Would a cached top two pay in the square auction's sweep? A CPU count.

Prices never fall during a solve, so a row's values w - price never rise.
If a row kept its best two columns and its third-best value from its last
full scan, two loads would give its exact top two at its next bid whenever
both recomputed values are strictly above the kept third value (a hit);
otherwise it must scan again (a miss). This script runs the Jacobi auction
of yolov7_tracker_tpu_torch/ops/auction_square.py in numpy float32 on the
seeded (128, 300) problems of chip_smoke.py and counts hits among all bids,
for real and dummy rows apart. It times nothing and needs no card:

    python tools/square_top2_cache_count.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import SQUARE_PHASES, seeded_problem  # noqa: E402
from yolov7_tracker_tpu_torch.ops import auction_square  # noqa: E402

NEG = np.float32(-1e9)


def count(cost, rm, cm, thresh, n_phases=SQUARE_PHASES, max_iters=4096):
    """(bids, hits) as {"real": k, "dummy": k} for one problem, and the
    sweeps of the solve. A release scans every row in full and so refreshes
    every row's cache."""
    th = torch.tensor([thresh], dtype=torch.float32)
    sched, cap = auction_square.eps_schedule(th, n_phases, 4.0)
    w, _ = auction_square._extended_weights(
        torch.from_numpy(cost)[None], torch.from_numpy(rm)[None],
        torch.from_numpy(cm)[None], th)
    w, sched, cap = w[0].numpy(), sched[0].numpy(), cap.numpy()[0]
    n, m = cost.shape
    s = n + m
    ids = np.arange(s)
    prices = np.zeros(s, np.float32)
    r2c = np.where(ids < n, ids + m, ids - n)
    c2r = np.where(ids < m, ids + n, ids - m)
    cached = np.zeros((s, 2), np.int64)         # a row's best two columns
    third = np.full(s, np.inf, np.float32)      # its third-best value then
    bids = {"real": 0, "dummy": 0}
    hits = {"real": 0, "dummy": 0}
    sweeps = 0

    def top3(rows):
        vals = w[rows] - prices[None, :]
        k = np.arange(len(rows))
        j1 = vals.argmax(axis=1)
        v1 = vals[k, j1]
        vals[k, j1] = -np.inf
        j2 = vals.argmax(axis=1)
        v2 = vals[k, j2]
        vals[k, j2] = -np.inf
        return v1, j1, v2, j2, vals.max(axis=1)

    for ph in range(n_phases):
        eps = sched[ph]
        v1, j1, _, j2, v3 = top3(ids)
        cached[:, 0], cached[:, 1], third[:] = j1, j2, v3
        cur = np.maximum(w[ids, np.maximum(r2c, 0)]
                         - prices[np.maximum(r2c, 0)], NEG)
        r2c = np.where((r2c >= 0) & (cur >= v1 - eps), r2c, -1)
        c2r[:] = -1
        c2r[r2c[r2c >= 0]] = ids[r2c >= 0]
        it = 0
        while it < max_iters and (r2c < 0).any():
            rows = ids[r2c < 0]
            now = w[rows[:, None], cached[rows]] - prices[cached[rows]]
            hit = (now > third[rows, None]).all(axis=1)
            for kind, sel in (("real", rows < n), ("dummy", rows >= n)):
                bids[kind] += int(sel.sum())
                hits[kind] += int((hit & sel).sum())
            v1, j1, v2, j2, v3 = top3(rows)
            miss = rows[~hit]
            cached[miss, 0], cached[miss, 1] = j1[~hit], j2[~hit]
            third[miss] = v3[~hit]
            bid = (prices[j1] + np.minimum(v1 - np.maximum(v2, NEG), cap)) \
                + eps
            # a column goes to its highest bidder, lowest row on a tie
            order = np.lexsort((rows, -bid.astype(np.float64), j1))
            first = np.ones(len(rows), bool)
            first[1:] = j1[order][1:] != j1[order][:-1]
            win = order[first]
            prev = c2r[j1[win]]
            r2c[prev[prev >= 0]] = -1
            c2r[j1[win]] = rows[win]
            r2c[rows[win]] = j1[win]
            prices[j1[win]] = bid[win]
            it += 1
        sweeps += it
    return bids, hits, sweeps


def main():
    rng = np.random.default_rng(1)     # chip_smoke.square_phase's problems
    total_b = {"real": 0, "dummy": 0}
    total_h = {"real": 0, "dummy": 0}
    for i in range(8):
        kind = "assoc" if i % 2 == 0 else "dense"
        cost, rm, cm = seeded_problem(rng, kind=kind)
        th = float(rng.choice([0.9, 0.7]))
        bids, hits, sweeps = count(cost, rm, cm, th)
        for k in bids:
            total_b[k] += bids[k]
            total_h[k] += hits[k]
        print(f"problem {i} ({kind}, thresh {th}): {sweeps} sweeps; real "
              f"rows {hits['real']} hits of {bids['real']} bids, dummy rows "
              f"{hits['dummy']} of {bids['dummy']}")
    b, h = sum(total_b.values()), sum(total_h.values())
    print(f"all: {h} hits of {b} bids = {100.0 * h / b:.1f}% (real rows "
          f"{100.0 * total_h['real'] / max(total_b['real'], 1):.1f}%, dummy "
          f"rows {100.0 * total_h['dummy'] / max(total_b['dummy'], 1):.1f}%)")


if __name__ == "__main__":
    main()
