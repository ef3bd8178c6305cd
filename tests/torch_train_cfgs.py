"""Narrow training configurations and seeded batches shared by the
tests that train the PyTorch port, with and without JAX
(tests/test_torch_train_*.py, tests/test_torch_cuda.py). Imports no JAX."""

import numpy as np

from yolov7_tracker_tpu_torch.models import zoo as tzoo


def narrow_aux_cfg(nc=8):
    """A four-level IAuxDetect cfg at width 0.25 in the w6 pattern (ReOrg
    stem, strides 8..64, SPPCSPC on the last level, an upsampled merge,
    four lead and four aux head inputs), shallow enough that float32
    training-mode gradients keep 1e-4 across packages. At 128 px and
    batch 4 each BatchNorm of the stride-64 level sees 16 values a
    channel; at batch 2 (8 values) float32 alone moves the smallest
    gradients by up to 5e-5 of their largest (float64 against float32,
    both in the port), too close to 1e-4."""
    rows = [
        [-1, 1, "ReOrg", []],                         # 0 /2
        [-1, 1, "Conv", [32, 3, 1]],                  # 1
        [-1, 1, "Conv", [64, 3, 2]],                  # 2 /4
        [-1, 1, "Conv", [64, 3, 2]],                  # 3 /8
        [-1, 1, "Conv", [128, 3, 2]],                 # 4 /16
        [-1, 1, "Conv", [128, 3, 2]],                 # 5 /32
        [-1, 1, "Conv", [256, 3, 2]],                 # 6 /64
        [-1, 1, "SPPCSPC", [128]],                    # 7
        [-1, 1, "Upsample", [None, 2, "nearest"]],    # 8 /32
        [[-1, 5], 1, "Concat", [1]],                  # 9
        [-1, 1, "Conv", [128, 1, 1]],                 # 10
        [3, 1, "Conv", [64, 3, 1]],                   # 11 lead
        [4, 1, "Conv", [128, 3, 1]],                  # 12
        [10, 1, "Conv", [128, 3, 1]],                 # 13
        [7, 1, "Conv", [256, 3, 1]],                  # 14
        [3, 1, "Conv", [64, 1, 1]],                   # 15 aux
        [4, 1, "Conv", [64, 1, 1]],                   # 16
        [5, 1, "Conv", [64, 1, 1]],                   # 17
        [6, 1, "Conv", [64, 1, 1]],                   # 18
        [[11, 12, 13, 14, 15, 16, 17, 18], 1, "IAuxDetect",
         ["nc", "anchors"]],
    ]
    return {"nc": nc, "depth_multiple": 1.0, "width_multiple": 0.25,
            "anchors": tzoo.ANCHORS_P6, "backbone": rows, "head": []}


def narrow_idetect_cfg(nc=8):
    """The same pattern with three levels (strides 8..32) and an IDetect
    head (SimOTA loss)."""
    rows = [
        [-1, 1, "ReOrg", []],                         # 0 /2
        [-1, 1, "Conv", [32, 3, 1]],                  # 1
        [-1, 1, "Conv", [64, 3, 2]],                  # 2 /4
        [-1, 1, "Conv", [64, 3, 2]],                  # 3 /8
        [-1, 1, "Conv", [128, 3, 2]],                 # 4 /16
        [-1, 1, "Conv", [256, 3, 2]],                 # 5 /32
        [-1, 1, "SPPCSPC", [128]],                    # 6
        [-1, 1, "Upsample", [None, 2, "nearest"]],    # 7 /16
        [[-1, 4], 1, "Concat", [1]],                  # 8
        [-1, 1, "Conv", [128, 1, 1]],                 # 9
        [3, 1, "Conv", [64, 3, 1]],                   # 10
        [9, 1, "Conv", [128, 3, 1]],                  # 11
        [6, 1, "Conv", [256, 3, 1]],                  # 12
        [[10, 11, 12], 1, "IDetect", ["nc", "anchors"]],
    ]
    return {"nc": nc, "depth_multiple": 1.0, "width_multiple": 0.25,
            "anchors": tzoo.ANCHORS_P5, "backbone": rows, "head": []}


def seeded_batch(seed, bsz=4, img=128, t_cap=16, n=5, nc=8):
    """(imgs (B, img, img, 3) float32 in [0, 1], targets (B, T, 5)
    normalised, tmask (B, T)) from a seed: n labelled boxes an image."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (bsz, img, img, 3)).astype(np.float32)
    t = np.zeros((bsz, t_cap, 5), np.float32)
    m = np.zeros((bsz, t_cap), bool)
    t[:, :n, 0] = rng.integers(0, nc, (bsz, n))
    t[:, :n, 1:3] = rng.uniform(0.2, 0.8, (bsz, n, 2))
    t[:, :n, 3:5] = rng.uniform(0.05, 0.5, (bsz, n, 2))
    m[:, :n] = True
    return imgs, t, m
