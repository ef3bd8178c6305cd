"""Every traffic mix and every weight is a function of the seed: the same
seed gives the same inputs, another seed other inputs of the same sizes,
and every seed the same detection load."""

import math

import numpy as np
import pytest
import torch

from perfbench.harness import traffic
from perfbench.harness.weights import detector_weights
from perfbench.reference.detector import architecture
from perfbench_tiny import tiny

SEED = 2**31 + 12345        # the runner's seeds pass 32 signed bits


def _frames(src):
    return [src.frame(k) for k in (0, 1, 57)]


@pytest.mark.parametrize("seed", [SEED, 3])
def test_mix_is_deterministic_in_the_seed(seed):
    mix = tiny("w6-bytetrack.video").traffic
    a = _frames(traffic.make(seed, mix))
    b = _frames(traffic.make(seed, mix))
    c = _frames(traffic.make(seed + 1, mix))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert [x.shape for x in a] == [x.shape for x in c]


def test_video_pans_as_np_roll():
    mix = tiny("w6-bytetrack.video").traffic
    src = traffic.make(SEED, mix)
    f0 = np.ascontiguousarray(src.frame(0))
    assert np.array_equal(src.frame(5), np.roll(f0, 5 * mix["pan_px"], 1))


def test_weights_are_deterministic_and_every_box_is_box_px():
    cfg = tiny("w6-bytetrack.video").config
    a = detector_weights(cfg, SEED, "cpu")
    b = detector_weights(cfg, SEED, "cpu")
    c = detector_weights(cfg, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer1.conv.weight"], c["layer1.conv.weight"])
    arch = architecture(cfg["pipeline"]["model"])
    na, no = 3, cfg["pipeline"]["nc"] + 5
    for i in range(len(arch.HEAD_FROM)):
        name = f"head_m{'2' if i >= len(arch.STRIDES) else ''}_" \
               f"{i % len(arch.STRIDES)}"
        for sd in (a, c):
            w = sd[name + ".weight"].view(na, no, -1)
            assert not w[:, 2:4].any()
            t = sd[name + ".bias"].view(na, no)[:, 2:4].double()
            anchor = torch.tensor(arch.ANCHORS[i % len(arch.STRIDES)],
                                  dtype=torch.float64).view(na, 2)
            wh = (2.0 * torch.sigmoid(t)) ** 2 * anchor
            assert torch.allclose(wh, torch.tensor(
                cfg["weights"]["box_px"], dtype=torch.float64).expand(na, 2),
                rtol=1e-5), (name, wh)
    assert math.isfinite(float(a["head_m_0.bias"].sum()))
