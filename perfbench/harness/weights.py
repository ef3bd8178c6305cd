"""Seeded detector weights, made on the device from ``--seed``.

A frozen copy of the arithmetic of the port's ``random_state_dict``,
``init_head_biases`` and ``sharpen_heads`` (and of ``chip_smoke.build_w6``'s
gain), as the configuration's ``weights`` section sets it: lecun-normal
conv kernels truncated at 2 std, scaled by ``gain`` except the heads'
output convs; identity BatchNorm statistics; implicit vectors around 0
(ia) and 1 (im); the head bias prior; then heads sharpened (kernels x
``sharpen.kernel``, objectness and class logits raised by
``sharpen.boost``, class logits jittered by ``sharpen.jitter``) so that
NMS keeps a dense load. Every box is ``box_px`` (w, h) on the letterboxed
canvas: the heads' width and height rows have no kernel and a bias that
gives that size at each anchor, so the load is the same on every seed.
Each kind of leaf is drawn in one call of a generator on the device. The
key names are the unfused layout that the program loads.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from perfbench.harness.seeds import sub_seed
from perfbench.reference.detector import Yolo, architecture
from perfbench.reference.reid import crops, network

TRUNC_STD = 0.87962566103423978      # std of N(0, 1) truncated at +-2


def _is_head_out(key: str) -> bool:
    return key.startswith("head_m")


def detector_weights(config: dict, seed: int,
                     device) -> Dict[str, torch.Tensor]:
    """The unfused float32 state dict of the configuration's detector
    (``pipeline.model`` at ``pipeline.nc``), drawn as ``weights`` says."""
    nc, w = config["pipeline"]["nc"], config["weights"]
    arch = architecture(config["pipeline"]["model"])
    template = Yolo(arch, nc).to("meta").state_dict()
    keys = {k: (k + ".implicit" if k.startswith("head_i") else k)
            for k in template}
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 0))
    convs = [k for k, v in template.items() if v.dim() == 4]
    sizes = [template[k].numel() for k in convs]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    std = torch.tensor(
        [math.sqrt(1.0 / template[k][0].numel()) / TRUNC_STD
         * (1.0 if _is_head_out(k) else w["gain"]) for k in convs],
        device=device)
    flat *= torch.repeat_interleave(std, torch.tensor(sizes, device=device))
    sd = {keys[k]: t.view(template[k].shape)
          for k, t in zip(convs, flat.split(sizes))}
    imp = [k for k in template if k.startswith("head_i")]
    isz = [template[k].numel() for k in imp]
    noise = 0.02 * torch.randn(sum(isz), device=device, generator=g)
    for k, t in zip(imp, noise.split(isz)):
        sd[keys[k]] = t + (0.0 if k.startswith("head_ia") else 1.0)
    for k, v in template.items():
        if keys[k] in sd:
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith(("running_var", ".weight")):
            sd[k] = torch.ones(v.shape, device=device)
        else:                       # BN bias, running mean, head biases
            sd[k] = torch.zeros(v.shape, device=device)
    na, no, nl = 3, nc + 5, len(arch.STRIDES)
    s, box = w["sharpen"], w["box_px"]
    gj = torch.Generator(device=device)
    gj.manual_seed(sub_seed(seed, 1))
    jitter = (2.0 * torch.rand((len(arch.HEAD_FROM), na, nc), device=device,
                               generator=gj) - 1.0)
    for i in range(len(arch.HEAD_FROM)):
        name = f"head_m{'2' if i >= nl else ''}_{i % nl}"
        k = (sd[name + ".weight"] * s["kernel"]).view(na, no, -1)
        k[:, 2:4] = 0.0                # every box box_px, wherever it is
        sd[name + ".weight"] = k.view(sd[name + ".weight"].shape)
        b = sd[name + ".bias"].view(na, no)
        stride = arch.STRIDES[i % nl]
        b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
        b[:, 5:] += math.log(0.6 / (nc - 0.99))
        b[:, 4] += s["boost"]
        b[:, 5:] += s["boost"] + s["jitter"] * jitter[i]
        # wh = (2 sigmoid(t))^2 * anchor = box_px
        anchor = torch.tensor(arch.ANCHORS[i % nl], dtype=torch.float32,
                              device=device).view(na, 2)
        half = torch.sqrt(torch.tensor(box, dtype=torch.float32,
                                       device=device) / anchor) / 2.0
        b[:, 2:4] = torch.log(half / (1.0 - half))
    return sd


def reid_weights(config: dict, seed: int, frame_u8: np.ndarray,
                 device) -> Dict[str, torch.Tensor]:
    """The ReID network's (``pipeline.reid``) float32 state dict: a frozen
    copy of the port's
    ``random_reid_state_dict`` arithmetic (kernels N(0, 1) / sqrt(fan-in),
    BN scales U(0.8, 1.2), biases N(0, 0.05)), each kind drawn in one call
    on the device, then BatchNorm's statistics measured by one train-mode
    pass over the crops of ``weights.reid_calib_boxes`` boxes drawn from
    the seed on
    ``frame_u8`` (chip_smoke.calibrate_bn: with seeded statistics alone,
    embeddings of different crops come out nearly parallel)."""
    arch = network(config["pipeline"]["reid"])
    net = arch.Net()
    template = net.state_dict()
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 7))
    sd = {}
    kinds = {"kernel": [], "scale": [], "bias": []}
    for k, v in template.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[k] = torch.zeros((), dtype=torch.long, device=device)
        elif leaf == "weight" and v.dim() > 1:
            kinds["kernel"].append(k)
        elif leaf == "weight":
            kinds["scale"].append(k)
        elif leaf in ("running_mean", "running_var"):
            sd[k] = torch.zeros(v.shape, device=device)   # measured below
        else:
            kinds["bias"].append(k)
    for kind, keys in kinds.items():
        sizes = [template[k].numel() for k in keys]
        if kind == "scale":
            flat = 0.8 + 0.4 * torch.rand(sum(sizes), device=device,
                                          generator=g)
        else:
            flat = torch.randn(sum(sizes), device=device, generator=g)
        for k, t in zip(keys, flat.split(sizes)):
            if kind == "kernel":
                t = t / math.sqrt(template[k][0].numel())
            elif kind == "bias":
                t = 0.05 * t
            sd[k] = t.view(template[k].shape)
    net.load_state_dict(sd)
    net = net.to(device)
    rng = np.random.default_rng(sub_seed(seed, 8))
    h, w = frame_u8.shape[:2]
    bw = w * rng.uniform(30 / 1920, 90 / 1920,
                         config["weights"]["reid_calib_boxes"])
    x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bw / 0.41)
    boxes = torch.tensor(np.stack([x, y, x + bw, y + bw / 0.41], 1),
                         dtype=torch.float32, device=device)
    frame = torch.from_numpy(np.ascontiguousarray(frame_u8)).to(device)
    norms = [m for m in net.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None                 # a plain average over the pass
    with torch.no_grad():
        net.train()(crops(frame, boxes, arch.CROP_HW))
    return {k: v.detach().clone() for k, v in net.state_dict().items()}
