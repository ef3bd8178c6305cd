"""Rank bodies of the parallel tests (tests/test_torch_parallel*.py): each
runs on every rank that ``parallel.mesh.launch`` starts, reads its inputs
from a file the test wrote (numpy and torch only), and returns what the
test compares, gathered in rank order. Imports no JAX: spawned ranks
import this module, and each reports the JAX modules it holds."""

import contextlib
import sys

import numpy as np
import torch

from yolov7_tracker_tpu_torch.models import blocks
from yolov7_tracker_tpu_torch.parallel import mesh as M

JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "yolov7_tracker_tpu")


def jax_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)


def det_streams(n_seq, n_frames, d=16, seed=0):
    """(tlbr, score, cls, valid, feature, warp) numpy arrays (n_frames,
    n_seq, d, ...) of seeded streams: constant-velocity boxes with
    occlusions, low-score frames and false positives."""
    rng = np.random.default_rng(seed)
    shape = (n_frames, n_seq, d)
    tlbr = np.zeros(shape + (4,), np.float32)
    score = np.zeros(shape, np.float32)
    valid = np.zeros(shape, bool)
    for s in range(n_seq):
        n_obj = int(rng.integers(5, 9))
        pos = rng.uniform(50, 500, (n_obj, 2))
        vel = rng.uniform(-5, 5, (n_obj, 2))
        wh = rng.uniform(25, 70, (n_obj, 2))
        for t in range(n_frames):
            rows, scores = [], []
            for i in range(n_obj):
                if i % 3 == 0 and 4 <= t < 7:
                    continue                        # occluded
                xy = pos[i] + vel[i] * t + rng.normal(0, 1.0, 2)
                rows.append(np.r_[xy, xy + wh[i]])
                scores.append(rng.uniform(0.7, 0.95) if rng.random() > 0.2
                              else rng.uniform(0.25, 0.45))
            for _ in range(int(rng.integers(0, 3))):  # false positives
                xy = rng.uniform(0, 600, 2)
                rows.append(np.r_[xy, xy + rng.uniform(20, 60, 2)])
                scores.append(rng.uniform(0.2, 0.8))
            order = rng.permutation(len(rows))[:d]
            k = len(order)
            tlbr[t, s, :k] = np.asarray(rows, np.float32)[order]
            score[t, s, :k] = np.asarray(scores, np.float32)[order]
            valid[t, s, :k] = True
    warp = np.broadcast_to(np.eye(2, 3, dtype=np.float32),
                           shape[:2] + (2, 3)).copy()
    return (tlbr, score, np.zeros(shape, np.float32), valid,
            np.zeros(shape + (0,), np.float32), warp)


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN and matmuls (the card's comparisons are in
    float32), restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _bn(mesh, case):
    """One training-mode BatchNorm2d on this rank's block of the global
    batch, the sink's Flax update at momentum 0 (the running mean becomes
    the batch mean) and a weighted sum's backward."""
    dev = mesh.device
    x, w = torch.as_tensor(case["x"], device=dev), torch.as_tensor(
        case["w"], device=dev)
    m = blocks.BatchNorm2d(x.shape[1]).to(dev).train()
    with torch.no_grad():
        m.weight.copy_(torch.as_tensor(case["scale"]))
        m.bias.copy_(torch.as_tensor(case["bias"]))
    xs = M.shard_batch(mesh, x).clone().requires_grad_(True)
    sink = []
    with blocks.batch_stats_sink(sink, mesh.group):
        y = m(xs)
    blocks.update_running_stats(sink, momentum=0.0)
    (y * M.shard_batch(mesh, w)).sum().backward()
    grads = [m.weight.grad.clone(), m.bias.grad.clone()]
    M.all_reduce_(mesh, grads)
    return {"mean": m.running_mean, "var": m.running_var,
            "y": M.gather_tensor(mesh, y.detach()),
            "x_grad": M.gather_tensor(mesh, xs.grad),
            "scale_grad": grads[0], "bias_grad": grads[1]}


def _track(mesh, case):
    """The sharded tracker over the case's streams, and each rank's
    launches of K3 and K4 (none on the CPU, where the plain versions
    run)."""
    from yolov7_tracker_tpu_torch.parallel.tracking import (
        make_sharded_tracker, stack_slabs)
    from yolov7_tracker_tpu_torch.trackers import slab as S
    from yolov7_tracker_tpu_torch.trackers.registry import build_tracker
    from yolov7_tracker_tpu_torch.utils import trace

    dev = mesh.device
    step, cfg = build_tracker(S.TrackerConfig(**case["cfg"]), dev)
    dets = S.DetSlab(*(torch.as_tensor(x, device=dev)
                       for x in case["dets"]))
    n = dets.valid.shape[1]
    with trace.recording():
        before = trace.counters()
        slabs, outs = make_sharded_tracker(step, mesh)(
            stack_slabs(cfg, n, dev), dets)
        after = trace.counters()
    launches = torch.tensor([after.get(k, 0) - before.get(k, 0)
                             for k in ("launches.k3", "launches.k4")],
                            device=dev)
    return {"slabs": tuple(slabs), "outs": tuple(outs),
            "launches": M.gather_tensor(mesh, launches[None])}


def _spatial(mesh, case):
    """The height-sharded forward of a yolov7-tiny and the pipeline's
    detect_batch_spatial."""
    from yolov7_tracker_tpu_torch.models import zoo
    from yolov7_tracker_tpu_torch.parallel.spatial import (
        make_spatial_detector)
    from yolov7_tracker_tpu_torch.pipeline import (PipelineConfig,
                                                   TrackingPipeline)
    from yolov7_tracker_tpu_torch.trackers.slab import TrackerConfig

    spec = zoo.get_spec(case["model"], nc=case["nc"])
    pipe = TrackingPipeline(
        PipelineConfig(**case["pipe"]),
        TrackerConfig(capacity=16, det_capacity=16),
        state_dict=case["state_dict"], spec=spec, device=mesh.device)
    raw = make_spatial_detector(pipe.model, mesh)(
        torch.as_tensor(case["imgs"], device=mesh.device))
    det = pipe.detect_batch_spatial(case["frames"], mesh)
    return {"raw": raw, "detect": det}


def suite(mesh, path):
    """Every case in the file at ``path`` ({"bn", "track", "spatial"}:
    inputs), on this rank."""
    cases = torch.load(path, weights_only=False)
    run = {"bn": _bn, "track": _track, "spatial": _spatial}
    with full_float32():
        out = {name: run[name](mesh, case) for name, case in cases.items()}
    out["jax_modules"] = M.gather_tensor(
        mesh, torch.tensor([len(jax_modules())], device=mesh.device))
    out["world"] = (mesh.size, mesh.backend)
    return out


def train_steps(mesh, path, out_dir):
    """Train steps of the port's data-parallel step from the converted
    JAX state in the file at ``path`` ({"spec_cfg", "opt", "hyp", "img",
    "runs": [(state_dict, [batches])]}), each rank on its block of every
    batch. Every rank writes its states and metrics after each step to
    ``out_dir/rank{r}.pt``."""
    case = torch.load(path, weights_only=False)
    with full_float32():
        _train_steps(mesh, case, out_dir)


def _train_steps(mesh, case, out_dir):
    from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg
    from yolov7_tracker_tpu_torch.parallel import train_step as ts
    from yolov7_tracker_tpu_torch.train.loss import Hyp

    spec = parse_yaml_cfg(case["spec_cfg"], name="aux")
    cfg = ts.OptConfig(**case["opt"])
    step = ts.make_train_step(spec, img_size=case["img"],
                              hyp=Hyp(**case["hyp"]), opt_cfg=cfg,
                              mesh=mesh)
    runs = []
    for sd, batches in case["runs"]:
        state = ts.make_train_state(spec, cfg, mesh=mesh,
                                    state_dict=sd["model"])
        state.load_state_dict(sd)
        out = []
        for b in batches:
            metrics = step(state, *M.shard_batch(
                mesh, tuple(torch.as_tensor(x, device=mesh.device)
                            for x in b)))
            snap = {k: ({n: t.cpu().clone() for n, t in v.items()}
                        if isinstance(v, dict) else v)
                    for k, v in state.state_dict().items()}
            out.append((snap, {k: float(v) for k, v in metrics.items()}))
        runs.append(out)
    torch.save({"runs": runs, "jax_modules": jax_modules()},
               f"{out_dir}/rank{mesh.rank}.pt")
