"""Detector training CLI on the PyTorch port (port of
yolov7_tracker_tpu/cli/train.py; the reference train.py / train_aux.py
surface).

SGD + Nesterov with one-cycle LR and grouped weight decay,
gradient accumulation to the nominal batch 64, EMA, bfloat16 autocast
with float32 masters (parallel/train_step.py); torch checkpoints
(``step_N/`` train states, ``best.pt`` / ``last.pt`` EMA weights); the
per-epoch mAP eval of cli/test.py; preemption-safe: SIGTERM / SIGINT (or
--preempt_after) checkpoints mid-epoch, writes preempted.json and exits
75 for a supervisor to relaunch with ``--resume auto``.

    python -m yolov7_tracker_tpu_torch.cli.train --model yolov7-tiny \
        --data ./data/visdrone_all.yaml --hyp ./data/hyp.scratch.tiny.yaml \
        --img 640 --batch 16 --epochs 30 [--device cpu]

The image-file data pipeline and its augmentations are OpenCV on the
host (train/datasets.py). ``train_loop`` is the loop itself, for any
dataset object with ``batches``, ``labels`` and ``len``.

``--n_devices N`` trains data-parallel on N ranks (0: every visible card;
one rank on the CPU), JAX's mesh with its global semantics
(parallel/train_step.py): ``--batch`` is the global batch, every rank
builds the same seeded batches and keeps its contiguous block of each
(parallel/mesh.shard_batch), and rank 0 alone writes the run dir, the
checkpoints, the artifact store and preempted.json, and runs the
evaluation. The CLI starts the ranks itself (NCCL, one card a rank; gloo
with ``--device cpu``) or joins the world of ``torchrun --nproc_per_node
N -m yolov7_tracker_tpu_torch.cli.train ... --n_devices N``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import yaml


def parse_args(argv=None):
    p = argparse.ArgumentParser("torch yolov7 train")
    p.add_argument("--model", type=str, default="yolov7-tiny")
    p.add_argument("--data", type=str, required=True,
                   help="dataset yaml: {train: <imgdir|txt>, val: ..., nc}")
    p.add_argument("--hyp", type=str, default="")
    p.add_argument("--img", type=int, default=640)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--max_labels", type=int, default=128)
    p.add_argument("--ckpt_dir", type=str, default="./runs/train")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint path, artifact:<name>:<alias> to "
                        "resume from the local artifact store, or "
                        "'auto' to pick the newest checkpoint under "
                        "--ckpt_dir (the utils/aws/resume.py analogue: "
                        "relaunch-after-preemption needs no run-specific "
                        "path)")
    p.add_argument("--preempt_after", type=int, default=0,
                   help="fault injection: simulate a preemption signal "
                        "after N optimizer steps (tests the SIGTERM "
                        "checkpoint-and-exit path deterministically)")
    p.add_argument("--artifacts", type=str, default="",
                   help="artifact-store root; enables dataset/checkpoint"
                        " artifact logging with lineage (local wandb "
                        "analogue, utils/artifacts.py)")
    p.add_argument("--run_name", type=str, default="",
                   help="artifact name prefix (default: model name)")
    p.add_argument("--eval_every", type=int, default=1,
                   help="epochs between val mAP evals; 0 disables")
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel ranks; 0 = every visible card (one "
                        "rank on the CPU)")
    p.add_argument("--image_weights", action="store_true",
                   help="per-epoch weighted image sampling by class "
                        "rarity x (1 - per-class mAP)^2 (train.py:312)")
    p.add_argument("--quad", action="store_true",
                   help="quad collate: 4 items -> one 2x-size sample "
                        "(utils/datasets.py collate_fn4)")
    p.add_argument("--multi_scale", action="store_true",
                   help="random train scale per batch from the JAX CLI's "
                        "fixed set of stride-rounded scales (0.7x..1.3x; "
                        "train.py:352-358)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; refuses to run without a GPU) or "
                        "cpu")
    return p.parse_args(argv)


def _find_latest_ckpt(ckpt_dir: str, fingerprint=None):
    """Newest step_* train-state dir under any run dir in ckpt_dir — the
    `--resume auto` target after a preemption/restart.

    ``fingerprint`` (dict of model/img/nc) filters to compatible
    checkpoints: a shared ckpt_dir may hold runs of other models, and
    auto-resuming an incompatible one under a relaunch-supervisor loop
    would crash-loop forever on the state_dict mismatch."""
    from ..utils.checkpoint import PARTIAL

    newest, newest_mtime = None, -1.0
    skipped = 0
    for run in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else ():
        run_path = os.path.join(ckpt_dir, run)
        if not os.path.isdir(run_path):
            continue
        for d in os.listdir(run_path):
            # a hard kill (SIGKILL/OOM) mid-save leaves the temporary
            # sibling behind (step_N.partial-<pid>, or orbax's
            # step_N.orbax-checkpoint-tmp-*); it may lack meta.json, so
            # without this guard it would be picked as the newest
            # "legacy" checkpoint and crash-loop every --resume auto
            if (not d.startswith("step_") or PARTIAL in d
                    or ".orbax-checkpoint-tmp" in d):
                continue
            path = os.path.join(run_path, d)
            if fingerprint:
                meta_path = os.path.join(path, "meta.json")
                meta = {}
                if os.path.isfile(meta_path):
                    with open(meta_path) as f:
                        meta = json.load(f)
                if any(k in meta and meta[k] != v
                       for k, v in fingerprint.items()):
                    skipped += 1
                    continue
            m = os.path.getmtime(path)
            if m > newest_mtime:
                newest, newest_mtime = path, m
    if skipped:
        print(f"--resume auto: skipped {skipped} checkpoint(s) from "
              "other model/img/nc configs")
    return newest


def main(argv=None):
    opts = parse_args(argv)
    from .. import resolve_device

    import torch

    dev = resolve_device(opts.device)
    if "WORLD_SIZE" in os.environ:      # a rank of torchrun's world
        n = opts.n_devices or int(os.environ["WORLD_SIZE"])
    else:
        n = opts.n_devices or (torch.cuda.device_count()
                               if dev.type == "cuda" else 1)
    with open(opts.data) as f:
        data_cfg = yaml.safe_load(f)
    if n > 1 or "WORLD_SIZE" in os.environ:
        from ..parallel.mesh import launch

        return launch(_train_rank, n, dev.type, opts, data_cfg)

    # Preemption safety (failure recovery the reference lacks — its
    # train.py dies on SIGTERM and utils/aws/resume.py restarts it from
    # the last *epoch* checkpoint): on SIGTERM/SIGINT, finish the
    # in-flight optimizer step, checkpoint mid-epoch, write
    # preempted.json, and return cleanly — `--resume auto` then picks
    # the checkpoint up, restarting the interrupted epoch.
    import signal

    stop = {"requested": False}

    def _on_preempt(signum, frame):
        stop["requested"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _on_preempt)
        except ValueError:  # not in main thread (embedded use)
            pass
    try:
        return _train(opts, data_cfg, stop, None)
    finally:
        # restore on every exit path — a raised SystemExit must not
        # leave the embedding process (pytest, a supervisor) with a
        # hijacked Ctrl-C
        for sig, h in old_handlers.items():
            signal.signal(sig, h)


def load_hyp(path):
    """Split a hyp yaml (data/hyp.scratch.*.yaml) into the kwargs for
    Hyp (loss gains), AugHyp (augmentation probs) and OptConfig
    (optimizer/schedule). Unknown keys are ignored, matching the
    reference's dict-indexed access of only the keys it uses."""
    with open(path) as f:
        h = yaml.safe_load(f)
    hyp_kw = {k: h[k] for k in
              ("box", "cls", "obj", "cls_pw", "obj_pw", "anchor_t",
               "label_smoothing", "loss_ota") if k in h}
    aug_kw = {k: h[k] for k in
              ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate",
               "scale", "shear", "perspective", "fliplr", "flipud",
               "mosaic", "mixup", "paste_in") if k in h}
    opt_kw = {k: h[k] for k in
              ("lr0", "lrf", "momentum", "weight_decay",
               "warmup_epochs", "warmup_momentum", "warmup_bias_lr")
              if k in h}
    return hyp_kw, aug_kw, opt_kw


def _train_rank(mesh, opts, data_cfg):
    """One rank of ``--n_devices N``: the loop on this rank's shards, with
    SIGTERM / SIGINT setting its stop flag (the launcher passes them on),
    and the host's random streams seeded alike on every rank (mixup draws
    from numpy's global one), so that every rank builds the same global
    batches. Returns the run dir (rank 0) or None."""
    import random
    import signal

    stop = {"requested": False}

    def _on_preempt(signum, frame):
        stop["requested"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_preempt)
    random.seed(0)
    np.random.seed(0)
    return _train(opts, data_cfg, stop, mesh)


def _train(opts, data_cfg, stop, mesh):
    from ..train.datasets import AugHyp, YoloDataset
    from ..utils.logging import plot_train_batch

    aug_kw = load_hyp(opts.hyp)[1] if opts.hyp else {}
    dataset = YoloDataset(
        data_cfg["train"], img_size=opts.img, hyp=AugHyp(**aug_kw),
        augment=True, max_labels=opts.max_labels,
    )

    def plot_batch(run_dir, bi, imgs, tgts, masks):
        plot_train_batch(imgs, tgts, masks,
                         os.path.join(run_dir, f"train_batch{bi}.jpg"),
                         names=data_cfg.get("names", ()))

    return train_loop(opts, data_cfg, dataset, stop, plot_batch=plot_batch,
                      mesh=mesh)


def train_loop(opts, data_cfg, dataset, stop, plot_batch=None, mesh=None):
    """The training loop of ``main`` (parsed ``opts``, the dataset yaml as
    a dict) over ``dataset``: an object with ``batches(batch)`` (and
    ``quad_batches`` for --quad, ``resample_by_weights`` for
    --image_weights), ``labels`` and ``len``. ``plot_batch(run_dir, bi,
    imgs, tgts, masks)`` is called on the first three batches of the
    first epoch; the yaml's val path is scored by evaluate_map. Returns
    the run dir. Under a ``mesh`` (parallel/mesh.py) every rank runs it
    on the same dataset and trains on its block of each batch; rank 0
    alone writes and evaluates, and returns the run dir (the others
    None)."""
    import torch

    from .. import resolve_device
    from ..models import zoo
    from ..parallel import mesh as mesh_mod
    from ..parallel import train_step as ts
    from ..train.loss import Hyp
    from ..utils import checkpoint

    dev = resolve_device(opts.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0

    def stopping():
        # every rank stops at the same step
        if mesh is not None:
            stop["requested"] = mesh_mod.any_rank(mesh, stop["requested"])
        return stop["requested"]

    hyp_kw, _, opt_kw = load_hyp(opts.hyp) if opts.hyp else ({}, {}, {})
    steps_per_epoch = max(len(dataset) // opts.batch, 1)
    spec = zoo.get_spec(opts.model, nc=int(data_cfg.get("nc", 80)))
    opt_cfg = ts.OptConfig(
        epochs=opts.epochs, steps_per_epoch=steps_per_epoch,
        batch_size=opts.batch, **opt_kw,
    )
    store = None
    run_name = opts.run_name or opts.model
    if opts.artifacts and lead:
        from ..utils.artifacts import ArtifactStore

        store = ArtifactStore(opts.artifacts)
    if opts.resume.startswith("artifact:") and mesh is not None:
        raise SystemExit("--resume artifact:... needs one rank: resolve "
                         "the artifact and pass its path")

    state = ts.make_train_state(spec, opt_cfg=opt_cfg, device=dev,
                                mesh=mesh)
    # checkpoint identity: stamped into every meta.json and required to
    # match for `--resume auto` candidates
    nc = int(data_cfg.get("nc", 80))
    fingerprint = {"model": opts.model, "img": opts.img, "nc": nc}
    start_epoch = 0
    resume_ref = None
    resume_meta = {}
    if opts.resume == "auto":
        auto = _find_latest_ckpt(opts.ckpt_dir, fingerprint)
        if auto is None:
            print("--resume auto: no checkpoint found, starting fresh")
            opts.resume = ""
        else:
            print(f"--resume auto: {auto}")
            opts.resume = auto
    if opts.resume:
        resume_path = opts.resume
        if opts.resume.startswith("artifact:"):
            if store is None:
                raise SystemExit("--resume artifact:... needs --artifacts")
            # pin the alias to its digest NOW — 'latest' will re-point
            # to the checkpoints this run logs
            resume_ref = store.resolve_ref(opts.resume)
            resume_path = store.resolve(opts.resume)
        state = checkpoint.load_train_state(resume_path, state)
        meta_path = os.path.join(resume_path, "meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                resume_meta = json.load(f)
            start_epoch = int(resume_meta.get("epoch", -1)) + 1

    hyp = Hyp(**hyp_kw)
    step_fns = {}

    def step_for(size: int):
        if size not in step_fns:
            step_fns[size] = ts.make_train_step(
                spec, img_size=size, hyp=hyp, opt_cfg=opt_cfg,
                compute_dtype="bfloat16", mesh=mesh,
            )
        return step_fns[size]

    gs = max(spec.strides)
    if opts.multi_scale:
        scales = sorted({
            max(int(round(opts.img * f / gs)) * gs, gs)
            for f in (0.7, 0.85, 1.0, 1.15, 1.3)
        })
    else:
        scales = [opts.img]
    import random as _random

    scale_rng = _random.Random(0)

    # restore the best fitness seen so far, else a resumed run's first
    # eval re-points the '-best' artifact aliases to a worse model
    # (train.py:414-419 restores best_fitness from the ckpt the same way)
    best_fitness = float(resume_meta.get("best_fitness", 0.0))
    run_dir = os.path.join(opts.ckpt_dir, time.strftime("%Y%m%d_%H%M%S"))
    if not lead:
        run_dir = None
        plot_batch = None
    else:
        os.makedirs(run_dir, exist_ok=True)
    from ..utils.logging import MetricsLogger

    logger = MetricsLogger(run_dir) if lead else None
    data_ref = None
    last_ckpt_ref = resume_ref
    if store is not None:
        # dataset artifact: the data yaml is the run's dataset identity
        # (wandb_utils.py:176-198 logs the dataset as an artifact)
        data_ref = store.log_artifact(
            opts.data, f"{run_name}-data", type="dataset",
            metadata={"nc": int(data_cfg.get("nc", 80)),
                      "n_images": len(dataset)},
        )
        logger.log_event({"artifact": data_ref, "kind": "dataset"})
    if lead:
        print(f"training {opts.model} on {len(dataset)} images, "
              f"{steps_per_epoch} steps/epoch, device={dev}"
              + (f", {mesh.size} ranks ({mesh.backend})" if mesh else ""))

    maps = np.zeros(nc)  # per-class mAPs from the latest eval
    ckpt_path = opts.resume or None
    for epoch in range(start_epoch, opts.epochs):
        if stopping():
            # SIGTERM landed during the previous epoch's eval: the
            # epoch checkpoint is already on disk — exit before paying
            # for another optimizer step
            if not lead:
                return run_dir
            with open(os.path.join(run_dir, "preempted.json"), "w") as f:
                json.dump({"epoch": epoch - 1, "step": int(state.step),
                           "ckpt": ckpt_path}, f)
            print(f"preempted before epoch {epoch}: resuming picks up "
                  f"{ckpt_path}")
            return run_dir
        if opts.image_weights:
            from ..train.datasets import (
                labels_to_class_weights, labels_to_image_weights,
            )

            cw = labels_to_class_weights(dataset.labels, nc)
            cw = cw * (1 - maps) ** 2 / nc
            dataset.resample_by_weights(
                labels_to_image_weights(dataset.labels, nc, cw)
            )
        t0 = time.time()
        losses = []
        batch_iter = (dataset.quad_batches(max(opts.batch // 4, 1))
                      if opts.quad else dataset.batches(opts.batch))
        for bi, (imgs, tgts, masks) in enumerate(batch_iter):
            if epoch == 0 and bi < 3 and plot_batch is not None:
                plot_batch(run_dir, bi, imgs, tgts, masks)
            size = scale_rng.choice(scales) if not opts.quad \
                else imgs.shape[1]
            if size != imgs.shape[1]:
                # labels are normalized; only pixels need resizing
                import cv2

                imgs = np.stack([
                    cv2.resize(im, (size, size),
                               interpolation=cv2.INTER_LINEAR)
                    for im in imgs
                ])
            if mesh is not None:
                imgs, tgts, masks = mesh_mod.shard_batch(
                    mesh, (imgs, tgts, masks))
            # BGR uint8 -> RGB float [0, 1] on the device
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
            x = x.flip(-1).float() / 255.0
            metrics = step_for(size)(state, x,
                                     torch.from_numpy(tgts).to(dev),
                                     torch.from_numpy(masks).to(dev))
            losses.append(metrics)
            if (opts.preempt_after
                    and int(state.step) >= opts.preempt_after):
                stop["requested"] = True  # injected fault
            if stopping():
                # preemption: checkpoint NOW (mid-epoch), mark the epoch
                # interrupted (meta epoch-1 => --resume restarts it),
                # and exit cleanly for the supervisor to relaunch with
                # --resume auto
                if not lead:
                    return run_dir
                ckpt_path = checkpoint.save_train_state(
                    run_dir, state, int(state.step),
                    {"epoch": epoch - 1, "interrupted_epoch": epoch,
                     "best_fitness": best_fitness, "preempted": True,
                     **fingerprint},
                )
                if store is not None:
                    last_ckpt_ref = store.log_artifact(
                        ckpt_path, f"{run_name}-ckpt", type="checkpoint",
                        aliases=("latest",),
                        metadata={"epoch": epoch, "preempted": True,
                                  "step": int(state.step),
                                  "run_dir": run_dir},
                        parents=[r for r in (data_ref, last_ckpt_ref)
                                 if r],
                    )
                with open(os.path.join(run_dir, "preempted.json"),
                          "w") as f:
                    json.dump({"epoch": epoch, "batch": bi,
                               "step": int(state.step),
                               "ckpt": ckpt_path}, f)
                print(f"preempted at epoch {epoch} step {int(state.step)}"
                      f": state saved to {ckpt_path}")
                return run_dir
        m = {k: float(np.mean([float(x[k]) for x in losses]))
             for k in losses[0]}
        if not lead:
            # rank 0 writes and evaluates; the others keep stepping with it
            if stopping():
                return run_dir
            maps = _eval_maps(opts, data_cfg, epoch, mesh, maps)
            continue
        logger.log(int(state.step), m, prefix="train")
        print(
            f"epoch {epoch}: loss {m['loss']:.4f} "
            f"(box {m['box']:.4f} obj {m['obj']:.4f} cls {m['cls']:.4f}) "
            f"{time.time()-t0:.1f}s"
        )
        ckpt_path = checkpoint.save_train_state(
            run_dir, state, int(state.step),
            {"epoch": epoch, "loss": m["loss"],
             "best_fitness": best_fitness, **fingerprint},
        )
        if store is not None:
            parents = [r for r in (data_ref, last_ckpt_ref) if r]
            last_ckpt_ref = store.log_artifact(
                ckpt_path, f"{run_name}-ckpt", type="checkpoint",
                aliases=("latest", f"epoch-{epoch}"),
                metadata={"epoch": epoch, "loss": m["loss"],
                          "step": int(state.step), "run_dir": run_dir},
                parents=parents,
            )
            logger.log_event({"artifact": last_ckpt_ref,
                              "kind": "checkpoint", "epoch": epoch})
        if stopping():
            # SIGTERM landed during the epoch-end phase (after the last
            # batch-loop check): the epoch checkpoint above already
            # covers this state — skip eval and exit within the
            # supervisor's grace window instead of running a minutes-long
            # val pass and training into the next epoch
            with open(os.path.join(run_dir, "preempted.json"), "w") as f:
                json.dump({"epoch": epoch, "step": int(state.step),
                           "ckpt": ckpt_path}, f)
            print(f"preempted at end of epoch {epoch}: state saved to "
                  f"{ckpt_path}")
            return run_dir
        if _evaluating(opts, data_cfg, epoch):
            from ..train.metrics import fitness
            from .test import evaluate_map

            res = evaluate_map(spec, state.ema_variables(), data_cfg["val"],
                               img=opts.img, max_labels=opts.max_labels,
                               device=dev)
            for c, a in res.get("per_class_ap", {}).items():
                if 0 <= int(c) < nc:
                    maps[int(c)] = a
            fit = fitness(res)
            print(f"  val: mAP50 {res['map50']:.4f} mAP {res['map']:.4f}")
            if fit > best_fitness:
                best_fitness = fit
                # this epoch's checkpoint was written pre-eval: refresh
                # its meta so a resume from it keeps the new best
                with open(os.path.join(ckpt_path, "meta.json"), "w") as f:
                    json.dump({"epoch": epoch, "loss": m["loss"],
                               "best_fitness": best_fitness,
                               **fingerprint}, f)
                best_path = checkpoint.save_variables(
                    os.path.join(run_dir, "best.pt"), state.ema_variables())
                if store is not None:
                    store.log_artifact(
                        best_path, f"{run_name}-best", type="model",
                        aliases=("latest", "best"),
                        metadata={"epoch": epoch, "fitness": float(fit),
                                  "map50": float(res["map50"])},
                        parents=[r for r in (last_ckpt_ref,) if r],
                    )
            if mesh is not None:
                maps = _eval_maps(opts, data_cfg, epoch, mesh, maps)
    if lead:
        checkpoint.save_variables(os.path.join(run_dir, "last.pt"),
                                  state.ema_variables())
    return run_dir


def _evaluating(opts, data_cfg, epoch) -> bool:
    return bool(data_cfg.get("val") and opts.eval_every > 0
                and (epoch + 1) % opts.eval_every == 0)


def _eval_maps(opts, data_cfg, epoch, mesh, maps):
    """Rank 0's per-class mAPs of this epoch's evaluation on every rank
    (--image_weights resamples by them), else ``maps``."""
    import torch

    from ..parallel.mesh import replicate

    if not _evaluating(opts, data_cfg, epoch):
        return maps
    t = torch.as_tensor(maps, dtype=torch.float64, device=mesh.device)
    replicate(mesh, [t])
    return t.cpu().numpy()


if __name__ == "__main__":
    run = main()
    # EX_TEMPFAIL signals "relaunch me with --resume auto" to a
    # supervisor loop (the utils/aws/resume.py role):
    #   until python -m yolov7_tracker_tpu_torch.cli.train ... \
    #       --resume auto; do sleep 5; done
    import sys as _sys

    # a rank other than 0 (under torchrun) returns no run dir
    if run and os.path.isfile(os.path.join(run, "preempted.json")):
        _sys.exit(75)
