"""The detector's training step, on one card or data-parallel over the
ranks of a ``parallel.mesh.DataMesh`` (port of
yolov7_tracker_tpu/parallel/train_step.py).

Optimizer parity with the reference (train.py:115-196): SGD with Nesterov
momentum in three groups named by the Flax leaf each parameter maps to
(models/from_jax.flax_leaf_name): conv ``kernel``s with the weight decay
scaled to the nominal batch 64, every ``bias`` warming up from
warmup_bias_lr, and the rest (BN scales, implicit vectors) decay-free;
one-cycle cosine LR and the momentum warmup, evaluated at the
integrated-batch counter ni on every step as the JAX step does, in
float32. ``torch.optim.SGD(nesterov=True)`` computes JAX's update (buf =
m * buf + g, d = g + m * buf, p -= lr * d) once its lr and momentum are
set before each step and its momentum buffers exist from the start.

The loss is a per-batch SUM (loss * batch), so gradients summed over
micro-batches equal one big batch's: accumulation to the nominal batch
lets ``p.grad`` accumulate and steps when ni % accumulate == 0 with the
warmup-interpolated accumulate (train.py:341-345, 369-374). ni lives on
the host, so deciding needs no sync. EMA (ModelEMA) averages the
parameters over optimizer updates; the BatchNorm statistics are not
averaged and follow Flax's update (models/blocks.BatchNorm2d).

bfloat16 compute is ``torch.autocast`` with float32 masters and the loss
on float32 preds; ``remat=True`` recomputes the forward in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).

Data parallelism keeps the JAX step's global semantics, which its
single-controller view gets for free and torch DDP would change: each rank
holds a contiguous block of the global batch (mesh.shard_batch), the
BatchNorm statistics are the global batch's (blocks.batch_stats_sink with
the mesh's group), the loss normalisers are global (train/loss.py
``group=``), so each rank's loss is its share of JAX's and one
all_reduce(SUM) of the gradients, not an average, gives JAX's gradient;
the update is then the same on every rank, and the replicas stay bit for
bit equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..models import blocks
from ..models.from_jax import (flax_leaf_name, jax_params_to_torch,
                               jax_variables_to_torch)
from ..models.spec import ModelSpec
from ..models.yolo import YoloV7, random_state_dict
from ..train.loss import (Hyp, compute_loss, compute_loss_aux_ota,
                          compute_loss_ota)
from .mesh import all_reduce_, replicate

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr0: float = 0.01
    lrf: float = 0.1            # final OneCycle fraction (hyp['lrf'])
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    epochs: int = 300
    steps_per_epoch: int = 100
    nominal_batch: int = 64
    batch_size: int = 16
    ema_decay: float = 0.9999


def _warmup_steps(cfg: OptConfig) -> float:
    # nw = max(3 epochs' worth of batches, 1000) (train.py:298)
    return max(cfg.warmup_epochs * cfg.steps_per_epoch, 1000.0)


def _warm(cfg: OptConfig, step: int):
    return F32(np.clip(F32(step) / F32(_warmup_steps(cfg)), F32(0), F32(1)))


def one_cycle_lf(cfg: OptConfig, step: int):
    """lf(x) = (1 + cos(x * pi / epochs)) / 2 * (1 - lrf) + lrf
    (train.py:190-196) at x = step / steps_per_epoch, in float32."""
    x = F32(step) / F32(cfg.steps_per_epoch)
    c = np.cos(F32(x * F32(math.pi)) / F32(cfg.epochs))
    return F32(F32(F32(F32(1) + c) / F32(2)) * F32(1 - cfg.lrf)
               + F32(cfg.lrf))


def one_cycle_lr(cfg: OptConfig, step: int, warmup_from: float = 0.0):
    """A group's LR at ni = step: linear from ``warmup_from`` (0, or
    warmup_bias_lr for the bias group) to lr0 * lf over the nw warmup
    steps, then one-cycle cosine (train.py:341-350)."""
    target = F32(F32(cfg.lr0) * one_cycle_lf(cfg, step))
    warm = _warm(cfg, step)
    return float(F32(F32(warmup_from) * F32(F32(1) - warm)
                     + F32(target * warm)))


def momentum_schedule(cfg: OptConfig, step: int):
    """warmup_momentum -> momentum over the nw warmup steps
    (train.py:349-350)."""
    warm = _warm(cfg, step)
    return float(F32(F32(cfg.warmup_momentum) * F32(F32(1) - warm)
                     + F32(F32(cfg.momentum) * warm)))


def accumulate_schedule(cfg: OptConfig, ni: int) -> float:
    """accumulate(ni) = max(round(1 + (nbs / bs - 1) * clip(ni / nw, 0,
    1)), 1) (train.py:110-111, 341-345), float32 with round-half-even as
    ``jnp.round``."""
    ratio = max(cfg.nominal_batch / cfg.batch_size, 1.0)
    interp = F32(F32(1) + F32(F32(ratio - 1.0) * _warm(cfg, ni)))
    return float(max(np.round(interp), F32(1)))


def accumulating(cfg: OptConfig) -> bool:
    return round(cfg.nominal_batch / cfg.batch_size) > 1


def weight_decay(cfg: OptConfig) -> float:
    # wd *= batch * accumulate / nbs, as the reference scales it
    return cfg.weight_decay * cfg.batch_size * max(
        round(cfg.nominal_batch / cfg.batch_size), 1) / cfg.nominal_batch


def ema_decay(cfg: OptConfig, n_updates: int) -> float:
    """d = decay * (1 - exp(-n / 2000)) over optimizer updates
    (ModelEMA, utils/torch_utils.py:269-303), in float32."""
    return float(F32(F32(cfg.ema_decay) * F32(
        F32(1) - np.exp(F32(-F32(n_updates)) / F32(2000)))))


def make_optimizer(model: YoloV7, cfg: OptConfig) -> torch.optim.SGD:
    """SGD + Nesterov in the reference's groups (train.py:115-196):
    'kernel' (weight decay), 'bias' (warms up from warmup_bias_lr) and
    'rest' (BN scales, implicit vectors). Momentum buffers start at
    zero, so the first update is JAX's too."""
    groups = {"kernel": [], "bias": [], "rest": []}
    for name, p in model.named_parameters():
        leaf = flax_leaf_name(name, p)
        groups[leaf if leaf in ("kernel", "bias") else "rest"].append(p)
    opt = torch.optim.SGD(
        [{"params": groups["kernel"], "name": "kernel",
          "weight_decay": weight_decay(cfg)},
         {"params": groups["bias"], "name": "bias", "weight_decay": 0.0},
         {"params": groups["rest"], "name": "rest", "weight_decay": 0.0}],
        lr=cfg.lr0, momentum=cfg.momentum, nesterov=True)
    for p in model.parameters():
        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    return opt


def set_schedule(opt: torch.optim.SGD, cfg: OptConfig, ni: int) -> None:
    """Each group's lr and the momentum at ni."""
    m = momentum_schedule(cfg, ni)
    for group in opt.param_groups:
        group["momentum"] = m
        group["lr"] = one_cycle_lr(
            cfg, ni, cfg.warmup_bias_lr if group["name"] == "bias" else 0.0)


@dataclasses.dataclass
class TrainState:
    """The model (float32 parameters and BN statistics), its optimizer
    (momentum buffers), the EMA of the parameters by name, ``step`` (ni,
    batches seen), ``ema_count`` (optimizer updates) and, when
    accumulating, the pending gradient sum in each parameter's ``.grad``."""

    model: YoloV7
    optimizer: torch.optim.SGD
    ema: Dict[str, torch.Tensor]
    step: int = 0
    ema_count: int = 0
    accumulate: bool = False

    def momentum(self) -> Dict[str, torch.Tensor]:
        return {n: self.optimizer.state[p]["momentum_buffer"]
                for n, p in self.model.named_parameters()}

    def grad_acc(self) -> Optional[Dict[str, torch.Tensor]]:
        if not self.accumulate:
            return None
        return {n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in self.model.named_parameters()}

    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters with the live BN statistics: what is scored
        and saved as best / last (cli/train.py:411-447)."""
        sd = dict(self.model.state_dict())
        sd.update(self.ema)
        return sd

    def state_dict(self) -> dict:
        acc = self.grad_acc()
        return {"model": self.model.state_dict(), "ema": dict(self.ema),
                "momentum": self.momentum(),
                "grad_acc": acc, "step": int(self.step),
                "ema_count": int(self.ema_count)}

    def load_state_dict(self, sd: Mapping) -> None:
        with torch.no_grad():
            self.model.load_state_dict(sd["model"])
            for name, p in self.model.named_parameters():
                self.ema[name].copy_(sd["ema"][name])
                self.optimizer.state[p]["momentum_buffer"].copy_(
                    sd["momentum"][name])
                if self.accumulate:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    p.grad.copy_(sd["grad_acc"][name])
        self.step = int(sd["step"])
        self.ema_count = int(sd["ema_count"])


def make_train_state(spec: ModelSpec, opt_cfg: OptConfig = OptConfig(),
                     seed: int = 0, device=None,
                     state_dict: Optional[Mapping] = None,
                     mesh=None) -> TrainState:
    """A fresh state on ``device`` (default: the card; the mesh's device
    under a mesh): seeded random weights with the head-bias prior
    (models/yolo.random_state_dict, as JAX's build_model calls its
    init_head_biases), or ``state_dict``. Under a ``mesh`` the parameters
    and buffers are rank 0's on every rank."""
    from .. import resolve_device

    dev = resolve_device(mesh.device if mesh is not None else device)
    if spec.head_kind == "DetectV8":
        raise NotImplementedError(
            "DetectV8 has no training loss in the JAX package (its "
            "train_step sends every non-aux head to the anchor loss)")
    if spec.head_kind == "IBin":
        raise NotImplementedError(
            "IBin trains only through train.loss.compute_loss_bin_ota: the "
            "JAX package's train_step sends every non-aux head to the "
            "anchor loss, which reads IBin's bin logits as objectness and "
            "class (it raises for nc > 1 and trains the wrong channels at "
            "nc = 1)")
    model = YoloV7(spec, fused=False)
    model.load_state_dict(state_dict if state_dict is not None
                          else random_state_dict(spec, seed=seed))
    model = model.to(dev).train()
    if mesh is not None:
        replicate(mesh, model)
    acc = accumulating(opt_cfg)
    if acc:
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
    return TrainState(
        model=model, optimizer=make_optimizer(model, opt_cfg),
        ema={n: p.detach().clone() for n, p in model.named_parameters()},
        accumulate=acc)


def train_state_from_jax(state_np, spec: ModelSpec,
                         opt_cfg: OptConfig = OptConfig(),
                         device=None) -> TrainState:
    """The JAX TrainState with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as the port's: parameters and BN statistics through
    models/from_jax, and the EMA, momentum buffers and gradient sum
    through the same renaming, on ``device`` (None: the card; raises
    without one)."""
    from .. import resolve_device

    device = resolve_device(device)
    sd = jax_variables_to_torch({"params": state_np.params,
                                 "batch_stats": state_np.batch_stats}, spec)
    state = make_train_state(spec, opt_cfg, device=device, state_dict=sd)
    acc = (jax_params_to_torch(state_np.grad_acc)
           if state_np.grad_acc is not None else None)
    state.load_state_dict({
        "model": sd, "ema": jax_params_to_torch(state_np.ema_params),
        "momentum": jax_params_to_torch(state_np.opt_state),
        "grad_acc": acc, "step": int(state_np.step),
        "ema_count": int(state_np.ema_count)})
    return state


def _apply_update(state: TrainState, cfg: OptConfig) -> None:
    """Optimizer step at ni, then the EMA (the ni % accumulate == 0 branch,
    train.py:369-374)."""
    set_schedule(state.optimizer, cfg, state.step)
    state.optimizer.step()
    state.ema_count += 1
    d = ema_decay(cfg, state.ema_count)
    params = [p.detach() for p in state.model.parameters()]
    ema = [state.ema[n] for n, _ in state.model.named_parameters()]
    with torch.no_grad():
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, params, alpha=float(F32(F32(1) - F32(d))))
    # the pending sum restarts at zero (JAX keeps a zeros tree)
    state.optimizer.zero_grad(set_to_none=not state.accumulate)


def _reduce_grads(state: TrainState, loss, mesh) -> None:
    """Backward of this rank's loss, then one all_reduce(SUM) of the
    gradients a dtype (flattened), added to the pending sum when
    accumulating (JAX: acc + grads) or set as the gradients."""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    all_reduce_(mesh, grads)
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = g
        else:
            p.grad.add_(g)


def make_train_step(spec: ModelSpec, img_size: int = 640, hyp: Hyp = Hyp(),
                    opt_cfg: OptConfig = OptConfig(),
                    compute_dtype: str = "float32", remat: bool = False,
                    mesh=None):
    """(state, imgs (B, H, W, 3) in [0, 1], targets (B, T, 5), tmask
    (B, T)) -> metrics {box, obj, cls, loss} (device tensors); updates
    ``state`` in place. IAuxDetect models train with the aux loss (the
    reference's train_aux.py path), others with SimOTA or, at hyp
    loss_ota = 0, the plain loss. Under a ``mesh`` the arguments are this
    rank's shard of the global batch, and the metrics are the global
    batch's (see the module docstring)."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}")
    if spec.head_kind == "IAuxDetect":
        loss_fn, n_heads = compute_loss_aux_ota, 2 * spec.nl
    else:
        loss_fn = compute_loss_ota if hyp.loss_ota else compute_loss
        n_heads = spec.nl
    acc = accumulating(opt_cfg)
    group = mesh.group if mesh is not None else None

    def step(state: TrainState, imgs, targets, tmask):
        model = state.model
        sink = []

        def forward(x):
            with blocks.batch_stats_sink(sink, group):
                return tuple(model(x, training=True)[:n_heads])

        dev = imgs.device
        amp = (torch.autocast(dev.type, dtype=torch.bfloat16)
               if compute_dtype == "bfloat16" else contextlib.nullcontext())
        with amp:
            if remat:
                preds = torch.utils.checkpoint.checkpoint(
                    forward, imgs, use_reentrant=False)
            else:
                preds = forward(imgs)
        # the recomputation of remat appends to ``sink`` again later; the
        # update reads this forward's statistics only
        blocks.update_running_stats(list(sink))
        loss, metrics = loss_fn([p.float() for p in preds], targets, tmask,
                                spec, img_size, hyp, group=group)
        if mesh is None:
            loss.backward()
        else:
            _reduce_grads(state, loss, mesh)
        ni = state.step
        if not acc or F32(ni) % F32(accumulate_schedule(opt_cfg, ni)) == 0:
            _apply_update(state, opt_cfg)
        state.step = ni + 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
