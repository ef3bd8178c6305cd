"""Ranks and the collectives of data parallelism (port of
yolov7_tracker_tpu/parallel/mesh.py).

The JAX package is one controller over a device mesh: a batch sharded on
the mesh's data axis, and XLA derives every cross-device reduction from
the shardings. The port follows PyTorch's idiom instead, one process per
rank over ``torch.distributed``, and makes each reduction explicit (the
BatchNorm statistics, the loss normalisers, the gradient sum, the halos of
a height-sharded frame, the gathers of sharded sequences).

``launch(fn, n, device, *args)`` starts n ranks, each calling ``fn(mesh,
*args)`` with its ``DataMesh``, and returns rank 0's result. The backend:
NCCL when every rank has a card of its own, gloo on the CPU and when ranks
share a card (a correctness check on one card: gloo moves card tensors
through the host). Only collectives that both support on the tensors given
are used: all_reduce, all_gather and broadcast; no point-to-point. They
run at world 1 too, so a one-card run goes through the backend's code.

    python -m yolov7_tracker_tpu_torch.cli.train ... --n_devices 4

launches itself; under ``torchrun --nproc_per_node 4 -m ...`` (WORLD_SIZE
set) every process joins the world torchrun made instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import shutil
import signal
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective waits this long for the other ranks (rank 0 may be
# evaluating or writing a checkpoint meanwhile)
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the world: its size, this rank, this rank's
    device, the process group and its backend."""

    size: int
    rank: int
    device: torch.device
    group: Any
    backend: str


def _devices(n: Optional[int], device) -> List[torch.device]:
    """The n ranks' devices. ``device``: "cpu", "cuda" (one card a rank:
    raises for more ranks than cards) or a list of n devices, in which one
    card may repeat. n None or 0: every visible card, one rank on the
    CPU."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if n and n != len(devs):
            raise ValueError(f"{n} ranks but {len(devs)} devices")
        return devs
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [dev] * (n or 1)
    cards = torch.cuda.device_count()
    n = n or cards
    if n > cards or cards == 0:
        raise RuntimeError(
            f"{n} card ranks asked for, {cards} cards visible; NCCL needs "
            "one card a rank (pass device='cpu' for CPU ranks)")
    return [torch.device("cuda", i) for i in range(n)]


def _backend(devs: Sequence[torch.device]) -> str:
    cards = [d for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and len({d.index for d in cards}) == len(devs):
        return "nccl"
    return "gloo"


def _join(rank: int, devs: Sequence[torch.device], init_method: str,
          timeout: datetime.timedelta) -> DataMesh:
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = _backend(devs)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=len(devs), rank=rank, timeout=timeout)
    return DataMesh(len(devs), rank, dev, dist.group.WORLD, backend)


def data_mesh(n_devices: Optional[int] = None, devices=None,
              timeout: datetime.timedelta = TIMEOUT) -> DataMesh:
    """This process's mesh. Inside a world that a launcher made (torchrun:
    WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR set), it joins that world;
    otherwise it makes a one-rank world, which ``n_devices`` above 1
    cannot be (use ``launch``). n_devices None or 0: every visible card
    (one rank on the CPU), as JAX's ``--n_devices 0``. ``devices``: "cpu",
    "cuda" or, outside torchrun, an explicit list (a card may repeat:
    gloo); under torchrun a card rank takes the card of its LOCAL_RANK."""
    if "WORLD_SIZE" in os.environ:
        n, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if n_devices and n_devices != n:
            raise ValueError(f"n_devices={n_devices} in a world of {n}")
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda" if devices is None else devices)
        if dev.type == "cuda":
            # one card a local rank, as NCCL needs
            dev = _devices(local + 1, "cuda")[local]
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method="env://", world_size=n, rank=rank,
                timeout=timeout)
        return DataMesh(n, rank, dev, dist.group.WORLD, dist.get_backend())
    devs = _devices(n_devices, devices)
    if len(devs) > 1:
        raise ValueError(
            f"data_mesh({len(devs)}) outside a launched world: start the "
            "ranks with parallel.mesh.launch or torchrun")
    if dist.is_initialized():
        return DataMesh(dist.get_world_size(), dist.get_rank(), devs[0],
                        dist.group.WORLD, dist.get_backend())
    root = tempfile.mkdtemp(prefix="mesh-")
    return _join(0, devs, f"file://{os.path.join(root, 'rendezvous')}",
                 timeout)


def _rank_main(rank, fn, devs, init_method, timeout, args, result_path):
    if devs[rank].type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(1)
    mesh = _join(rank, devs, init_method, timeout)
    try:
        out = fn(mesh, *args)
        if rank == 0 and result_path:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device, *args,
           timeout: datetime.timedelta = TIMEOUT):
    """Run ``fn(mesh, *args)`` on n ranks and return rank 0's result.
    ``fn`` must be importable (a module-level function: spawned ranks
    unpickle it); its result must be what ``torch.save`` writes.

    ``device``: "cpu", "cuda" (one card a rank, NCCL; raises for more
    ranks than visible cards) or a list of n devices (a card may repeat:
    gloo). Under torchrun (WORLD_SIZE set), this process is one rank of
    the world torchrun made and runs ``fn`` once. Otherwise n = 1 runs in
    this process, in a one-rank world; n > 1 spawns n processes (start
    method spawn: CUDA does not survive a fork) that meet through a file
    in a fresh temporary directory, so that concurrent launches never
    share a port. Every collective gives up after ``timeout``, so a rank
    that fails or hangs in a collective fails the launch."""
    if "WORLD_SIZE" in os.environ:
        return fn(data_mesh(n, device, timeout), *args)
    devs = _devices(n, device)
    root = tempfile.mkdtemp(prefix="mesh-")
    try:
        init = f"file://{os.path.join(root, 'rendezvous')}"
        result = os.path.join(root, "result.pt")
        if len(devs) == 1:
            mesh = _join(0, devs, init, timeout)
            try:
                return fn(mesh, *args)
            finally:
                dist.destroy_process_group()
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, devs, init, timeout, args, result),
            nprocs=len(devs), join=False, start_method="spawn")
        with _passing_signals(ctx.processes):
            while not ctx.join():
                pass
        return torch.load(result, weights_only=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def _passing_signals(processes):
    """SIGTERM / SIGINT sent to the launching process go on to the ranks
    (the training CLI checkpoints on them), where it has a main thread."""
    def pass_on(signum, frame):
        for p in processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, pass_on)
        except ValueError:      # not the main thread
            pass
    try:
        yield
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)


def _block(mesh: DataMesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide over "
                         f"{mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def _map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(mesh: DataMesh, tree, axis: int = 0):
    """This rank's contiguous block of ``axis`` of every array in ``tree``
    (tensors or numpy arrays), the layout of JAX's P("data"): rank r holds
    items [r * B / n, (r + 1) * B / n). Raises when B does not divide by
    the world size."""
    def take(x):
        idx = [slice(None)] * x.ndim
        idx[axis] = _block(mesh, x.shape[axis])
        return x[tuple(idx)]

    return _map(take, tree)


def _buckets(tensors):
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


def _flat_collective(tensors, op):
    """``op`` on one flat buffer a dtype, copied back into ``tensors``."""
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        k = 0
        for t in bucket:
            t.copy_(flat[k:k + t.numel()].view_as(t))
            k += t.numel()


def all_reduce_(mesh: DataMesh, tensors) -> None:
    """Sum each tensor over the ranks, in place (one all_reduce a
    dtype)."""
    _flat_collective(tensors, lambda f: dist.all_reduce(f, group=mesh.group))


def replicate(mesh: DataMesh, module_or_tensors):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, or a list of tensors. Returns its argument."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(),
                   *module_or_tensors.buffers()]
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        _flat_collective(tensors, lambda f: dist.broadcast(
            f, 0, group=mesh.group))
    return module_or_tensors


def any_rank(mesh: DataMesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (all_reduce MAX)."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def gather_tensor(mesh: DataMesh, x: torch.Tensor, axis: int = 0,
                  sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order
    (all_gather). ``sizes``: each rank's extent along ``axis`` when they
    differ (the others' are padded to the largest for the collective)."""
    sizes = list(sizes) if sizes is not None else [x.shape[axis]] * mesh.size
    top = max(sizes)
    pad = x
    if x.shape[axis] < top:
        shape = list(x.shape)
        shape[axis] = top - x.shape[axis]
        pad = torch.cat([x, x.new_zeros(shape)], dim=axis)
    # bool travels as uint8: not every backend reduces or gathers bool
    wire = (pad.to(torch.uint8) if pad.dtype == torch.bool
            else pad).contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    parts = [p.narrow(axis, 0, s) for p, s in zip(parts, sizes)]
    out = torch.cat(parts, dim=axis)
    return out.bool() if x.dtype == torch.bool else out


def gather(mesh: DataMesh, tree, axis: int = 0):
    """``gather_tensor`` on every tensor of ``tree`` (a tensor, a
    NamedTuple, list or dict of them)."""
    return _map(lambda x: gather_tensor(mesh, x, axis), tree)
