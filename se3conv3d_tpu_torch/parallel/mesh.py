"""Data-parallel groups (counterpart of ``se3conv3d_tpu/parallel/mesh.py``).

The JAX package's 1-D ``data`` mesh of N devices is one program over N
chips: GSPMD shards the batch axis and inserts the reductions.  Here it is N
ranks, one process per card, in one ``torch.distributed`` group: every rank
holds the whole model and its own share of every global batch
(:mod:`.multihost`), and the sums that the one logical program takes over
the global batch are taken over the group:

* batch-norm statistics (``nn.norm.MaskedBatchNorm``), through
  :func:`rank_sum`, which carries gradients;
* the calibration sums (``nn.conv.calibrate_norms``) and the truncation
  fraction (``PNEConv``), through :func:`group_sum_`;
* the loss's valid count and the gradients (``train.trainer.Trainer``);
* the metric accumulators (:func:`.multihost.cross_host_sum`).

A group is described by :func:`make_group` (its devices and backend: NCCL
on the card, gloo on the CPU; gloo also reduces CUDA tensors, through the
host, which lets two ranks share one card) and started by :func:`launch`,
which spawns one process per rank with ``torch.multiprocessing.spawn``;
each rank joins through a ``FileStore`` in a temporary directory (no
network, no port).  :func:`joined` joins the calling process as one rank
(a group of one, or a rank started by other means).  Every reduction here
runs whenever the process is in a group, a group of one included (where it
is the identity), so a one-rank group drives the same code as N ranks.

The 2-D ``(data, points)`` mesh, which shards the point axis of one scene,
has no counterpart: ``points > 1`` raises ``NotImplementedError``
(ROADMAP.md, Queue 1, "the (data, points) mesh").
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DataGroup", "make_group", "launch", "joined", "in_group", "rank", "world_size",
           "rank_device", "rank_sum", "group_sum_", "barrier", "pad_batch_to_multiple"]

# how long a collective waits for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)
# the card this process's rank runs on (set by joined())
_RANK_DEVICE: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """N ranks for data parallelism: rank ``r`` runs on ``devices[r]``."""

    devices: tuple
    backend: str

    @property
    def size(self) -> int:
        return len(self.devices)


def make_group(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
               backend: Optional[str] = None, points: int = 1) -> DataGroup:
    """A data-parallel group of ``n_devices`` ranks (default: one per card).

    Args:
      n_devices: ranks; at most ``len(devices)``.
      devices: the ranks' devices, in rank order (default: every card,
        ``cuda:0`` ... ``cuda:{count - 1}``); a device may repeat (two ranks
        on one card, or on the CPU).
      backend: ``"nccl"`` or ``"gloo"`` (default: NCCL where every device
        is a card, gloo otherwise).  NCCL takes one rank per card.
      points: the JAX mesh's point axis; only 1 is ported.
    """
    if points > 1:
        raise NotImplementedError(
            f"points={points}: the (data, points) mesh, which shards the point axis of a scene, "
            "is not ported (ROADMAP.md Queue 1, 'the (data, points) mesh')")
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("requested a group of no devices")
    if backend is None:
        backend = "nccl" if all(d.type == "cuda" for d in devs) else "gloo"
    if backend == "nccl" and len({str(d) for d in devs}) < len(devs):
        raise ValueError("NCCL takes one rank per card: pass backend='gloo' to share a card")
    return DataGroup(tuple(devs), backend)


def in_group() -> bool:
    """Whether this process is a rank of a group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank_device() -> Optional[torch.device]:
    """This rank's device, or None outside a group."""
    return _RANK_DEVICE if in_group() else None


@contextlib.contextmanager
def joined(group: DataGroup, rank_index: int = 0, store_path: Optional[str] = None):
    """Join ``group`` as rank ``rank_index`` for the ``with`` block (the
    process group is destroyed at its end).  ``store_path`` is the
    ``FileStore`` file every rank shares (default: a new one in a temporary
    directory, enough for a group of one)."""
    global _RANK_DEVICE
    if in_group():
        raise RuntimeError("this process is already a rank of a group")
    with contextlib.ExitStack() as stack:
        if store_path is None:
            if group.size > 1:
                raise ValueError("the ranks of a group of several share one store_path")
            store_path = os.path.join(stack.enter_context(tempfile.TemporaryDirectory(
                prefix="se3conv_group_")), "store")
        device = group.devices[rank_index]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = dist.FileStore(store_path, group.size)
        dist.init_process_group(group.backend, store=store, rank=rank_index,
                                world_size=group.size, timeout=TIMEOUT)
        _RANK_DEVICE = device
        try:
            yield device
        finally:
            _RANK_DEVICE = None
            dist.destroy_process_group()


def _rank_main(rank_index: int, group: DataGroup, tmp: str, fn: Callable, args: tuple) -> None:
    if group.devices[rank_index].type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // group.size))
    with joined(group, rank_index, os.path.join(tmp, "store")):
        result = fn(rank_index, *args)
    with open(os.path.join(tmp, f"result_{rank_index}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(group: DataGroup, fn: Callable, *args) -> List[Any]:
    """Run ``fn(rank, *args)`` in one new process per rank of ``group``,
    each joined to it; returns the ranks' return values (pickled back), in
    rank order.  ``fn`` must be importable (a module-level function).  A
    rank that fails ends every rank and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="se3conv_group_") as tmp:
        mp.spawn(_rank_main, args=(group, tmp, fn, args), nprocs=group.size, join=True)
        results = []
        for r in range(group.size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


class _RankSum(torch.autograd.Function):
    """``x.sum(dims)`` summed over the ranks, with gradient-free ``extras``
    in the same reduction.  Its gradient is the sum over the ranks of the
    incoming gradients (every rank's loss reads the summed value), spread
    over ``x`` as a sum's is.  One node, where one process has the sum's:
    the backward runs in the same order either way."""

    @staticmethod
    def forward(ctx, x, dims, *extras):
        ctx.dims, ctx.shape = dims, x.shape
        total = x.sum(dims)
        flat = torch.cat([total.reshape(-1)] + [e.reshape(-1).to(total.dtype) for e in extras])
        dist.all_reduce(flat)
        outs, start = [], 0
        for t in (total,) + extras:
            outs.append(flat[start : start + t.numel()].reshape(t.shape).to(t.dtype))
            start += t.numel()
        ctx.mark_non_differentiable(*outs[1:])
        return tuple(outs)

    @staticmethod
    def backward(ctx, grad, *extra_grads):
        grad = grad.clone()
        dist.all_reduce(grad)
        for d in sorted(ctx.dims):
            grad = grad.unsqueeze(d)
        return (grad.expand(ctx.shape), None) + (None,) * len(extra_grads)


def rank_sum(x: torch.Tensor, dims, *extras: torch.Tensor) -> tuple:
    """``(x.sum(dims), *extras)``, each summed over the group's ranks in one
    reduction (``x``'s sum differentiably, ``extras`` without a gradient);
    the local sums outside a group."""
    if in_group():
        return _RankSum.apply(x, tuple(dims), *extras)
    return (x.sum(dims),) + extras


def group_sum_(x: torch.Tensor) -> torch.Tensor:
    """In-place, gradient-free sum of ``x`` over the ranks (no-op outside a
    group); returns ``x``."""
    if in_group():
        dist.all_reduce(x)
    return x


def barrier() -> None:
    if in_group():
        dist.barrier()


def pad_batch_to_multiple(batch: Any, multiple: int) -> Any:
    """Host-side pad of axis 0 of every array of a (nested dict / list /
    tuple) batch to a multiple of ``multiple``; the padded examples are
    zeros, so their masks are all False and they count for nothing."""

    def pad(x):
        if isinstance(x, dict):
            return {k: pad(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(pad(v) for v in x)
        x = np.asarray(x)
        extra = (-x.shape[0]) % multiple
        if extra == 0:
            return x
        return np.pad(x, [(0, extra)] + [(0, 0)] * (x.ndim - 1))

    return pad(batch)
