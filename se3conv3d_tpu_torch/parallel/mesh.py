"""Data-parallel and point-parallel groups (counterpart of
``se3conv3d_tpu/parallel/mesh.py``).

The JAX package's ``(data, points)`` mesh of N = D x P devices is one
program over N chips: GSPMD shards the batch axis over ``data`` and the
point axis of every per-point array over ``points``, and inserts the
collectives.  Here it is N ranks, one process each, in one
``torch.distributed`` group, laid out as the JAX mesh's device grid: rank
``r`` sits at ``(data, points) = divmod(r, P)``.  Every rank holds the whole
model.

* The **data** axis splits a global batch's examples
  (:mod:`.multihost`): the P ranks of one points row take the same
  examples.
* The **points** axis splits one scene.  A level of capacity M (each
  hierarchy level, the raw cloud, the output cloud) is cut into P
  contiguous slices of ``ceil(M / P)`` rows, the last one short or empty
  (:func:`local_rows`, as GSPMD pads an uneven axis).  A rank holds the
  activations of its own rows only: features, BN inputs and outputs, skips,
  logits, labels.  The hierarchy itself (positions, masks, frames: a few
  floats a point) is built whole on every rank of a points row from the
  raw cloud gathered over the row (``train.trainer.Trainer.build``), and
  each level is handed to the model as this rank's row slice
  (``core.pointcloud.PointCloud.row_slice``); the neighbour tables are
  searched for the rank's query rows only, against the whole source level
  (``models.spec.NeighborhoodProvider``).  A layer that reads source rows
  through its neighbour table takes them from :func:`points_gather`, one
  all-gather over the points row, whose backward sums the incoming
  gradients over the row and keeps the rank's own rows; the conv kernels'
  autograd node gathers inside itself, so that no rank keeps a whole-level
  copy past the layer that gathered it.

The sums that the one logical program takes over the global batch and the
whole scene are taken over the whole group (rows are disjoint across ranks,
so one sum serves both axes):

* batch-norm statistics (``nn.norm.MaskedBatchNorm``), through
  :func:`rank_sum`, which carries gradients;
* the calibration sums (``nn.conv.calibrate_norms``) and the truncation
  fraction (``PNEConv``), through :func:`group_sum_`;
* the loss's valid count and the gradients (``train.trainer.Trainer``);
* the metric accumulators (:func:`.multihost.cross_host_sum`; the run loop,
  the voters and the CLIs use data-only groups, as the JAX package's).

A global pool (``core.pointcloud.global_pool``) reduces over the points row
only (:func:`points_sum`, :func:`points_extreme`).

A group is described by :func:`make_group` (its devices, backend and
points: NCCL on the card, gloo on the CPU; gloo also reduces and gathers
CUDA tensors, through the host, which lets several ranks share one card)
and started by :func:`launch`, which spawns one process per rank with
``torch.multiprocessing.spawn``; each rank joins through a ``FileStore`` in
a temporary directory (no network, no port) and, with P > 1, creates one
subgroup per points row, in the same order on every rank.  :func:`joined`
joins the calling process as one rank (a group of one, or a rank started by
other means).  Every reduction here runs whenever the process is in a
group, a group of one included (where it is the identity), so a one-rank
group drives the same code as N ranks.  Gloo and NCCL run the same
collectives (``all_gather`` into equal padded slices, ``all_reduce``); a
``reduce_scatter`` backward and halo-only exchange are later work
(``ROADMAP.md``).
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
           "rank_device", "rank_sum", "group_sum_", "barrier", "pad_batch_to_multiple",
           "data_rank", "data_size", "points_rank", "points_size", "local_rows", "points_gather",
           "gather_points", "sum_points_rows", "points_sum", "points_extreme", "points_lengths",
           "points_agree"]

# how long a collective waits for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)
# the card this process's rank runs on (set by joined())
_RANK_DEVICE: Optional[torch.device] = None
# this rank's points row, with P > 1 (set by joined()): (subgroup, data
# coordinate, points coordinate, P)
_POINTS: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """D x P ranks: rank ``r`` runs on ``devices[r]`` at ``(data, points) =
    divmod(r, points)``; ``points`` 1 is a data-only group."""

    devices: tuple
    backend: str
    points: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data(self) -> int:
        """Ranks along the data axis (D)."""
        return self.size // self.points


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
      points: P, the ranks of one points row, which split each scene's
        point axis (module note); the devices must be a multiple of it.
        Rank ``r`` sits at ``divmod(r, points)``, as the JAX mesh's device
        grid ``reshape(n // points, points)``.
    """
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
    if points < 1 or len(devs) % points:
        raise ValueError(f"{len(devs)} devices not divisible by points={points}")
    if backend is None:
        backend = "nccl" if all(d.type == "cuda" for d in devs) else "gloo"
    if backend == "nccl" and len({str(d) for d in devs}) < len(devs):
        raise ValueError("NCCL takes one rank per card: pass backend='gloo' to share a card")
    return DataGroup(tuple(devs), backend, points)


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


def points_size() -> int:
    """P, the ranks of this process's points row (1 outside a points group)."""
    return _POINTS[3] if _POINTS is not None and in_group() else 1


def points_rank() -> int:
    """This rank's coordinate along the points axis (0 outside a points group)."""
    return _POINTS[2] if _POINTS is not None and in_group() else 0


def data_size() -> int:
    """D, the ranks along the data axis (1 outside a group)."""
    return world_size() // points_size()


def data_rank() -> int:
    """This rank's coordinate along the data axis (0 outside a group)."""
    return rank() // points_size()


def local_rows(capacity: int, index: Optional[int] = None, size: Optional[int] = None) -> tuple:
    """``(start, stop)`` of the rows of a level of ``capacity`` rows that
    points coordinate ``index`` of ``size`` holds (default: this rank's):
    contiguous slices of ``ceil(capacity / size)`` rows, the last ones short
    or empty."""
    index = points_rank() if index is None else index
    size = points_size() if size is None else size
    step = -(-capacity // size)
    start = min(index * step, capacity)
    return start, min(start + step, capacity)


@contextlib.contextmanager
def joined(group: DataGroup, rank_index: int = 0, store_path: Optional[str] = None):
    """Join ``group`` as rank ``rank_index`` for the ``with`` block (the
    process group is destroyed at its end).  ``store_path`` is the
    ``FileStore`` file every rank shares (default: a new one in a temporary
    directory, enough for a group of one)."""
    global _RANK_DEVICE, _POINTS
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
            if group.points > 1:
                _join_points_rows(group, rank_index)
            yield device
        finally:
            _RANK_DEVICE = _POINTS = None
            dist.destroy_process_group()


def _join_points_rows(group: DataGroup, rank_index: int) -> None:
    """One subgroup per points row, created in row order on every rank (as
    ``new_group`` requires); keep this rank's."""
    global _POINTS
    p = group.points
    d_index, p_index = divmod(rank_index, p)
    for d in range(group.data):
        row = dist.new_group(list(range(d * p, (d + 1) * p)))
        if d == d_index:
            _POINTS = (row, d_index, p_index, p)


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


def _points_row():
    return _POINTS[0]


def _small_device() -> torch.device:
    """Where a small bookkeeping tensor of a collective lives: the rank's
    card under NCCL, the host under gloo."""
    return _RANK_DEVICE if dist.get_backend() == "nccl" else torch.device("cpu")


def points_lengths(n: int) -> List[int]:
    """Every rank's ``n`` along this rank's points row, in points order
    (``[n]`` outside a points group): one small all-gather."""
    if points_size() == 1:
        return [n]
    mine = torch.tensor([n], dtype=torch.int64, device=_small_device())
    every = [torch.empty_like(mine) for _ in range(points_size())]
    dist.all_gather(every, mine, group=_points_row())
    return [int(x) for x in every]


def points_agree(value: int) -> bool:
    """Whether every rank of this rank's points row holds the same integer
    ``value`` (below 2**63): one all-reduce of ``(value, -value)`` by max."""
    if points_size() == 1:
        return True
    pair = torch.tensor([value, -value], dtype=torch.int64, device=_small_device())
    dist.all_reduce(pair, op=dist.ReduceOp.MAX, group=_points_row())
    return int(pair[0]) == value and -int(pair[1]) == value


# dtypes gathered as their bytes (gloo gathers neither)
_AS_BYTES = (torch.bfloat16, torch.bool)


def gather_points(x: torch.Tensor, dim: int, total: int) -> torch.Tensor:
    """The whole level from every rank's rows of it (no autograd): this
    rank's ``x`` holds rows :func:`local_rows` ``(total)`` along ``dim``;
    each rank's slice is padded to ``ceil(total / P)`` rows, all-gathered
    over the points row and cut back to ``total``.  Identity outside a
    points group."""
    size = points_size()
    if size == 1:
        return x
    start, stop = local_rows(total)
    if x.shape[dim] != stop - start:
        raise ValueError(f"this rank holds {x.shape[dim]} rows of {total}, its slice is [{start}, {stop})")
    step = -(-total // size)
    pad = list(x.shape)
    pad[dim] = step - x.shape[dim]
    piece = torch.cat([x, x.new_zeros(pad)], dim) if pad[dim] else x.contiguous()
    wire = piece.view(torch.uint8) if piece.dtype in _AS_BYTES else piece  # a gather moves bytes
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=_points_row())
    parts = [t.view(piece.dtype) for t in parts]
    return torch.cat(parts, dim).narrow(dim, 0, total)


def sum_points_rows(x: torch.Tensor, dim: int, total: int) -> torch.Tensor:
    """The sum over the points row of every rank's whole-level ``x`` (``total``
    rows along ``dim``), cut to this rank's rows (no autograd; a new tensor,
    so that the whole-level buffer is freed).  Identity outside a points
    group."""
    if points_size() == 1:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=_points_row())
    start, stop = local_rows(total)
    return x.narrow(dim, start, stop - start).clone()


class _PointsGather(torch.autograd.Function):
    """:func:`gather_points` with its backward: the sum over the points row
    of the incoming whole-level gradients (every rank's layer read this
    rank's rows), this rank's rows kept."""

    @staticmethod
    def forward(ctx, x, dim, total):
        ctx.dim, ctx.total = dim, total
        return gather_points(x, dim, total)

    @staticmethod
    def backward(ctx, grad):
        return sum_points_rows(grad, ctx.dim, ctx.total), None, None


def points_gather(x: torch.Tensor, dim: int = 1, total: Optional[int] = None) -> torch.Tensor:
    """The whole level along ``dim`` from every rank's rows of it, with
    gradients (module note); ``total`` the level's rows (default: the sum of
    the ranks' rows, one more small all-gather).  Identity outside a points
    group."""
    if points_size() == 1:
        return x
    if total is None:
        total = sum(points_lengths(x.shape[dim]))
    return _PointsGather.apply(x, dim, total)


class _PointsSum(torch.autograd.Function):
    """``x`` summed over the points row; the gradient is the sum over the
    row of the incoming gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=_points_row())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_points_row())
        return grad


class _PointsExtreme(torch.autograd.Function):
    """The elementwise max (``largest``) or min of ``x`` over the points
    row; the gradient goes to the ranks that hold the extreme (the owning
    ranks): the sum over the row of the incoming gradients, shared in
    proportion to ``ties``, each rank's count of the elements its ``x``
    was the extreme of, so every tied element of the row takes an even
    share, as ``amax`` over the whole cloud gives it."""

    @staticmethod
    def forward(ctx, x, ties, largest):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN, group=_points_row())
        owns = x == out
        ctx.save_for_backward(owns, torch.where(owns, ties.float(), torch.zeros_like(out, dtype=torch.float32)))
        return out

    @staticmethod
    def backward(ctx, grad):
        owns, ties = ctx.saved_tensors
        both = torch.stack([grad.float(), ties])
        dist.all_reduce(both, group=_points_row())
        share = both[0] * ties / both[1].clamp(min=1)
        return torch.where(owns, share, torch.zeros_like(share)).to(grad.dtype), None, None


def points_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the points row, with gradients (identity outside a
    points group)."""
    return _PointsSum.apply(x) if points_size() > 1 else x


def points_extreme(x: torch.Tensor, ties: torch.Tensor, largest: bool) -> torch.Tensor:
    """The elementwise max or min of ``x`` over the points row, with
    gradients to the owning ranks, split over the row's tied elements
    (``ties``: this rank's count of the elements each entry of ``x`` is the
    extreme of); the identity outside a points group."""
    return _PointsExtreme.apply(x, ties, largest) if points_size() > 1 else x


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
