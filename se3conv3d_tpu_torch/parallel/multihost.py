"""Each rank's share of a global batch, and the metric sums over the ranks
(counterpart of ``se3conv3d_tpu/parallel/multihost.py``).

As in the JAX package, the ranks need no coordination beyond a shared seed:
every rank runs the same seeded sampler and so draws the same global batch
list; each takes its round-robin slice of every global batch
(:func:`process_slice`), loads only those examples, and pads its local
count to the count all ranks agree on (:func:`local_batch_size`,
:func:`pad_samples_to`, with all-masked fillers that count for nothing).
The examples are split over the group's data axis: the ranks of one points
row (:mod:`.mesh`) take the same examples, and :func:`shard_points` then
gives each its contiguous share of every per-point array, the counterpart
of ``shard_batch``'s per-point rule on a ``(data, points)`` mesh.  The data
coordinate and the data-axis size come from the process's group, or from
explicit arguments as in JAX.

What changes for PyTorch: there is no global array to assemble
(``global_batch``): each rank's batch already is its share, and the model's
reductions run over the group.  :func:`host_local` returns a rank's own
examples: the identity in a data-only group, the points row's rows put
back together along the point axis in a points group (the JAX package's
``_combine_local_shards``).  :func:`cross_host_sum` is one ``all_reduce``
per dtype over the accumulators, in float64 and int64 (the JAX one gathers
through 32-bit arrays unless x64 is enabled, its own note; the port does
the sum it intends, ``tests/test_torch_multihost.py`` records it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import mesh

__all__ = ["process_index", "process_count", "process_slice", "local_batch_size",
           "pad_samples_to", "shard_points", "host_local", "cross_host_sum"]


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return mesh.rank()


def process_count() -> int:
    """The number of ranks (1 outside a group)."""
    return mesh.world_size()


def process_slice(batch_indices: Sequence[int], process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List[int]:
    """This rank's examples of one global batch, round-robin
    (``batch[r::count]``) over the data axis (default: this rank's data
    coordinate and the group's data-axis size, so the ranks of one points
    row take the same examples): the point-budget sampler packs large
    scenes first, so striding balances the points per rank."""
    pi = mesh.data_rank() if process_index is None else process_index
    pc = mesh.data_size() if process_count is None else process_count
    return list(batch_indices[pi::pc])


def local_batch_size(global_batch_size: int, process_count: Optional[int] = None) -> int:
    """Examples every rank supplies: ``ceil(B / D)`` over the data axis,
    the same on every rank without communication."""
    pc = mesh.data_size() if process_count is None else process_count
    return -(-global_batch_size // pc)


def _empty_like_sample(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An all-masked filler with ``sample``'s keys: zero rows of each
    per-point array, zeros of each scalar (``pad_collate`` gives it an
    all-False mask row)."""
    n = sample["positions"].shape[0]
    out: Dict[str, np.ndarray] = {}
    for k, v in sample.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[k] = np.zeros((0,) + v.shape[1:], v.dtype)
        else:
            out[k] = np.zeros_like(np.asarray(v))
    return out


def pad_samples_to(samples: List[Dict[str, np.ndarray]], target: int,
                   template: Optional[Dict[str, np.ndarray]] = None) -> List[Dict[str, np.ndarray]]:
    """Pad a local sample list to ``target`` with empty (all-masked)
    samples; no-op when already there.  ``template`` gives the filler's keys
    and shapes when the list is empty (a rank whose round-robin slice of a
    small global batch holds nothing)."""
    if len(samples) > target:
        raise ValueError(f"{len(samples)} local samples exceed the agreed per-host count {target}")
    if not samples:
        if template is None:
            raise ValueError("cannot pad an empty local sample list without a template")
        return [_empty_like_sample(template) for _ in range(target)]
    filler = _empty_like_sample(samples[0])
    return samples + [filler] * (target - len(samples))


def shard_points(batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's share of a batch on a points group: every per-point array
    (``ndim >= 2``: positions, mask, features, per-point labels ``[B, N,
    ...]``) cut to this rank's contiguous rows :func:`~.mesh.local_rows`
    ``(N)``; per-example arrays (``[B]``) whole.  Numpy arrays or tensors;
    the identity outside a points group."""
    if mesh.points_size() == 1:
        return batch

    def cut(x):
        if x.ndim < 2:
            return x
        start, stop = mesh.local_rows(x.shape[1])
        return x[:, start:stop]

    return {k: cut(v) for k, v in batch.items()}


def host_local(x):
    """This rank's examples of a per-point array ``x`` (``[B, rows, ...]``):
    in a data-only group ``x`` itself (a rank holds only its own); in a
    points group the points row's rows gathered back into the whole cloud,
    in points order.  A tensor or a numpy array (returned as it came)."""
    if mesh.points_size() == 1:
        return x
    as_numpy = isinstance(x, np.ndarray)
    t = torch.from_numpy(x) if as_numpy else x
    if dist.get_backend() == "nccl":
        t = t.to(mesh.rank_device())
    with torch.no_grad():
        whole = mesh.points_gather(t, 1)
    return whole.cpu().numpy() if as_numpy else whole.to(x.device)


def _flatten(tree) -> tuple:
    """``(leaves, rebuild)`` of a tree of tuples, lists, dicts and
    dataclasses over numpy arrays and numbers."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        leaves, build = _flatten(tuple(getattr(tree, n) for n in names))
        return leaves, lambda xs: dataclasses.replace(tree, **dict(zip(names, build(xs))))
    if isinstance(tree, dict):
        keys = list(tree)
        leaves, build = _flatten(tuple(tree[k] for k in keys))
        return leaves, lambda xs: dict(zip(keys, build(xs)))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]
        sizes = [len(p[0]) for p in parts]

        def build(xs):
            out, i = [], 0
            for (_, b), n in zip(parts, sizes):
                out.append(b(xs[i : i + n]))
                i += n
            return type(tree)(out)

        return [leaf for p in parts for leaf in p[0]], build
    return [tree], lambda xs: xs[0]


def cross_host_sum(tree: Any) -> Any:
    """Sum a tree of host-side accumulators (numpy arrays or numbers, in
    tuples, lists, dicts or dataclasses) over the ranks: an exact no-op
    outside a group; else one ``all_reduce`` of the floating leaves in
    float64 and one of the integer and bool leaves in int64.  Each leaf
    comes back as a numpy array of its own dtype."""
    if not mesh.in_group():
        return tree
    leaves, build = _flatten(tree)
    arrays = [np.asarray(x) for x in leaves]
    out: List[Optional[np.ndarray]] = [None] * len(arrays)
    device = mesh.rank_device() if dist.get_backend() == "nccl" else torch.device("cpu")
    for wide, kinds in ((np.float64, "f"), (np.int64, "iub")):
        pick = [i for i, a in enumerate(arrays) if a.dtype.kind in kinds]
        if not pick:
            continue
        flat = torch.from_numpy(np.concatenate([arrays[i].astype(wide).reshape(-1) for i in pick]))
        flat = flat.to(device)
        dist.all_reduce(flat)
        flat = flat.cpu().numpy()
        start = 0
        for i in pick:
            n = arrays[i].size
            out[i] = flat[start : start + n].reshape(arrays[i].shape).astype(arrays[i].dtype)
            start += n
    if any(o is None for o in out):
        raise TypeError("cross_host_sum takes real or integer accumulators")
    return build(out)
