"""Each rank's share of a global batch, and the metric sums over the ranks
(counterpart of ``se3conv3d_tpu/parallel/multihost.py``).

As in the JAX package, the ranks need no coordination beyond a shared seed:
every rank runs the same seeded sampler and so draws the same global batch
list; each takes its round-robin slice of every global batch
(:func:`process_slice`), loads only those examples, and pads its local
count to the count all ranks agree on (:func:`local_batch_size`,
:func:`pad_samples_to`, with all-masked fillers that count for nothing).
The rank and the number of ranks come from the process's group
(:mod:`.mesh`), or from explicit arguments as in JAX.

What changes for PyTorch: there is no global array to assemble
(``global_batch``): each rank's batch already is its share, and the model's
reductions run over the group.  :func:`host_local` is the identity: each
rank holds only its own rows.  :func:`cross_host_sum` is one ``all_reduce``
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
           "pad_samples_to", "host_local", "cross_host_sum"]


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return mesh.rank()


def process_count() -> int:
    """The number of ranks (1 outside a group)."""
    return mesh.world_size()


def process_slice(batch_indices: Sequence[int], process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List[int]:
    """This rank's examples of one global batch, round-robin
    (``batch[r::count]``): the point-budget sampler packs large scenes
    first, so striding balances the points per rank."""
    pi = mesh.rank() if process_index is None else process_index
    pc = mesh.world_size() if process_count is None else process_count
    return list(batch_indices[pi::pc])


def local_batch_size(global_batch_size: int, process_count: Optional[int] = None) -> int:
    """Examples every rank supplies: ``ceil(B / ranks)``, the same on every
    rank without communication."""
    pc = mesh.world_size() if process_count is None else process_count
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


def host_local(x):
    """This rank's rows of ``x``: ``x`` itself (a rank holds only its own)."""
    return x


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
