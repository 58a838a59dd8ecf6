"""The cell-blocked conv's building blocks, each a Hopper CUDA kernel beside
its plain PyTorch version: counterparts of the four Pallas kernels of
``experiments/probe_cellconv.py`` (``csrc/probe_cellconv.cu``).

- :func:`gather_blocks` (p1): ``out[i] = 2 * tab[ids[i]]``, the table
  seen as blocks of ``block_rows`` rows;
- :func:`gather_sum_blocks` (p2 and p4): ``out[i] = sum_r tab[ids[i, r]]``,
  added in r order from zero, as the TPU grid's revisited output did, so
  the kernel, the plain version (a loop over r) and the JAX kernel agree
  bit for bit.  Both launch one kernel, ``block_gather`` (scaled for p1):
  the TPU prefetched the ids as scalars; here a block of
  :func:`gather_plan` (an output block, a slice of its float4s) knows its
  output block, its threads read that block's ids into registers, and each
  thread issues its table loads, 4 at a time, before its first add;
- :func:`masked_dist_product` (p3): ``pne = (d2 < 0.04) * (3 d2 + 1)``
  over the pairwise squared distances ``d2 = (dx^2 + dy^2) + dz^2`` of the
  queries' and candidates' xyz (each square rounded before the add, as the
  JAX kernel computes it), then ``pne @ cf``.  The kernel runs the product
  on tensor cores in 3xTF32, a block a tile of 64 queries x 32 channels:
  each thread computes the pne values of its own mma fragment from the
  xyz, the candidates' features stream through shared memory by
  ``cp.async``, and 4 groups of warps over the candidates add their
  partial tiles in group order (no atomics: two calls give the same bits).

An id outside ``[0, NB)`` is an error: the kernels never clamp or read
through it and write NaN over its output block; :func:`bad_ids` counts
such ids (a host synchronisation, kept out of the kernel call so that a
CUDA graph can capture it).  CPU tensors run the plain versions (where a
bad id raises ``IndexError``); CUDA tensors launch the kernels or raise.
Each wrapper counts its launches (``launches``).
"""
from __future__ import annotations

import torch

from .build import library
from .probes import _check, _on_card, _stream, kernel_attributes

__all__ = [
    "RADIUS2", "GATHER_SCALE", "CELLCONV_KERNELS", "P3_TILE_Q", "P3_SLICE", "P3_TILE_C", "GATHER_THREADS",
    "bad_ids", "gather_plan", "gather_writes", "gather_blocks", "gather_blocks_reference",
    "gather_sum_blocks", "gather_sum_blocks_reference", "masked_dist_pne", "masked_dist_product",
    "masked_dist_product_reference", "cellconv_kernel_attributes",
]

# p3's radius mask: d2 < 0.04 in float32, as the JAX kernel compares
RADIUS2 = 0.04
# the kernels of csrc/probe_cellconv.cu by their index in se3_probe_cellconv_attrs
CELLCONV_KERNELS = ("block_gather<scaled>", "block_gather<sum>", "masked_dist_product")
# p1's factor: the JAX kernel writes tab_ref[:] * 2.0
GATHER_SCALE = 2.0
# masked_dist_product's kernel takes NQ, NC and C in multiples of these: a
# block's queries, a staged slice's candidates, a block's channels
P3_TILE_Q, P3_SLICE, P3_TILE_C = 64, 32, 32
# block_gather: threads a block, a float4 each
GATHER_THREADS = 128


def bad_ids(ids: torch.Tensor, nb: int) -> int:
    """How many of ``ids`` lie outside ``[0, nb)`` (synchronises)."""
    return int(((ids < 0) | (ids >= nb)).sum())


def _blocks(tab: torch.Tensor, block_rows: int) -> torch.Tensor:
    if tab.dim() != 2 or tab.shape[0] % block_rows or tab.shape[0] == 0:
        raise ValueError(f"tab must be [NB * {block_rows}, C], got {tuple(tab.shape)}")
    return tab.reshape(-1, block_rows, tab.shape[1])


def _card_ids(name: str, ids: torch.Tensor, tab: torch.Tensor) -> bool:
    """False for CPU tensors; True for contiguous int32 ids and float32 tab
    on one CUDA device; raises otherwise."""
    if not _on_card(name, tab):
        return False
    if ids.device != tab.device or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"{name} takes contiguous int32 ids on {tab.device}, got {ids.dtype} on {ids.device}")
    return True


def gather_plan(nq: int, block: int) -> dict:
    """``block_gather``'s launch for ``nq`` output blocks of ``block``
    floats: a block of ``threads`` threads (:data:`GATHER_THREADS`, fewer,
    in whole warps, for a block of fewer float4s) for each output block
    (grid x) and slice of ``threads`` of its float4s (grid y, at most
    65,535; block y writes float4s ``y T + t, (y + grid_y) T + t, ...``).
    Pure Python; the CPU tests check that :func:`gather_writes` covers the
    output once."""
    blk4 = block // 4
    threads = min(GATHER_THREADS, 32 * -(-blk4 // 32))
    slices = -(-blk4 // threads)
    grid = (nq, min(slices, 65535))
    return {"threads": threads, "slices": slices, "grid": grid, "blocks": grid[0] * grid[1]}


def gather_writes(plan: dict, x: int, y: int, block: int) -> list:
    """The float4 indices of the flat output that block ``(x, y)`` of
    :func:`gather_plan` writes."""
    blk4, t = block // 4, plan["threads"]
    return [x * blk4 + j for j0 in range(y * t, blk4, plan["grid"][1] * t) for j in range(j0, min(j0 + t, blk4))]


def _block_gather(name: str, ids: torch.Tensor, tab: torch.Tensor, block_rows: int, scaled: bool) -> torch.Tensor:
    nq, r = ids.shape[0], (1 if ids.dim() == 1 else ids.shape[1])
    nb, c = tab.shape[0] // block_rows, tab.shape[1]
    block = block_rows * c
    if nq < 1 or r < 1 or block % 4 or tab.data_ptr() % 16:
        raise ValueError(f"{name}'s kernel takes 1 or more ids a block, blocks of a multiple of 4 floats and a "
                         f"16-byte aligned tab; got ids {tuple(ids.shape)}, blocks of {block}")
    out = torch.empty(nq * block_rows, c, dtype=torch.float32, device=tab.device)
    with torch.cuda.device(tab.device):
        _check(library("probe_cellconv").se3_probe_block_gather(
            ids.data_ptr(), nq, r, tab.data_ptr(), nb, block, int(scaled), GATHER_SCALE,
            gather_plan(nq, block)["threads"], out.data_ptr(), _stream(tab)), name)
    return out


def gather_blocks_reference(ids: torch.Tensor, tab: torch.Tensor, block_rows: int) -> torch.Tensor:
    t3 = _blocks(tab, block_rows)
    return (t3[ids.long()] * GATHER_SCALE).reshape(-1, tab.shape[1])


def gather_blocks(ids: torch.Tensor, tab: torch.Tensor, block_rows: int) -> torch.Tensor:
    """``[NQ * block_rows, C]``: block ``i`` of the output is 2 times block
    ``ids[i]`` of ``tab [NB * block_rows, C]`` (p1; ids ``[NQ]``)."""
    if ids.dim() != 1:
        raise ValueError(f"ids must be [NQ], got {tuple(ids.shape)}")
    _blocks(tab, block_rows)
    if not _card_ids("gather_blocks", ids, tab):
        return gather_blocks_reference(ids, tab, block_rows)
    out = _block_gather("gather_blocks", ids, tab, block_rows, True)
    gather_blocks.launches += 1
    return out


def gather_sum_blocks_reference(ids: torch.Tensor, tab: torch.Tensor, block_rows: int) -> torch.Tensor:
    t3 = _blocks(tab, block_rows)
    s = torch.zeros(ids.shape[0], block_rows, tab.shape[1], dtype=torch.float32, device=tab.device)
    for r in range(ids.shape[1]):  # the TPU grid's inner steps, in order
        s = s + t3[ids[:, r].long()]
    return s.reshape(-1, tab.shape[1])


def gather_sum_blocks(ids: torch.Tensor, tab: torch.Tensor, block_rows: int) -> torch.Tensor:
    """``[NQ * block_rows, C]``: block ``i`` of the output is the sum over
    ``r`` of block ``ids[i, r]`` of ``tab [NB * block_rows, C]``, added in r
    order from zero (p2; p4 with the gradient blocks as ``tab``; ids ``[NQ,
    R]``)."""
    if ids.dim() != 2:
        raise ValueError(f"ids must be [NQ, R], got {tuple(ids.shape)}")
    _blocks(tab, block_rows)
    if not _card_ids("gather_sum_blocks", ids, tab):
        return gather_sum_blocks_reference(ids, tab, block_rows)
    out = _block_gather("gather_sum_blocks", ids, tab, block_rows, False)
    gather_sum_blocks.launches += 1
    return out


def masked_dist_pne(qp: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """``pne [NQ, NC]``: ``(d2 < 0.04) * (3 d2 + 1)`` with ``d2 = (dx*dx +
    dy*dy) + dz*dz`` over the first three columns of ``qp [NQ, L]`` and
    ``cp [NC, L]``, each product and sum rounded on its own."""
    d2 = None
    for d in range(3):
        diff = qp[:, d, None] - cp[None, :, d]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return torch.where(d2 < RADIUS2, d2 * 3.0 + 1.0, torch.zeros((), dtype=d2.dtype, device=d2.device))


def masked_dist_product_reference(qp: torch.Tensor, cp: torch.Tensor, cf: torch.Tensor) -> torch.Tensor:
    return torch.matmul(masked_dist_pne(qp, cp), cf)


def masked_dist_product(qp: torch.Tensor, cp: torch.Tensor, cf: torch.Tensor, pne_out=None) -> torch.Tensor:
    """``[NQ, C]``: :func:`masked_dist_pne` ``@ cf [NC, C]`` (p3), float32.
    ``pne_out [NQ, NC]``, where given, receives the pne the call used, so a
    check can count mask disagreements.  The kernel takes NQ a multiple of
    64, NC of 32 and C of 32 (:data:`P3_TILE_Q`, :data:`P3_SLICE`,
    :data:`P3_TILE_C`) and refuses other shapes."""
    if qp.dim() != 2 or cp.dim() != 2 or cf.dim() != 2 or qp.shape[1] < 3 or cp.shape[1] < 3 \
            or cf.shape[0] != cp.shape[0]:
        raise ValueError(f"qp [NQ, >=3], cp [NC, >=3] and cf [NC, C], got {tuple(qp.shape)}, {tuple(cp.shape)} "
                         f"and {tuple(cf.shape)}")
    nq, nc, c = qp.shape[0], cp.shape[0], cf.shape[1]
    if pne_out is not None and (tuple(pne_out.shape) != (nq, nc) or pne_out.dtype != torch.float32
                                or pne_out.device != qp.device or not pne_out.is_contiguous()):
        raise ValueError(f"pne_out must be a contiguous float32 [{nq}, {nc}] on {qp.device}")
    if not _on_card("masked_dist_product", qp, cp, cf):
        pne = masked_dist_pne(qp, cp)
        if pne_out is not None:
            pne_out.copy_(pne)
        return torch.matmul(pne, cf)
    if nq % P3_TILE_Q or nc % P3_SLICE or c % P3_TILE_C or 0 in (nq, nc, c):
        raise ValueError(f"the kernel takes NQ a multiple of {P3_TILE_Q}, NC of {P3_SLICE} and C of {P3_TILE_C}; "
                         f"got {nq}, {nc}, {c}")
    out = torch.empty(nq, c, dtype=torch.float32, device=qp.device)
    with torch.cuda.device(qp.device):
        _check(library("probe_cellconv").se3_probe_masked_dist_product(
            qp.data_ptr(), qp.shape[1], nq, cp.data_ptr(), cp.shape[1], nc, cf.data_ptr(), c, out.data_ptr(),
            None if pne_out is None else pne_out.data_ptr(), _stream(qp)), "masked_dist_product")
    masked_dist_product.launches += 1
    return out


for _fn in (gather_blocks, gather_sum_blocks, masked_dist_product):
    _fn.launches = 0


def cellconv_kernel_attributes() -> dict:
    """Registers, local bytes and shared memory of every kernel of
    ``csrc/probe_cellconv.cu`` (``cudaFuncGetAttributes``; needs the card)."""
    return {k: kernel_attributes("probe_cellconv", "se3_probe_cellconv_attrs", i)
            for i, k in enumerate(CELLCONV_KERNELS)}
