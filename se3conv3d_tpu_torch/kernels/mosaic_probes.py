"""The Mosaic pattern probes of ``experiments/probe_mosaic.py``, each a
Hopper CUDA kernel beside its plain PyTorch version
(``csrc/probe_mosaic.cu``; ``p11_grid_accum`` is :func:`probes.grid_column_accum`).

The JAX script's 17 probes each ran one ``pl.pallas_call`` (its
``run_kernel``, one block with whole arrays in VMEM, or p11's grid): a
product, reshape, slice, transpose or mid-index write at TM = 128, E = 32,
G = 2, D = 9, Q = 32, C = O = 64.  Here the 16 of ``run_kernel`` are four
kernels over a grid of tiles:

- ``strided_product`` (p1-p4, p8, p10, p13, p15): ``out[b, i, j] = sum_k
  A[b, i, k] * B[b, k, j]``, each operand a strided view of its input,
  float32 or bfloat16 operands and float32 FMA sums; a long K with few
  output tiles (p3, p15) is split across blocks and the splits added in a
  fixed order;
- ``strided_copy`` (p5-p7, p12, p16, p17): the reshape, slice or transpose
  as a copy of a strided view, 16 bytes a thread where the view's inner
  stride is 1;
- ``blockdiag_build`` (p9) and ``mid_write`` (p14).

:data:`PROBES` maps the JAX names to one wrapper per probe, each counting
its own launches (``launches``; p11 counts on ``probes.grid_column_accum``);
:data:`REFERENCES` to the plain versions, :data:`SHAPES` to the inputs the
JAX probe draws (``fresh``'s shapes and dtypes), :data:`KIND` to how a
result is held: ``copy`` bitwise, ``product`` within a share of ``max
|plain|``, ``sum`` against the sum of its terms' magnitudes.  CPU tensors
run the plain versions; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import math

import torch

from . import probes
from .build import library
from .probes import _check, _stream, kernel_attributes

__all__ = ["TM", "E", "G", "D", "Q", "C", "O", "SHAPES", "KIND", "PROBES", "REFERENCES", "MOSAIC_KERNELS",
           "probe_work", "mosaic_kernel_attributes"]

TM, E, G, D, Q, C, O = 128, 32, 2, 9, 32, 64, 64
_P = TM // 2
_F32, _BF16 = torch.float32, torch.bfloat16
# the kernels of csrc/probe_mosaic.cu by their index in se3_probe_mosaic_attrs
MOSAIC_KERNELS = ("strided_product<float>", "strided_product<bf16>", "strided_copy<vec>", "strided_copy<scalar>",
                  "blockdiag_build", "mid_write", "sum_rows_ordered")
_TILE, _SPLIT_K, _TARGET_BLOCKS = 32, 64, 128

# name: the (shape, dtype) of each input, as the JAX probe's fresh(...) draws them
SHAPES = {
    "p1_plain_2d": (((TM * E * G, D), _F32), ((D, Q), _F32)),
    "p2_leading_batch": (((TM, E, C), _F32), ((TM, E, Q), _F32)),
    "p3_multi_contract": (((TM, C, Q), _F32), ((C, Q, O), _F32)),
    "p4_free_dims_rhs": (((TM, E, C), _F32), ((TM, E, G, Q), _F32)),
    "p5_lane_merge": (((TM, E, G, Q), _F32),),
    "p6_sublane_split": (((TM * E * G, Q), _F32),),
    "p7_mid_slice": (((TM, E, G, Q), _F32),),
    "p8_blockdiag_batched": (((_P, 2 * C, 2 * E), _F32), ((_P, 2 * E, 2 * G * Q), _F32)),
    "p9_concat_blockdiag_build": (((TM, C, E), _F32),),
    "p10_bf16_batched": (((TM, E, C), _BF16), ((TM, E, Q), _BF16)),
    "p11_grid_accum": (((8 * TM, Q), _F32),),
    "p12_transpose_last2": (((TM, C, Q), _F32),),
    "p13_nt_contract": (((_P, E, C), _F32), ((_P, 2 * Q, C), _F32)),
    "p14_mid_write": (((TM, C), _F32),),
    "p15_dim0_contract": (((TM * E, 2 * D), _F32), ((TM * E, 2 * Q), _F32)),
    "p16_leading_split_rank2": (((TM * E, 2 * Q), _F32),),
    "p17_outer_swap": (((TM, C, Q), _F32),),
}
KIND = {name: "product" for name in ("p1_plain_2d", "p2_leading_batch", "p3_multi_contract", "p4_free_dims_rhs",
                                     "p8_blockdiag_batched", "p10_bf16_batched", "p13_nt_contract",
                                     "p15_dim0_contract")}
KIND.update({name: "copy" for name in SHAPES if name not in KIND})
KIND["p11_grid_accum"] = "sum"


# --- the plain versions: products in float32 (bfloat16 operands widened, exactly) --

def _f(x):
    return x.float()


def _blockdiag_reference(a):
    x = a.reshape(_P, 2, C, E)
    zero = torch.zeros(_P, C, E, dtype=a.dtype, device=a.device)
    top = torch.cat([x[:, 0], zero], 2)
    bot = torch.cat([zero, x[:, 1]], 2)
    return torch.cat([top, bot], 1)


REFERENCES = {
    "p1_plain_2d": lambda a, b: torch.matmul(a, b),
    "p2_leading_batch": lambda a, b: torch.matmul(a.transpose(1, 2), b),
    "p3_multi_contract": lambda a, b: torch.matmul(a.reshape(TM, C * Q), b.reshape(C * Q, O)),
    "p4_free_dims_rhs": lambda a, b: torch.matmul(a.transpose(1, 2), b.reshape(TM, E, G * Q)).reshape(TM, C, G, Q),
    "p5_lane_merge": lambda a: a.reshape(TM, E, G * Q).clone(),
    "p6_sublane_split": lambda a: a.reshape(TM, E * G, Q).clone(),
    "p7_mid_slice": lambda a: a[:, :, 1, :].contiguous(),
    "p8_blockdiag_batched": lambda a, b: torch.matmul(a, b),
    "p9_concat_blockdiag_build": _blockdiag_reference,
    "p10_bf16_batched": lambda a, b: torch.matmul(_f(a).transpose(1, 2), _f(b)),
    "p11_grid_accum": probes.grid_column_accum_reference,
    "p12_transpose_last2": lambda a: a.transpose(1, 2).contiguous(),
    "p13_nt_contract": lambda a, b: torch.matmul(a, b.transpose(1, 2)),
    "p14_mid_write": lambda a: torch.stack([a * float(q) for q in range(4)], 1),
    "p15_dim0_contract": lambda a, b: torch.matmul(a.t(), b),
    "p16_leading_split_rank2": lambda a: a.reshape(TM, E, 2 * Q).clone(),
    "p17_outer_swap": lambda a: a.transpose(0, 1).contiguous(),
}


# --- the launches -----------------------------------------------------------------

def _splits(batch: int, m: int, n: int, k: int) -> tuple:
    """``(splits, k_per_split)``: K split across blocks (each split a
    multiple of 32 deep) where the output tiles are too few to fill the
    card, else one split."""
    tiles = batch * math.ceil(m / _TILE) * math.ceil(n / _TILE)
    splits = max(1, min(k // _SPLIT_K, _TARGET_BLOCKS // tiles))
    if splits == 1:
        return 1, k
    per = math.ceil(math.ceil(k / splits) / _TILE) * _TILE
    return math.ceil(k / per), per


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [batch, M, K] @ b [batch, K, N]`` of two strided views, float32
    out ``[batch, M, N]``."""
    batch, m, k = a.shape
    n = b.shape[2]
    splits, per = _splits(batch, m, n, k)
    out = torch.empty(batch, m, n, dtype=torch.float32, device=a.device)
    part = torch.empty(splits, batch, m, n, dtype=torch.float32, device=a.device) if splits > 1 else None
    with torch.cuda.device(a.device):
        _check(library("probe_mosaic").se3_probe_strided_product(
            a.data_ptr(), b.data_ptr(), int(a.dtype == _BF16), *a.stride(), *b.stride(), batch, m, n, k, splits, per,
            None if part is None else part.data_ptr(), out.data_ptr(), _stream(a)), "strided_product")
    return out


def _copy(view: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a strided float32 view of up to 4 dims."""
    shape, strides = list(view.shape), list(view.stride())
    shape, strides = [1] * (4 - len(shape)) + shape, [0] * (4 - len(strides)) + strides
    out = torch.empty(view.shape, dtype=torch.float32, device=view.device)
    with torch.cuda.device(view.device):
        _check(library("probe_mosaic").se3_probe_strided_copy(view.data_ptr(), *shape, *strides, out.data_ptr(),
                                                              _stream(view)), "strided_copy")
    return out


def _blockdiag(a: torch.Tensor) -> torch.Tensor:
    out = torch.empty(_P, 2 * C, 2 * E, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_mosaic").se3_probe_blockdiag_build(a.data_ptr(), _P, C, E, out.data_ptr(),
                                                                 _stream(a)), "blockdiag_build")
    return out


def _mid_write(a: torch.Tensor) -> torch.Tensor:
    out = torch.empty(a.shape[0], 4, a.shape[1], dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_mosaic").se3_probe_mid_write(a.data_ptr(), a.shape[0], 4, a.shape[1], out.data_ptr(),
                                                           _stream(a)), "mid_write")
    return out


_LAUNCH = {
    "p1_plain_2d": lambda a, b: _product(a[None], b[None])[0],
    "p2_leading_batch": lambda a, b: _product(a.transpose(1, 2), b),
    "p3_multi_contract": lambda a, b: _product(a.reshape(1, TM, C * Q), b.reshape(1, C * Q, O))[0],
    "p4_free_dims_rhs": lambda a, b: _product(a.transpose(1, 2), b.reshape(TM, E, G * Q)).reshape(TM, C, G, Q),
    "p5_lane_merge": lambda a: _copy(a.reshape(TM, E, G * Q)),
    "p6_sublane_split": lambda a: _copy(a.reshape(TM, E * G, Q)),
    "p7_mid_slice": lambda a: _copy(a[:, :, 1, :]),
    "p8_blockdiag_batched": _product,
    "p9_concat_blockdiag_build": _blockdiag,
    "p10_bf16_batched": lambda a, b: _product(a.transpose(1, 2), b),
    "p12_transpose_last2": lambda a: _copy(a.transpose(1, 2)),
    "p13_nt_contract": lambda a, b: _product(a, b.transpose(1, 2)),
    "p14_mid_write": _mid_write,
    "p15_dim0_contract": lambda a, b: _product(a.t()[None], b[None])[0],
    "p16_leading_split_rank2": lambda a: _copy(a.reshape(TM, E, 2 * Q)),
    "p17_outer_swap": lambda a: _copy(a.transpose(0, 1)),
}


def _wrapper(name: str):
    launch, plain, shapes = _LAUNCH[name], REFERENCES[name], SHAPES[name]

    def probe(*xs: torch.Tensor) -> torch.Tensor:
        if [tuple(x.shape) for x in xs] != [s for s, _ in shapes]:
            raise ValueError(f"{name} takes inputs of shapes {[s for s, _ in shapes]}, got "
                             f"{[tuple(x.shape) for x in xs]}")
        dev = xs[0].device
        if dev.type == "cpu":
            return plain(*xs)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        for x, (_, dt) in zip(xs, shapes):
            if x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{name} takes contiguous {dt} tensors on one device, got {x.dtype} on {x.device}")
        out = launch(*xs)
        probe.launches += 1
        return out

    probe.__name__ = probe.__qualname__ = name
    probe.__doc__ = f"The Mosaic probe {name} on the card (plain version for CPU tensors)."
    probe.launches = 0
    return probe


PROBES = {name: (_wrapper(name) if name in _LAUNCH else probes.grid_column_accum)
          for name in SHAPES}


def probe_work(name: str, xs, out: torch.Tensor) -> dict:
    """What probe ``name`` must do on inputs ``xs`` giving ``out``: each
    input read once and the output written once (``bytes``), and a
    product's multiply-adds (``fma_flops``, 2 per term)."""
    nbytes = float(sum(x.numel() * x.element_size() for x in xs) + out.numel() * out.element_size())
    flops = 0.0
    if KIND[name] == "product":
        a = xs[0]
        terms = {"p1_plain_2d": D, "p2_leading_batch": E, "p3_multi_contract": C * Q, "p4_free_dims_rhs": E,
                 "p8_blockdiag_batched": 2 * E, "p10_bf16_batched": E, "p13_nt_contract": C,
                 "p15_dim0_contract": a.shape[0]}[name]
        flops = 2.0 * out.numel() * terms
    return {"fma_flops": flops, "bytes": nbytes}


def mosaic_kernel_attributes() -> dict:
    """Registers, local bytes and shared memory of every kernel of
    ``csrc/probe_mosaic.cu`` (``cudaFuncGetAttributes``; needs the card)."""
    return {k: kernel_attributes("probe_mosaic", "se3_probe_mosaic_attrs", i) for i, k in enumerate(MOSAIC_KERNELS)}
