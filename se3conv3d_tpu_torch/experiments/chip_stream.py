"""The rate at which a hand kernel streams the conv's input tables, beside
PyTorch's own reduction (the port of ``experiments/chip_stream.py``).

    python -m se3conv3d_tpu_torch.experiments.chip_stream

sums feat ``[M, E, C]`` (512 MiB at M = 65,536), the geometry table ``[M*E,
19]`` (152 MiB) and a ``[M*E, 128]`` table (1 GiB), each with the column-sum
kernel (``kernels.probes.column_sums``) and with ``torch.sum(x *
1.000001)`` (the JAX script's XLA line), and prints ``{name} {ms} ms
{GB/s}`` per line with the share of the card's nominal 3.35 TB/s: the
median per call over CUDA-event timed runs of back-to-back calls after a
warm-up, each array read once a call.  :func:`sum_feat` computes what the JAX ``pallas_sum_feat`` returns,
``C * sum(x[..., C-1])`` (its kernel kept the last channel's sum and
broadcast it over the ``[1, C]`` output); the kernel still reads every
column, so the rate is that of the whole array.  :func:`sum_geo` returns
the sum of every value, as ``pallas_sum_geo``.  It runs on the card and
raises without one.
"""
from __future__ import annotations

import torch

from ..kernels import probes
from .common import cuda_median_ms, require_cuda

__all__ = ["M", "E", "C", "GD1", "NOMINAL_BYTES_PER_S", "torch_sum", "sum_feat", "sum_geo", "make_inputs",
           "main"]

M = 65536
E, C = 32, 64
GD1 = 19
# an H100 SXM's HBM rate on NVIDIA's data sheet
NOMINAL_BYTES_PER_S = 3.35e12


def torch_sum(x: torch.Tensor) -> torch.Tensor:
    """The JAX script's XLA yardstick, ``sum(x * 1.000001)``, in PyTorch."""
    return torch.sum(x * 1.000001)


def sum_feat(x: torch.Tensor) -> torch.Tensor:
    """``C * sum(x[..., C-1])`` for ``x [..., C]``, what the JAX
    ``pallas_sum_feat`` returns; the kernel sums every column of ``x``
    seen as ``[-1, C]``."""
    c = x.shape[-1]
    return probes.column_sums(x.reshape(-1, c))[c - 1] * float(c)


def sum_geo(x: torch.Tensor) -> torch.Tensor:
    """The sum of every value of ``x [R, L]``: the column sums, added in
    column order."""
    return probes.column_sums(x)[x.shape[1]]


def make_inputs(m: int, seed: int, device) -> tuple:
    """``feat [M, E, C]``, ``geo [M*E, 19]``, ``geo128 [M*E, 128]``:
    standard normal draws of a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(m, E, C, generator=gen, device=device),
            torch.randn(m * E, GD1, generator=gen, device=device),
            torch.randn(m * E, 128, generator=gen, device=device))


def main() -> dict:
    """Time each sum; returns ``{name: (ms, GB/s)}``."""
    dev = require_cuda("chip_stream")
    feat, geo, geo128 = make_inputs(M, 0, dev)
    rows = [("torch sum feat", torch_sum, feat), ("torch sum geo19", torch_sum, geo),
            ("torch sum geo128", torch_sum, geo128), ("cuda sum feat", sum_feat, feat),
            ("cuda sum geo19", sum_geo, geo), ("cuda sum geo128", sum_geo, geo128)]
    out = {}
    for name, fn, x in rows:
        nbytes = x.numel() * x.element_size()
        ms = cuda_median_ms(lambda: fn(x))
        rate = nbytes / ms / 1e6
        out[name] = (ms, rate)
        print(f"{name:24s} {ms:8.2f} ms  {rate:7.1f} GB/s  ({rate * 1e9 / NOMINAL_BYTES_PER_S:.1%} of "
              f"3.35 TB/s, {torch.cuda.get_device_name(0)})", flush=True)
    return out


if __name__ == "__main__":
    main()
