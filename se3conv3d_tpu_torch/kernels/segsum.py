"""Blocked prefix sum and sorted segment sums: a Hopper CUDA kernel and its
plain PyTorch version (counterpart of ``se3conv3d_tpu/ops/pallas/segsum.py``).

The 'sorted' feature-gradient reduction of the conv backward
(``ops.pne_conv``, ``SE3CONV_BWD_MODE=sorted``) writes each edge's gradient
row at its slot in source order; the per-source sums are then prefix
differences: ``sum(run n) = prefix[run_end[n]] - prefix[run_start[n]]``
with ``prefix`` the inclusive float32 prefix sum behind a zero row.

``blocked_cumsum`` launches ``csrc/segsum_cumsum.cu`` (which replaces the
Pallas ``_cumsum_kernel``, ``se3conv3d_tpu/ops/pallas/segsum.py:38``) for
CUDA tensors and runs :func:`blocked_cumsum_reference` for CPU tensors;
there is no other fallback.  The plain version follows the TPU kernel's
arithmetic: each 256-row block's local prefix is a lower-triangular matrix
product, and the blocks' running totals (the TPU kernel's carry) are the
same blocked scan one level up.

Accumulation is float32.  A prefix difference carries an absolute error of
about ``eps * |prefix|`` against a direct sum of the run, where ``|prefix|``
grows with everything summed before the run.
"""
from __future__ import annotations

import torch

from .build import library

__all__ = ["blocked_cumsum", "blocked_cumsum_reference", "sorted_segment_sum", "BLOCK"]

BLOCK = 256  # rows per block of the plain version, as the TPU kernel's default


def blocked_cumsum_reference(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch inclusive float32 prefix sum along the rows of
    ``x [E, C]`` or ``[B, E, C]``."""
    squeeze = x.dim() == 2
    x = (x[None] if squeeze else x).float()
    b, e, c = x.shape
    nb = max(-(-e // block), 1)
    xb = torch.nn.functional.pad(x, (0, 0, 0, nb * block - e)).reshape(b, nb, block, c)
    tri = torch.tril(torch.ones(block, block, dtype=torch.float32, device=x.device))
    local = torch.matmul(tri, xb)                               # [B, nb, block, C]
    if nb > 1:
        totals = blocked_cumsum_reference(local[:, :, -1], block)  # inclusive over blocks
        carry = torch.cat([totals.new_zeros(b, 1, c), totals[:, :-1]], 1)
        local = local + carry[:, :, None, :]
    out = local.reshape(b, nb * block, c)[:, :e]
    return out[0] if squeeze else out


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along the rows of ``x [E, C]`` or
    ``[B, E, C]`` (float32).  CPU tensors run
    :func:`blocked_cumsum_reference`; CUDA tensors launch the kernel, one
    launch for the whole batch."""
    if x.device.type == "cpu":
        return blocked_cumsum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() not in (2, 3) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [E, C] or [B, E, C] tensor, got {tuple(x.shape)}")
    x3 = x[None] if x.dim() == 2 else x
    b, e, c = x3.shape
    if b > 65535 or -(-c // 32) > 65535:
        raise ValueError(f"kernel takes B <= 65535 and C <= {65535 * 32}, got {tuple(x.shape)}")
    out = torch.empty_like(x3)
    lib = library("cumsum")
    sums = torch.empty((b, lib.se3_blocked_cumsum_tiles(e), c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.se3_blocked_cumsum(x3.data_ptr(), out.data_ptr(), sums.data_ptr(), b, e, c,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blocked_cumsum kernel launch failed: CUDA error {err}")
    blocked_cumsum.launches += 1
    return out.reshape(x.shape)


# kernel launches so far (CPU calls do not count); callers may reset them
blocked_cumsum.launches = 0


def sorted_segment_sum(data: torch.Tensor, run_start: torch.Tensor,
                       run_end: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``data [E, C]`` / ``[B, E, C]`` whose rows are
    grouped into contiguous runs ``[run_start[n], run_end[n])`` ->
    ``[N, C]`` / ``[B, N, C]`` float32."""
    squeeze = data.dim() == 2
    if squeeze:
        data, run_start, run_end = data[None], run_start[None], run_end[None]
    prefix = blocked_cumsum(data)
    c = prefix.shape[2]

    def exclusive_at(i):  # the prefix behind a zero row, at row i
        rows = prefix.gather(1, (i - 1).clamp(min=0)[:, :, None].expand(-1, -1, c))
        return torch.where((i > 0)[:, :, None], rows, torch.zeros_like(rows))

    out = exclusive_at(run_end) - exclusive_at(run_start)
    return out[0] if squeeze else out
