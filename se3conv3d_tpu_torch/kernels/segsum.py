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
there is no other fallback.  The kernel is one single-pass launch that
reads each row once; its tile offsets are fixed sums of the tiles'
aggregates, so two calls give the same bits.  Its state (counters, a
generation, tagged partial sums) lives in a buffer per device and stream,
zeroed once when it is made or grown; the kernel leaves it ready for the
next call.  The plain version follows the TPU kernel's arithmetic: each
256-row block's local prefix is a lower-triangular matrix product, and the
blocks' running totals (the TPU kernel's carry) are the same blocked scan
one level up.

The payload is float32 or bfloat16; accumulation and the prefix are
float32, as the TPU kernel's (``segsum.py:17``).  A prefix difference
carries an absolute error of about ``eps * |prefix|`` against a direct sum
of the run, where ``|prefix|`` grows with everything summed before the run.
"""
from __future__ import annotations

import torch

from .build import library

__all__ = ["blocked_cumsum", "blocked_cumsum_reference", "sorted_segment_sum", "BLOCK"]

BLOCK = 256  # rows per block of the plain version, as the TPU kernel's default
PAYLOADS = (torch.float32, torch.bfloat16)
# (device index, stream handle) -> the kernel's state buffer
_SCAN_STATE: dict = {}


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
    ``[B, E, C]`` (float32 or bfloat16).  CPU tensors run
    :func:`blocked_cumsum_reference`; CUDA tensors launch the kernel, one
    launch for the whole batch (none when ``x`` is empty)."""
    if x.dtype not in PAYLOADS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return blocked_cumsum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() not in (2, 3) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [E, C] or [B, E, C] tensor, got {tuple(x.shape)}")
    x3 = x[None] if x.dim() == 2 else x
    b, e, c = x3.shape
    out = torch.empty(x3.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    lib = library("cumsum")
    words = lib.se3_blocked_cumsum_words(b, e, c)
    if words < 0:
        raise ValueError(f"kernel takes at most 2**31 - 1 tiles of 256 rows x 64 columns, "
                         f"got {tuple(x.shape)}")
    stream = torch.cuda.current_stream(x.device)
    state = _scan_state(x.device, stream, words)
    with torch.cuda.device(x.device):
        err = lib.se3_blocked_cumsum(x3.data_ptr(), out.data_ptr(), state.data_ptr(), b, e, c,
                                     int(x.dtype == torch.bfloat16), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"blocked_cumsum kernel launch failed: CUDA error {err}")
    blocked_cumsum.launches += 1
    return out.reshape(x.shape)


def _scan_state(dev: torch.device, stream, words: int) -> torch.Tensor:
    """The kernel's state buffer for ``stream``: at least ``words`` int64,
    zeroed when made.  One per device and stream, so that two streams never
    share one; made anew, at the size of the call, when a call needs more
    (8 bytes per 256 x 64 tile, 6 MiB at the ScanNet level-0 conv)."""
    key = (dev.index, stream.cuda_stream)
    buf = _SCAN_STATE.get(key)
    if buf is None or buf.numel() < words:
        buf = _SCAN_STATE[key] = torch.zeros(words, dtype=torch.int64, device=dev)
    return buf


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
