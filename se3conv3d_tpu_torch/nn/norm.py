"""Mask-aware batch norm (counterpart of ``se3conv3d_tpu/nn/norm.py``).

The reference's ``BatchNormPC`` is ``torch.nn.BatchNorm1d(momentum=0.2)``
over flat point rows, frames counting as rows.  Parameter and buffer names
follow the flax module (``scale``, ``bias``; ``mean``, ``var``).

Eval mode normalises with the running statistics.  Training mode takes the
batch statistics over the valid rows only (padding stays out of them): the
biased variance normalises, the unbiased one enters the running update
``running = (1 - momentum) * running + momentum * batch``.  For
``[B, N, F, C]`` input the rows are the valid points x frames, the
reference's ``(n * F, C)`` layout.  (The JAX package counts only the valid
points there, so its batch statistics at F > 1 are F times too large;
``tests/test_torch_train.py`` records that deviation.)

In a data-parallel group (``parallel.mesh``) the batch is the global one, as
on a JAX mesh, where GSPMD runs one program over the global batch: each
rank's sum and count of valid rows are summed over the ranks before the
mean, and its sums of squared deviations from that mean before the
variance (the two passes of the one-process formula), through
``rank_sum``, whose gradient is summed over the ranks too and which takes
the place of the one-process sum node for node, so a group of one gives
the one-process bits; the running update takes the global count.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import rank_sum

__all__ = ["MaskedBatchNorm"]


class MaskedBatchNorm(nn.Module):
    """BatchNorm of ``x [B, N, C]`` or ``[B, N, F, C]`` (mask ``[B, N]``)."""

    momentum = 0.2  # the reference's BatchNorm1d(momentum=0.2)

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.mean, self.var
        else:
            rows = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).to(x.dtype)
            rows = rows.expand(*x.shape[:-1], 1)  # one weight per (point, frame) row
            dims = tuple(range(x.ndim - 1))
            total, count = rank_sum(x * rows, dims, rows.sum())
            count = count.clamp(min=1.0)
            mean = total / count
            var = rank_sum(rows * (x - mean) ** 2, dims)[0] / count
            with torch.no_grad():
                unbiased = var * (count / (count - 1.0).clamp(min=1.0))
                self.mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
