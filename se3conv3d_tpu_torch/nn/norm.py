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
"""
from __future__ import annotations

import torch
from torch import nn

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
            count = rows.sum().clamp(min=1.0)
            mean = (x * rows).sum(dims) / count
            var = (rows * (x - mean) ** 2).sum(dims) / count
            with torch.no_grad():
                unbiased = var * (count / (count - 1.0).clamp(min=1.0))
                self.mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
