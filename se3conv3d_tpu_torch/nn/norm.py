"""Mask-aware batch norm (counterpart of ``se3conv3d_tpu/nn/norm.py``).

The reference's ``BatchNormPC`` is ``torch.nn.BatchNorm1d(momentum=0.2)``
over flat point rows, frames counting as rows.  Parameter and buffer names
follow the flax module (``scale``, ``bias``; ``mean``, ``var``).

Only eval mode is ported: it normalises with the running statistics, so
padding cannot leak into it.  Training statistics come with the training
step.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["MaskedBatchNorm"]


class MaskedBatchNorm(nn.Module):
    """BatchNorm of ``x [B, N, C]`` or ``[B, N, F, C]`` (mask ``[B, N]``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        del mask  # eval mode: running statistics only
        if self.training:
            raise NotImplementedError("batch-statistics (training) mode is not ported yet")
        return (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias
