"""Linear layer, stochastic depth, skip connection and the residual blocks
ResNetFormer, ResNetB and ResConvNeXt (counterparts of
``se3conv3d_tpu/nn/blocks.py``).

The JAX blocks call ``jax.nn.gelu`` with its default, the tanh
approximation, so the port does too (``approximate="tanh"``); only the PNE
activation inside the conv is the exact erf form.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.neighborhoods import Neighborhood
from ..core.pointcloud import PointCloud
from .norm import MaskedBatchNorm

__all__ = ["TorchLinear", "DropPath", "DropPathDraws", "SkipConnection", "ResNetFormer", "ResNetB",
           "ResConvNeXt", "gelu_tanh"]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh-approximate) GELU."""
    return F.gelu(x, approximate="tanh")


class TorchLinear(nn.Module):
    """``x @ kernel + bias`` with ``kernel [in, out]`` and torch.nn.Linear's
    uniform +-1/sqrt(fan_in) init."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        nn.init.uniform_(self.kernel, -bound, bound, generator=generator)
        nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class DropPathDraws:
    """Where train-mode :class:`DropPath` layers get their keep masks during
    one forward: uniforms from ``generator`` (``keep = floor(1 - p + u)``
    per example), or ``keep_masks`` handed in, consumed in call order.
    Never the global RNG: a draw with neither source raises."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 keep_masks: Optional[Sequence[torch.Tensor]] = None):
        self.generator = generator
        self._masks = None if keep_masks is None else iter(keep_masks)

    def keep_mask(self, batch: int, keep: float, like: torch.Tensor) -> torch.Tensor:
        """``[batch]`` of 0/1 in ``like``'s dtype and device."""
        if self._masks is not None:
            mask = next(self._masks, None)
            if mask is None:
                raise ValueError("more train-mode DropPath calls than injected keep masks")
            if tuple(mask.shape) != (batch,):
                raise ValueError(f"keep mask has shape {tuple(mask.shape)}, expected ({batch},)")
            return mask.to(device=like.device, dtype=like.dtype)
        if self.generator is None:
            raise ValueError("train-mode DropPath needs a generator or injected keep masks")
        u = torch.rand(batch, generator=self.generator, device=like.device, dtype=like.dtype)
        return torch.floor(keep + u)


class DropPath(nn.Module):
    """Per-example stochastic depth: in training mode the whole residual
    branch of an example is kept (scaled by ``1 / keep``) or dropped
    together, ``x / keep * floor(keep + u)``; identity in eval mode."""

    def __init__(self, drop_prob: float):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x, drops: Optional[DropPathDraws] = None):
        if self.drop_prob == 0.0 or not self.training:
            return x
        if drops is None:
            raise ValueError("train-mode DropPath needs a DropPathDraws source")
        keep = 1.0 - self.drop_prob
        mask = drops.keep_mask(x.shape[0], keep, x)
        return x / keep * mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1))


class SkipConnection(nn.Module):
    """``drop_path(x * gamma) + y`` with learnable per-channel ``gamma [1, C]``
    initialised to 1e-6."""

    def __init__(self, features: int, drop_prob: float, init_gamma: float = 1e-6):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((1, features), init_gamma))
        self.drop_path = DropPath(drop_prob)

    def forward(self, x, y, drops: Optional[DropPathDraws] = None):
        return self.drop_path(x * self.gamma, drops) + y


class ResNetFormer(nn.Module):
    """Pre-norm conv residual + pre-norm MLP residual."""

    def __init__(self, in_features: int, out_features: int, conv_factory, drop_prob: float = 0.0):
        super().__init__()
        self.norm_1 = MaskedBatchNorm(in_features)
        self.spatial_conv = conv_factory.make(in_features, in_features)
        self.skip_path_1 = SkipConnection(in_features, drop_prob)
        self.norm_2 = MaskedBatchNorm(in_features)
        self.linear_1 = TorchLinear(in_features, in_features * 2)
        self.linear_2 = TorchLinear(in_features * 2, out_features)
        self.skip_conv = (
            TorchLinear(in_features, out_features) if in_features != out_features else None
        )
        self.skip_path_2 = SkipConnection(out_features, drop_prob)

    def forward(self, pc: PointCloud, features, neigh: Neighborhood, calibrate: bool = False,
                drops: Optional[DropPathDraws] = None):
        x = self.norm_1(features, pc.mask)
        x = self.spatial_conv(pc, pc, x, neigh, calibrate)
        x = self.skip_path_1(x, features, drops)
        y = self.norm_2(x, pc.mask)
        y = self.linear_2(gelu_tanh(self.linear_1(y)))
        skip = self.skip_conv(x) if self.skip_conv is not None else x
        return self.skip_path_2(y, skip, drops)


class ResNetB(nn.Module):
    """Bottleneck residual block: norm -> linear (C/2) -> conv (C/2 -> C/2)
    -> GELU -> linear (C_out) -> skip."""

    def __init__(self, in_features: int, out_features: int, conv_factory, drop_prob: float = 0.0):
        super().__init__()
        hidden = in_features // 2
        self.norm = MaskedBatchNorm(in_features)
        self.linear_1 = TorchLinear(in_features, hidden)
        self.spatial_conv = conv_factory.make(hidden, hidden)
        self.linear_2 = TorchLinear(hidden, out_features)
        self.skip_conv = (
            TorchLinear(in_features, out_features) if in_features != out_features else None
        )
        self.skip_path = SkipConnection(out_features, drop_prob)

    def forward(self, pc: PointCloud, features, neigh: Neighborhood, calibrate: bool = False,
                drops: Optional[DropPathDraws] = None):
        x = self.linear_1(self.norm(features, pc.mask))
        x = gelu_tanh(self.spatial_conv(pc, pc, x, neigh, calibrate))
        x = self.linear_2(x)
        skip = self.skip_conv(features) if self.skip_conv is not None else features
        return self.skip_path(x, skip, drops)


class ResConvNeXt(nn.Module):
    """ConvNeXt-style block: conv -> norm -> linear (2C) -> GELU -> linear
    (C_out) -> skip."""

    def __init__(self, in_features: int, out_features: int, conv_factory, drop_prob: float = 0.0):
        super().__init__()
        self.spatial_conv = conv_factory.make(in_features, in_features)
        self.norm = MaskedBatchNorm(in_features)
        self.linear_1 = TorchLinear(in_features, in_features * 2)
        self.linear_2 = TorchLinear(in_features * 2, out_features)
        self.skip_conv = (
            TorchLinear(in_features, out_features) if in_features != out_features else None
        )
        self.skip_path = SkipConnection(out_features, drop_prob)

    def forward(self, pc: PointCloud, features, neigh: Neighborhood, calibrate: bool = False,
                drops: Optional[DropPathDraws] = None):
        x = self.spatial_conv(pc, pc, features, neigh, calibrate)
        x = self.linear_1(self.norm(x, pc.mask))
        x = self.linear_2(gelu_tanh(x))
        skip = self.skip_conv(features) if self.skip_conv is not None else features
        return self.skip_path(x, skip, drops)
