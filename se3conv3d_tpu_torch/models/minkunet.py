"""Dense-voxel MinkUNet34A baseline (counterpart of
``se3conv3d_tpu/models/minkunet.py``).

The reference's optional MinkowskiEngine U-Net (``models/MinkUNet.py``:
BasicBlock, ``LAYERS`` (2, 3, 4, 6, 2, 2, 2, 2), ``PLANES`` (32, 64, 128,
256, 256, 128, 96, 96, 96), ``INIT_DIM`` 32, a k = 5 stem, k = 2 / s = 2
downs and ups, skip concats, a 1x1 head) as the JAX package has it: a dense
U-Net on a static ``[B, X, Y, Z]`` grid.  Features are scatter-averaged into
their voxels (:func:`voxelize`, ``index_add_``), activations are masked by
the (max-pooled) occupancy after every stage, batch norms take the
statistics of the occupied voxels only (the port's ``MaskedBatchNorm`` over
the flattened grid), and the logits are gathered back per point
(:func:`devoxelize`).  Points outside the grid are clamped to its boundary
voxels; masked points go to a trash voxel past it.

The 3D convs are cuDNN's ``conv3d`` / ``conv_transpose3d`` (the JAX package
runs XLA's ``conv_general_dilated``, no Pallas kernel).  The activations
are ``[B, C, X, Y, Z]`` tensors in ``channels_last_3d`` memory, so the
norms' ``[B, voxels, C]`` view costs no copy.  Weights carry the torch
layouts; ``utils.weights.minkunet_from_flax`` converts a JAX model's
(``[out, in, kx, ky, kz]`` from flax's ``[kx, ky, kz, in, out]``; the
transposed convs flipped in space as well, since flax's ``ConvTranspose``
with its default ``transpose_kernel=False`` computes
``out[2i + a] = x[i] W[1 - a]`` where torch's computes ``x[i] W[a]``).
On the card, the default ``torch.backends.cudnn.allow_tf32 = True`` rounds
the conv operands to TF32: a comparison with the CPU turns it off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.norm import MaskedBatchNorm

__all__ = ["MinkUNet34A", "voxelize", "devoxelize", "LAYERS", "PLANES", "INIT_DIM"]

LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
PLANES = (32, 64, 128, 256, 256, 128, 96, 96, 96)
INIT_DIM = 32


def voxelize(positions: torch.Tensor, mask: torch.Tensor, features: torch.Tensor, cell: float,
             dims: Tuple[int, int, int]) -> tuple:
    """Scatter-mean ``features [B, N, C]`` onto a dense grid.

    The origin of each example is the minimum of its valid points; a point's
    voxel is ``floor((p - origin) / cell)``, clamped into ``dims``.  Returns
    ``(grid [B, X, Y, Z, C], occ [B, X, Y, Z] bool, flat_idx [B, N] int64)``:
    each point's voxel (0 for a masked point), for :func:`devoxelize`.
    """
    b, n, c = features.shape
    big = torch.finfo(positions.dtype).max
    origin = torch.where(mask[..., None], positions, torch.full_like(positions, big)).amin(1, keepdim=True)
    coords = torch.floor((positions - origin) / cell).to(torch.int32)
    coords = torch.minimum(coords.clamp(min=0), torch.tensor(dims, dtype=torch.int32, device=coords.device) - 1)
    coords = coords.long()
    flat = (coords[..., 0] * dims[1] + coords[..., 1]) * dims[2] + coords[..., 2]
    nvox = dims[0] * dims[1] * dims[2]
    flat = torch.where(mask, flat, torch.full_like(flat, nvox))  # the trash voxel
    rows = (flat + torch.arange(b, device=flat.device)[:, None] * (nvox + 1)).reshape(-1)
    sums = torch.zeros(b * (nvox + 1), c, dtype=features.dtype, device=features.device)
    sums.index_add_(0, rows, features.reshape(-1, c))
    cnt = torch.zeros(b * (nvox + 1), dtype=torch.float32, device=features.device)
    cnt.index_add_(0, rows, torch.ones(rows.shape, dtype=torch.float32, device=features.device))
    mean = (sums / cnt.clamp(min=1.0)[:, None]).reshape(b, nvox + 1, c)[:, :-1]
    occ = (cnt > 0).reshape(b, nvox + 1)[:, :-1]
    return mean.reshape(b, *dims, c), occ.reshape(b, *dims), torch.where(mask, flat, torch.zeros_like(flat))


def devoxelize(grid: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Each point's row of ``grid [B, X, Y, Z, C]`` at ``flat_idx [B, N]``."""
    b, c = grid.shape[0], grid.shape[-1]
    return torch.gather(grid.reshape(b, -1, c), 1, flat_idx[..., None].expand(-1, -1, c))


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = False) -> nn.Conv3d:
    """flax ``Conv(padding="SAME")``: at stride 1 an odd kernel pads
    ``kernel // 2``; k = s = 2 on an even extent pads nothing."""
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=kernel // 2 if stride == 1 else 0,
                     bias=bias)


class _MaskedBN(nn.Module):
    """BatchNorm over the occupied voxels only (Minkowski's BN normalises
    over its sparse sites)."""

    def __init__(self, features: int):
        super().__init__()
        self.norm = MaskedBatchNorm(features)

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        rows = x.permute(0, 2, 3, 4, 1).reshape(b, -1, c)  # a view in channels_last_3d
        out = self.norm(rows, occ.reshape(b, -1))
        return out.reshape(b, *x.shape[2:], c).permute(0, 4, 1, 2, 3)


def _pool_occ(occ: torch.Tensor) -> torch.Tensor:
    """Occupancy of the 2x-downsampled grid: any occupied child."""
    return F.max_pool3d(occ[:, None].float(), 2, 2)[:, 0] > 0


def _masked(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    return x * occ[:, None].to(x.dtype)


class _BasicBlock(nn.Module):
    """ResNet BasicBlock (reference ``MinkUNet.py:33-85``)."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3), _MaskedBN(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _MaskedBN(planes)
        self.down = None
        if cin != planes:
            self.down = nn.Sequential(_conv(cin, planes, 1), _MaskedBN(planes))

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), occ))
        out = self.bn2(self.conv2(out), occ)
        residual = x if self.down is None else self.down[1](self.down[0](x), occ)
        return _masked(F.relu(out + residual), occ)


class MinkUNet34A(nn.Module):
    """Dense-voxel MinkUNet34A (reference ``MinkUNet.py:440-441``).

    Call: ``model(positions [B, N, 3], mask [B, N], features [B, N, C]) ->
    logits [B, N, num_classes]``; train mode (``model.train()``) takes the
    batch statistics.  ``grid_dims`` must be multiples of 16 (four
    halvings, each of an even extent, as the skip concats need).
    """

    def __init__(self, num_classes: int, in_features: int, cell: float = 0.1,
                 grid_dims: Tuple[int, int, int] = (96, 48, 96),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if any(d % 16 for d in grid_dims):
            raise ValueError(f"grid_dims {grid_dims}: each must be a multiple of 16")
        self.num_classes, self.cell, self.grid_dims = num_classes, cell, tuple(grid_dims)
        self.stem, self.stem_bn = _conv(in_features, INIT_DIM, 5), _MaskedBN(INIT_DIM)
        down_in = (INIT_DIM, PLANES[0], PLANES[1], PLANES[2])
        self.downs = nn.ModuleList(nn.ModuleList([_conv(c, c, 2, stride=2), _MaskedBN(c)]) for c in down_in)
        # stage s takes the down's output (encoder) or the up's concat (decoder)
        stage_in = (INIT_DIM, PLANES[0], PLANES[1], PLANES[2],
                    PLANES[4] + PLANES[2], PLANES[5] + PLANES[1], PLANES[6] + PLANES[0],
                    PLANES[7] + INIT_DIM)
        self.stages = nn.ModuleList(
            nn.ModuleList(_BasicBlock(cin if i == 0 else PLANES[s], PLANES[s]) for i in range(LAYERS[s]))
            for s, cin in enumerate(stage_in))
        up_in = (PLANES[3], PLANES[4], PLANES[5], PLANES[6])
        self.ups = nn.ModuleList(
            nn.ModuleList([nn.ConvTranspose3d(cin, PLANES[4 + i], 2, stride=2, bias=False),
                           _MaskedBN(PLANES[4 + i])]) for i, cin in enumerate(up_in))
        self.head_final = _conv(PLANES[7], PLANES[8], 1, bias=True)
        self.head_hidden, self.head_bn = _conv(PLANES[8], PLANES[8], 1), _MaskedBN(PLANES[8])
        # no bias: the reference's out_pred_2 (MinkUNet.py:248-252)
        self.head_out = _conv(PLANES[8], num_classes, 1)
        self.to(memory_format=torch.channels_last_3d)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers: LeCun-normal conv kernels (fan-in
        ``in * k^3``; a transposed conv's fan-in is its input channels times
        ``k^3``), zero biases."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
                    w = mod.weight
                    cin = w.shape[1] if isinstance(mod, nn.Conv3d) else w.shape[0]
                    fan_in = cin * w.shape[2] * w.shape[3] * w.shape[4]
                    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # truncated at 2 sigma
                    t = torch.empty(w.shape, dtype=w.dtype)
                    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
                    w.copy_(t * std)
                    if mod.bias is not None:
                        mod.bias.zero_()

    def _stage(self, s: int, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        for block in self.stages[s]:
            x = block(x, occ)
        return x

    def forward(self, positions: torch.Tensor, mask: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        grid, occ0, flat_idx = voxelize(positions, mask, features, self.cell, self.grid_dims)
        x = grid.permute(0, 4, 1, 2, 3)  # [B, C, X, Y, Z], channels_last_3d
        out_p1 = _masked(F.relu(self.stem_bn(self.stem(x), occ0)), occ0)

        skips, occs, x = [out_p1], [occ0], out_p1
        for s, (conv, bn) in enumerate(self.downs):
            occ = _pool_occ(occs[-1])
            x = _masked(F.relu(bn(conv(x), occ)), occ)
            x = self._stage(s, x, occ)
            skips.append(x)
            occs.append(occ)
        # decoder: up to the level above, concat its skip, blocks
        for i, (conv, bn) in enumerate(self.ups):
            occ = occs[3 - i]
            x = _masked(F.relu(bn(conv(x), occ)), occ)
            x = self._stage(4 + i, torch.cat([x, skips[3 - i]], 1), occ)

        x = self.head_final(x)
        h = F.relu(self.head_bn(self.head_hidden(x), occ0))
        logits = self.head_out(h).permute(0, 2, 3, 4, 1)  # [B, X, Y, Z, classes]
        return devoxelize(logits, flat_idx)
