"""Segmentation U-Nets (counterpart of ``se3conv3d_tpu/models/seg_unet.py``):
``FPNSegUNet`` (encoder + FPN decoder + segmentation head) and the plain
``SegUNet`` (encoder + top-down decoder + head); an equivariant model's
logits are averaged over the output cloud's frames."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.hierarchy import Hierarchy
from ..core.pointcloud import PointCloud, frame_pool
from ..nn.blocks import DropPathDraws, TorchLinear, gelu_tanh
from ..nn.norm import MaskedBatchNorm
from .decoder import Decoder, FPNDecoder
from .encoder import Encoder
from .spec import ModelSpec, NeighborhoodProvider

__all__ = ["FPNSegUNet", "SegUNet", "init_parameters"]


def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Seeded init of every submodule that defines ``reset_parameters``,
    in module order."""
    for sub in module.modules():
        if sub is not module and hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator)


class FPNSegUNet(nn.Module):
    """``model(hierarchy, features, out_pc, calibrate=False, drops=None) ->
    [B, M, num_classes]`` logits: the level-0 features are ``[B, N0, F, C]``
    for an equivariant spec (the logits frame-averaged) and ``[B, N0, C]``
    for a standard one.

    ``model.train()`` selects batch statistics in every BN and stochastic
    depth in every block; the DropPath keep masks then come from ``drops``.
    The head is ``seg_conv``, then ``spec.num_hidden_seg_head`` times BN ->
    GELU -> linear (``seg_hidden_norm_{i}``, ``seg_hidden_linear_{i}``),
    then BN -> GELU -> ``seg_linear``.
    """

    def __init__(self, spec: ModelSpec, num_in_feats: int, num_classes: int,
                 frame_pooling: str = "avg", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.frame_pooling = frame_pooling
        self.encoder = Encoder(spec, num_in_feats)
        self.fpn_decoder = FPNDecoder(spec)
        self.seg_conv = spec.conv.make(spec.fpn_dec_feats, spec.fpn_dec_feats)
        for i in range(spec.num_hidden_seg_head):
            self.add_module(f"seg_hidden_norm_{i}", MaskedBatchNorm(spec.fpn_dec_feats))
            self.add_module(f"seg_hidden_linear_{i}",
                            TorchLinear(spec.fpn_dec_feats, spec.fpn_dec_feats))
        self.seg_norm = MaskedBatchNorm(spec.fpn_dec_feats)
        self.seg_linear = TorchLinear(spec.fpn_dec_feats, num_classes)
        init_parameters(self, generator)

    def forward(self, hierarchy: Hierarchy, features: torch.Tensor, out_pc: PointCloud,
                calibrate: bool = False, drops: Optional[DropPathDraws] = None,
                provider: Optional[NeighborhoodProvider] = None) -> torch.Tensor:
        """``provider``: the neighborhood cache of ``hierarchy`` to read (a
        checkpoint ensemble shares one); by default a new one."""
        s = self.spec
        if provider is None:
            provider = NeighborhoodProvider(hierarchy, s, collect_trunc=calibrate)
        enc = self.encoder(hierarchy, features, provider, calibrate, drops)
        x = self.fpn_decoder(hierarchy, enc, provider, calibrate, drops)
        neigh_out = provider.to_cloud(
            0, out_pc, s.radius_scale * hierarchy.levels_radii[0], s.neigh_type, s.num_knn
        )
        x = self.seg_conv(hierarchy.levels[0], out_pc, x, neigh_out, calibrate)
        for i in range(s.num_hidden_seg_head):
            x = gelu_tanh(getattr(self, f"seg_hidden_norm_{i}")(x, out_pc.mask))
            x = getattr(self, f"seg_hidden_linear_{i}")(x)
        x = gelu_tanh(self.seg_norm(x, out_pc.mask))
        x = self.seg_linear(x)
        return frame_pool(x, self.frame_pooling) if s.equivariant else x


class SegUNet(nn.Module):
    """The plain (non-FPN) segmentation U-Net, called as :class:`FPNSegUNet`:
    encoder, top-down ``Decoder``, then the head on the finest trunk level
    ``P = spec.patch_num_levels``: BN (``seg_norm_1``) -> conv to the output
    cloud (``seg_conv``, ``num_features[0] -> seg_head_feats``) -> BN
    (``seg_norm_2``) -> GELU -> ``seg_linear``."""

    def __init__(self, spec: ModelSpec, num_in_feats: int, num_classes: int,
                 frame_pooling: str = "avg", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.frame_pooling = frame_pooling
        self.encoder = Encoder(spec, num_in_feats)
        self.decoder = Decoder(spec)
        self.seg_norm_1 = MaskedBatchNorm(spec.num_features[0])
        self.seg_conv = spec.conv.make(spec.num_features[0], spec.seg_head_feats)
        self.seg_norm_2 = MaskedBatchNorm(spec.seg_head_feats)
        self.seg_linear = TorchLinear(spec.seg_head_feats, num_classes)
        init_parameters(self, generator)

    def forward(self, hierarchy: Hierarchy, features: torch.Tensor, out_pc: PointCloud,
                calibrate: bool = False, drops: Optional[DropPathDraws] = None,
                provider: Optional[NeighborhoodProvider] = None) -> torch.Tensor:
        s = self.spec
        if provider is None:
            provider = NeighborhoodProvider(hierarchy, s, collect_trunc=calibrate)
        enc = self.encoder(hierarchy, features, provider, calibrate, drops)
        x = self.decoder(hierarchy, enc, provider, calibrate, drops)[-1]
        p = s.patch_num_levels
        x = self.seg_norm_1(x, hierarchy.levels[p].mask)
        neigh_out = provider.to_cloud(
            p, out_pc, s.radius_scale * hierarchy.levels_radii[p], s.neigh_type, s.num_knn
        )
        x = self.seg_conv(hierarchy.levels[p], out_pc, x, neigh_out, calibrate)
        x = gelu_tanh(self.seg_norm_2(x, out_pc.mask))
        x = self.seg_linear(x)
        return frame_pool(x, self.frame_pooling) if s.equivariant else x
