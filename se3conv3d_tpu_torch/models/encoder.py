"""Patch encoder and encoder trunk (counterpart of
``se3conv3d_tpu/models/encoder.py``).  Hierarchy levels are indexed as in
the reference: patch levels 0..P, trunk levels P..P+L-1."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..core.hierarchy import Hierarchy
from ..nn.blocks import DropPathDraws, ResConvNeXt, ResNetB, ResNetFormer, TorchLinear, gelu_tanh
from ..nn.norm import MaskedBatchNorm
from .spec import ModelSpec, NeighborhoodProvider

__all__ = ["PatchEncoder", "Encoder", "BLOCK_LAYERS"]

BLOCK_LAYERS = {
    "resnetformer": ResNetFormer,
    "resnetb": ResNetB,
    "resconvnext": ResConvNeXt,
}


class PatchEncoder(nn.Module):
    """Per patch level: conv (lvl -> lvl+1) and conv (lvl+1 -> lvl+1), each
    followed by BN + GELU; then linear + BN."""

    def __init__(self, spec: ModelSpec, num_in_feats: int):
        super().__init__()
        self.spec = spec
        s = spec
        for lvl in range(s.patch_num_levels):
            feats = s.patch_num_features[lvl]
            in_feats = num_in_feats if lvl == 0 else s.patch_num_features[lvl - 1]
            self.add_module(f"conv_{2 * lvl}", s.conv.make(in_feats, feats))
            self.add_module(f"norm_{2 * lvl}", MaskedBatchNorm(feats))
            self.add_module(f"conv_{2 * lvl + 1}", s.conv.make(feats, feats))
            self.add_module(f"norm_{2 * lvl + 1}", MaskedBatchNorm(feats))
        last = s.patch_num_features[-1] if s.patch_num_levels else num_in_feats
        self.linear = TorchLinear(last, s.num_features[0])
        self.norm_out = MaskedBatchNorm(s.num_features[0])

    def forward(self, hierarchy: Hierarchy, features, provider: NeighborhoodProvider,
                calibrate: bool = False) -> torch.Tensor:
        s = self.spec
        radii = hierarchy.levels_radii
        x = features
        for lvl in range(s.patch_num_levels):
            nxt = hierarchy.levels[lvl + 1]
            neigh = provider.get(lvl, lvl + 1, s.patch_radius_scale * radii[lvl],
                                 s.patch_neigh_type, s.patch_num_knn)
            x = getattr(self, f"conv_{2 * lvl}")(hierarchy.levels[lvl], nxt, x, neigh, calibrate)
            x = gelu_tanh(getattr(self, f"norm_{2 * lvl}")(x, nxt.mask))
            neigh = provider.get(lvl + 1, lvl + 1, s.patch_radius_scale * radii[lvl + 1],
                                 s.patch_neigh_type, s.patch_num_knn)
            x = getattr(self, f"conv_{2 * lvl + 1}")(nxt, nxt, x, neigh, calibrate)
            x = gelu_tanh(getattr(self, f"norm_{2 * lvl + 1}")(x, nxt.mask))
        x = self.linear(x)
        return self.norm_out(x, hierarchy.levels[s.patch_num_levels].mask)


class Encoder(nn.Module):
    """Patch stem + per-level stacks of ``spec.block_layer`` blocks
    (:data:`BLOCK_LAYERS`) with down-convs between levels; returns the
    per-level features, finest trunk level first."""

    def __init__(self, spec: ModelSpec, num_in_feats: int):
        super().__init__()
        self.spec = spec
        s = spec
        self.patch_encoder = PatchEncoder(s, num_in_feats)
        block_cls = BLOCK_LAYERS[s.block_layer]
        drop_paths = np.linspace(0.0, s.max_path_drop, int(np.sum(s.num_blocks)))
        block_id = 0
        for lvl, feats in enumerate(s.num_features):
            for i in range(s.num_blocks[lvl]):
                self.add_module(
                    f"block_{lvl}_{i}",
                    block_cls(feats, feats, s.conv_blocks, float(drop_paths[block_id])),
                )
                block_id += 1
            if lvl < len(s.num_features) - 1:
                self.add_module(f"down_norm_{lvl}", MaskedBatchNorm(feats))
                self.add_module(f"down_conv_{lvl}", s.conv.make(feats, s.num_features[lvl + 1]))

    def forward(self, hierarchy: Hierarchy, features, provider: NeighborhoodProvider,
                calibrate: bool = False,
                drops: Optional[DropPathDraws] = None) -> List[torch.Tensor]:
        s = self.spec
        radii = hierarchy.levels_radii
        p = s.patch_num_levels
        x = self.patch_encoder(hierarchy, features, provider, calibrate)
        out_feats = []
        for lvl in range(len(s.num_features)):
            h_lvl = lvl + p
            pc = hierarchy.levels[h_lvl]
            neigh = provider.get(h_lvl, h_lvl, s.radius_scale_blocks * radii[h_lvl],
                                 s.neigh_type, s.num_knn_blocks)
            for i in range(s.num_blocks[lvl]):
                x = getattr(self, f"block_{lvl}_{i}")(pc, x, neigh, calibrate, drops)
            out_feats.append(x)
            if lvl < len(s.num_features) - 1:
                x = getattr(self, f"down_norm_{lvl}")(x, pc.mask)
                neigh_down = provider.get(h_lvl, h_lvl + 1, s.radius_scale * radii[h_lvl],
                                          s.neigh_type, s.num_knn)
                x = getattr(self, f"down_conv_{lvl}")(
                    pc, hierarchy.levels[h_lvl + 1], x, neigh_down, calibrate
                )
        return out_feats
