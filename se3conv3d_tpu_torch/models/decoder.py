"""Decoder, PatchDecoder and FPNDecoder (counterparts of
``se3conv3d_tpu/models/decoder.py``)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..core.hierarchy import Hierarchy
from ..nn.blocks import DropPathDraws, SkipConnection, TorchLinear, gelu_tanh
from ..nn.norm import MaskedBatchNorm
from .spec import ModelSpec, NeighborhoodProvider

__all__ = ["Decoder", "PatchDecoder", "FPNDecoder"]


class Decoder(nn.Module):
    """Top-down pathway: per level norm -> conv (level -> level-1) ->
    SkipConnection with the encoder's skip features; returns the features
    deepest first."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        feats = spec.num_features
        n_steps = len(feats) - 1
        drop_paths = np.linspace(spec.max_path_dec_drop, 0.0, max(n_steps, 1))
        for it in range(n_steps):
            lvl_feats, dst_feats = feats[n_steps - it], feats[n_steps - it - 1]
            self.add_module(f"norm_{it}", MaskedBatchNorm(lvl_feats))
            self.add_module(f"conv_{it}", spec.conv.make(lvl_feats, dst_feats))
            self.add_module(
                f"skip_{it}", SkipConnection(dst_feats, float(drop_paths[n_steps - 1 - it]))
            )

    def forward(self, hierarchy: Hierarchy, enc_feats: List[torch.Tensor],
                provider: NeighborhoodProvider, calibrate: bool = False,
                drops: Optional[DropPathDraws] = None):
        s = self.spec
        radii = hierarchy.levels_radii
        n_steps = len(s.num_features) - 1
        last_level = hierarchy.num_levels - 1
        enc_rev = list(reversed(enc_feats))
        x = enc_rev[0]
        out = [x]
        for it in range(n_steps):
            cur = last_level - it
            x = getattr(self, f"norm_{it}")(x, hierarchy.levels[cur].mask)
            neigh = provider.get(cur, cur - 1, s.radius_scale_dec * radii[cur],
                                 s.neigh_type, s.num_knn_dec)
            x = getattr(self, f"conv_{it}")(
                hierarchy.levels[cur], hierarchy.levels[cur - 1], x, neigh, calibrate
            )
            x = getattr(self, f"skip_{it}")(x, enc_rev[it + 1], drops)
            out.append(x)
        return out


class PatchDecoder(nn.Module):
    """Per patch level: conv (lvl+1 -> lvl) + BN + GELU."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        for lvl in range(spec.patch_num_levels):
            self.add_module(f"conv_{lvl}", spec.conv.make(spec.fpn_dec_feats, spec.fpn_dec_feats))
            self.add_module(f"norm_{lvl}", MaskedBatchNorm(spec.fpn_dec_feats))

    def forward(self, hierarchy: Hierarchy, x, provider: NeighborhoodProvider,
                calibrate: bool = False):
        s = self.spec
        radii = hierarchy.levels_radii
        for lvl in reversed(range(s.patch_num_levels)):
            neigh = provider.get(lvl + 1, lvl, s.radius_scale_dec * radii[lvl + 1],
                                 s.neigh_type, s.num_knn_dec)
            x = getattr(self, f"conv_{lvl}")(
                hierarchy.levels[lvl + 1], hierarchy.levels[lvl], x, neigh, calibrate
            )
            x = gelu_tanh(getattr(self, f"norm_{lvl}")(x, hierarchy.levels[lvl].mask))
        return x


class FPNDecoder(nn.Module):
    """Decoder + FPN lateral sums + patch upsample."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        s = spec
        self.decoder = Decoder(s)
        self.linear_out = TorchLinear(s.num_features[0], s.fpn_dec_feats)
        self.norm_out = MaskedBatchNorm(s.fpn_dec_feats)
        rev_feats = list(reversed(s.num_features[1:]))
        for it in range(len(s.num_features) - 1):
            self.add_module(f"norm_a_{it}", MaskedBatchNorm(rev_feats[it]))
            self.add_module(f"linear_{it}", TorchLinear(rev_feats[it], s.fpn_dec_feats))
            self.add_module(f"conv_{it}", s.conv.make(s.fpn_dec_feats, s.fpn_dec_feats))
            self.add_module(f"norm_b_{it}", MaskedBatchNorm(s.fpn_dec_feats))
        self.patch_decoder = PatchDecoder(s) if s.patch_num_levels > 0 else None

    def forward(self, hierarchy: Hierarchy, enc_feats: List[torch.Tensor],
                provider: NeighborhoodProvider, calibrate: bool = False,
                drops: Optional[DropPathDraws] = None):
        s = self.spec
        radii = hierarchy.levels_radii
        dec = self.decoder(hierarchy, enc_feats, provider, calibrate, drops)
        last_level = hierarchy.num_levels - 1
        dest = last_level - len(enc_feats) + 1
        dest_pc = hierarchy.levels[dest]
        x = self.norm_out(self.linear_out(dec[-1]), dest_pc.mask)
        for it in range(len(s.num_features) - 1):
            cur = last_level - it
            y = getattr(self, f"norm_a_{it}")(dec[it], hierarchy.levels[cur].mask)
            y = getattr(self, f"linear_{it}")(y)
            neigh = provider.get(cur, dest, s.radius_scale_dec * radii[cur],
                                 s.neigh_type, s.num_knn_dec)
            y = getattr(self, f"conv_{it}")(hierarchy.levels[cur], dest_pc, y, neigh, calibrate)
            x = x + getattr(self, f"norm_b_{it}")(y, dest_pc.mask)
        if self.patch_decoder is not None:
            x = self.patch_decoder(hierarchy, x, provider, calibrate)
        return x
