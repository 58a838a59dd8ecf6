"""Classification network (counterpart of ``se3conv3d_tpu/models/class_net.py``):
encoder, pooling of the last level to one vector per cloud, BN and a linear
head."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.hierarchy import Hierarchy
from ..core.pointcloud import frame_pool, global_pool
from ..nn.blocks import DropPathDraws, TorchLinear
from ..nn.norm import MaskedBatchNorm
from .encoder import Encoder
from .seg_unet import init_parameters
from .spec import ModelSpec, NeighborhoodProvider

__all__ = ["ClassNet"]


class ClassNet(nn.Module):
    """``model(hierarchy, features, *, calibrate=False, drops=None) -> [B,
    num_classes]`` logits.

    The last trunk level's features are pooled over their frames by
    ``spec.frame_pooling_method`` where it is set (an equivariant model's
    ``[B, N, F, C]``), then over the points of the last hierarchy level by
    ``spec.pooling_method`` (over points and frames jointly where no frame
    pooling is set); each pooled vector is one row of ``class_norm``.
    Submodule names follow the flax module, so a JAX ClassNet's variables
    load strictly through ``utils.weights.from_flax``.
    """

    def __init__(self, spec: ModelSpec, num_in_feats: int, num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spec.global_equiv_featurevector:
            raise NotImplementedError("ClassNet's global equivariant feature vector is not ported yet")
        self.spec = spec
        self.encoder = Encoder(spec, num_in_feats)
        self.class_norm = MaskedBatchNorm(spec.num_features[-1])
        self.class_head = TorchLinear(spec.num_features[-1], num_classes)
        init_parameters(self, generator)

    def forward(self, hierarchy: Hierarchy, features: torch.Tensor, *, calibrate: bool = False,
                drops: Optional[DropPathDraws] = None,
                provider: Optional[NeighborhoodProvider] = None) -> torch.Tensor:
        s = self.spec
        if provider is None:
            provider = NeighborhoodProvider(hierarchy, s, collect_trunc=calibrate)
        feats = self.encoder(hierarchy, features, provider, calibrate, drops)[-1]
        if feats.dim() == 4 and s.frame_pooling_method is not None:
            feats = frame_pool(feats, s.frame_pooling_method)
        x = global_pool(hierarchy.levels[-1], feats, s.pooling_method)  # [B, C]
        rows = torch.ones(x.shape[0], 1, dtype=torch.bool, device=x.device)
        x = self.class_norm(x[:, None, :], rows)[:, 0]
        return self.class_head(x)
