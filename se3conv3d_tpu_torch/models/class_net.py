"""Classification network (counterpart of ``se3conv3d_tpu/models/class_net.py``):
encoder, pooling of the last level to one vector per cloud, BN and a linear
head; or, with ``spec.global_equiv_featurevector``, an equivariant feature
vector per point and frame of one extra hierarchy level."""
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

    With ``spec.global_equiv_featurevector`` the hierarchy carries one
    level past the trunk, and the net returns ``[B, M_extra, F, 2C]``
    instead of logits (C = ``num_features[-1]``): ``almost_last_norm`` over
    the last trunk level, a conv into the extra level whose kNN
    neighborhood holds every point of the trunk level (k = its capacity;
    ``global_conv_down``, C -> 2C), ``last_norm`` and ``last_linear``.
    There is no ``class_norm`` and no ``class_head`` then.

    On a points group (``parallel.mesh``) the hierarchy's levels are this
    rank's row slices: the pool reduces over the points row
    (``core.pointcloud.global_pool``), so every rank of the row gets the same
    logits; the extra level's one row belongs to the first slice (the others
    are empty), and its kNN reads the whole trunk level.
    """

    def __init__(self, spec: ModelSpec, num_in_feats: int, num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.encoder = Encoder(spec, num_in_feats)
        c = spec.num_features[-1]
        if spec.global_equiv_featurevector:
            self.almost_last_norm = MaskedBatchNorm(c)
            self.global_conv_down = spec.conv.make(c, 2 * c)
            self.last_norm = MaskedBatchNorm(2 * c)
            self.last_linear = TorchLinear(2 * c, 2 * c)
        else:
            self.class_norm = MaskedBatchNorm(c)
            self.class_head = TorchLinear(c, num_classes)
        init_parameters(self, generator)

    def forward(self, hierarchy: Hierarchy, features: torch.Tensor, *, calibrate: bool = False,
                drops: Optional[DropPathDraws] = None,
                provider: Optional[NeighborhoodProvider] = None) -> torch.Tensor:
        s = self.spec
        if provider is None:
            provider = NeighborhoodProvider(hierarchy, s, collect_trunc=calibrate)
        feats = self.encoder(hierarchy, features, provider, calibrate, drops)[-1]
        if s.global_equiv_featurevector:
            trunk = hierarchy.num_levels - 2
            pc, extra = hierarchy.levels[trunk], hierarchy.levels[trunk + 1]
            x = self.almost_last_norm(feats, pc.mask)
            neigh = provider.get(trunk, trunk + 1, 0.0, "knn", pc.source.capacity)
            x = self.global_conv_down(pc, extra, x, neigh, calibrate)
            return self.last_linear(self.last_norm(x, extra.mask))
        if feats.dim() == 4 and s.frame_pooling_method is not None:
            feats = frame_pool(feats, s.frame_pooling_method)
        x = global_pool(hierarchy.levels[-1], feats, s.pooling_method)  # [B, C]
        # on a points group every rank holds the pooled rows; the slice that
        # starts at row 0 counts them in class_norm's statistics
        rows = torch.full((x.shape[0], 1), hierarchy.levels[-1].start == 0, dtype=torch.bool,
                          device=x.device)
        x = self.class_norm(x[:, None, :], rows)[:, 0]
        return self.class_head(x)
