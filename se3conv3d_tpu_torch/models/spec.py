"""Static model configuration and the per-forward neighborhood provider
(counterpart of ``se3conv3d_tpu/models/spec.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.hierarchy import Hierarchy
from ..core.neighborhoods import (
    SUBSAMPLED_SPACING_FACTOR,
    Neighborhood,
    ball_query_neighborhood,
    knn_neighborhood,
)
from ..core.pointcloud import PointCloud
from ..kernels.fused_equiv import live_row_table
from ..nn.conv import ConvFactory
from ..ops import pne_conv as ops

__all__ = ["ModelSpec", "NeighborhoodProvider", "consumers"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Architecture hyperparameters of the segmentation U-Net and of the
    classification net.

    ``max_neighbors`` is the static cap of the padded ball-query tables
    (the reference's ball query is unbounded; the nearest ones are kept).
    ``block_layer`` names the encoder's residual block
    (``models.encoder.BLOCK_LAYERS``).  ``seg_head_feats`` is the width of
    the plain ``SegUNet``'s head.  ``pooling_method`` pools a
    classification net's last level over its points, after
    ``frame_pooling_method`` (if set) has pooled its frames;
    ``global_equiv_featurevector`` instead maps the last trunk level into
    one extra hierarchy level by an all-points conv (``ClassNet``).
    """

    conv: ConvFactory
    conv_blocks: Optional[ConvFactory] = None
    patch_num_levels: int = 1
    patch_num_features: Tuple[int, ...] = (8,)
    patch_neigh_type: str = "ball_query"
    patch_radius_scale: float = 2.0
    patch_num_knn: int = 16
    block_layer: str = "resnetformer"
    num_blocks: Tuple[int, ...] = (2, 2, 2, 2, 2)
    num_features: Tuple[int, ...] = (64, 128, 192, 256, 320)
    neigh_type: str = "ball_query"
    radius_scale: float = 2.0
    num_knn: int = 16
    radius_scale_blocks: float = 2.0
    num_knn_blocks: int = 16
    radius_scale_dec: float = 1.5
    num_knn_dec: int = 16
    fpn_dec_feats: int = 128
    num_hidden_seg_head: int = 0
    seg_head_feats: int = 128
    max_path_drop: float = 0.2
    max_path_dec_drop: float = 0.0
    pooling_method: str = "avg"
    frame_pooling_method: Optional[str] = None
    global_equiv_featurevector: bool = False
    max_neighbors: int = 24

    @property
    def equivariant(self) -> bool:
        """Whether the convs are the equivariant ones (frames per point)."""
        return self.conv.equivariant

    def __post_init__(self):
        if self.conv_blocks is None:
            object.__setattr__(self, "conv_blocks", self.conv)
        if len(self.patch_num_features) != self.patch_num_levels:
            raise ValueError("patch_num_features must have patch_num_levels entries")
        if len(self.num_blocks) != len(self.num_features):
            raise ValueError("num_blocks and num_features must align")


def consumers(spec: ModelSpec, self_neighborhood: bool) -> tuple:
    """The conv factories whose convs read a neighborhood, the leading one
    first, as ``se3conv3d_tpu/models/spec.py`` lists them: a self
    neighborhood feeds the block stack (``conv_blocks``) and the patch
    stem's self conv (``conv``), a cross-level one ``conv`` convs only."""
    return (spec.conv_blocks, spec.conv) if self_neighborhood else (spec.conv,)


class NeighborhoodProvider:
    """Neighborhood cache over one hierarchy for one forward.

    ``get(src, dst, radius, neigh_type, k)`` builds the table from level
    ``src`` to level ``dst`` once per key and attaches the layer-independent
    edge geometry that every conv on it shares -- the reference's rot-tensor
    cache -- as each of its consumers (:func:`consumers`) reads it, decided
    from :func:`~se3conv3d_tpu_torch.nn.conv.fused_dispatch` of each factory
    as ``se3conv3d_tpu/models/spec.py:_attach_equiv_geometry`` decides it:

    * equivariant kernel-path convs: ``equiv_rel`` / ``equiv_rot`` (6D), in
      the operand dtype of the leading such consumer (bfloat16 halves it for
      a bfloat16 spec);
    * equivariant plain-path convs: ``plain_rel`` / ``plain_rot``, float32,
      in the leading such consumer's ``rel_rot_type``;
    * standard convs: the raw offsets ``std_rel``, in the leading consumer's
      operand dtype where it is a kernel-path mlp conv, else float32 (the
      kernel-point weights and the plain path are computed from float32
      offsets; the JAX package gathers those per conv, the cache computes
      the same function).

    A conv that the payload does not serve (the other dtype or
    representation) rebuilds its own, with a warning.  Every neighborhood
    also gets the live-row table its convs' forwards and backwards walk
    (``live_rows``; one host synchronisation per neighborhood, whatever the
    grad mode).  In the 'sorted' backward mode, with autograd on, a self
    neighborhood (``src == dst``: the block stack's) also gets the sort
    tables its convs' backwards share; a single-use one builds them in its
    conv (``ops.pne_conv``), as in the JAX package.

    On a points group the hierarchy's levels are this rank's row slices
    (``core.hierarchy.Hierarchy.row_slices``): a table is searched for the
    destination's rows of this rank against the whole source level
    (``PointCloud.source``): its indices and sort tables address the whole
    source level, its edge geometry and live-row table this rank's rows.
    """

    def __init__(self, hierarchy: Hierarchy, spec: ModelSpec, collect_trunc: bool = False):
        self.hierarchy = hierarchy
        self.spec = spec
        self.collect_trunc = collect_trunc
        self._cache: Dict[tuple, Neighborhood] = {}

    def _build(self, src_pc: PointCloud, dst_pc: PointCloud, radius: float,
               neigh_type: str, k: int, spacing: Optional[float], facs: tuple) -> Neighborhood:
        if neigh_type == "ball_query":
            neigh = ball_query_neighborhood(
                src_pc, dst_pc, radius, self.spec.max_neighbors, want_trunc=self.collect_trunc
            )
        elif neigh_type == "knn":
            neigh = knn_neighborhood(
                src_pc, dst_pc, k,
                grid_cell_size=None if spacing is None else SUBSAMPLED_SPACING_FACTOR * spacing,
            )
        else:
            raise ValueError(f"unknown neighborhood type {neigh_type!r}")
        geometry = {}
        if self.spec.equivariant:
            kernel = [fac for fac in facs if fac.fused]
            plain = [fac for fac in facs if not fac.fused]
            if kernel:
                geometry["equiv_rel"], geometry["equiv_rot"] = ops.equiv_geometry_parts(
                    src_pc, dst_pc, neigh, ops.geometry_dtype(kernel[0].compute_dtype))
            if plain:
                geometry["plain_rel"], geometry["plain_rot"] = ops.equiv_geometry_parts(
                    src_pc, dst_pc, neigh, None, plain[0].rel_rot_type)
        else:
            lead = facs[0]
            dtype = (ops.geometry_dtype(lead.compute_dtype) if lead.fused and "mlp" in lead.pne_type
                     else torch.float32)
            geometry["std_rel"] = ops.std_geometry(src_pc, dst_pc, neigh, dtype)
        return dataclasses.replace(neigh, **geometry, live_rows=live_row_table(neigh.mask))

    def get(self, src: int, dst: int, radius: float, neigh_type: str, k: int) -> Neighborhood:
        key = (src, dst, round(float(radius), 9), neigh_type, k)
        if key not in self._cache:
            src_pc = self.hierarchy.levels[src].source
            neigh = self._build(src_pc, self.hierarchy.levels[dst], radius, neigh_type, k,
                                self.hierarchy.levels_radii[src], consumers(self.spec, src == dst))
            if src == dst and ops.sorted_backward() and torch.is_grad_enabled():
                neigh = ops.backward_sort_tables(neigh, src_pc.capacity)
            self._cache[key] = neigh
        return self._cache[key]

    def to_cloud(self, src: int, dst_pc: PointCloud, radius: float, neigh_type: str,
                 k: int) -> Neighborhood:
        """Neighborhood from a hierarchy level to an external cloud (the
        segmentation output cloud)."""
        return self._build(
            self.hierarchy.levels[src].source, dst_pc, radius, neigh_type, k,
            self.hierarchy.levels_radii[src], consumers(self.spec, self_neighborhood=False),
        )
