"""Weights from the JAX package (flax variable trees) into the port.

The port's point-cloud modules carry the flax names
(``encoder.patch_encoder.conv_0``, ``block_0_1``, ``proj_axes``, ``kernel``
...), so a flax path joined with dots is the port's ``state_dict`` key
(:func:`from_flax`).  ``MinkUNet34A`` holds ``torch.nn.Conv3d`` /
``ConvTranspose3d`` modules under names of its own, and flax numbers its
modules by creation order: :func:`minkunet_from_flax` maps one onto the
other and converts the kernels' layouts.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_flax", "minkunet_from_flax"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "."))
        else:
            flat[path] = value
    return flat


def from_flax(params: Mapping, batch_stats: Mapping, calib: Mapping) -> Dict[str, torch.Tensor]:
    """``(params, batch_stats, calib)`` numpy trees -> the port's state_dict.

    Load with ``model.load_state_dict(sd)`` (strict), which checks that
    every tensor of the model is given and no extra key is left over.
    """
    sd = {}
    for tree in (params, batch_stats, calib):
        for key, value in _flatten(tree).items():
            if key in sd:
                raise ValueError(f"duplicate key {key!r} across the flax collections")
            sd[key] = torch.from_numpy(np.array(value))
    return sd


def minkunet_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``MinkUNet34A``'s ``(params, batch_stats)`` -> the port's
    ``MinkUNet34A`` state_dict (load it strictly).

    A flax ``Conv`` kernel ``[kx, ky, kz, in, out]`` becomes ``[out, in, kx,
    ky, kz]``; a ``ConvTranspose`` kernel (flax's default
    ``transpose_kernel=False``: ``out[2i + a] = x[i] W[1 - a]``) is flipped
    in its three spatial axes and becomes ``[in, out, kx, ky, kz]``, as
    ``torch.nn.ConvTranspose3d`` computes ``x[i] W[a]``.  Flax names the
    modules by creation order: the stem (``Conv_0``, ``_MaskedBN_0``), each
    encoder level's down (``Conv_{1-4}``, ``_MaskedBN_{1-4}``) then its
    blocks, each decoder level's up (``ConvTranspose_{0-3}``,
    ``_MaskedBN_{5-8}``) then its blocks (``_BasicBlock_{0-22}`` in order),
    the head (``Conv_{5-7}``, ``_MaskedBN_9``).  Raises where a flax leaf is
    left over.
    """
    from ..models.minkunet import LAYERS

    flat_p, flat_s = _flatten(params), _flatten(batch_stats)
    used, sd = set(), {}

    def take(tree, key):
        used.add((id(tree), key))
        return np.asarray(tree[key])

    def conv(port: str, flax: str, transposed: bool = False) -> None:
        k = take(flat_p, f"{flax}.kernel")
        w = np.flip(k, (0, 1, 2)).transpose(3, 4, 0, 1, 2) if transposed else k.transpose(4, 3, 0, 1, 2)
        sd[f"{port}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        if f"{flax}.bias" in flat_p:
            sd[f"{port}.bias"] = torch.from_numpy(np.array(take(flat_p, f"{flax}.bias")))

    def bn(port: str, flax: str) -> None:
        for tree, names in ((flat_p, ("scale", "bias")), (flat_s, ("mean", "var"))):
            for name in names:
                sd[f"{port}.norm.{name}"] = torch.from_numpy(
                    np.array(take(tree, f"{flax}.MaskedBatchNorm_0.{name}")))

    conv("stem", "Conv_0")
    bn("stem_bn", "_MaskedBN_0")
    block = 0
    for s, n_blocks in enumerate(LAYERS):
        if s < 4:
            conv(f"downs.{s}.0", f"Conv_{s + 1}")
            bn(f"downs.{s}.1", f"_MaskedBN_{s + 1}")
        else:
            conv(f"ups.{s - 4}.0", f"ConvTranspose_{s - 4}", transposed=True)
            bn(f"ups.{s - 4}.1", f"_MaskedBN_{s + 1}")
        for i in range(n_blocks):
            port, flax = f"stages.{s}.{i}", f"_BasicBlock_{block}"
            conv(f"{port}.conv1", f"{flax}.Conv_0")
            bn(f"{port}.bn1", f"{flax}._MaskedBN_0")
            conv(f"{port}.conv2", f"{flax}.Conv_1")
            bn(f"{port}.bn2", f"{flax}._MaskedBN_1")
            if f"{flax}.Conv_2.kernel" in flat_p:
                conv(f"{port}.down.0", f"{flax}.Conv_2")
                bn(f"{port}.down.1", f"{flax}._MaskedBN_2")
            block += 1
    conv("head_final", "Conv_5")
    conv("head_hidden", "Conv_6")
    bn("head_bn", "_MaskedBN_9")
    conv("head_out", "Conv_7")
    left = [k for tree in (flat_p, flat_s) for k in tree if (id(tree), k) not in used]
    if left:
        raise ValueError(f"flax leaves without a MinkUNet34A counterpart: {left[:5]}")
    return sd
