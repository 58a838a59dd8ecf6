"""Weights from the JAX package (flax variable trees) into the port.

The port's modules carry the flax names (``encoder.patch_encoder.conv_0``,
``block_0_1``, ``proj_axes``, ``kernel`` ...), so a flax path joined with
dots is the port's ``state_dict`` key.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_flax"]


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
