"""DFaust model presets and the pinned recipe (counterpart of
``se3conv3d_tpu/models/presets.py`` for the FAUST seg models).

``DFAUST_I_ROT_PCA_2F_MODEL`` and ``DFAUST_I_ROT_PCA_2F_TRAINING`` are the
``Model`` and ``Training`` sections of ``configs/dfaust/dfaust_I_rot_pca_2F.yaml``
as Python dicts, so the card needs no YAML reader; a test holds them equal
to the file.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..core.hierarchy import FrameConfig, HierarchyConfig
from ..nn.conv import ConvFactory
from .spec import ModelSpec

__all__ = [
    "SEG_PRESETS",
    "DFAUST_I_ROT_PCA_2F_MODEL",
    "DFAUST_I_ROT_PCA_2F_TRAINING",
    "DFAUST_NUM_POINTS",
    "DFAUST_NUM_CLASSES",
    "get_model_spec",
    "spec_from_model_dict",
    "hierarchy_config_from_model_dict",
]

DFAUST_I_ROT_PCA_2F_MODEL: Dict[str, Any] = {
    "model": "FPNSegUNetMLPGeluRotEqFAUST",
    "max_drop_path": 0.5,
    "init_subsample": 0.04,
    "output_subsample": 0.04,
    "grid_subsamples": [0.05, 0.1, 0.2, 0.4],
    "capacities": [4096, 2048, 1024, 512, 128],
    "out_capacity": 4096,
    "max_neighbors": 32,
    "RefFrames": {
        "pca": True,
        "neigh_method": "knn",
        "neigh_kwargs": {"neigh_k": 16},
        "fixed_axis": False,
        "train_n_frames": 2,
        "test_n_frames": 2,
    },
}
DFAUST_I_ROT_PCA_2F_TRAINING: Dict[str, Any] = {
    "log_folder": "./logs/dfaust_RotEq_I_OOD_2F",
    "num_epochs": 150,
    "batch_size": 32,
    "weight_decay": 0.0001,
    "max_lr": 0.005,
    "pct_start": 0.05,
    "div_factor": 10.0,
    "final_div_factor": 1000.0,
    "clip_grads": 100.0,
    "label_smoothing": 0.2,
    "save_models_frequency": 50,
    "val_freq": 5,
}
DFAUST_NUM_POINTS = 4096   # Dataset.num_points of the recipe
DFAUST_NUM_CLASSES = 20    # DFaust body-part labels


def _faust_spec(equivariant: bool) -> ModelSpec:
    """Reference ``FPNSegUNetFAUST`` (``seg_models.py:16-36``)."""
    return ModelSpec(
        conv=ConvFactory(num_basis=32, pne_type="mlp_gelu", equivariant=equivariant),
        patch_num_levels=1,
        patch_num_features=(32,),
        patch_radius_scale=2.0,
        num_blocks=(2, 2, 2, 2),
        num_features=(32, 64, 128, 256),
        radius_scale=2.0,
        radius_scale_dec=2.0,
        radius_scale_blocks=2.0,
        fpn_dec_feats=32,
        num_hidden_seg_head=0,
        max_neighbors=32,
    )


SEG_PRESETS = {
    # the standard (non-equivariant) conv is not ported yet: building it raises
    "FPNSegUNetMLPGeluFAUST": lambda: _faust_spec(False),
    "FPNSegUNetMLPGeluRotEqFAUST": lambda: _faust_spec(True),
}


def get_model_spec(name: str, **overrides) -> ModelSpec:
    if name not in SEG_PRESETS:
        raise KeyError(f"unknown model preset {name!r}; available: {sorted(SEG_PRESETS)}")
    spec = SEG_PRESETS[name]()
    return dataclasses.replace(spec, **overrides) if overrides else spec


def spec_from_model_dict(model: Dict[str, Any]) -> ModelSpec:
    """``Model`` section -> ModelSpec (preset plus ``max_neighbors`` /
    ``max_drop_path`` overrides, as ``train/config.py`` does)."""
    overrides = {}
    if "max_neighbors" in model:
        overrides["max_neighbors"] = int(model["max_neighbors"])
    if "max_drop_path" in model:
        overrides["max_path_drop"] = float(model["max_drop_path"])
    return get_model_spec(model["model"], **overrides)


def hierarchy_config_from_model_dict(model: Dict[str, Any], num_points: int,
                                     train: bool = True) -> HierarchyConfig:
    """``Model`` section -> HierarchyConfig (explicit capacities only)."""
    rf = model["RefFrames"]
    return HierarchyConfig(
        init_cell_size=float(model["init_subsample"]),
        cell_sizes=tuple(float(c) for c in model["grid_subsamples"]),
        capacities=tuple(int(c) for c in model["capacities"]),
        out_cell_size=float(model["output_subsample"]),
        out_capacity=int(model.get("out_capacity", num_points)),
        frames=FrameConfig(
            n_frames=int(rf["train_n_frames" if train else "test_n_frames"]),
            pca=bool(rf["pca"]),
            fixed_axis=rf["fixed_axis"],
            neigh_method=rf["neigh_method"],
            neigh_k=int(rf["neigh_kwargs"]["neigh_k"]),
        ),
    )
