"""Model presets and the pinned recipes (counterpart of
``se3conv3d_tpu/models/presets.py``: the FAUST and ScanNet segmentation
models and the ModelNet40 classification nets).

The pinned recipes are the ``Model`` and ``Training`` sections of YAML
files under ``configs/`` as Python dicts, for the smoke runs that build a
model without a recipe file; tests hold them equal to the files as the
port's reader (``train/config.load_yaml_config``) and PyYAML read them:

- ``DFAUST_I_ROT_PCA_2F_*``: ``configs/dfaust/dfaust_I_rot_pca_2F.yaml``;
- ``DFAUST_I_ROT_PCA_MIXF_*``: ``configs/dfaust/dfaust_I_rot_pca_mixF.yaml``;
- ``DFAUST_I_ROT_MC_2F_*``: ``configs/dfaust/dfaust_I_rot_MC_2F.yaml``;
- ``DFAUST_I_ROT_MC_MIXF_*``: ``configs/dfaust/dfaust_I_rot_MC_mixF.yaml``;
- ``SCANNET20_ROT_PCA_I_*``: ``configs/scannet/scannet20_rot_pca_I.yaml``;
- ``SCANNET20_ROT_I_*``: ``configs/scannet/scannet20_rot_I.yaml``;
- the standard (non-equivariant) models: ``DFAUST_I_STANDARD_*``
  (``configs/dfaust/dfaust_I_standard.yaml``), ``SCANNET20_STANDARD_I_*``
  and ``SCANNET20_STANDARD_SO2_*`` (``configs/scannet/
  scannet20_standard_{I,SO2}.yaml``, which differ only in ``log_folder``
  and in their augmentation files, which the port does not read);
- the ModelNet40 classification recipes: ``MODELNET40_PCA_2F_*``,
  ``MODELNET40_MC_2F_*`` and ``MODELNET40_STANDARD_*``
  (``configs/modelnet40/modelnet40_{pca_2F,MC_2F,standard}.yaml``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.hierarchy import FrameConfig, HierarchyConfig
from ..nn.conv import ConvFactory
from .spec import ModelSpec

__all__ = [
    "SEG_PRESETS",
    "CLASS_PRESETS",
    "DFAUST_I_ROT_PCA_2F_MODEL",
    "DFAUST_I_ROT_PCA_2F_TRAINING",
    "DFAUST_I_ROT_PCA_MIXF_MODEL",
    "DFAUST_I_ROT_PCA_MIXF_TRAINING",
    "DFAUST_I_ROT_MC_2F_MODEL",
    "DFAUST_I_ROT_MC_2F_TRAINING",
    "DFAUST_I_ROT_MC_MIXF_MODEL",
    "DFAUST_I_ROT_MC_MIXF_TRAINING",
    "DFAUST_I_STANDARD_MODEL",
    "DFAUST_I_STANDARD_TRAINING",
    "DFAUST_NUM_POINTS",
    "DFAUST_NUM_CLASSES",
    "SCANNET20_ROT_PCA_I_MODEL",
    "SCANNET20_ROT_PCA_I_TRAINING",
    "SCANNET20_ROT_I_MODEL",
    "SCANNET20_ROT_I_TRAINING",
    "SCANNET20_STANDARD_I_MODEL",
    "SCANNET20_STANDARD_I_TRAINING",
    "SCANNET20_STANDARD_SO2_MODEL",
    "SCANNET20_STANDARD_SO2_TRAINING",
    "SCANNET_SCENE_MAX_POINTS",
    "SCANNET_NUM_FEATURES",
    "SCANNET20_NUM_CLASSES",
    "SCANNET20_IGNORE_LABEL",
    "MODELNET40_PCA_2F_MODEL",
    "MODELNET40_PCA_2F_TRAINING",
    "MODELNET40_MC_2F_MODEL",
    "MODELNET40_MC_2F_TRAINING",
    "MODELNET40_STANDARD_MODEL",
    "MODELNET40_STANDARD_TRAINING",
    "MODELNET40_NUM_POINTS",
    "MODELNET40_NUM_FEATURES",
    "MODELNET40_NUM_CLASSES",
    "get_model_spec",
    "spec_from_model_dict",
    "COMPUTE_DTYPES",
    "frame_config_from_dict",
    "hierarchy_config_from_model_dict",
    "mix_n_frames",
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
# the DFaust recipes share their Model section but for RefFrames, and their
# Training section but for log_folder, batch_size and accum_grads
_DFAUST_MODEL_BASE = {k: v for k, v in DFAUST_I_ROT_PCA_2F_MODEL.items() if k != "RefFrames"}
_MIX_N_FRAMES = {4: 0.15, 2: 0.35, 1: 0.50}
DFAUST_I_ROT_PCA_MIXF_MODEL: Dict[str, Any] = {
    **_DFAUST_MODEL_BASE,
    "RefFrames": {
        "pca": True,
        "neigh_method": "knn",
        "neigh_kwargs": {"neigh_k": 16},
        "fixed_axis": False,
        "train_n_frames": 1,
        "test_n_frames": 1,
        "mix_n_frames": dict(_MIX_N_FRAMES),
    },
}
DFAUST_I_ROT_PCA_MIXF_TRAINING: Dict[str, Any] = {
    **DFAUST_I_ROT_PCA_2F_TRAINING, "log_folder": "./logs/dfaust_RotEq_I_OOD_mixF"}
DFAUST_I_ROT_MC_2F_MODEL: Dict[str, Any] = {
    **_DFAUST_MODEL_BASE,
    "RefFrames": {"pca": False, "fixed_axis": False, "train_n_frames": 2, "test_n_frames": 2},
}
DFAUST_I_ROT_MC_2F_TRAINING: Dict[str, Any] = {
    **DFAUST_I_ROT_PCA_2F_TRAINING, "log_folder": "./logs/dfaust_RotEq_I_MC_2F"}
DFAUST_I_ROT_MC_MIXF_MODEL: Dict[str, Any] = {
    **_DFAUST_MODEL_BASE,
    "RefFrames": {"pca": False, "fixed_axis": False, "train_n_frames": 1, "test_n_frames": 1,
                  "mix_n_frames": dict(_MIX_N_FRAMES)},
}
DFAUST_I_ROT_MC_MIXF_TRAINING: Dict[str, Any] = {
    **DFAUST_I_ROT_PCA_2F_TRAINING,
    "log_folder": "./logs/dfaust_RotEq_I_OOD_MC_mixF",
    "batch_size": 16,
    "accum_grads": 2,
}
DFAUST_I_STANDARD_MODEL: Dict[str, Any] = {**_DFAUST_MODEL_BASE, "model": "FPNSegUNetMLPGeluFAUST"}
DFAUST_I_STANDARD_TRAINING: Dict[str, Any] = {
    **DFAUST_I_ROT_PCA_2F_TRAINING, "log_folder": "./logs/dfaust_standard_I"}
DFAUST_NUM_POINTS = 4096   # Dataset.num_points of the recipe
DFAUST_NUM_CLASSES = 20    # DFaust body-part labels

SCANNET20_ROT_PCA_I_MODEL: Dict[str, Any] = {
    "model": "FPNSegUNetMLPGeluRotEqScanNet",
    "compute_dtype": "bfloat16",
    "remat": False,
    "max_drop_path": 0.5,
    "init_subsample": 0.1,
    "output_subsample": 0.1,
    "grid_subsamples": [0.2, 0.4, 0.8, 1.6],
    "capacities": [131072, 32768, 8192, 2048, 512],
    "out_capacity": 131072,
    "max_neighbors": 24,
    "RefFrames": {
        "pca": True,
        "neigh_method": "knn",
        "neigh_kwargs": {"neigh_k": 16},
        "fixed_axis": False,
        "train_n_frames": 1,
        "test_n_frames": 1,
    },
}
SCANNET20_ROT_PCA_I_TRAINING: Dict[str, Any] = {
    "log_folder": "./logs/scannet20_RotEq_pca_I",
    "num_epochs": 600,
    "num_batches": 250,
    "pts_per_batch": 750000,
    "scan_scenes": True,
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
SCANNET20_ROT_I_MODEL: Dict[str, Any] = {
    **{k: v for k, v in SCANNET20_ROT_PCA_I_MODEL.items() if k != "RefFrames"},
    "RefFrames": {"pca": False, "fixed_axis": 2, "train_n_frames": 1, "test_n_frames": 1},
}
SCANNET20_ROT_I_TRAINING: Dict[str, Any] = {
    **SCANNET20_ROT_PCA_I_TRAINING, "log_folder": "./logs/scannet20_RotEq_I"}
# the standard ScanNet recipes: the rot recipes' Model section without
# RefFrames (bfloat16 convs), and their Training section but for log_folder
SCANNET20_STANDARD_I_MODEL: Dict[str, Any] = {
    **{k: v for k, v in SCANNET20_ROT_PCA_I_MODEL.items() if k != "RefFrames"},
    "model": "FPNSegUNetMLPGeluScanNet",
}
SCANNET20_STANDARD_I_TRAINING: Dict[str, Any] = {
    **SCANNET20_ROT_PCA_I_TRAINING, "log_folder": "./logs/scannet20_standard_I"}
SCANNET20_STANDARD_SO2_MODEL: Dict[str, Any] = dict(SCANNET20_STANDARD_I_MODEL)
SCANNET20_STANDARD_SO2_TRAINING: Dict[str, Any] = {
    **SCANNET20_ROT_PCA_I_TRAINING, "log_folder": "./logs/scannet20_standard_SO2"}
SCANNET_SCENE_MAX_POINTS = 120000  # Dataset.train_scene_max_pts of the recipe
SCANNET_NUM_FEATURES = 6           # normals + rgb (se3conv3d_tpu/data/loaders.py:431)
SCANNET20_NUM_CLASSES = 21         # 20 classes + unlabelled (loaders.py:319)
SCANNET20_IGNORE_LABEL = 0         # the loss skips unlabelled points (train/run.py:150)

MODELNET40_PCA_2F_MODEL: Dict[str, Any] = {
    "model": "ClassNetRotEquivMLPGELU19Former",
    "max_drop_path": 0.2,
    "init_subsample": 0.05,
    "grid_subsamples": [0.05, 0.1, 0.2, 0.3, 0.4],
    "capacities": [4096, 4096, 2048, 1024, 512, 256],
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
MODELNET40_PCA_2F_TRAINING: Dict[str, Any] = {
    "log_folder": "./logs/mn40_I_2F_pca_rot_equiv",
    "num_epochs": 500,
    "batch_size": 12,
    "weight_decay": 0.0001,
    "max_lr": 0.01,
    "div_factor": 100.0,
    "final_div_factor": 10000.0,
    "pct_start": 0.02,
    "clip_grads": 100.0,
    "label_smoothing": 0.2,
    "save_models_frequency": 20,
    "val_freq": 5,
}
# the ModelNet40 recipes share their Model section but for the preset,
# max_drop_path and RefFrames, and their Training section but for log_folder
_MODELNET40_MODEL_BASE = {k: v for k, v in MODELNET40_PCA_2F_MODEL.items() if k != "RefFrames"}
MODELNET40_MC_2F_MODEL: Dict[str, Any] = {
    **_MODELNET40_MODEL_BASE,
    "max_drop_path": 0.5,
    "RefFrames": {"pca": False, "fixed_axis": False, "train_n_frames": 2, "test_n_frames": 2},
}
MODELNET40_MC_2F_TRAINING: Dict[str, Any] = {
    **MODELNET40_PCA_2F_TRAINING, "log_folder": "./logs/mn40_MC_2F"}
MODELNET40_STANDARD_MODEL: Dict[str, Any] = {**_MODELNET40_MODEL_BASE, "model": "ClassNetMLPGELU19Former"}
MODELNET40_STANDARD_TRAINING: Dict[str, Any] = {
    **MODELNET40_PCA_2F_TRAINING, "log_folder": "./logs/mn40_standard"}
MODELNET40_NUM_POINTS = 4096   # Dataset.num_points of the recipes
MODELNET40_NUM_FEATURES = 1    # the loader's ones features (se3conv3d_tpu/data/loaders.py:205,274)
MODELNET40_NUM_CLASSES = 40


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


def _scannet_spec(equivariant: bool) -> ModelSpec:
    """Reference ``FPNSegUNetScanNet`` (``seg_models.py:39-59``): no patch
    stem, five trunk levels."""
    return ModelSpec(
        conv=ConvFactory(num_basis=32, pne_type="mlp_gelu", equivariant=equivariant),
        patch_num_levels=0,
        patch_num_features=(),
        patch_radius_scale=2.0,
        num_blocks=(2, 3, 4, 6, 4),
        num_features=(64, 128, 192, 256, 320),
        radius_scale=2.0,
        radius_scale_dec=2.0,
        radius_scale_blocks=2.0,
        fpn_dec_feats=128,
        num_hidden_seg_head=0,
    )


def _classnet19_spec(equivariant: bool, frame_pooling: Optional[str] = None) -> ModelSpec:
    """Reference ``ClassNet19Former`` / ``...Max`` (``class_models.py:15-59``):
    a patch stem and five trunk levels up to 512 channels, average pooling
    over the points (after max pooling over the frames for ``...Max``)."""
    return ModelSpec(
        conv=ConvFactory(num_basis=32, pne_type="mlp_gelu", equivariant=equivariant),
        patch_num_levels=1,
        patch_num_features=(32,),
        patch_radius_scale=2.0,
        num_blocks=(2, 3, 4, 6, 4),
        num_features=(32, 64, 128, 256, 512),
        radius_scale=2.0,
        radius_scale_blocks=2.0,
        pooling_method="avg",
        frame_pooling_method=frame_pooling,
        max_neighbors=32,
    )


SEG_PRESETS = {
    "FPNSegUNetMLPGeluFAUST": lambda: _faust_spec(False),
    "FPNSegUNetMLPGeluRotEqFAUST": lambda: _faust_spec(True),
    "FPNSegUNetMLPGeluScanNet": lambda: _scannet_spec(False),
    "FPNSegUNetMLPGeluRotEqScanNet": lambda: _scannet_spec(True),
}

CLASS_PRESETS = {
    "ClassNetMLPGELU19Former": lambda: _classnet19_spec(False),
    "ClassNetRotEquivMLPGELU19Former": lambda: _classnet19_spec(True),
    "ClassNetRotEquivMLPGELU19FormerMax": lambda: _classnet19_spec(True, frame_pooling="max"),
}


def get_model_spec(name: str, **overrides) -> ModelSpec:
    """A preset of either table by its reference model-class name."""
    table = {**SEG_PRESETS, **CLASS_PRESETS}
    if name not in table:
        raise KeyError(f"unknown model preset {name!r}; available: {sorted(table)}")
    spec = table[name]()
    return dataclasses.replace(spec, **overrides) if overrides else spec


# a recipe's compute_dtype -> the convs' operand dtype (absent: float32)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def spec_from_model_dict(model: Dict[str, Any]) -> ModelSpec:
    """``Model`` section -> ModelSpec (preset plus ``max_neighbors`` /
    ``max_drop_path`` overrides, and ``compute_dtype`` on both conv
    factories, as ``se3conv3d_tpu/train/config.py:build_model_from_config``
    does).  ``compute_dtype`` is ``float32``, ``bfloat16`` or absent; any
    other raises ``NotImplementedError``."""
    overrides = {}
    if "max_neighbors" in model:
        overrides["max_neighbors"] = int(model["max_neighbors"])
    if "max_drop_path" in model:
        overrides["max_path_drop"] = float(model["max_drop_path"])
    spec = get_model_spec(model["model"], **overrides)
    if "compute_dtype" in model:
        name = model["compute_dtype"]
        if name not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype {name!r}: the port's convs compute in {sorted(COMPUTE_DTYPES)}")
        cdt = COMPUTE_DTYPES[name]
        spec = dataclasses.replace(
            spec,
            conv=dataclasses.replace(spec.conv, compute_dtype=cdt),
            conv_blocks=dataclasses.replace(spec.conv_blocks, compute_dtype=cdt),
        )
    return spec


def frame_config_from_dict(ref_frames: Optional[Dict[str, Any]],
                           train: bool = True) -> Optional[FrameConfig]:
    """``Model.RefFrames`` -> FrameConfig, each key read with the JAX
    package's default (``se3conv3d_tpu/train/config.py:
    frame_config_from_dict``): ``train_n_frames`` / ``test_n_frames`` (else
    ``n_frames``, else 2), ``pca`` True, ``fixed_axis`` False,
    ``neigh_method`` ``'knn'``, ``neigh_kwargs.neigh_k`` 16 and
    ``.bq_radius`` 0.  No section: None (the standard models)."""
    if not ref_frames:
        return None
    kwargs = ref_frames.get("neigh_kwargs", {}) or {}
    n_frames = ref_frames.get("train_n_frames" if train else "test_n_frames",
                              ref_frames.get("n_frames", 2))
    return FrameConfig(
        n_frames=int(n_frames),
        pca=bool(ref_frames.get("pca", True)),
        fixed_axis=ref_frames.get("fixed_axis", False),
        neigh_method=ref_frames.get("neigh_method", "knn"),
        neigh_k=int(kwargs.get("neigh_k", 16)),
        bq_radius=float(kwargs.get("bq_radius", 0.0)),
    )


def hierarchy_config_from_model_dict(model: Dict[str, Any], num_points: int,
                                     train: bool = True,
                                     with_output: Optional[bool] = None) -> HierarchyConfig:
    """``Model`` section -> HierarchyConfig (explicit capacities only), as
    ``se3conv3d_tpu/train/config.py:hierarchy_config_from_model_dict``: a
    section without ``output_subsample`` (the ModelNet40 recipes), or
    ``with_output=False`` (the classification task), makes the raw cloud
    the output cloud (``out_cell_size`` None)."""
    out_cell = model.get("output_subsample")
    if with_output is False:
        out_cell = None
    return HierarchyConfig(
        init_cell_size=float(model["init_subsample"]),
        cell_sizes=tuple(float(c) for c in model["grid_subsamples"]),
        capacities=tuple(int(c) for c in model["capacities"]),
        out_cell_size=None if out_cell is None else float(out_cell),
        out_capacity=int(model.get("out_capacity", num_points)),
        frames=frame_config_from_dict(model.get("RefFrames"), train),
    )


def mix_n_frames(model: Dict[str, Any]) -> Optional[Dict[int, float]]:
    """A recipe's ``RefFrames.mix_n_frames`` as ``{frame count:
    probability}`` (the train run's per-micro-batch draw,
    ``se3conv3d_tpu/train/run.py``), or None where the recipe has none."""
    mix = (model.get("RefFrames") or {}).get("mix_n_frames")
    return {int(k): float(v) for k, v in mix.items()} if mix else None
