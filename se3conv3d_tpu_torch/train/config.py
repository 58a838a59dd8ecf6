"""Recipes (counterpart of ``se3conv3d_tpu/train/config.py``): reading and
writing a recipe's YAML file, overlaying a test-regime YAML on the training
recipe it evaluates, its augmentation modules, and building the model from
its ``Model`` section.

The recipes are read by the port's own reader of the YAML subset they use
(``utils/yaml_subset.py``), not by PyYAML.

The port's entry point runs on the card: :func:`build_model_from_config`
puts the model on ``cuda`` unless the caller asks for the CPU with
``device="cpu"`` (the tests do), and raises where there is no card.  It
never falls back to the CPU.
"""
from __future__ import annotations

import copy
import importlib
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..models.class_net import ClassNet
from ..models.presets import CLASS_PRESETS, spec_from_model_dict
from ..models.seg_unet import FPNSegUNet
from ..utils import yaml_subset

__all__ = ["load_yaml_config", "dump_yaml_config", "is_test_config", "merge_test_config",
           "load_augmentations", "build_model_from_config"]


def load_yaml_config(path: str) -> Dict[str, Any]:
    """A recipe's YAML file as a dict, with empty ``Training`` / ``Dataset``
    / ``Model`` sections where it has none (as the JAX package reads it with
    ``yaml.safe_load``)."""
    cfg = yaml_subset.load(path)
    for section in ("Training", "Dataset", "Model"):
        cfg.setdefault(section, {})
    return cfg


def dump_yaml_config(cfg: Dict[str, Any], path: str) -> None:
    """Write ``cfg`` as YAML that :func:`load_yaml_config` (and PyYAML's
    ``safe_load``) read back equal."""
    yaml_subset.dump(cfg, path)


def is_test_config(cfg: Dict[str, Any]) -> bool:
    """True for a test-regime YAML: a ``Testing`` section and no ``Model``
    section (e.g. ``configs/scannet/scannet20_test_pca_I_SO2.yaml``)."""
    return bool(cfg.get("Testing")) and not cfg.get("Model")


def merge_test_config(train_cfg: Dict[str, Any], test_cfg: Dict[str, Any]
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Overlay a test-regime YAML on the training recipe it evaluates, as
    the JAX package's ``merge_test_config``: the model comes from the
    training recipe; the eval split (``Dataset.split`` becomes
    ``test_split``) and augmentation modules from the test YAML's
    ``Dataset``; ``Testing.RefFrames`` overrides the model's frames (its
    ``n_frames`` becomes ``test_n_frames``) and ``Testing.batch_size``
    becomes ``Training.batch_size``.  Returns ``(merged, testing)``, with
    ``testing`` the raw ``Testing`` section (``num_epochs``: the votes;
    ``save_folder``: where predictions go)."""
    merged = copy.deepcopy(train_cfg)
    testing = dict(test_cfg.get("Testing") or {})
    ds = dict(test_cfg.get("Dataset") or {})
    out_ds = merged.setdefault("Dataset", {})
    if "split" in ds:
        out_ds["test_split"] = ds.pop("split")
    out_ds.update(ds)
    rf = testing.get("RefFrames")
    if rf:
        model_rf = dict(merged.setdefault("Model", {}).get("RefFrames") or {})
        model_rf.update({k: v for k, v in rf.items() if k != "n_frames"})
        if "n_frames" in rf:
            model_rf["test_n_frames"] = int(rf["n_frames"])
        merged["Model"]["RefFrames"] = model_rf
    if "batch_size" in testing:
        merged.setdefault("Training", {})["batch_size"] = testing["batch_size"]
    return merged, testing


def load_augmentations(dotted_path: Optional[str]) -> List[dict]:
    """The ``DS_AUGMENTS`` list of the module at ``dotted_path`` (e.g.
    ``configs.dfaust.DFaust_DS_Aug``, importable from the repository root);
    ``'None'`` or empty gives no augmentations."""
    if not dotted_path or dotted_path == "None":
        return []
    return list(importlib.import_module(dotted_path).DS_AUGMENTS)


def build_model_from_config(model_dict: Dict[str, Any], num_in_feats: int, num_classes: int,
                            device=None,
                            generator: Optional[torch.Generator] = None
                            ) -> Union[FPNSegUNet, ClassNet]:
    """``Model`` section -> an ``FPNSegUNet`` (a segmentation preset) or a
    ``ClassNet`` (a classification preset) on ``device`` (default: the
    card), initialised from ``generator``.

    Reads the preset name, ``max_neighbors``, ``max_drop_path`` and
    ``compute_dtype`` (``bfloat16``, ``float32`` or absent, put on both
    conv factories: bfloat16 convs run the kernels' bfloat16 operand path;
    any other dtype raises ``NotImplementedError``).  ``remat``,
    ``lean_vjp`` and ``cache_equiv_geometry`` tune the JAX package's TPU
    memory use; they are accepted and change nothing here, since the port's
    conv always saves only its inputs and its provider always caches the
    geometry.
    """
    spec = spec_from_model_dict(model_dict)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on an NVIDIA GPU; "
                               "pass device='cpu' to run its plain PyTorch path on the CPU")
        device = "cuda"
    net = ClassNet if model_dict["model"] in CLASS_PRESETS else FPNSegUNet
    model = net(spec, num_in_feats=num_in_feats, num_classes=num_classes, generator=generator)
    return model.to(device)
