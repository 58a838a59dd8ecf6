"""Model building from a recipe's ``Model`` section (counterpart of
``se3conv3d_tpu/train/config.py:build_model_from_config``).

The port's entry point runs on the card: :func:`build_model_from_config`
puts the model on ``cuda`` unless the caller asks for the CPU with
``device="cpu"`` (the tests do), and raises where there is no card.  It
never falls back to the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ..models.class_net import ClassNet
from ..models.presets import CLASS_PRESETS, spec_from_model_dict
from ..models.seg_unet import FPNSegUNet

__all__ = ["build_model_from_config"]


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
