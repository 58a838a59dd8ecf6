"""Segmentation model of the port (layout mirrors ``se3conv3d_tpu.models``)."""
from .presets import SEG_PRESETS, get_model_spec
from .seg_unet import FPNSegUNet, init_parameters
from .spec import ModelSpec, NeighborhoodProvider
