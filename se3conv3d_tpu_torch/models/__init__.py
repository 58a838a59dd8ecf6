"""Models of the port (layout mirrors ``se3conv3d_tpu.models``)."""
from .class_net import ClassNet
from .presets import CLASS_PRESETS, SEG_PRESETS, get_model_spec
from .encoder import BLOCK_LAYERS
from .seg_unet import FPNSegUNet, SegUNet, init_parameters
from .spec import ModelSpec, NeighborhoodProvider
