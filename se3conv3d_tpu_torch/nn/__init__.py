"""See the module docstrings; layout mirrors ``se3conv3d_tpu.nn``."""
from .conv import ConvFactory, PNEConv
from .norm import MaskedBatchNorm
from .blocks import (
    DropPath,
    ResConvNeXt,
    ResNetB,
    ResNetFormer,
    SkipConnection,
    TorchLinear,
)
from .icosphere import icosphere_points
from .attention import LoRAttConv, MultiHeadAttConv
