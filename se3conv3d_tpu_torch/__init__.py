"""se3conv3d_tpu_torch: the PyTorch + CUDA port of ``se3conv3d_tpu``.

Same module layout as the JAX package (``core``, ``ops``, ``nn``,
``models``, ``train``, ``utils``) plus ``kernels``, which holds the
hand-written CUDA kernels for NVIDIA Hopper and their plain PyTorch
versions.  Public functions keep the JAX package's layouts (``[B, N, F, C]``
features, ``[B, M, K]`` neighbor tables with masks) so the two packages can
be compared on the same numpy inputs.

Importing the package touches no CUDA, no ``nvcc`` and no ``triton``:
kernels are built at their first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
