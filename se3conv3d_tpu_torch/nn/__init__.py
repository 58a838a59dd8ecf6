"""See the module docstrings; layout mirrors ``se3conv3d_tpu.nn``."""
