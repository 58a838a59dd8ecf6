"""Command-line entry points of the port (``python -m
se3conv3d_tpu_torch.tasks.train``, ``.test_seg``, ``.test_class``)."""
