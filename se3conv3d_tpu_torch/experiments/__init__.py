"""The port's counterparts of the probe scripts under ``experiments/``, each
a library plus ``python -m se3conv3d_tpu_torch.experiments.<name>`` on the
card: ``chip_stage_time`` (the fused forward stage by stage),
``bisect_fused`` (the same forward one stage at a time and five backward
building blocks) and ``chip_stream`` (the rate at which a hand kernel
streams the conv's input tables).  Their kernels are in
``kernels/probes.py``."""
