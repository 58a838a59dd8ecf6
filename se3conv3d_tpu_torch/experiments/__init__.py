"""The port's counterparts of the probe scripts under ``experiments/``, each
a library plus ``python -m se3conv3d_tpu_torch.experiments.<name>`` on the
card: ``chip_stage_time`` (the fused forward stage by stage),
``bisect_fused`` (the same forward one stage at a time and five backward
building blocks), ``chip_stream`` (the rate at which a hand kernel
streams the conv's input tables), ``bisect_accum`` and ``bisect_accum2``
(accumulators that every grid block revisits), ``probe_cellconv`` (the
cell-blocked conv's gathers and masked product, ``PART`` or ``--part``) and
``probe_mosaic`` (17 product, layout and accumulation patterns).  Their
kernels are in ``kernels/probes.py``, ``kernels/cellconv_probes.py`` and
``kernels/mosaic_probes.py``."""
