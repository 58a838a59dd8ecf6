"""Run logging (counterpart of ``se3conv3d_tpu/utils/logging.py``).

``WandbLogger`` is the optional experiment logger the reference tasks use
(``train_dfaust_rot.py:472-478``): inactive without a project or where
wandb is missing, as in the JAX package.  ``StepTimer`` captures a
``torch.profiler`` trace of a span into a Chrome trace file
(``trace.json`` in its directory), where the JAX package's takes a
``jax.profiler`` trace.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

__all__ = ["WandbLogger", "StepTimer"]

# tab20-style class palette without a matplotlib dependency
_PALETTE = np.asarray([
    [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40], [148, 103, 189],
    [140, 86, 75], [227, 119, 194], [127, 127, 127], [188, 189, 34], [23, 190, 207],
    [174, 199, 232], [255, 187, 120], [152, 223, 138], [255, 152, 150], [197, 176, 213],
    [196, 156, 148], [247, 182, 210], [199, 199, 199], [219, 219, 141], [158, 218, 229],
], np.float64)


class WandbLogger:
    """Optional wandb logging; inactive when wandb is missing, when it fails
    to start, or without a project."""

    def __init__(self, project: Optional[str] = None, config: Optional[dict] = None,
                 name: Optional[str] = None):
        self._run = self._wandb = None
        if project is None:
            return
        try:
            import wandb

            self._run = wandb.init(project=project, config=config, name=name)
            self._wandb = wandb
        except Exception:  # a logger that cannot start leaves the run going
            self._run = None

    @property
    def active(self) -> bool:
        return self._run is not None

    def log(self, metrics: dict, step: Optional[int] = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_cloud(self, key: str, positions, class_ids, num_classes: int,
                  step: Optional[int] = None):
        """3D point-cloud panel colored by class id (reference
        ``train_dfaust_rot.py:340-366`` wandb.Object3D logging)."""
        if self._run is None:
            return
        ids = np.asarray(class_ids).astype(np.int64)
        cloud = np.concatenate([np.asarray(positions, np.float64), _PALETTE[ids % len(_PALETTE)]], 1)
        self._run.log({key: self._wandb.Object3D(cloud)}, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()


class StepTimer:
    """A ``torch.profiler`` trace of a span (``start_trace`` /
    ``stop_trace``) written to ``{trace_dir}/trace.json``; the run loop
    keeps its own host-clock split of each step."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir
        self._prof = None

    def start_trace(self):
        if self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def stop_trace(self) -> Optional[str]:
        """End the trace; returns the trace file's path."""
        if self._prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path
