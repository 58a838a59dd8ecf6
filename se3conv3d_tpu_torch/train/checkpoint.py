"""Checkpoints (counterpart of ``se3conv3d_tpu/train/checkpoint.py``), as
``torch.save`` payloads.

Each checkpoint is one file, ``ckpt_{step}.pt`` under the manager's
directory, holding ``{"step", "state", "metadata", "config"}``: the run's
state (the model's ``state_dict`` with its parameters, BN statistics and
calibration buffers; the optimizer's AdamW moments and step, its schedule's
step and accumulation counter), the metadata (epoch, best metric) and the
resolved recipe, as the reference stores its config dicts in every
``.pth`` (``train_dfaust_rot.py:411-432``).  The newest ``max_to_keep``
stay.  Files are written whole under another name and then renamed, and
read with ``weights_only=True``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """(state, metadata, config) per step in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, state: Dict[str, Any], metadata: Optional[Dict] = None,
             config: Optional[Dict] = None) -> str:
        """Write step ``step``; drop the oldest beyond ``max_to_keep``."""
        path = self.path(step)
        part = f"{path}.{os.getpid()}.part"
        torch.save({"step": int(step), "state": state, "metadata": metadata, "config": config}, part)
        os.replace(part, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def all_steps(self) -> List[int]:
        """Sorted steps stored."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None, map_location=None) -> Optional[Dict[str, Any]]:
        """The whole payload of ``step`` (default: the latest), or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location, weights_only=True)

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Tuple[Optional[Dict[str, Any]], Optional[Dict]]:
        """``(state, metadata)`` of ``step`` (default: the latest), or
        ``(None, None)`` where none is stored."""
        payload = self.load(step, map_location)
        if payload is None:
            return None, None
        return payload["state"], payload["metadata"]
