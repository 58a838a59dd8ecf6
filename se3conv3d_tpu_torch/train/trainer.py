"""Calibration and eval steps (counterpart of the segmentation path of
``se3conv3d_tpu/train/trainer.py``; the training step comes later).

A batch is a dict of tensors: ``positions [B, N, 3]``, ``mask [B, N]``,
``features [B, N, C]`` and optionally ``labels [B, N]``.  Each step builds
the hierarchy (random draws from ``generator``, or injected ``draws``),
repeats the level-0 features over the frames and runs the model in eval
mode without autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.hierarchy import HierarchyConfig, HierarchyDraws, build_hierarchy
from .losses import masked_segmentation_loss_parts

__all__ = ["Trainer"]


class Trainer:
    """Eval-side steps of one (segmentation model, hierarchy config).

    Args:
      model: an ``FPNSegUNet``; its parameters, BN statistics and
        calibration buffers are the state the steps read and update.
      hierarchy_config: used by the calibration step.
      eval_hierarchy_config: used by the eval step (default: the same).
      label_smoothing / ignore_label: loss settings.
    """

    def __init__(self, model, hierarchy_config: HierarchyConfig,
                 eval_hierarchy_config: Optional[HierarchyConfig] = None,
                 label_smoothing: float = 0.0, ignore_label: Optional[int] = None):
        self.model = model
        self.hcfg = hierarchy_config
        self.eval_hcfg = eval_hierarchy_config or hierarchy_config
        self.label_smoothing = label_smoothing
        self.ignore_label = ignore_label

    def build(self, batch: dict, generator: Optional[torch.Generator] = None,
              draws: Optional[HierarchyDraws] = None, train: bool = True):
        """Hierarchy, frame-repeated level-0 features, output cloud, output
        labels and the raw -> output subsample map."""
        hcfg = self.hcfg if train else self.eval_hcfg
        h, f0, out_pc, out_labels, raw_to_out = build_hierarchy(
            batch["positions"], batch["mask"], batch.get("features"), hcfg,
            batch.get("labels"), generator=generator, draws=draws,
        )
        if hcfg.frames is not None and f0 is not None:
            f0 = f0[:, :, None, :].repeat(1, 1, hcfg.frames.n_frames, 1)
        return h, f0, out_pc, out_labels, raw_to_out

    @torch.no_grad()
    def calibration_step(self, batch: dict, generator: Optional[torch.Generator] = None,
                         draws: Optional[HierarchyDraws] = None) -> None:
        """Update every conv's calibration buffers from one batch."""
        h, f0, out_pc, _, _ = self.build(batch, generator, draws)
        self.model.eval()
        self.model(h, f0, out_pc, calibrate=True)

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: Optional[torch.Generator] = None,
                  draws: Optional[HierarchyDraws] = None) -> dict:
        """Logits ``[B, M, classes]``, output mask, and (with labels) the
        loss and output labels; ``out_idx`` maps output points to raw ones."""
        h, f0, out_pc, out_labels, raw_to_out = self.build(batch, generator, draws, train=False)
        self.model.eval()
        logits = self.model(h, f0, out_pc)
        out = {"logits": logits, "mask": out_pc.mask}
        if out_labels is not None:
            total, count = masked_segmentation_loss_parts(
                logits, out_labels, out_pc.mask, self.label_smoothing, self.ignore_label
            )
            out["loss"] = total / count.clamp(min=1.0)
            out["labels"] = out_labels
        if raw_to_out is not None:
            out["out_idx"] = raw_to_out.chosen_idx
        return out
