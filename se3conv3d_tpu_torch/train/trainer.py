"""Calibration, train and eval steps (counterpart of
``se3conv3d_tpu/train/trainer.py``), for segmentation and classification.

A batch is a dict of tensors: ``positions [B, N, 3]``, ``mask [B, N]``,
``features [B, N, C]`` and optionally ``labels``: ``[B, N]`` per point for
segmentation, ``[B]`` per cloud for classification.  A classification
model takes no output cloud: its hierarchy is built without labels, and
its loss is the cross entropy of its ``[B, classes]`` logits over the
clouds that hold a point (a filler cloud with none counts for nothing).  Each step builds
the hierarchy (random draws from ``generator``, or injected ``draws``) and
repeats the level-0 features over the frames.  Calibration and eval run the
model in eval mode without autograd; the train step runs it in train mode
(batch-statistics BN, stochastic depth), backpropagates the masked
label-smoothed loss and takes one optimizer step.

With ``scan_scenes`` (the ScanNet recipes' ``Training.scan_scenes``) a train
step over B > 1 scenes runs them one at a time, as the JAX package's
``_train_step_scan``: per scene the hierarchy build, the train-mode forward
and the backward of the masked loss *sum*, so activations are those of one
scene and BN statistics update scene after scene; then every gradient is
divided by the summed count of valid points, and one clipped optimizer step
follows.  The steps run on the model's device and move the batch there.

An eval step may serve a checkpoint ensemble (:meth:`Trainer.eval_ensemble`):
the hierarchy is built once, with one draw of its random numbers, and each
member's weights are loaded into the model in turn and run on it with one
shared neighborhood cache, so every member sees the same hierarchy and
frames, as every member of a JAX ensemble gets the same key.

A train step may take its own frame count (``n_frames``): the recipes with
``RefFrames.mix_n_frames`` draw one per micro-batch (:func:`draw_n_frames`,
as the JAX package's ``train/run.py``).  The parameters do not depend on
it, so one ``Trainer`` serves every count; calibration and eval keep the
recipe's ``train_n_frames`` / ``test_n_frames``.  With an optimizer that
accumulates gradients (``Training.accum_grads``), each train step is one
micro-batch and every k-th one updates the parameters.

In a data-parallel group (``parallel.mesh``: N ranks, each with its share of
the global batch) a train step takes the step of the global batch, as the
JAX package's one program on a mesh does: the loss is the masked sum over
the global batch over its global valid count, so each rank back-propagates
its local sum over the global count (summed over the ranks, no gradient),
and the gradients are then summed over the ranks in one flattened buffer;
the BN statistics and calibration sums are the global batch's
(``nn.norm``, ``nn.conv``).  A per-rank mean followed by an average over
the ranks (DDP's rule) would weigh the ranks' points unequally whenever they
hold different numbers of valid points (a filler, a masked tail).  Every
rank then clips and updates from the same gradients, so the parameters stay
bitwise equal; ``loss`` and ``grad_norm`` are the global values.
``scan_scenes`` is ignored in a group of several ranks, with the JAX
package's warning.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.hierarchy import HierarchyConfig, HierarchyDraws, build_hierarchy
from ..models.class_net import ClassNet
from ..models.spec import NeighborhoodProvider
from ..nn.blocks import DropPathDraws
from ..parallel.mesh import group_sum_, in_group, world_size
from .losses import classification_loss_parts, masked_segmentation_loss_parts
from .schedule import Optimizer

__all__ = ["Trainer", "draw_n_frames", "to_tensors"]

# the batch keys a step reads, and the dtypes the Trainer takes
_TENSOR_KEYS = {"positions": torch.float32, "mask": torch.bool, "features": torch.float32,
                "labels": torch.int64}


def to_tensors(batch: dict, device) -> dict:
    """The keys a step reads of a numpy batch (``data.pad_collate``), as
    tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device, dt)
            for k, dt in _TENSOR_KEYS.items() if k in batch}


def draw_n_frames(mix: Dict[int, float], rng: np.random.Generator) -> int:
    """One micro-batch's frame count from ``mix`` (``{count: probability}``,
    ``models.presets.mix_n_frames``): ``rng.choice`` over the sorted counts
    with the probabilities normalised, the expression of the JAX package's
    ``train/run.py``, so the same numpy seed gives the same sequence."""
    counts = sorted(mix)
    probs = np.asarray([mix[c] for c in counts])
    return int(rng.choice(counts, p=probs / probs.sum()))


class Trainer:
    """Steps of one (model, hierarchy config, optimizer).

    Args:
      model: an ``FPNSegUNet`` or a ``SegUNet`` (the segmentation task)
        or a ``ClassNet`` (the classification task, ``self.task``); its
        parameters, BN statistics and calibration buffers are the state
        the steps read and update.
      hierarchy_config: used by the calibration and train steps.
      eval_hierarchy_config: used by the eval step (default: the same).
      label_smoothing / ignore_label: loss settings.
      optimizer: ``train.schedule.Optimizer`` over the model's parameters;
        needed by :meth:`train_step` only.
      scan_scenes: scene-sequential train steps (see the module docstring);
        segmentation only, as in every recipe.
    """

    def __init__(self, model, hierarchy_config: HierarchyConfig,
                 eval_hierarchy_config: Optional[HierarchyConfig] = None,
                 label_smoothing: float = 0.0, ignore_label: Optional[int] = None,
                 optimizer: Optional[Optimizer] = None, scan_scenes: bool = False):
        self.task = "classification" if isinstance(model, ClassNet) else "segmentation"
        if scan_scenes and self.task == "classification":
            raise ValueError("scan_scenes is a segmentation option: no classification recipe sets it")
        if scan_scenes and world_size() > 1:
            warnings.warn(
                "scan_scenes is ignored in a data-parallel group (the batch axis is split over the "
                "ranks instead); each rank runs its multi-scene share as one batch: size "
                "pts_per_batch so that each card's share fits its memory", RuntimeWarning, stacklevel=2)
            scan_scenes = False
        self.model = model
        self.device = next(model.parameters()).device
        self.scan_scenes = scan_scenes
        self.hcfg = hierarchy_config
        self.eval_hcfg = eval_hierarchy_config or hierarchy_config
        self.label_smoothing = label_smoothing
        self.ignore_label = ignore_label
        self.optimizer = optimizer
        self.step = 0

    def build(self, batch: dict, generator: Optional[torch.Generator] = None,
              draws: Optional[HierarchyDraws] = None, train: bool = True,
              n_frames: Optional[int] = None):
        """Hierarchy, frame-repeated level-0 features, output cloud, output
        labels (classification: the batch's per-cloud labels) and the raw ->
        output subsample map; ``n_frames`` replaces the config's frame
        count."""
        hcfg = self.hcfg if train else self.eval_hcfg
        if n_frames is not None and hcfg.frames is not None:
            hcfg = dataclasses.replace(hcfg, frames=hcfg.frames.with_n_frames(n_frames))
        batch = {k: v.to(self.device) for k, v in batch.items()}
        seg = self.task == "segmentation"
        h, f0, out_pc, out_labels, raw_to_out = build_hierarchy(
            batch["positions"], batch["mask"], batch.get("features"), hcfg,
            batch.get("labels") if seg else None, generator=generator, draws=draws,
        )
        if not seg:
            out_labels = batch.get("labels")
        if hcfg.frames is not None and f0 is not None:
            f0 = f0[:, :, None, :].repeat(1, 1, hcfg.frames.n_frames, 1)
        return h, f0, out_pc, out_labels, raw_to_out

    def _forward(self, h, f0, out_pc, **kwargs):
        """The model on a built hierarchy (a classification model takes no
        output cloud)."""
        if self.task == "segmentation":
            return self.model(h, f0, out_pc, **kwargs)
        return self.model(h, f0, **kwargs)

    def _loss_parts(self, logits, out_labels, out_pc):
        if self.task == "classification":
            return classification_loss_parts(logits, out_labels, self.label_smoothing,
                                             example_mask=out_pc.mask.any(1))
        return masked_segmentation_loss_parts(
            logits, out_labels, out_pc.mask, self.label_smoothing, self.ignore_label
        )

    def _loss(self, logits, out_labels, out_pc):
        total, count = self._loss_parts(logits, out_labels, out_pc)
        return total / count.clamp(min=1.0)

    @torch.no_grad()
    def calibration_step(self, batch: dict, generator: Optional[torch.Generator] = None,
                         draws: Optional[HierarchyDraws] = None) -> None:
        """Update every conv's calibration buffers from one batch."""
        h, f0, out_pc, _, _ = self.build(batch, generator, draws)
        self.model.eval()
        self._forward(h, f0, out_pc, calibrate=True)

    def train_step(self, batch: dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[HierarchyDraws] = None,
                   drop_masks: Optional[Sequence[torch.Tensor]] = None,
                   n_frames: Optional[int] = None) -> dict:
        """One optimizer step (one micro-batch of it, with an accumulating
        optimizer) on a labelled batch.

        The hierarchy draws come from ``draws`` or ``generator``, the
        DropPath keep masks (``[B]`` each, in call order) from
        ``drop_masks`` or ``generator``; under ``scan_scenes`` with B > 1,
        ``draws`` and ``drop_masks`` are lists with one entry per scene
        (``[1]`` masks).  ``n_frames`` builds the hierarchy with that many
        frames per point instead of the recipe's ``train_n_frames``.
        Returns ``{"loss", "grad_norm"}`` as device scalars; ``grad_norm``
        is the global norm of this batch's gradients before clipping.  BN
        running statistics are updated in place.
        """
        if self.optimizer is None:
            raise ValueError("train_step needs a Trainer built with an optimizer")
        if self.scan_scenes and batch["mask"].shape[0] > 1:
            loss = self.backward_scenes(batch, generator, draws, drop_masks, n_frames)
        else:
            h, f0, out_pc, out_labels, _ = self.build(batch, generator, draws, train=True,
                                                      n_frames=n_frames)
            loss = self.backward(h, f0, out_pc, out_labels, DropPathDraws(generator, drop_masks))
        grad_norm = self.optimizer.step()
        self.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    def backward(self, h, f0, out_pc, out_labels, drops: DropPathDraws) -> torch.Tensor:
        """Train-mode forward and backward on a built hierarchy: sets every
        parameter's ``.grad`` to the gradient of the masked label-smoothed
        loss (updating the BN running statistics) and returns the loss."""
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        total, count = self._loss_parts(self._forward(h, f0, out_pc, drops=drops), out_labels, out_pc)
        if not in_group():
            loss = total / count.clamp(min=1.0)
            loss.backward()
            return loss.detach()
        # the global batch's loss: the local sum over the global count
        sums = group_sum_(torch.stack([total.detach(), count.to(total.dtype)]))
        count = sums[1].clamp(min=1.0)
        (total / count).backward()
        self.sum_grads()
        return sums[0] / count

    def sum_grads(self) -> None:
        """Sum every parameter's ``.grad`` over the group's ranks, in one
        flattened buffer (no-op outside a group)."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if not in_group() or not grads:
            return
        flat = group_sum_(torch.cat([g.reshape(-1) for g in grads]))
        start = 0
        for g in grads:
            g.copy_(flat[start : start + g.numel()].view_as(g))
            start += g.numel()

    def backward_scenes(self, batch: dict, generator: Optional[torch.Generator] = None,
                        draws: Optional[Sequence[HierarchyDraws]] = None,
                        drop_masks: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                        n_frames: Optional[int] = None) -> torch.Tensor:
        """Scene-sequential forward and backward (``scan_scenes``): sets
        every parameter's ``.grad`` to the count-weighted mean gradient over
        the scenes of ``batch`` and returns ``sum(total) / sum(count)``."""
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        total = count = None
        for i in range(batch["mask"].shape[0]):
            scene = {k: v[i : i + 1] for k, v in batch.items()}
            h, f0, out_pc, out_labels, _ = self.build(
                scene, generator, None if draws is None else draws[i], train=True,
                n_frames=n_frames)
            drops = DropPathDraws(generator, None if drop_masks is None else drop_masks[i])
            t, c = self._loss_parts(self._forward(h, f0, out_pc, drops=drops), out_labels, out_pc)
            t.backward()
            total = t.detach() if total is None else total + t.detach()
            count = c if count is None else count + c
        denom = count.clamp(min=1.0)
        with torch.no_grad():
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(denom)
        return total / denom

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: Optional[torch.Generator] = None,
                  draws: Optional[HierarchyDraws] = None) -> dict:
        """Logits (``[B, M, classes]``; classification ``[B, classes]``),
        output mask, and (with labels) the loss and output labels;
        ``out_idx`` maps output points to raw ones."""
        return self.eval_ensemble(batch, [None], generator, draws)[0]

    def load_member(self, state_dict: dict) -> None:
        """Load one ensemble member's weights (a model ``state_dict``)."""
        self.model.load_state_dict(state_dict)

    @torch.no_grad()
    def eval_ensemble(self, batch: dict, members: Sequence[Optional[dict]],
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[HierarchyDraws] = None) -> List[dict]:
        """:meth:`eval_step` of each member of a checkpoint ensemble, in
        order, on one hierarchy built once: a member is a model
        ``state_dict``, loaded before its forward, or None for the weights
        the model holds.  The members share the neighborhood cache."""
        h, f0, out_pc, out_labels, raw_to_out = self.build(batch, generator, draws, train=False)
        self.model.eval()
        provider = NeighborhoodProvider(h, self.model.spec)
        outs = []
        for member in members:
            if member is not None:
                self.load_member(member)
            logits = self._forward(h, f0, out_pc, provider=provider)
            out = {"logits": logits, "mask": out_pc.mask}
            if out_labels is not None:
                out["loss"] = self._loss(logits, out_labels, out_pc)
                out["labels"] = out_labels
            if raw_to_out is not None:
                out["out_idx"] = raw_to_out.chosen_idx
            outs.append(out)
        return outs
