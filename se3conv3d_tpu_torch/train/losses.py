"""Losses (counterpart of ``se3conv3d_tpu/train/losses.py``): label-smoothed
cross entropy over valid, non-ignored output points (segmentation) or over
the clouds of a batch (classification)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_cross_entropy", "masked_segmentation_loss_parts",
           "classification_loss_parts", "classification_loss"]


def softmax_cross_entropy(logits, labels, label_smoothing: float = 0.0):
    """Per-element cross entropy; smoothed target ``(1-s) onehot + s/C``."""
    num_classes = logits.shape[-1]
    log_probs = torch.log_softmax(logits, -1)
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(logits.dtype)
    target = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    return -(target * log_probs).sum(-1)


def masked_segmentation_loss_parts(logits, labels, mask, label_smoothing: float = 0.0,
                                   ignore_label: Optional[int] = None):
    """Unnormalised ``(total, count)`` of the masked cross entropy."""
    valid = mask
    if ignore_label is not None:
        valid = valid & (labels != ignore_label)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = softmax_cross_entropy(logits, safe, label_smoothing)
    total = torch.where(valid, ce, torch.zeros_like(ce)).sum()
    return total, valid.sum().to(ce.dtype)


def classification_loss_parts(logits, labels, label_smoothing: float = 0.0,
                              example_mask: Optional[torch.Tensor] = None):
    """Unnormalised ``(total, count)`` of the cross entropy of ``[B, C]``
    logits over the batch; ``example_mask [B]`` leaves filler clouds out."""
    ce = softmax_cross_entropy(logits, labels, label_smoothing)
    if example_mask is None:
        return ce.sum(), torch.tensor(float(ce.shape[0]), dtype=ce.dtype, device=ce.device)
    total = torch.where(example_mask, ce, torch.zeros_like(ce)).sum()
    return total, example_mask.sum().to(ce.dtype)


def classification_loss(logits, labels, label_smoothing: float = 0.0,
                        example_mask: Optional[torch.Tensor] = None):
    """Mean cross entropy over the (unmasked) clouds of the batch."""
    total, count = classification_loss_parts(logits, labels, label_smoothing, example_mask)
    return total / count.clamp(min=1.0)
