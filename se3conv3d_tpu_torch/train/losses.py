"""Segmentation loss (counterpart of ``se3conv3d_tpu/train/losses.py``):
label-smoothed cross entropy over valid, non-ignored output points."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_cross_entropy", "masked_segmentation_loss_parts"]


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
