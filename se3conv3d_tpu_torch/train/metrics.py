"""Segmentation and classification metrics (counterpart of
``se3conv3d_tpu/train/metrics.py``).

:class:`SemSegMetrics` accumulates per-class intersection / union /
ground-truth / prediction counts on the host (reference
``metrics/SemSegMetrics.py:3-68``) and reports per-class and mean IoU and
accuracy with an optional class mask (ScanNet's ignored classes).  Masked
points count for nothing, nor do ids outside ``[0, classes)``, as in the
JAX package's one-hot counts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["SemSegMetrics", "accuracy", "dataset_class_mask"]


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dataset_class_mask(ds, num_classes: int) -> Optional[np.ndarray]:
    """Metric class mask from a dataset's declared ``mask_classes`` (ScanNet:
    class 0, plus the 11 train-only classes on scannet200 val/test); None
    for datasets that score every class (DFaust, ModelNet40)."""
    mask_classes = getattr(ds, "mask_classes", None)
    if not mask_classes:
        return None
    class_mask = np.ones(num_classes, bool)
    for c in mask_classes:
        class_mask[c] = False
    return class_mask


@dataclasses.dataclass(frozen=True)
class SemSegMetrics:
    """Per-class int64 counts; :meth:`update` returns a new accumulator."""

    intersection: np.ndarray  # [C]
    union: np.ndarray  # [C]
    gt_count: np.ndarray  # [C]
    pred_count: np.ndarray  # [C]

    @classmethod
    def empty(cls, num_classes: int) -> "SemSegMetrics":
        z = np.zeros((num_classes,), np.int64)
        return cls(intersection=z, union=z, gt_count=z, pred_count=z)

    @property
    def num_classes(self) -> int:
        return self.intersection.shape[0]

    def update(self, pred, labels, mask) -> "SemSegMetrics":
        """Accumulate predicted class ids against labels (numpy arrays or
        tensors of any one shape) where ``mask`` is set."""
        c = self.num_classes
        m = _numpy(mask).reshape(-1).astype(bool)
        pred = _numpy(pred).reshape(-1)[m].astype(np.int64)
        labels = _numpy(labels).reshape(-1)[m].astype(np.int64)
        p_ok = (pred >= 0) & (pred < c)
        l_ok = (labels >= 0) & (labels < c)
        pred_cnt = np.bincount(pred[p_ok], minlength=c)
        gt_cnt = np.bincount(labels[l_ok], minlength=c)
        inter = np.bincount(labels[l_ok & p_ok & (pred == labels)], minlength=c)
        return SemSegMetrics(
            intersection=self.intersection + inter,
            union=self.union + pred_cnt + gt_cnt - inter,
            gt_count=self.gt_count + gt_cnt,
            pred_count=self.pred_count + pred_cnt,
        )

    def summary(self, class_mask: Optional[Sequence[bool]] = None) -> dict:
        """Per-class and mean IoU / accuracy; ``class_mask`` selects the
        classes the means take."""
        inter = self.intersection.astype(np.float64)
        union = self.union.astype(np.float64)
        gt = self.gt_count.astype(np.float64)
        iou = inter / np.maximum(union, 1.0)
        acc = inter / np.maximum(gt, 1.0)
        sel = np.ones_like(iou, bool) if class_mask is None else np.asarray(class_mask, bool)
        return {
            "iou_per_class": iou,
            "acc_per_class": acc,
            "miou": float(iou[sel].mean()) if sel.any() else 0.0,
            "macc": float(acc[sel].mean()) if sel.any() else 0.0,
            "overall_acc": float(inter.sum() / max(gt.sum(), 1.0)),
        }


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Classification top-1 accuracy of ``[B, C]`` logits (a float32
    scalar, as the JAX package's)."""
    return (logits.argmax(-1) == labels).to(torch.float32).mean()
