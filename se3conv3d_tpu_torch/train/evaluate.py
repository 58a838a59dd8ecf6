"""Test-time evaluation with logit voting and segment smoothing (counterpart
of ``se3conv3d_tpu/train/evaluate.py``).

Reference evaluation CLIs (SURVEY §3.3): ``test_dfaust_rot.py:293-315`` /
``test_scannet_rot.py:294-312`` accumulate per-scene logits at full
resolution over the vote epochs, re-drawing augmentations (through the
augmentation pipelines' epoch counters) and reference frames each pass;
``test_scannet_rot.py:314-329`` smooths them over ScanNet segments;
``test_rot.py:111-156`` votes classification logits over epochs and a
checkpoint ensemble.

What it keeps from the JAX package: the float64 accumulators, one epoch
counter step per :meth:`SegmentationVoter.run_epoch`, ``votes_per_step``
copies of a scene on the batch axis, the ``valid_ids`` and ``out_idx``
remapping, the capacity buckets of scenes above the eval capacity, the
padded trailing classification batch, the metrics.  What changes for
PyTorch: the hierarchy draws of scene ``i`` in vote epoch ``e`` come from
one ``torch.Generator`` seeded with the integer of the JAX key,
``e * 100003 + i`` (classification: ``e * 99991 + start``), so a test can
map each draw to the JAX key (``generator.initial_seed()``); an ensemble's
members share one hierarchy build per scene and vote
(``Trainer.eval_ensemble``); the segmentation accumulators are float64
tensors on the trainer's device (within one vote no raw point receives two
output rows, so ``index_add_`` gives the JAX sums bitwise).  One process:
``process_index`` / ``process_count`` stay plain ints, defaulting to 0 and
1, only to keep the JAX voters' arguments (the multi-host
``cross_host_sum`` is not ported, and no caller of the port sets them).

Two deviations from the JAX package, both its defects: a scene's buffer is
sized by the dataset's ``get_num_pts`` where it has one, else by the first
draw, and a draw whose point count differs from the buffer's without
``valid_ids`` (or whose ``valid_ids`` fall outside it) raises
``ValueError`` naming the scene, where the JAX voter indexes out of bounds
or adds at the wrong points; and ``run_epoch`` takes the number of votes of
its group, so a caller can run exactly the votes asked for.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.loaders import pad_collate
from .metrics import SemSegMetrics
from .trainer import to_tensors

__all__ = ["CAPACITY_BUCKET", "SegmentationVoter", "ClassificationVoter", "segment_smooth"]

# a scene above the eval capacity runs at its point count rounded up to a
# multiple of this
CAPACITY_BUCKET = 16384


def segment_smooth(logits: np.ndarray, segments: np.ndarray) -> np.ndarray:
    """Mean logits per segment id, broadcast back to points (reference
    ``test_scannet_rot.py:314-329``)."""
    n_seg = int(segments.max()) + 1
    sums = np.zeros((n_seg, logits.shape[-1]), logits.dtype)
    np.add.at(sums, segments, logits)
    counts = np.bincount(segments, minlength=n_seg)[:, None]
    return (sums / np.maximum(counts, 1))[segments]


def _members(states) -> list:
    """``states`` (None: the weights the model holds; a ``state_dict``; a
    list of them) as a list of ensemble members."""
    if states is None or isinstance(states, dict):
        return [states]
    return list(states)


def _load_single(trainer, members: list) -> list:
    """A one-member ensemble is loaded once, not once per batch: returns the
    members to pass to ``eval_ensemble``."""
    if len(members) == 1 and members[0] is not None:
        trainer.load_member(members[0])
        return [None]
    return members


class SegmentationVoter:
    """Full-resolution logit voting over re-drawn augmentations and frames.

    Args:
      trainer: a ``Trainer`` (its eval step returns ``out_idx`` where the
        recipe subsamples the output cloud).
      dataset: a segmentation dataset; its scenes give full-resolution
        labels (and segments) with augmentations re-drawn per epoch.
      capacity: the pad capacity of single-scene batches.
      trainer_factory: ``capacity -> Trainer`` for scenes above
        ``capacity``, each run at its point count rounded up to a multiple
        of ``CAPACITY_BUCKET`` (``Experiment.make_eval_trainer``).
      votes_per_step: copies of a scene per eval step, each its own vote.
    """

    def __init__(self, trainer, dataset, num_classes: int, capacity: int,
                 trainer_factory=None, process_index: int = 0,
                 process_count: int = 1, votes_per_step: int = 1):
        self.trainer = trainer
        self.dataset = dataset
        self.num_classes = num_classes
        self.capacity = capacity
        # per scene: float64 [points, classes] on the trainer's device
        self.accum: List[Optional[torch.Tensor]] = [None] * len(dataset)
        self.process_index = process_index
        self.process_count = process_count
        # One eval step carries V copies of a scene on the batch axis: the
        # frames are drawn per point and the host augmentations per copy, so
        # they are V independent votes.  An epoch-scheduled augmentation
        # advances once per run_epoch, i.e. per group of V.
        self.votes_per_step = max(int(votes_per_step), 1)
        # Scenes above the capacity (real ScanNet scenes reach about 1.5M
        # points, which the reference feeds whole) run at a capacity bucket.
        self.trainer_factory = trainer_factory
        self.bucket_trainers = {}

    def _trainer_for(self, n_raw: int):
        if n_raw <= self.capacity:
            return self.trainer, self.capacity
        if self.trainer_factory is None:
            raise ValueError(f"scene with {n_raw} points exceeds the evaluator capacity "
                             f"{self.capacity} and no trainer_factory was provided")
        cap = -(-n_raw // CAPACITY_BUCKET) * CAPACITY_BUCKET
        if cap not in self.bucket_trainers:
            self.bucket_trainers[cap] = self.trainer_factory(cap)
        return self.bucket_trainers[cap], cap

    def _raw_ids(self, i: int, sample: dict, n_raw: int) -> Optional[torch.Tensor]:
        """The scene's point of each of the sample's points, checked against
        the scene's buffer (None: the sample's own order)."""
        rows = self.accum[i].shape[0]
        valid_ids = sample.get("valid_ids")
        if valid_ids is None:
            if n_raw != rows:
                raise ValueError(
                    f"scene {i}: a draw of {n_raw} points has no valid_ids to map it onto the "
                    f"scene's {rows} points (the dataset has no get_num_pts, or its draw crops)")
            return None
        if len(valid_ids) and int(np.max(valid_ids)) >= rows:
            raise ValueError(f"scene {i}: valid_ids reach point {int(np.max(valid_ids))} of a "
                             f"buffer of {rows} points")
        return torch.from_numpy(np.asarray(valid_ids, np.int64))

    def run_epoch(self, states=None, epoch: int = 0, votes: Optional[int] = None) -> None:
        """One group of ``votes`` (default ``votes_per_step``) votes of
        every scene.  ``states``: None (the weights the model holds), a
        model ``state_dict`` or a list of them (a checkpoint ensemble: each
        member's logits go into the same buffers)."""
        members = _load_single(self.trainer, _members(states))
        self.dataset.increase_epoch_counter()
        v = self.votes_per_step if votes is None else int(votes)
        for i in range(self.process_index, len(self.dataset), self.process_count):
            samples = [self.dataset[i] for _ in range(v)]
            n_raws = [s["positions"].shape[0] for s in samples]
            keeps = [{k: val for k, val in s.items() if k in ("positions", "features", "labels")}
                     for s in samples]
            trainer, cap = self._trainer_for(max(n_raws))
            batch = to_tensors(pad_collate(keeps, capacity=cap), trainer.device)
            if self.accum[i] is None:
                full_n = (self.dataset.get_num_pts(i) if hasattr(self.dataset, "get_num_pts")
                          else n_raws[0])
                self.accum[i] = torch.zeros((full_n, self.num_classes), dtype=torch.float64,
                                            device=trainer.device)
            raw_ids = [self._raw_ids(i, s, n) for s, n in zip(samples, n_raws)]
            gen = torch.Generator(device=trainer.device).manual_seed(epoch * 100003 + i)
            for out in trainer.eval_ensemble(batch, members, gen):
                self._accumulate(i, out, n_raws, raw_ids, cap)

    def _accumulate(self, i: int, out: dict, n_raws, raw_ids, cap: int) -> None:
        acc = self.accum[i]
        for j, n_raw in enumerate(n_raws):
            rows = torch.nonzero(out["mask"][j]).reshape(-1)
            idx = out["out_idx"][j][rows] if "out_idx" in out else rows
            ok = idx < n_raw
            orig = idx[ok].to(acc.device, torch.int64)
            if raw_ids[j] is not None:
                orig = raw_ids[j].to(acc.device)[orig]
            acc.index_add_(0, orig, out["logits"][j][rows[ok]].to(acc.device, torch.float64))

    def metrics(self, full_labels: Sequence[Optional[np.ndarray]],
                segments: Optional[Sequence[np.ndarray]] = None, class_mask=None,
                smooth: bool = False) -> dict:
        """Per-class and mean IoU / accuracy of the voted predictions over
        the points that received a logit (``smooth``: after
        :func:`segment_smooth` over each scene's ``segments``)."""
        m = SemSegMetrics.empty(self.num_classes)
        for i, labels in enumerate(full_labels):
            if self.accum[i] is None or labels is None:
                continue
            logits = self.accum[i].cpu().numpy()
            if smooth and segments is not None:
                logits = segment_smooth(logits, segments[i])
            m = m.update(logits.argmax(-1), labels, logits.sum(-1) != 0)
        return m.summary(class_mask)


class ClassificationVoter:
    """Logit voting over epochs and a checkpoint ensemble (reference
    ``test_rot.py:111-156``); ``accum`` (float64) and ``labels`` are numpy
    arrays on the host."""

    def __init__(self, trainer, dataset, num_classes: int, capacity: int, batch_size: int = 8,
                 process_index: int = 0, process_count: int = 1):
        self.trainer = trainer
        self.dataset = dataset
        self.num_classes = num_classes
        self.capacity = capacity
        self.batch_size = batch_size
        self.accum = np.zeros((len(dataset), num_classes), np.float64)
        self.labels = np.zeros((len(dataset),), np.int64)
        self.process_index = process_index
        self.process_count = process_count

    def run_epoch(self, states=None, epoch: int = 0) -> None:
        """One vote of every shape, in batches of ``batch_size``; the
        trailing partial batch is padded with its last shape, and only its
        real shapes accumulate."""
        members = _load_single(self.trainer, _members(states))
        self.dataset.increase_epoch_counter()
        mine = list(range(self.process_index, len(self.dataset), self.process_count))
        for start in range(0, len(mine), self.batch_size):
            idx = mine[start : start + self.batch_size]
            samples = [self.dataset[i] for i in idx]
            while len(samples) < self.batch_size:
                samples.append(samples[-1])
            batch = pad_collate([{"positions": s["positions"], "features": s["features"],
                                  "labels": s["label"]} for s in samples], capacity=self.capacity)
            gen = torch.Generator(device=self.trainer.device).manual_seed(epoch * 99991 + start)
            for out in self.trainer.eval_ensemble(to_tensors(batch, self.trainer.device), members, gen):
                self.accum[idx] += out["logits"][: len(idx)].cpu().numpy()
            self.labels[idx] = [int(s["label"]) for s in samples[: len(idx)]]

    def accuracy(self) -> float:
        return float((self.accum.argmax(-1) == self.labels).mean())

    def class_accuracy(self) -> float:
        """Class-balanced accuracy: the mean of the per-class accuracies of
        the classes present (reference ``test_rot.py:284-291``)."""
        return float(np.mean(self.per_class_accuracy()))

    def per_class_accuracy(self) -> np.ndarray:
        equal = self.accum.argmax(-1) == self.labels
        return np.array([equal[self.labels == c].mean() for c in range(self.num_classes)
                         if (self.labels == c).any()])
