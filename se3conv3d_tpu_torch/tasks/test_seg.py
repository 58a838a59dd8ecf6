"""Segmentation evaluation CLI, the port's counterpart of
``tasks/test_seg.py``: voting over re-drawn augmentations and frames, an
optional checkpoint ensemble and segment smoothing, on the card.

    python -m se3conv3d_tpu_torch.tasks.test_seg \\
        --conf_file configs/scannet/scannet20_test_pca_I_SO2.yaml \\
        --log_folder <training run> --data_folder <data> \\
        [--vote_epochs N] [--checkpoints N] [--smooth_segments] [--save_output DIR]

``--conf_file`` is a training recipe, or a test-regime YAML (``Testing`` and
``Dataset`` sections) overlaid on the training recipe of the run under
evaluation: ``--train_conf``, or the ``config.yaml`` its log folder holds.
It runs exactly ``--vote_epochs`` votes, in groups of ``--votes_per_step``
(the last group takes the remainder; the JAX CLI rounds the count up to a
multiple of the group).  It prints the per-class table, ``mIoU / mAcc / OA``
and writes them with ``--save_output``; on ScanNet it also writes one
benchmark label file ``<scene>.txt`` and one coloured cloud
``<scene>_colored.txt`` per scene.  A split without labels gives
predictions only.  Run it from the repository root (the recipes name their
augmentation modules by dotted path).  Without a CUDA device it raises; it
never evaluates on the CPU unless the caller asks (``main(argv,
device="cpu")``).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..train.config import is_test_config, load_yaml_config, merge_test_config
from ..train.evaluate import SegmentationVoter
from ..train.metrics import dataset_class_mask
from ..train.run import Experiment, make_datasets, restore_ensemble
from ..utils.scannet_io import save_scannet20_scene_colors, save_scannet20_scene_labels

__all__ = ["main", "resolve_config", "vote_groups", "load_segments", "require_device"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m se3conv3d_tpu_torch.tasks.test_seg",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf_file", required=True,
                    help="training YAML, or a test-regime YAML (Testing + Dataset sections) "
                         "combined with --train_conf / --log_folder")
    ap.add_argument("--data_folder", required=True)
    ap.add_argument("--train_conf", default=None,
                    help="training YAML of the run under evaluation (needed with a test-regime "
                         "--conf_file unless --log_folder holds its config.yaml)")
    ap.add_argument("--vote_epochs", type=int, default=None,
                    help="default: Testing.num_epochs of the conf, else 30")
    ap.add_argument("--votes_per_step", type=int, default=1,
                    help="vote draws per eval step, as copies on the batch axis (frames and "
                         "augmentations re-drawn per copy)")
    ap.add_argument("--checkpoints", type=int, default=1,
                    help="ensemble the newest N stored checkpoints")
    ap.add_argument("--smooth_segments", action="store_true")
    ap.add_argument("--log_folder", default=None)
    ap.add_argument("--save_output", nargs="?", const="__from_conf__", default=None,
                    help="directory for the results (and, on ScanNet, per-scene benchmark label "
                         "files and coloured clouds); with no value, Testing.save_folder")
    return ap


def require_device(experiment_kwargs: dict) -> None:
    """Raise where there is no card and the caller did not ask for a device."""
    if experiment_kwargs.get("device") is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port evaluates on an NVIDIA GPU; call "
                           "main(argv, device='cpu') to run its plain PyTorch path on the CPU")


def resolve_config(args) -> tuple:
    """``(experiment config, Testing section)``: a training YAML as it is,
    or a test-regime YAML overlaid on the training recipe of
    ``--train_conf`` or of the log folder's ``config.yaml``."""
    cfg = load_yaml_config(args.conf_file)
    if not is_test_config(cfg):
        return cfg, {}
    train_conf = args.train_conf
    if train_conf is None and args.log_folder:
        candidate = os.path.join(args.log_folder, "config.yaml")
        if os.path.exists(candidate):
            train_conf = candidate
    if train_conf is None:
        raise SystemExit("test-regime config: pass --train_conf <training yaml>, or --log_folder "
                         "<training log dir> containing the saved config.yaml")
    return merge_test_config(load_yaml_config(train_conf), cfg)


def save_folder(args, testing: dict) -> Optional[str]:
    """``--save_output``'s directory (with no value: ``Testing.save_folder``)."""
    if args.save_output != "__from_conf__":
        return args.save_output
    if not testing.get("save_folder"):
        raise SystemExit("--save_output given without a value and the conf has no Testing.save_folder")
    return testing["save_folder"]


def vote_groups(vote_epochs: int, votes_per_step: int) -> List[int]:
    """The votes of each ``run_epoch`` call: groups of ``votes_per_step``,
    the last one the remainder, ``vote_epochs`` in all."""
    v = max(int(votes_per_step), 1)
    return [min(v, vote_epochs - k) for k in range(0, vote_epochs, v)]


def load_segments(exp: Experiment, data_folder: str) -> None:
    """Rebuild the eval dataset with its ScanNet segment ids attached."""
    if not getattr(exp.val_ds, "load_segments", False):
        exp.val_ds = make_datasets(exp.ds_cfg, data_folder, "val", load_segments=True)


def main(argv: Optional[Sequence[str]] = None, **experiment_kwargs) -> tuple:
    """Parse ``argv`` (default: the command line), vote, report; returns
    ``(voter, summary)`` (summary None for a split without labels).
    ``experiment_kwargs`` go to ``Experiment`` (the tests pass
    ``device="cpu"``; the command line has no such flag)."""
    args = _parser().parse_args(argv)
    require_device(experiment_kwargs)
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    cfg, testing = resolve_config(args)
    vote_epochs = args.vote_epochs if args.vote_epochs is not None else int(testing.get("num_epochs", 30))
    out_dir = save_folder(args, testing)

    exp = Experiment(cfg, args.data_folder, log_folder=args.log_folder, **experiment_kwargs)
    if args.smooth_segments:
        load_segments(exp, args.data_folder)
    states = restore_ensemble(exp, args.checkpoints)
    voter = SegmentationVoter(exp.trainer, exp.val_ds, exp.num_classes, exp.capacity,
                              trainer_factory=exp.make_eval_trainer,
                              votes_per_step=args.votes_per_step)
    done = 0
    for epoch, votes in enumerate(vote_groups(vote_epochs, args.votes_per_step)):
        voter.run_epoch(states, epoch, votes)
        done += votes
        print(f"vote epoch {done}/{vote_epochs}", flush=True)

    if hasattr(exp.val_ds, "scenes"):
        full_labels = [s.get("labels") for s in exp.val_ds.scenes]
        segments = [s.get("segments") for s in exp.val_ds.scenes] if args.smooth_segments else None
    else:
        full_labels = [exp.val_ds[i].get("labels") for i in range(len(exp.val_ds))]
        segments = None
    summary = None
    if any(labels is not None for labels in full_labels):
        class_mask = dataset_class_mask(exp.val_ds, exp.num_classes)
        summary = voter.metrics(full_labels, segments, class_mask, smooth=args.smooth_segments)
        # per-class table, reference format (test_dfaust_rot.py:346-365)
        names = getattr(exp.val_ds, "class_names", None) or [f"class_{i}" for i in range(exp.num_classes)]
        for i in range(exp.num_classes):
            masked = "" if class_mask is None or class_mask[i] else "  (masked)"
            print(f"{names[i][:24]:>24} | acc {summary['acc_per_class'][i] * 100:6.2f}"
                  f" | iou {summary['iou_per_class'][i] * 100:6.2f}{masked}")
        print(f"mIoU: {summary['miou']:.4f}  mAcc: {summary['macc']:.4f}  OA: {summary['overall_acc']:.4f}")
    else:
        # an unlabeled split (the ScanNet benchmark test set): predictions only
        print("no labels in the evaluation split; skipping metrics")

    if out_dir and summary is not None:
        # the reference's save_results format (test_dfaust_rot.py:164-172)
        os.makedirs(out_dir, exist_ok=True)
        np.savetxt(os.path.join(out_dir, "per_class_iou.txt"), summary["iou_per_class"])
        np.savetxt(os.path.join(out_dir, "per_class_acc.txt"), summary["acc_per_class"])
        with open(os.path.join(out_dir, "results.txt"), "w") as f:
            f.write(f"mIoU: {summary['miou']:.4f} \n")
            f.write(f"mAcc: {summary['macc']:.4f} \n")
            f.write(f"OA: {summary['overall_acc']:.4f} \n")
    if out_dir and exp.dataset_name.startswith("scannet"):
        # per-scene voted predictions in the benchmark format (reference
        # test_scannet_rot.py:396-465 and scannet_io.py)
        os.makedirs(out_dir, exist_ok=True)
        for i, name in enumerate(exp.val_ds.file_list):
            if voter.accum[i] is None:
                continue
            pred = voter.accum[i].cpu().numpy().argmax(-1)
            save_scannet20_scene_labels(os.path.join(out_dir, f"{name}.txt"), pred)
            save_scannet20_scene_colors(os.path.join(out_dir, f"{name}_colored.txt"),
                                        exp.val_ds.scenes[i]["points"][:, :3], pred)
        print(f"saved predictions for {len(exp.val_ds.file_list)} scenes to {out_dir}")
    return voter, summary


if __name__ == "__main__":
    main()
