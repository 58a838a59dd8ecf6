"""Classification evaluation CLI, the port's counterpart of
``tasks/test_class.py``: voting over vote epochs and a checkpoint ensemble,
on the card.

    python -m se3conv3d_tpu_torch.tasks.test_class \\
        --conf_file configs/modelnet40/modelnet40_test_rot.yaml \\
        --log_folder <training run> --data_folder <data> \\
        [--vote_epochs N] [--checkpoints N] [--save_output DIR]

``--conf_file`` is a training recipe or a test-regime YAML, resolved as
``test_seg`` resolves it (``Testing.batch_size`` becomes the eval batch).
It prints ``Acc:`` and ``Class Acc:``; ``--save_output`` writes
``accum_logits.txt``, ``class_acc_list.txt`` and ``results.txt``.  Without
a CUDA device it raises unless the caller asks for the CPU (``main(argv,
device="cpu")``).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from ..train.evaluate import ClassificationVoter
from ..train.run import Experiment, restore_ensemble
from .test_seg import REPO_ROOT, require_device, resolve_config, save_folder

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m se3conv3d_tpu_torch.tasks.test_class",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf_file", required=True,
                    help="training YAML, or a test-regime YAML combined with --train_conf / --log_folder")
    ap.add_argument("--data_folder", required=True)
    ap.add_argument("--train_conf", default=None,
                    help="training YAML of the run under evaluation (needed with a test-regime "
                         "--conf_file unless --log_folder holds its config.yaml)")
    ap.add_argument("--vote_epochs", type=int, default=None,
                    help="default: Testing.num_epochs of the conf, else 10")
    ap.add_argument("--checkpoints", type=int, default=1,
                    help="ensemble the newest N stored checkpoints")
    ap.add_argument("--log_folder", default=None)
    ap.add_argument("--save_output", nargs="?", const="__from_conf__", default=None,
                    help="directory for the accumulated logits and the accuracy text files; "
                         "with no value, Testing.save_folder")
    return ap


def main(argv: Optional[Sequence[str]] = None, **experiment_kwargs) -> tuple:
    """Parse ``argv`` (default: the command line), vote, report; returns
    ``(voter, summary)`` with ``summary = {"accuracy", "class_accuracy"}``.
    ``experiment_kwargs`` go to ``Experiment`` (the tests pass
    ``device="cpu"``)."""
    args = _parser().parse_args(argv)
    require_device(experiment_kwargs)
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    cfg, testing = resolve_config(args)
    vote_epochs = args.vote_epochs if args.vote_epochs is not None else int(testing.get("num_epochs", 10))
    out_dir = save_folder(args, testing)

    exp = Experiment(cfg, args.data_folder, log_folder=args.log_folder, **experiment_kwargs)
    states = restore_ensemble(exp, args.checkpoints)
    voter = ClassificationVoter(exp.trainer, exp.val_ds, exp.num_classes, exp.capacity,
                                batch_size=int(exp.tr.get("batch_size", 8)))
    for epoch in range(vote_epochs):
        voter.run_epoch(states, epoch)
        print(f"vote epoch {epoch + 1}/{vote_epochs}: acc={voter.accuracy():.4f}", flush=True)

    # final report, reference format (test_rot.py:293-294)
    acc, class_acc = voter.accuracy(), voter.class_accuracy()
    print("Acc: {:.2f} ".format(acc * 100.0))
    print("Class Acc: {:.2f} ".format(class_acc * 100.0))
    if out_dir:
        # the reference's save_results payload (test_rot.py:159-169)
        os.makedirs(out_dir, exist_ok=True)
        np.savetxt(os.path.join(out_dir, "accum_logits.txt"), voter.accum)
        np.savetxt(os.path.join(out_dir, "class_acc_list.txt"), voter.per_class_accuracy())
        with open(os.path.join(out_dir, "results.txt"), "w") as f:
            f.write("Acc: {:.2f} \n".format(acc * 100.0))
            f.write("Class Acc: {:.2f} \n".format(class_acc * 100.0))
        print(f"saved results to {out_dir}")
    return voter, {"accuracy": acc, "class_accuracy": class_acc}


if __name__ == "__main__":
    main()
