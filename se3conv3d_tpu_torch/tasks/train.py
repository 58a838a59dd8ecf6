"""Training CLI, the port's counterpart of ``tasks/train.py``: one entry
point driven by a recipe's YAML file, on the card.

    python -m se3conv3d_tpu_torch.tasks.train \\
        --conf_file configs/dfaust/dfaust_I_rot_pca_2F.yaml \\
        --data_folder /path/to/dfaust [--resume] [--max_epochs N] [--n_devices N]

Run it from the repository root: the recipes name their augmentation
modules by dotted path (``configs.dfaust.DFaust_DS_Aug``), so the root is
put on ``sys.path`` when :func:`main` runs.  Without a CUDA device it
raises; it never trains on the CPU.  ``--n_devices N`` (N >= 2) trains over
N ranks, one process per card on ``cuda:0`` ... ``cuda:N-1`` over NCCL
(``parallel.mesh``), and raises where the machine has fewer cards.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from ..parallel.mesh import launch, make_group
from ..train.run import Experiment

__all__ = ["main"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m se3conv3d_tpu_torch.tasks.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf_file", required=True)
    ap.add_argument("--data_folder", required=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--n_devices", type=int, default=None,
                    help="train over this many ranks, one process per card (data parallelism)")
    ap.add_argument("--max_epochs", type=int, default=None)
    ap.add_argument("--log_folder", default=None)
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of one training epoch (the second, "
                         "or the only one) to this directory")
    return ap


def group_from(n_devices: int, experiment_kwargs: dict):
    """The CLIs' data-parallel group of ``n_devices`` ranks: every card by
    default, or ``experiment_kwargs``' ``devices`` and ``backend`` (popped),
    or ``n_devices`` ranks on its ``device`` (gloo on the CPU)."""
    devices = experiment_kwargs.pop("devices", None)
    backend = experiment_kwargs.pop("backend", None)
    device = experiment_kwargs.pop("device", None)
    if devices is None and device is not None:
        devices = [device] * n_devices
    return make_group(n_devices, devices=devices, backend=backend)


def _train_rank(rank_index: int, argv, experiment_kwargs: dict) -> dict:
    exp = _train(argv, experiment_kwargs)
    return {"rank": rank_index, "history": exp.history, "trainer_step": exp.trainer.step,
            "checkpoints": exp.ckpt.all_steps()}


def _train(argv, experiment_kwargs: dict) -> Experiment:
    args = _parser().parse_args(argv)
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    exp = Experiment(args.conf_file, args.data_folder, n_devices=args.n_devices,
                     log_folder=args.log_folder, **experiment_kwargs)
    exp.run(resume=args.resume, max_epochs=args.max_epochs, profile_dir=args.profile_dir)
    return exp


def main(argv: Optional[Sequence[str]] = None, **experiment_kwargs):
    """Parse ``argv`` (default: the command line), train, and return the
    ``Experiment``.  ``experiment_kwargs`` go to ``Experiment`` (the tests
    pass ``device="cpu"``; the command line has no such flag).  With
    ``--n_devices`` N >= 2 the ranks train in N new processes (their group:
    :func:`group_from`) and this returns each rank's ``{"rank", "history",
    "trainer_step", "checkpoints"}``, in rank order."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n = _parser().parse_args(argv).n_devices
    if n is not None and n > 1:
        group = group_from(n, experiment_kwargs)
        return launch(group, _train_rank, argv, experiment_kwargs)
    return _train(argv, experiment_kwargs)


if __name__ == "__main__":
    main()
