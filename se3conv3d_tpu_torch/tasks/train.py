"""Training CLI, the port's counterpart of ``tasks/train.py``: one entry
point driven by a recipe's YAML file, on the card.

    python -m se3conv3d_tpu_torch.tasks.train \\
        --conf_file configs/dfaust/dfaust_I_rot_pca_2F.yaml \\
        --data_folder /path/to/dfaust [--resume] [--max_epochs N]

Run it from the repository root: the recipes name their augmentation
modules by dotted path (``configs.dfaust.DFaust_DS_Aug``), so the root is
put on ``sys.path`` when :func:`main` runs.  Without a CUDA device it
raises; it never trains on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

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
                    help="one card only: values above 1 raise (data parallelism is not ported)")
    ap.add_argument("--max_epochs", type=int, default=None)
    ap.add_argument("--log_folder", default=None)
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of one training epoch (the second, "
                         "or the only one) to this directory")
    return ap


def main(argv: Optional[Sequence[str]] = None, **experiment_kwargs) -> Experiment:
    """Parse ``argv`` (default: the command line), train, and return the
    ``Experiment``.  ``experiment_kwargs`` go to ``Experiment`` (the tests
    pass ``device="cpu"``; the command line has no such flag)."""
    args = _parser().parse_args(argv)
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    exp = Experiment(args.conf_file, args.data_folder, n_devices=args.n_devices,
                     log_folder=args.log_folder, **experiment_kwargs)
    exp.run(resume=args.resume, max_epochs=args.max_epochs, profile_dir=args.profile_dir)
    return exp


if __name__ == "__main__":
    main()
