"""Which combination of revisited accumulators fails, on the card (the port
of ``experiments/bisect_accum2.py``).

    python -m se3conv3d_tpu_torch.experiments.bisect_accum2 [tag ...]

runs the JAX script's seven combinations (default: all, in order) at grid
32, ``a [4096, 32, 64]``: each of ``dproj`` ``[18, 64]``, ``dbias`` ``[1,
64]``, ``dw2`` ``[64, 64, 64]`` alone and each pair, with ``dfeat = 2a``,
then all three without it; every output the sum of every value of ``a``.
Each runs as a trial of ``bisect_accum`` (:func:`bisect_accum.trial`:
``kernels.probes.block_total_accum`` held by :func:`bisect_accum.check_accum`)
and prints ``PASS tag seconds`` or ``FAIL tag error``.  The exit status is
1 if any failed.  Inputs come from a seeded generator on the card (the JAX
script's from ``os.urandom``).  It runs on the card and raises without one.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from .bisect_accum import GD, GQ, C, O, trial
from .common import require_cuda

__all__ = ["SHAPES", "GRID", "COMBINATIONS", "tag", "main"]

SHAPES = {"dproj": (GD, GQ), "dbias": (1, GQ), "dw2": (GQ, C, O)}
GRID = 32
# (names, with_dfeat), in the JAX script's order
COMBINATIONS = ((("dproj",), True), (("dbias",), True), (("dw2",), True), (("dproj", "dbias"), True),
                (("dproj", "dw2"), True), (("dbias", "dw2"), True), (("dproj", "dbias", "dw2"), False))


def tag(names, with_dfeat: bool) -> str:
    """The JAX script's name of a combination, e.g. ``dproj+dbias+dfeat``."""
    return "+".join(names) + ("+dfeat" if with_dfeat else "")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the combinations; returns the number that failed."""
    combos = {tag(*c): c for c in COMBINATIONS}
    names = list(sys.argv[1:] if argv is None else argv) or list(combos)
    unknown = [n for n in names if n not in combos]
    if unknown:
        raise SystemExit(f"no combination {unknown}; combinations: {tuple(combos)}")
    dev = require_cuda("bisect_accum2")
    failed = 0
    for seed, name in enumerate(names):
        outs, with_dfeat = combos[name]
        failed += not trial(name, [SHAPES[n] for n in outs], with_dfeat, GRID, 100 + seed, dev)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
