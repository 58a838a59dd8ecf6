"""Accumulate into outputs that every grid block revisits, at growing grids,
on the card (the port of ``experiments/bisect_accum.py``).

    python -m se3conv3d_tpu_torch.experiments.bisect_accum [name ...]

runs the JAX script's six trials (default: all, in order): grids of 16, 32
and 64 blocks of ``a [128, 32, 64]`` with the three accumulators (d_proj
``[18, 64]``, d_bias ``[1, 64]``, dW2 ``[64, 64, 64]``) and ``dfeat = 2a``;
then at grid 32 the three without dfeat, one with it and dfeat alone.  Each
trial runs ``kernels.probes.block_total_accum`` and prints ``PASS name
seconds`` or ``FAIL name error``.  On the TPU a trial passed when Mosaic
lowered and ran its kernel; here it passes when the kernel builds, launches
and agrees with its plain version: dfeat bit for bit, every element of
every accumulator the same value, within ``1e-9 * sum |a|`` of the float64
total (:data:`SUM_RTOL`).  The exit status is 1 if any trial failed.  Each trial draws ``a`` from a seeded generator on the
card (the JAX script's from ``os.urandom``).  It runs on the card and
raises without one.
"""
from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import torch

from ..kernels import probes
from .common import require_cuda

__all__ = ["TM", "E", "G", "D", "Q", "C", "O", "GD", "GQ", "SHAPES", "SUM_RTOL", "TRIALS", "draw", "check_accum",
           "planted_totals", "trial", "main"]

TM, E, G, D, Q, C, O = probes.TM, 32, 2, 9, 32, 64, 64
GD, GQ = G * D, G * Q
# the accumulators in the JAX script's order: d_proj, d_bias, dW2
SHAPES = ((GD, GQ), (1, GQ), (GQ, C, O))
# a total against the float64 one, over sum |a|: float32 sums in other
# orders read about 1e-10, planted_totals' 6e-8 or more (PERF.md)
SUM_RTOL = 1e-9
# values in one chunk of planted_totals' wrong totals: chunk sums rounded
# to bfloat16, or one chunk left out, must fail check_accum
CHUNK = 16384
# name: (grid_n, n_accum, with_dfeat), in the JAX script's order
TRIALS = {f"grid{gn}_accum3_dfeat": (gn, 3, True) for gn in (16, 32, 64)}
TRIALS.update({"grid32_accum3_nodfeat": (32, 3, False), "grid32_accum1_dfeat": (32, 1, True),
               "grid32_accum0_dfeat": (32, 0, True)})


def draw(grid_n: int, seed: int, device) -> torch.Tensor:
    """``a [TM * grid_n, E, C]``, standard normal from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(TM * grid_n, E, C, generator=gen, device=device)


def check_accum(a: torch.Tensor, got: Sequence[torch.Tensor], shapes, with_dfeat: bool) -> float:
    """Holds :func:`probes.block_total_accum`'s outputs against the plain
    version (shapes, dfeat bit for bit) and the float64 total; returns the
    worst ``|total - float64 total| / sum |a|``, raises ``ValueError`` on a
    disagreement."""
    ref = probes.block_total_accum_reference(a, shapes, with_dfeat)
    if [tuple(x.shape) for x in got] != [tuple(x.shape) for x in ref]:
        raise ValueError(f"shapes {[tuple(x.shape) for x in got]}, plain version {[tuple(x.shape) for x in ref]}")
    if with_dfeat:
        if not torch.equal(got[0], ref[0]):
            raise ValueError("dfeat is not 2a bit for bit")
        got = got[1:]
    exact, terms = float(a.double().sum()), float(a.double().abs().sum())
    worst = 0.0
    for x in got:
        v = x.reshape(-1)[0]
        if not (bool(torch.isfinite(v)) and bool((x == v).all())):
            raise ValueError(f"accumulator {tuple(x.shape)} is not one finite value")
        err = abs(float(v) - exact) / terms
        if err > SUM_RTOL:
            raise ValueError(f"accumulator {tuple(x.shape)}: |kernel - float64 total| = {err:.3e} of sum |a| "
                             f"(bound {SUM_RTOL:g})")
        worst = max(worst, err)
    return worst


def planted_totals(a: torch.Tensor) -> dict:
    """Wrong totals that :func:`check_accum` must reject: the kernel's chunk
    totals rounded to bfloat16 before they are added, and the total with
    its first chunk left out."""
    chunks = a.reshape(-1, CHUNK).sum(1)
    return {"bf16_partials": chunks.bfloat16().float().sum(), "dropped_chunk": chunks[1:].sum()}


def trial(name: str, shapes, with_dfeat: bool, grid_n: int, seed: int, device) -> bool:
    """One trial; prints PASS or FAIL, returns whether it passed."""
    a = draw(grid_n, seed, device)
    try:
        t0 = time.perf_counter()
        got = probes.block_total_accum(a, shapes, with_dfeat)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        err = check_accum(a, got, shapes, with_dfeat)
        print(f"PASS {name:24s} {dt:6.3f}s  max_rel_err={err:.3e}", flush=True)
        return True
    except (RuntimeError, ValueError) as e:
        print(f"FAIL {name:24s} {type(e).__name__}: {str(e)[:160]}", flush=True)
        return False


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the trials; returns the number that failed."""
    names = list(sys.argv[1:] if argv is None else argv) or list(TRIALS)
    unknown = [n for n in names if n not in TRIALS]
    if unknown:
        raise SystemExit(f"no trial {unknown}; trials: {tuple(TRIALS)}")
    dev = require_cuda("bisect_accum")
    failed = 0
    for seed, name in enumerate(names):
        grid_n, n_accum, with_dfeat = TRIALS[name]
        failed += not trial(name, SHAPES[:n_accum], with_dfeat, grid_n, seed, dev)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
