"""The Mosaic pattern probes on the card (the port of
``experiments/probe_mosaic.py``).

    python -m se3conv3d_tpu_torch.experiments.probe_mosaic [name ...]

runs the named probes (default: all 17, in the JAX script's order), each a
product, reshape, slice, transpose, mid-index write or revisited
accumulation at TM = 128, E = 32, G = 2, D = 9, Q = 32, C = O = 64
(``kernels.mosaic_probes.PROBES``), and prints ``PASS name seconds out
shape`` or ``FAIL name error``.  On the TPU a probe passed when Mosaic
lowered and ran its kernel; here it passes when its kernel builds, launches
and agrees with its plain version: copies bit for bit, products within
``1e-5 * max |plain|`` (float32 sums in other orders; p10's bfloat16
products are exact in float32), p11's column sums within ``1e-6`` of their
terms' magnitudes.  The exit status is 1 if any probe failed.  Inputs come
from a seeded generator on the card (the JAX script's ``fresh`` from a key
of ``os.urandom``).  It runs on the card and raises without one.
"""
from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import torch

from ..kernels import mosaic_probes as mp
from .common import require_cuda

__all__ = ["PRODUCT_RTOL", "SUM_RTOL", "draw", "check", "main"]

# products: float32 sums in other orders; p11: float32 column sums
PRODUCT_RTOL, SUM_RTOL = 1e-5, 1e-6


def draw(name: str, seed: int, device) -> list:
    """The inputs of probe ``name``: standard normal draws of a seeded
    generator in the JAX probe's shapes, cast to its dtypes."""
    if name not in mp.SHAPES:
        raise ValueError(f"no probe {name!r}; probes: {tuple(mp.SHAPES)}")
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(*shape, generator=gen, device=device).to(dt) for shape, dt in mp.SHAPES[name]]


def check(name: str, xs, got: torch.Tensor) -> float:
    """Holds ``got`` against the plain version of probe ``name`` as
    :data:`mosaic_probes.KIND` says; returns the error read (0 for a
    copy), raises ``ValueError`` on a disagreement."""
    ref = mp.REFERENCES[name](*xs)
    if got.shape != ref.shape or got.dtype != torch.float32 or not bool(torch.isfinite(got).all()):
        raise ValueError(f"out {tuple(got.shape)} {got.dtype} (plain {tuple(ref.shape)}) or non-finite values")
    kind = mp.KIND[name]
    if kind == "copy":
        if not torch.equal(got, ref):
            raise ValueError(f"max |kernel - plain| = {float((got - ref).abs().max()):.3e}, not bitwise")
        return 0.0
    if kind == "sum":
        terms = xs[0].double().abs().sum(0)
        err = float(((got[0].double() - ref[0].double()).abs() / terms).max())
        bound = SUM_RTOL
    else:
        err = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
        bound = PRODUCT_RTOL
    if err > bound:
        raise ValueError(f"error {err:.3e} over bound {bound:g}")
    return err


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the probes; returns the number that failed."""
    names = list(sys.argv[1:] if argv is None else argv) or list(mp.PROBES)
    unknown = [n for n in names if n not in mp.PROBES]
    if unknown:
        raise SystemExit(f"no probe {unknown}; probes: {tuple(mp.PROBES)}")
    dev = require_cuda("probe_mosaic")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full float32
    failed = 0
    for seed, name in enumerate(names):
        xs = draw(name, 300 + seed, dev)
        try:
            t0 = time.perf_counter()
            out = mp.PROBES[name](*xs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            err = check(name, xs, out)
            print(f"PASS {name:28s} {dt:7.3f}s out{tuple(out.shape)} err={err:.3e}", flush=True)
        except (RuntimeError, ValueError) as e:
            failed += 1
            print(f"FAIL {name:28s} {type(e).__name__}: {str(e)[:140]}", flush=True)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
