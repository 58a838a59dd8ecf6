"""The cell-blocked conv's building blocks on the card (the port of
``experiments/probe_cellconv.py``).

    PART=p1|p2|p3|p4 python -m se3conv3d_tpu_torch.experiments.probe_cellconv
    python -m se3conv3d_tpu_torch.experiments.probe_cellconv --part p1|p2|p3|p4|all

runs one part (``PART`` in the environment as in the JAX script, default
p1; ``--part`` overrides it, ``all`` runs the four in order) at the JAX
script's sizes, through ``kernels.cellconv_probes``:

- p1: 16 blocks of ``[32, 128]`` gathered by int32 id from a 64-block
  table, times 2 (``gather_blocks``);
- p2: 16 output blocks, each the sum of the R = 4 table blocks its ids
  name, added in r order (``gather_sum_blocks``);
- p3: 8 x 256 queries against 512 candidates: the masked distance
  embedding and its product with the candidates' features
  (``masked_dist_product``; the queries' features ``qf`` are drawn and
  unused, as in the JAX kernel);
- p4: the candidate-major layout, 64 output blocks each summing the R = 4
  of 16 gradient blocks its ids name (``gather_sum_blocks``).

Each prints ``PASS part seconds`` or ``FAIL part error``.  It passes when
the kernel builds, launches and agrees with its plain version: p1, p2 and
p4 bit for bit (copies and sums in the same order), p3's pne bit for bit
(so no pair falls on the other side of the mask) and its product within
``1e-5 * max |plain|`` (float32 sums in another order).  Every id is
checked to lie in its table (:func:`cellconv_probes.bad_ids`, after the
kernel call).  The exit status is 1 if a part failed.  Inputs come from a
seeded generator on the card (the JAX script's from ``np.random``).  It runs
on the card and raises without one.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Mapping, Optional, Sequence

import torch

from ..kernels import cellconv_probes as cc
from .common import require_cuda

__all__ = ["PARTS", "NB", "P", "C", "QB", "R", "Q3", "CAND", "QB3", "P3_RTOL", "draw", "run", "reference",
           "check", "main"]

PARTS = ("p1", "p2", "p3", "p4")
NB, P, C = 64, 32, 128  # p1, p2, p4: 64 table blocks of 32 rows x 128 columns
QB, R = 16, 4           # p1, p2: query steps; p2, p4: blocks summed per output block
Q3, CAND, QB3 = 256, 512, 8  # p3: queries a block, candidates, query blocks
# p3's product: float32 sums in another order
P3_RTOL = 1e-5


def draw(part: str, seed: int, device) -> dict:
    """The inputs of ``part`` at the JAX script's sizes: int32 ids uniform
    in their table, standard normal tables and features, uniform [0, 1)
    positions ``[N, 8]`` (xyz and padding)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ids(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=device, dtype=torch.int32)

    if part in ("p1", "p2"):
        return {"ids": ids(NB, QB) if part == "p1" else ids(NB, QB, R),
                "tab": torch.randn(NB * P, C, generator=gen, device=device)}
    if part == "p3":
        return {"qp": torch.rand(QB3 * Q3, 8, generator=gen, device=device),
                "qf": torch.randn(QB3 * Q3, C, generator=gen, device=device),
                "cp": torch.rand(CAND, 8, generator=gen, device=device),
                "cf": torch.randn(CAND, C, generator=gen, device=device)}
    if part == "p4":
        return {"ids": ids(QB, NB, R), "g": torch.randn(QB * P, C, generator=gen, device=device)}
    raise ValueError(f"no part {part!r}; parts: {PARTS}")


def run(part: str, x: dict, pne_out=None) -> torch.Tensor:
    """The part's kernel (the plain version for CPU tensors)."""
    if part == "p1":
        return cc.gather_blocks(x["ids"], x["tab"], P)
    if part == "p2":
        return cc.gather_sum_blocks(x["ids"], x["tab"], P)
    if part == "p3":
        return cc.masked_dist_product(x["qp"], x["cp"], x["cf"], pne_out)
    return cc.gather_sum_blocks(x["ids"], x["g"], P)


def reference(part: str, x: dict) -> torch.Tensor:
    """The part's plain version."""
    if part == "p1":
        return cc.gather_blocks_reference(x["ids"], x["tab"], P)
    if part == "p2":
        return cc.gather_sum_blocks_reference(x["ids"], x["tab"], P)
    if part == "p3":
        return cc.masked_dist_product_reference(x["qp"], x["cp"], x["cf"])
    return cc.gather_sum_blocks_reference(x["ids"], x["g"], P)


def check(part: str, x: dict, got: torch.Tensor, pne=None) -> float:
    """Holds ``got`` (and p3's ``pne``) against the plain version; returns
    ``max |got - plain|`` (p3: over ``max |plain|``), raises ``ValueError``
    on a disagreement or an id outside its table."""
    if "ids" in x:
        bad = cc.bad_ids(x["ids"], QB if part == "p4" else NB)
        if bad:
            raise ValueError(f"{bad} ids outside their table")
    ref = reference(part, x)
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise ValueError(f"shape {tuple(got.shape)} (plain {tuple(ref.shape)}) or non-finite values")
    if part != "p3":
        if not torch.equal(got, ref):
            raise ValueError(f"max |kernel - plain| = {float((got - ref).abs().max()):.3e}, not bitwise")
        return 0.0
    if pne is not None:
        want = cc.masked_dist_pne(x["qp"], x["cp"])
        flips = int(((pne != 0) != (want != 0)).sum())
        if flips or not torch.equal(pne, want):
            raise ValueError(f"pne differs from the plain version's: {flips} mask disagreements")
    err = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    if err > P3_RTOL:
        raise ValueError(f"max |kernel - plain| = {err:.3e} of max |plain| (bound {P3_RTOL:g})")
    return err


def main(argv: Optional[Sequence[str]] = None, env: Optional[Mapping[str, str]] = None) -> int:
    """Run the chosen part (or all); returns the number that failed."""
    env = os.environ if env is None else env
    parser = argparse.ArgumentParser(prog="probe_cellconv")
    parser.add_argument("--part", choices=PARTS + ("all",), default=env.get("PART", "p1"))
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    dev = require_cuda("probe_cellconv")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain product in full float32
    failed = 0
    for i, part in enumerate(PARTS if args.part == "all" else (args.part,)):
        x = draw(part, 200 + i, dev)
        pne = torch.empty(QB3 * Q3, CAND, device=dev) if part == "p3" else None
        try:
            t0 = time.perf_counter()
            out = run(part, x, pne)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            err = check(part, x, out, pne)
            print(f"PASS {part} {dt:6.3f}s  out{tuple(out.shape)} max_err={err:.3e}", flush=True)
        except (RuntimeError, ValueError) as e:
            failed += 1
            print(f"FAIL {part} {type(e).__name__}: {str(e)[:160]}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
