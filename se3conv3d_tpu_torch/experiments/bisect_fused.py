"""Build the fused forward one stage at a time (s1-s6) and run five backward
building blocks (b1-b5) on the card (the port of
``experiments/bisect_fused.py``).

    python -m se3conv3d_tpu_torch.experiments.bisect_fused [name ...]

runs the named probes (default: all, in order) and prints ``PASS name
seconds`` or ``FAIL name error`` per probe, as the JAX script does.  On the
TPU a probe passed when Mosaic lowered and ran its kernel; here it passes
when its kernel builds, launches and agrees with its plain version on the
same inputs (``max |kernel - plain| <= 1e-5 * max |plain|``: float32 sums
in other orders, the weight contraction in 3xTF32).  The exit status is 1
if any probe failed.  The stages write their whole tensors
(``kernels.probes.stage_forward``) at MP = 1024 rows: s1 pne ``[MP*E,
GQ]``, s2 the aggregation ``[MP, GQ, C]``, s3 the swap ``[GQ, MP, C]``,
s4 the weight contraction ``[GQ, MP, O]``, s5 the sum over q ``[G, MP,
O]``, s6 the same with a leading batch of 1 (``jax.vmap`` in the JAX
script); b1-b5 are ``kernels.probes``' ``gelu_jvp``, ``expand_groups``,
``batched_contract``, ``rank3_accum`` and ``merge_back`` at the JAX
script's shapes.  Every probe draws its inputs from a seeded generator on
the card (:func:`draw`; the JAX script's from a key).  It runs on the card
and raises without one.
"""
from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import torch

from ..kernels import probes
from .common import require_cuda

__all__ = ["TM", "E", "G", "D", "Q", "C", "O", "GD", "GQ", "MP", "RTOL", "STAGES", "REFERENCES",
           "make_inputs", "draw", "check", "main"]

TM, E, G, D, Q, C, O = 128, 32, 2, 9, 32, 64, 64
GD, GQ = G * D, G * Q
MP = 1024  # rows of the staged forward
# kernel vs plain: float32 sums in other orders (the contraction in 3xTF32)
RTOL = 1e-5


def make_inputs(seed: int, device, mp: int = MP) -> tuple:
    """``geo [MP*E, GD]``, ``feat [MP, E, C]``, ``proj [GD, GQ] * 0.2``,
    ``bias [1, GQ] * 0.1``, ``w2 [GQ, C, O] * 0.1``: the JAX script's
    ``make_inputs``, drawn from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return (normal(mp * E, GD), normal(mp, E, C), normal(GD, GQ) * 0.2, normal(1, GQ) * 0.1,
            normal(GQ, C, O) * 0.1)


def _stage(name):
    def fn(geo, feat, proj, bias, w2):
        return probes.stage_forward(geo, feat, proj, w2, bias, name)
    return fn


def s6_vmap(geo, feat, proj, bias, w2):
    return probes.stage_forward(geo[None], feat[None], proj, w2, bias, "reduce")


def _plain_stage(name, batch=False):
    def fn(geo, feat, proj, bias, w2):
        if batch:
            geo, feat = geo[None], feat[None]
        return probes.stage_forward_reference(geo, feat, proj, w2, bias, name)
    return fn


STAGES = {
    "s1_pne": _stage("pne"),
    "s2_agg": _stage("agg"),
    "s3_swap": _stage("swap"),
    "s4_wcontract": _stage("wcontract"),
    "s5_reduce": _stage("reduce"),
    "s6_vmap": s6_vmap,
    "b1_jvp_gelu": probes.gelu_jvp,
    "b2_gexp": lambda a: probes.expand_groups(a, Q),
    "b3_dw2_contract11": probes.batched_contract,
    "b4_rank3_accum": lambda a: probes.rank3_accum(a, GQ, O, TM),
    "b5_merge_back": probes.merge_back,
}
REFERENCES = {
    "s1_pne": _plain_stage("pne"),
    "s2_agg": _plain_stage("agg"),
    "s3_swap": _plain_stage("swap"),
    "s4_wcontract": _plain_stage("wcontract"),
    "s5_reduce": _plain_stage("reduce"),
    "s6_vmap": _plain_stage("reduce", batch=True),
    "b1_jvp_gelu": probes.gelu_jvp_reference,
    "b2_gexp": lambda a: probes.expand_groups_reference(a, Q),
    "b3_dw2_contract11": probes.batched_contract_reference,
    "b4_rank3_accum": lambda a: probes.rank3_accum_reference(a, GQ, O, TM),
    "b5_merge_back": probes.merge_back_reference,
}
_B_SHAPES = {
    "b1_jvp_gelu": ((TM * E, GQ),),
    "b2_gexp": ((G, TM, O),),
    "b3_dw2_contract11": ((GQ, TM, C), (GQ, TM, O)),
    "b4_rank3_accum": ((MP, C),),
    "b5_merge_back": ((TM, E, GQ),),
}


def draw(name: str, seed: int, device) -> tuple:
    """The inputs of probe ``name``: the stages' :func:`make_inputs`, or
    the standard normal operands of a backward block at the JAX script's
    shapes."""
    if name not in STAGES:
        raise ValueError(f"no probe {name!r}; probes: {tuple(STAGES)}")
    if name.startswith("s"):
        return make_inputs(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(*shape, generator=gen, device=device) for shape in _B_SHAPES[name])


def check(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``max |got - ref| / max |ref|``; raises unless the shapes agree, the
    values are finite and the ratio is within :data:`RTOL`."""
    if got.shape != ref.shape:
        raise ValueError(f"shape {tuple(got.shape)}, plain version {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise ValueError("non-finite output")
    err = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    if err > RTOL:
        raise ValueError(f"max |kernel - plain| = {err:.3e} of max |plain| (bound {RTOL:g})")
    return err


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the probes; returns the number that failed."""
    names = list(sys.argv[1:] if argv is None else argv) or list(STAGES)
    unknown = [n for n in names if n not in STAGES]
    if unknown:
        raise SystemExit(f"no probe {unknown}; probes: {tuple(STAGES)}")
    dev = require_cuda("bisect_fused")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full float32
    failed = 0
    for seed, name in enumerate(names):
        inputs = draw(name, seed, dev)
        try:
            t0 = time.perf_counter()
            out = STAGES[name](*inputs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            err = check(out, REFERENCES[name](*inputs))
            print(f"PASS {name:16s} {dt:6.2f}s  max_rel_err={err:.3e}", flush=True)
        except (RuntimeError, ValueError) as e:
            failed += 1
            print(f"FAIL {name:16s} {type(e).__name__}: {str(e)[:160]}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
