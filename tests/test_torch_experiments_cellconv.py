"""The port's cell-conv building blocks (``kernels.cellconv_probes``, whose
plain versions run for CPU tensors) against ``experiments/probe_cellconv.py``'s
own Pallas kernels, run in interpret mode on the CPU, on the same inputs.

The script runs its part at import: ``runpy.run_path`` with ``PART`` and
``INTERPRET=1`` set by ``monkeypatch.setenv``, after ``np.random.seed(s)``;
its globals then hold the part's inputs (``ids``, ``tab``, ``g``, ``qp``,
``qf``, ``cp``, ``cf``), its kernel's output ``out`` and its ``f``, and the
test hands numpy copies of the inputs to the port.

Bounds: p1, p2 and p4 bit for bit (a scale by 2 and sums in the JAX grid's
order, from zero, r = 0, 1, ...).  p3: no mask disagreement with the JAX
kernel's own pne, read back through its ``f`` with ``cf`` the columns of
the identity (each output then one pne times 1 plus zeros, exact); each pne
within one ulp of it, because XLA's CPU backend fuses the kernel's
``diff * diff + acc`` and ``acc * 3 + 1`` into fused multiply-adds where
the kernel as written (and the port) rounds each step (pinned in
:func:`test_jax_cpu_kernel_contracts_pne_into_fmas`); the port's pne bit for
bit equal to a numpy oracle that rounds each step; the product within
``1e-5 * max |JAX|`` (float32 sums in another order).  One case plants
pairs whose squared distance lies within a few ulps of 0.04, where the
fused form moves some across the mask.
"""
import os
import runpy

import numpy as np
import pytest
import torch

from se3conv3d_tpu_torch.experiments import probe_cellconv as pc
from se3conv3d_tpu_torch.kernels import cellconv_probes as cc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "probe_cellconv.py")
P3_RTOL = 1e-5


def run_script(monkeypatch, part, seed):
    monkeypatch.setenv("PART", part)
    monkeypatch.setenv("INTERPRET", "1")
    np.random.seed(seed)
    return runpy.run_path(SCRIPT, run_name="probe_cellconv_script")


def port_inputs(ns, part):
    names = {"p1": ("ids", "tab"), "p2": ("ids", "tab"), "p3": ("qp", "qf", "cp", "cf"), "p4": ("ids", "g")}[part]
    return {k: torch.from_numpy(np.array(ns[k])) for k in names}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("part", ["p1", "p2", "p4"])
def test_gather_parts_match_jax_kernel_bitwise(monkeypatch, capsys, part, seed):
    ns = run_script(monkeypatch, part, seed)
    assert f"{part} max err 0.0" in capsys.readouterr().out
    x = port_inputs(ns, part)
    assert x["ids"].dtype == torch.int32
    assert tuple(x["ids"].shape) == {"p1": (pc.QB,), "p2": (pc.QB, pc.R), "p4": (pc.NB, pc.R)}[part]
    assert cc.bad_ids(x["ids"], pc.QB if part == "p4" else pc.NB) == 0
    got = pc.run(part, x)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.asarray(ns["out"]))
    pc.check(part, x, got)


def jax_pne(ns):
    """The JAX kernel's pne, read back through its ``f``: the product with
    each 128-column block of the identity."""
    qp, qf, cp = ns["qp"], ns["qf"], ns["cp"]
    cand, c = ns["CAND"], ns["C"]
    eye = np.eye(cand, dtype=np.float32)
    return np.concatenate([np.asarray(ns["f"](qp, qf, cp, eye[:, i:i + c])) for i in range(0, cand, c)], 1)


def _fma(a, b, c):
    """float32 fma(a, b, c): the exact product (float64 holds it) plus c,
    rounded once to float32 (twice through float64; a double rounding needs
    a float64 sum on a float32 midpoint, and none occurs on these draws)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def oracle_pne(qp, cp, fused=False):
    """pne in numpy: each square and sum rounded on its own (the kernel as
    written), or as XLA's CPU backend contracts it (``fused``)."""
    q, c = np.asarray(qp, np.float32)[:, :3], np.asarray(cp, np.float32)[:, :3]
    dx, dy, dz = (q[:, None, d] - c[None, :, d] for d in range(3))
    if fused:
        d2 = _fma(dz, dz, _fma(dx, dx, dy * dy))
        v = _fma(d2, np.float32(3), np.float32(1))
    else:
        d2 = (dx * dx + dy * dy) + dz * dz
        v = d2 * np.float32(3) + np.float32(1)
    return np.where(d2 < np.float32(cc.RADIUS2), v, np.float32(0)), d2


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_dist_product_matches_jax_kernel(monkeypatch, seed):
    ns = run_script(monkeypatch, "p3", seed)
    x = port_inputs(ns, "p3")
    pne = torch.empty(pc.QB3 * pc.Q3, pc.CAND)
    got = pc.run("p3", x, pne)
    want, jp, pne = np.asarray(ns["out"]), jax_pne(ns), pne.numpy()
    assert np.array_equal(pne, oracle_pne(ns["qp"], ns["cp"])[0])
    assert not ((pne != 0) != (jp != 0)).any()  # no mask disagreement
    assert (np.abs(pne - jp) <= np.spacing(np.abs(jp))).all()  # XLA's fused d2: at most one ulp
    assert 0 < int((pne != 0).sum()) < pne.size // 10  # the mask keeps a few pairs a query
    assert np.abs(got.numpy() - want).max() <= P3_RTOL * np.abs(want).max()
    pc.check("p3", x, got, torch.from_numpy(pne))


def test_jax_cpu_kernel_contracts_pne_into_fmas(monkeypatch):
    """On the CPU, XLA fuses the kernel's ``acc += diff * diff`` and ``acc *
    3.0 + 1.0`` into fused multiply-adds, ``d2 = fma(dz, dz, fma(dx, dx,
    dy*dy))`` and ``fma(d2, 3, 1)``, where the kernel as written rounds each
    step (as the port does, on both devices): a value may differ by one
    ulp, and a pair within an ulp of the radius may fall on the other side
    of the mask."""
    ns = run_script(monkeypatch, "p3", 0)
    jp = jax_pne(ns)
    assert np.array_equal(jp, oracle_pne(ns["qp"], ns["cp"], fused=True)[0])
    assert not np.array_equal(jp, oracle_pne(ns["qp"], ns["cp"])[0])


def test_masked_dist_pne_at_the_radius():
    """Candidates at distance 0.2 (1 + k * 2^-24), k in [-8, 8], from a
    query: their d2 straddles 0.04 within a few ulps.  The plain version
    (which the card's kernel matches bit for bit, in the card tests) rounds
    as the kernel is written; the fused form would move some pairs across
    the mask."""
    rng = np.random.default_rng(5)
    qp = rng.random((pc.QB3 * pc.Q3, 8)).astype(np.float32)
    cp = rng.random((pc.CAND, 8)).astype(np.float32)
    for i in range(cp.shape[0]):
        d = rng.standard_normal(3)
        cp[i, :3] = qp[(i * 37) % qp.shape[0], :3] + 0.2 * (1 + (i % 17 - 8) * 2.0 ** -24) * d / np.linalg.norm(d)
    want, d2 = oracle_pne(qp, cp)
    got = cc.masked_dist_pne(torch.from_numpy(qp), torch.from_numpy(cp)).numpy()
    assert np.array_equal(got, want)
    near = np.abs(d2 - np.float32(cc.RADIUS2)) < 1e-8
    assert near.sum() > 100 and 0 < (got[near] != 0).sum() < near.sum()
    fused = oracle_pne(qp, cp, fused=True)[0]
    assert ((fused != 0) != (want != 0)).sum() > 0


def test_port_sizes_are_the_scripts(monkeypatch):
    for part in pc.PARTS:
        ns = run_script(monkeypatch, part, 0)
        x = pc.draw(part, 0, "cpu")
        assert {k: tuple(v.shape) for k, v in x.items()} == {k: tuple(np.shape(ns[k])) for k in x}
        assert {k: str(v.dtype) for k, v in x.items()} == {k: "torch." + str(np.asarray(ns[k]).dtype) for k in x}


def test_gather_plain_versions_refuse_bad_ids():
    x = pc.draw("p2", 0, "cpu")
    x["ids"][0, 0] = pc.NB
    assert cc.bad_ids(x["ids"], pc.NB) == 1
    with pytest.raises(IndexError):
        pc.run("p2", x)
    with pytest.raises(ValueError, match="ids outside their table"):
        pc.check("p2", x, torch.zeros(pc.QB * pc.P, pc.C))


def test_cellconv_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.main(["--part", "p1"])
