"""The port's Mosaic pattern probes (``kernels.mosaic_probes.PROBES``, whose
plain versions run for CPU tensors) against ``experiments/probe_mosaic.py``'s
own Pallas kernels, run in interpret mode on the CPU, on the same inputs.

The script is loaded by file path (its ``__main__`` guard keeps it from
running) with ``pl.pallas_call`` patched to ``interpret=True`` through
``monkeypatch``.  Each probe draws its inputs inside, from a key, through
the script's ``fresh``: the test wraps ``fresh`` to record the shapes and
dtypes asked for, runs the probe, draws the same arrays from the same key
and hands their numpy copies to the port (p10's bfloat16 values pass
through float32 exactly).  Each of the 17 probes is one case.

Bounds: reshapes, the slice, the transposes, the block-diagonal build and
the mid-index write bit for bit (copies and one exact scale); products
within ``1e-5 * max |JAX|`` (float32 sums in other orders; p10's bfloat16
products are exact in float32, so only the sums' order differs); p11's
column sums within ``1e-6`` of each column's ``sum |a|``.

``chip_smoke.py``'s one PyTorch call per probe (``mosaic_library``, whose
time stands beside each kernel's) computes the probe's function: the
copies bit for bit, the products within ``1e-5 * max |plain|``, p10's
bfloat16 result within ``1e-2`` (one bfloat16 rounding of each output).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from se3conv3d_tpu_torch.experiments import probe_mosaic
from se3conv3d_tpu_torch.kernels import mosaic_probes as mp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT_RTOL, SUM_RTOL = 1e-5, 1e-6
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture
def jax_mosaic(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    path = os.path.join(REPO, "experiments", "probe_mosaic.py")
    spec = importlib.util.spec_from_file_location("experiments_probe_mosaic", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_probe_list_is_the_scripts(jax_mosaic):
    assert list(mp.PROBES) == list(jax_mosaic.PROBES) == list(mp.SHAPES) == list(mp.REFERENCES)
    assert len(mp.PROBES) == 17 and set(mp.KIND) == set(mp.PROBES)
    assert (mp.TM, mp.E, mp.G, mp.D, mp.Q, mp.C, mp.O) == (jax_mosaic.TM, jax_mosaic.E, jax_mosaic.G, jax_mosaic.D,
                                                          jax_mosaic.Q, jax_mosaic.C, jax_mosaic.O)


@pytest.mark.parametrize("name", list(mp.PROBES))
def test_mosaic_probe_matches_jax_kernel(jax_mosaic, monkeypatch, name):
    asked = []
    fresh = jax_mosaic.fresh

    def recording_fresh(key, *shape_dtypes):
        asked.append(shape_dtypes)
        return fresh(key, *shape_dtypes)

    monkeypatch.setattr(jax_mosaic, "fresh", recording_fresh)
    key = jax.random.PRNGKey(list(mp.PROBES).index(name) + 40)
    want = np.asarray(jax.block_until_ready(jax_mosaic.PROBES[name](key)))
    (shape_dtypes,) = asked
    assert [(tuple(s), _DTYPES[dt]) for s, dt in shape_dtypes] == [(s, dt) for s, dt in mp.SHAPES[name]]
    xs = [torch.from_numpy(np.array(a, dtype=np.float32)).to(dt)
          for a, (_, dt) in zip(fresh(key, *shape_dtypes), mp.SHAPES[name])]
    got = mp.PROBES[name](*xs)
    assert got.dtype == torch.float32 and want.dtype == np.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    kind = mp.KIND[name]
    if kind == "copy":
        assert np.array_equal(got, want)
    elif kind == "product":
        assert np.abs(got - want).max() <= PRODUCT_RTOL * np.abs(want).max()
    else:
        terms = np.abs(np.asarray(xs[0], np.float64)).sum(0)
        assert (np.abs(got[0] - want[0]) <= SUM_RTOL * terms).all()
    probe_mosaic.check(name, xs, torch.from_numpy(got))


def test_probe_work_counts_the_products():
    """p8 is the largest: 64 x 128 x 128 outputs of 64 terms, 134 MFLOP,
    on tensor cores (``product_flops``)."""
    xs = probe_mosaic.draw("p8_blockdiag_batched", 0, "cpu")
    w = mp.probe_work("p8_blockdiag_batched", xs, mp.PROBES["p8_blockdiag_batched"](*xs))
    assert w["product_flops"] == 2.0 * 64 * 128 * 128 * 64
    assert w["bytes"] == 4.0 * (64 * 128 * 64 + 64 * 64 * 128 + 64 * 128 * 128)
    xs = probe_mosaic.draw("p5_lane_merge", 0, "cpu")
    assert mp.probe_work("p5_lane_merge", xs, mp.PROBES["p5_lane_merge"](*xs)) == {"product_flops": 0.0,
                                                                                   "bytes": 2.0 * 4 * 128 * 32 * 64}


def test_split_k_covers_k():
    for batch, m, n, k in ((1, 128, 64, 2048), (1, 18, 64, 4096), (1, 8192, 32, 9), (128, 64, 32, 32)):
        plan = mp.product_plan(batch, m, n, k, torch.float32, (m * k, k, 1), (k * n, n, 1))
        splits, per = plan["splits"], plan["k_per_split"]
        assert splits * per >= k and per % 32 == 0 and (splits - 1) * per < k
    # the two long depths split over a full cluster of 8, in one launch
    assert mp.product_plans()["p3_multi_contract"]["splits"] == 8
    assert mp.product_plans()["p15_dim0_contract"]["splits"] == 8


def test_mosaic_wrappers_refuse_other_shapes():
    with pytest.raises(ValueError, match="takes inputs of shapes"):
        mp.PROBES["p5_lane_merge"](torch.zeros(2, 3))


def test_mosaic_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_mosaic.main(["p1_plain_2d"])


@pytest.fixture(scope="module")
def library_calls():
    spec = importlib.util.spec_from_file_location("chip_smoke_library", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.mosaic_library("cpu")


@pytest.mark.parametrize("name", [n for n in mp.PROBES if n != "p11_grid_accum"])
def test_library_call_computes_the_probe(library_calls, name):
    assert set(library_calls) == set(mp.PROBES) - {"p11_grid_accum"}
    xs = probe_mosaic.draw(name, 7, "cpu")
    want = mp.REFERENCES[name](*xs)
    got = library_calls[name](*xs)
    assert got.shape == want.shape
    if mp.KIND[name] == "copy":
        assert torch.equal(got, want)
    else:
        bound = 1e-2 if name == "p10_bf16_batched" else PRODUCT_RTOL
        assert float((got.float() - want).abs().max()) <= bound * float(want.abs().max())
