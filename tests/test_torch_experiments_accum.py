"""The port's accumulators into a revisited output
(``kernels.probes.block_total_accum`` and ``grid_column_accum``, whose plain
versions run for CPU tensors) against the JAX scripts' own Pallas kernels,
run in interpret mode on the CPU, on the same inputs.

``experiments/bisect_accum.py`` and ``experiments/bisect_accum2.py`` run
their trials at import, so their ``trial`` functions are taken from their
source with ``ast`` and executed in a namespace where ``os.urandom`` returns
fixed bytes (the key of the trial's ``a``) and ``jax.block_until_ready``
records the kernel's outputs; ``pl.pallas_call`` is patched to
``interpret=True`` through ``monkeypatch``.  The test draws the same ``a``
from the same key and hands its numpy copy to the port.  Every output
combination of both scripts runs at grids 4 and 8 (grid 8 for the second
script's own seven combinations only), each a parametrised case.
``experiments/probe_mosaic.py``'s ``p11_grid_accum`` is loaded by file path
(its ``__main__`` guard keeps it from running).

Bounds: ``dfeat = 2a`` bit for bit (one exact product in both).  A total is
a float32 sum of up to 2M values that cancel, so it is held against the sum
of its terms' magnitudes: within ``bisect_accum.SUM_RTOL = 1e-9 * sum |a|``
of a float64 oracle (what the CLIs hold the kernel to; sound float32 sums
read about 1e-10, and ``bisect_accum.planted_totals``' wrong totals, which
``check_accum`` must reject, 6e-8 or more), within ``1e-6 * sum |a|`` of
the JAX kernel's (its own float32 sums in another order), and every element
of an accumulator equal to the others.  The column sums of p11 within
``1e-6`` of each column's ``sum |a|`` of the float64 oracle and of the JAX
kernel's; the card kernel's summation order
(``probes.grid_column_in_kernel_order``) within ``1e-6`` of the JAX
kernel's too.
"""
import ast
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2
from se3conv3d_tpu_torch.kernels import probes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SUM_RTOL = 1e-6
SEED_BYTES = bytes([7, 1, 3, 9])


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


class _RecordingJax:
    """``jax`` with ``block_until_ready`` recording what it waits for."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def block_until_ready(self, x):
        self.outputs.append(x)
        return jax.block_until_ready(x)


def jax_trial(script):
    """``trial`` of ``experiments/<script>.py`` and the recorder of its
    kernel's outputs."""
    path = os.path.join(REPO, "experiments", f"{script}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "trial"
            or isinstance(n, ast.Assign) and isinstance(n.targets[0], (ast.Name, ast.Tuple))]
    rec = _RecordingJax()
    ns = dict(jax=rec, jnp=jnp, pl=pl, pltpu=pltpu, os=types.SimpleNamespace(urandom=lambda n: SEED_BYTES[:n]))
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns, rec


def trial_input(grid_n):
    """The ``a`` a trial draws from the key ``SEED_BYTES`` gives."""
    key = jax.random.PRNGKey(int.from_bytes(SEED_BYTES, "little"))
    return np.array(jax.random.normal(key, (bisect_accum.TM * grid_n, bisect_accum.E, bisect_accum.C)))


def check_against_jax(a, want, shapes, with_dfeat, capsys, tag):
    assert f"PASS {tag}" in capsys.readouterr().out
    got = probes.block_total_accum(torch.from_numpy(a), shapes, with_dfeat)
    assert [tuple(x.shape) for x in got] == [tuple(np.shape(w)) for w in want]
    assert bisect_accum.check_accum(torch.from_numpy(a), got, shapes, with_dfeat) <= bisect_accum.SUM_RTOL
    terms = np.abs(a.astype(np.float64)).sum()
    if with_dfeat:
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        got, want = got[1:], want[1:]
    for x, w in zip(got, want):
        x, w = x.numpy(), np.asarray(w)
        assert (x == x.flat[0]).all() and (w == w.flat[0]).all()
        assert abs(float(x.flat[0]) - float(w.flat[0])) <= JAX_SUM_RTOL * terms


ACCUM_CASES = [(g, n, d) for g in (4, 8) for n in range(4) for d in (True, False) if n or d]


@pytest.mark.parametrize("grid_n,n_accum,with_dfeat", ACCUM_CASES)
def test_bisect_accum_matches_jax_kernel(interpret, capsys, grid_n, n_accum, with_dfeat):
    ns, rec = jax_trial("bisect_accum")
    ns["trial"]("case", grid_n, n_accum, with_dfeat)
    (want,) = rec.outputs
    check_against_jax(trial_input(grid_n), list(want), bisect_accum.SHAPES[:n_accum], with_dfeat, capsys, "case")


SUBSETS = [names for names in (("dproj",), ("dbias",), ("dw2",), ("dproj", "dbias"), ("dproj", "dw2"),
                               ("dbias", "dw2"), ("dproj", "dbias", "dw2"))]
ACCUM2_CASES = [(4, names, d) for names in SUBSETS for d in (True, False)]
ACCUM2_CASES += [(8, names, d) for names, d in bisect_accum2.COMBINATIONS]


@pytest.mark.parametrize("grid_n,names,with_dfeat", ACCUM2_CASES,
                         ids=[f"grid{g}-{bisect_accum2.tag(n, d)}" for g, n, d in ACCUM2_CASES])
def test_bisect_accum2_matches_jax_kernel(interpret, capsys, grid_n, names, with_dfeat):
    ns, rec = jax_trial("bisect_accum2")
    assert ns["SHAPES"] == bisect_accum2.SHAPES
    ns["trial"](list(names), grid_n=grid_n, with_dfeat=with_dfeat)
    (want,) = rec.outputs
    check_against_jax(trial_input(grid_n), list(want), [bisect_accum2.SHAPES[n] for n in names], with_dfeat,
                      capsys, bisect_accum2.tag(names, with_dfeat))


def test_port_trials_are_the_scripts():
    """The CLIs run the scripts' own trials, in order: the names, grids and
    outputs of the module-level calls."""
    calls = {}
    for script in ("bisect_accum", "bisect_accum2"):
        with open(os.path.join(REPO, "experiments", f"{script}.py")) as f:
            tree = ast.parse(f.read())
        calls[script] = [ast.unparse(n) for n in tree.body if not isinstance(n, (ast.FunctionDef, ast.Import,
                                                                                   ast.ImportFrom, ast.Assign))
                         and not isinstance(getattr(n, "value", None), ast.Constant)]
    assert calls["bisect_accum"] == [
        "for gn in (16, 32, 64):\n    trial(f'grid{gn}_accum3_dfeat', gn, 3, True)",
        "for gn in (32,):\n    trial(f'grid{gn}_accum3_nodfeat', gn, 3, False)\n"
        "    trial(f'grid{gn}_accum1_dfeat', gn, 1, True)\n    trial(f'grid{gn}_accum0_dfeat', gn, 0, True)"]
    assert list(bisect_accum.TRIALS.items()) == [
        ("grid16_accum3_dfeat", (16, 3, True)), ("grid32_accum3_dfeat", (32, 3, True)),
        ("grid64_accum3_dfeat", (64, 3, True)), ("grid32_accum3_nodfeat", (32, 3, False)),
        ("grid32_accum1_dfeat", (32, 1, True)), ("grid32_accum0_dfeat", (32, 0, True))]
    script2 = [c.replace("trial(", "").rstrip(")") for c in calls["bisect_accum2"]]
    assert script2 == [f"{list(n)}" + ("" if d else ", with_dfeat=False") for n, d in bisect_accum2.COMBINATIONS]


def test_bisect_accum_dw2_is_the_total_and_nan_where_a_value_is_infinite(interpret, capsys):
    """``bisect_accum.py`` writes its 'dW2' as ``broadcast(red[...][:, :1,
    :1]) * 0 + sum(red)``: no weight gradient, the block total where every
    value is finite; the ``* 0`` term turns an infinite value into NaN, where
    d_proj and d_bias hold the infinite total.  The port writes the total
    into all three."""
    ns, rec = jax_trial("bisect_accum")
    real_normal = jax.random.normal

    def planted(key, shape):
        return real_normal(key, shape).at[0, 0, 0].set(jnp.inf)

    ns["jax"] = types.SimpleNamespace(**{k: getattr(rec, k) for k in ("jit", "ShapeDtypeStruct", "block_until_ready")},
                                      random=types.SimpleNamespace(PRNGKey=jax.random.PRNGKey, normal=planted))
    ns["trial"]("inf", 2, 3, False)
    dproj, dbias, dw2 = (np.asarray(x) for x in rec.outputs[0])
    assert np.isposinf(dproj).all() and np.isposinf(dbias).all() and np.isnan(dw2).all()
    a = trial_input(2)
    a[0, 0, 0] = np.inf
    got = probes.block_total_accum(torch.from_numpy(a), bisect_accum.SHAPES, False)
    assert all(bool(torch.isposinf(x).all()) for x in got)


@pytest.fixture
def jax_mosaic(interpret):
    path = os.path.join(REPO, "experiments", "probe_mosaic.py")
    spec = importlib.util.spec_from_file_location("experiments_probe_mosaic_accum", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1])
def test_p11_grid_accum_matches_jax_kernel(jax_mosaic, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_mosaic.PROBES["p11_grid_accum"](key))
    (a,) = (np.array(x) for x in jax_mosaic.fresh(key, ((8 * jax_mosaic.TM, jax_mosaic.Q), jnp.float32)))
    assert probes.TM == jax_mosaic.TM
    got = probes.grid_column_accum(torch.from_numpy(a)).numpy()
    a64 = a.astype(np.float64)
    terms = np.abs(a64).sum(0)
    assert got.shape == want.shape == (1, jax_mosaic.Q)
    assert (np.abs(got[0] - a64.sum(0)) <= JAX_SUM_RTOL * terms).all()
    assert (np.abs(got[0] - want[0]) <= JAX_SUM_RTOL * terms).all()
    # the card kernel's order (probes.grid_column_in_kernel_order) against the JAX kernel
    order = probes.grid_column_in_kernel_order(torch.from_numpy(a)).numpy()
    assert (np.abs(order[0] - want[0]) <= JAX_SUM_RTOL * terms).all()


def test_block_total_accum_plain_version_adds_blocks_in_order():
    """The plain version is the TPU grid's order: block sums added from
    zero in block order (float32), so it matches that loop bit for bit."""
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((5 * 128, 4, 8)).astype(np.float32))
    s = torch.zeros(())
    for i in range(5):
        s = s + a[i * 128:(i + 1) * 128].sum()
    (out,) = probes.block_total_accum(a, [(2, 3)], False)
    assert torch.equal(out, s.expand(2, 3))
    with pytest.raises(ValueError, match="at most 3 outputs"):
        probes.block_total_accum(a, [(1,)] * 4, False)
    assert probes.accum_tag(bisect_accum.SHAPES, True) == "18x64+1x64+64x64x64+dfeat"
    assert probes.accum_tag((), True) == "dfeat"


@pytest.mark.parametrize("grid_n,seed", [(4, 0), (4, 1), (8, 2)])
def test_check_accum_holds_totals_to_the_float64_total(grid_n, seed):
    """The bound on a total tells sound float32 sums from wrong ones: the
    plain version and the kernel's order (``block_total_in_kernel_order``
    on the card's grid of 2 x 132 blocks) read at most half of
    ``SUM_RTOL``; chunk totals rounded to bfloat16 and a dropped chunk read
    ten times it or more, and ``check_accum`` rejects them."""
    a = bisect_accum.draw(grid_n, seed, "cpu")
    shapes = bisect_accum.SHAPES
    sound = probes.block_total_accum(a, shapes, True)
    assert bisect_accum.check_accum(a, sound, shapes, True) <= bisect_accum.SUM_RTOL / 2
    in_kernel_order = probes.block_total_in_kernel_order(a, 2 * 132)
    planted = bisect_accum.planted_totals(a)
    exact, terms = float(a.double().sum()), float(a.double().abs().sum())
    assert abs(float(in_kernel_order) - exact) / terms <= bisect_accum.SUM_RTOL / 2
    for name, total in planted.items():
        assert abs(float(total) - exact) / terms >= 10 * bisect_accum.SUM_RTOL, name
        wrong = sound[:1] + [total.expand(s).clone() for s in shapes]
        with pytest.raises(ValueError, match="float64 total"):
            bisect_accum.check_accum(a, wrong, shapes, True)


@pytest.mark.parametrize("entry", ["bisect_accum", "bisect_accum2"])
def test_accum_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"bisect_accum": bisect_accum, "bisect_accum2": bisect_accum2}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
