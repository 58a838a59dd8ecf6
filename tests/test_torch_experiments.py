"""The port's probes (``se3conv3d_tpu_torch.experiments``: the staged fused
forward, the backward building blocks and the streaming sum, whose plain
versions run for CPU tensors) against the JAX probe scripts' own Pallas
kernels, run in interpret mode on the CPU, on the same inputs.

``experiments/bisect_fused.py`` is loaded by file path (its ``__main__``
guard keeps it from running) with ``pl.pallas_call`` patched to
``interpret=True`` through ``monkeypatch``; its stages draw from a key, so
the test takes the same arrays from its ``make_inputs(key)`` (b1-b5: the
same ``jax.random.normal`` draws) and hands their numpy copies to the port.
``experiments/chip_stage_time.py`` and ``experiments/chip_stream.py`` run
their whole measurement at import, so their kernels and calls (``cast``,
``kern``, ``run``; ``k_sum``, ``pallas_sum_feat``, ``pallas_sum_geo``) are
taken from their source with ``ast`` and executed in a namespace that sets
the scripts' constants at a small M (256, TM = 64), fed numpy draws from a
seed.

Bounds: float32 tensors within ``1e-5 * max |JAX|`` (float32 sums in other
orders).  A scalar is a sum of ~1e6 values that cancel (the ``full`` stage
sums to a few hundred from terms of order one), so it is held against the
sum of its terms' magnitudes, not against itself: the port's float32
scalars within ``1e-6 * sum |terms|`` of a float64 oracle of the same
function, and within ``5e-6 * sum |terms|`` of the JAX script's, which is
itself a float32 sum of its G*M*O = 32,768 broadcast tile sums (off the
oracle by up to 1.3e-6 of ``sum |terms|`` at pne on these draws, the port
by at most 5e-8).  The bfloat16 stages (``CDT=bf16``) round at the same
points in both packages and sum in float32 in other orders, which can flip
a rounding by one bfloat16 ulp where a value lies next to a boundary; each
is held within a stated bound (:data:`BF16_SCALAR_RTOL`: pne's is set by
the JAX script's own float32 sum, as above) that lies under half of its
no-rounding control (the port in float32 against JAX in bfloat16), and
its reading must be at most half of the control's, as the repo's other
bf16 gates.  The JAX script's swap stage cannot run in bfloat16: it
stores the bfloat16 sum of ``basis_b`` into its float32 output, which
Pallas refuses; the test pins that, and holds the port against the same
kernel with that one sum widened to float32.
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

from se3conv3d_tpu_torch.experiments import bisect_fused, chip_stage_time, chip_stream
from se3conv3d_tpu_torch.kernels import probes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_RTOL = 1e-5
SCALAR_RTOL, JAX_SCALAR_RTOL = 1e-6, 5e-6
# readings on these draws (seed 2): sound 1.7e-6 / 8.0e-8 / 2.1e-8 / 1.2e-7,
# controls 2.2e-5 / 8.5e-6 / 9.5e-6 / 1.1e-5 of sum |terms|
BF16_SCALAR_RTOL = {"pne": 1e-5, "agg": 1e-6, "swap": 1e-6, "full": 1e-6}
BF16_SOUND_SHARE = 0.5
SMALL_M, SMALL_TM = 256, 64


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture
def jax_bisect(interpret):
    path = os.path.join(REPO, "experiments", "bisect_fused.py")
    spec = importlib.util.spec_from_file_location("experiments_bisect_fused", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_functions(name, keep, **consts):
    """The functions ``keep`` of ``experiments/<name>.py``, executed in a
    namespace of the script's imports and ``consts``."""
    path = os.path.join(REPO, "experiments", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in keep]
    assert sorted(n.name for n in body) == sorted(keep)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def _float32_sums(module):
    """``jnp`` whose ``sum`` of a bfloat16 array is taken in float32."""
    wrapped = types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module) if not k.startswith("__")})
    wrapped.sum = lambda x, *a, **k: module.sum(x.astype(module.float32) if x.dtype == module.bfloat16 else x,
                                                *a, **k)
    return wrapped


def jax_stage_run(stage, bf16, m=SMALL_M, tm=SMALL_TM, widen_sums=False):
    c = chip_stage_time
    ns = _script_functions("chip_stage_time", ("cast", "kern", "run"), M=m, TM=tm, E=c.E, G=c.G, D=c.D,
                           Q=c.Q, C=c.C, O=c.O, GD1=c.GD1, GQ=c.GQ, STAGE=stage,
                           CDT=jnp.bfloat16 if bf16 else None)
    if widen_sums:
        ns["jnp"] = _float32_sums(jnp)
    return ns["run"]


def stage_inputs(seed, m=SMALL_M):
    c = chip_stage_time
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m * c.E, c.GD1)).astype(np.float32),
            rng.standard_normal((m, c.E, c.C)).astype(np.float32),
            (rng.standard_normal((c.GD1, c.GQ)) * 0.2).astype(np.float32),
            (rng.standard_normal((c.GQ, c.C, c.O)) * 0.1).astype(np.float32))


def stage_oracle(args, stage, tm=SMALL_TM):
    """``(value, sum |terms|)`` of the float32 stage in float64."""
    geo, feat, proj, w = (a.double() for a in args)
    m, e, _ = feat.shape
    t = probes.gelu_tanh(geo @ proj)
    if stage != "pne":
        t = torch.einsum("meq,mec->mqc", t.reshape(m, e, -1), feat)
    if stage == "full":
        t = torch.einsum("mqc,qco->qmo", t, w).reshape(chip_stage_time.G, chip_stage_time.Q, m, -1).sum(1)
    scale = 1.0 if stage == "full" else chip_stage_time.G * tm * chip_stage_time.O
    return float(t.sum()) * scale, float(t.abs().sum()) * scale


def stage_terms(args, stage, cdt, tm=SMALL_TM):
    """sum |terms| of the stage's scalar: the magnitudes of the stage's
    values (plain version), times the JAX kernel's broadcast."""
    t = probes.stage_forward_reference(*args[:3], args[3], None, chip_stage_time.STAGES[stage], cdt)
    scale = 1.0 if stage == "full" else chip_stage_time.G * tm * chip_stage_time.O
    return float(t.double().abs().sum()) * scale


@pytest.mark.parametrize("stage", list(chip_stage_time.STAGES))
def test_chip_stage_time_float32_matches_jax_kernel(interpret, stage):
    x = stage_inputs(1)
    want = float(jax_stage_run(stage, False)(*x))
    args = [torch.from_numpy(a) for a in x]
    before = probes.stage_sum.launches
    got = chip_stage_time.run(*args, stage=stage, tm=SMALL_TM)
    assert probes.stage_sum.launches == before  # CPU tensors launch no kernel
    assert got.dtype == torch.float32 and got.dim() == 0
    exact, terms = stage_oracle(args, stage)
    assert abs(float(got) - exact) <= SCALAR_RTOL * terms
    assert abs(float(got) - want) <= JAX_SCALAR_RTOL * terms


@pytest.mark.parametrize("stage", list(chip_stage_time.STAGES))
def test_chip_stage_time_bfloat16_matches_jax_kernel(interpret, stage):
    x = stage_inputs(2)
    if stage == "swap":  # the script as written cannot store a bfloat16 sum in its float32 output
        with pytest.raises(ValueError, match="dtype"):
            jax_stage_run(stage, True)(*x)
    want = float(jax_stage_run(stage, True, widen_sums=stage == "swap")(*x))
    args = [torch.from_numpy(a) for a in x]
    got = float(chip_stage_time.run(*args, stage=stage, tm=SMALL_TM, cdt=torch.bfloat16))
    control = float(chip_stage_time.run(*args, stage=stage, tm=SMALL_TM))
    terms = stage_terms(args, stage, torch.bfloat16)
    sound, unrounded = abs(got - want) / terms, abs(control - want) / terms
    assert sound <= BF16_SCALAR_RTOL[stage] < BF16_SOUND_SHARE * unrounded
    assert sound <= BF16_SOUND_SHARE * unrounded


S_STAGES = ("s1_pne", "s2_agg", "s3_swap", "s4_wcontract", "s5_reduce", "s6_vmap")


@pytest.mark.parametrize("name", S_STAGES)
def test_bisect_fused_stage_matches_jax_kernel(jax_bisect, name):
    key = jax.random.PRNGKey(S_STAGES.index(name) + 10)
    want = np.asarray(jax_bisect.STAGES[name](key))
    inputs = [torch.from_numpy(np.array(a)) for a in jax_bisect.make_inputs(key)]
    before = probes.stage_forward.launches
    got = bisect_fused.STAGES[name](*inputs)
    assert probes.stage_forward.launches == before
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= F32_RTOL * np.abs(want).max()


def _b_draws(mod, name, key):
    """The JAX script's own draws of backward block ``name``."""
    TM, E, G, Q, C, O, GQ, MP = (mod.TM, mod.E, mod.G, mod.Q, mod.C, mod.O, mod.GQ, mod.MP)
    if name == "b3_dw2_contract11":
        k1, k2 = jax.random.split(key)
        return jax.random.normal(k1, (GQ, TM, C)), jax.random.normal(k2, (GQ, TM, O))
    shape = {"b1_jvp_gelu": (TM * E, GQ), "b2_gexp": (G, TM, O), "b4_rank3_accum": (MP, C),
             "b5_merge_back": (TM, E, GQ)}[name]
    return (jax.random.normal(key, shape),)


B_BLOCKS = ("b1_jvp_gelu", "b2_gexp", "b3_dw2_contract11", "b4_rank3_accum", "b5_merge_back")


@pytest.mark.parametrize("name", B_BLOCKS)
def test_bisect_fused_backward_block_matches_jax_kernel(jax_bisect, name):
    key = jax.random.PRNGKey(B_BLOCKS.index(name) + 20)
    want = np.asarray(jax_bisect.STAGES[name](key))
    inputs = [torch.from_numpy(np.array(a)) for a in _b_draws(jax_bisect, name, key)]
    got = bisect_fused.STAGES[name](*inputs)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= F32_RTOL * np.abs(want).max()
    # the port's draw gives the JAX script's shapes
    assert [tuple(a.shape) for a in bisect_fused.draw(name, 0, "cpu")] == [tuple(a.shape) for a in inputs]


def jax_stream(m=SMALL_M, tm=SMALL_TM):
    c = chip_stream
    return _script_functions("chip_stream", ("k_sum", "pallas_sum_feat", "pallas_sum_geo"), M=m, TM=tm,
                             E=c.E, C=c.C, GD1=c.GD1)


@pytest.mark.parametrize("lanes", [chip_stream.GD1, 128])
def test_chip_stream_sum_geo_matches_jax_kernel(interpret, lanes):
    x = np.random.default_rng(lanes).standard_normal((SMALL_M * chip_stream.E, lanes)).astype(np.float32)
    want = float(jax_stream()["pallas_sum_geo"](x, lanes))
    got = chip_stream.sum_geo(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= SCALAR_RTOL * np.abs(x.astype(np.float64)).sum()


def test_chip_stream_sum_feat_matches_jax_kernel(interpret):
    x = np.random.default_rng(64).standard_normal((SMALL_M, chip_stream.E, chip_stream.C)).astype(np.float32)
    want = float(jax_stream()["pallas_sum_feat"](x))
    got = float(chip_stream.sum_feat(torch.from_numpy(x)))
    c = chip_stream.C
    assert abs(got - want) <= SCALAR_RTOL * c * np.abs(x[..., -1].astype(np.float64)).sum()


def test_pallas_sum_feat_returns_c_times_the_last_channel(interpret):
    """The JAX kernel keeps the last channel's sum (``[-1:]`` of a 3-D
    block's sum over its first two axes) and broadcasts it over its ``[1,
    C]`` output: ``C * sum(x[..., C-1])``, not the whole sum."""
    x = np.random.default_rng(7).standard_normal((SMALL_M, chip_stream.E, chip_stream.C)).astype(np.float32)
    want = float(jax_stream()["pallas_sum_feat"](x))
    x64 = x.astype(np.float64)
    c = chip_stream.C
    last = c * x64[..., -1].sum()
    assert abs(want - last) <= SCALAR_RTOL * c * np.abs(x64[..., -1]).sum()
    assert abs(want - x64.sum()) > 100 * SCALAR_RTOL * np.abs(x64).sum()


@pytest.mark.parametrize("width", [64, 19, 128])
def test_column_sums_against_float64(width):
    x = np.random.default_rng(width).standard_normal((3000, width)).astype(np.float32)
    got = probes.column_sums(torch.from_numpy(x)).numpy()
    x64 = x.astype(np.float64)
    assert got.shape == (width + 1,)
    assert np.abs(got[:width] - x64.sum(0)).max() <= SCALAR_RTOL * np.abs(x64).sum(0).max()
    assert abs(got[width] - x64.sum()) <= SCALAR_RTOL * np.abs(x64).sum()


def test_gelu_tanh_grad_is_the_derivative():
    x = torch.linspace(-6, 6, 2001, dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(probes.gelu_tanh(x).sum(), x)
    assert torch.allclose(probes.gelu_tanh_grad(x.detach()), grad, rtol=1e-12, atol=1e-12)


def test_stage_work_at_the_bench_shape():
    """The whole forward at M = 65,536: 5.10 + 17.18 + 34.36 GFLOP over 159
    MB of geo, 537 MB of feat and 34 MB of output (and W's 1 MB)."""
    w = chip_stage_time.stage_work("full", 65536)
    assert w["fma_flops"] / 1e9 == pytest.approx(5.10 + 17.18, abs=0.01)
    assert w["product_flops"] / 1e9 == pytest.approx(34.36, abs=0.01)
    assert w["bytes"] / 1e6 == pytest.approx(159 + 537 + 34 + 1, abs=1)
    assert chip_stage_time.stage_work("pne", 65536)["bytes"] == 4.0 * 65536 * 32 * 19


@pytest.mark.parametrize("entry", ["chip_stage_time", "bisect_fused", "chip_stream"])
def test_probe_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"chip_stage_time": chip_stage_time, "bisect_fused": bisect_fused, "chip_stream": chip_stream}[entry]
    call = {"chip_stage_time": lambda: mod.main(["full"], env={"M": "256"}),
            "bisect_fused": lambda: mod.main(["s1_pne"]), "chip_stream": mod.main}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_stage_sum_writes_the_forward_output(cdt):
    """The 'reduce' stage hands its [G, M, O] output to ``out``, the sum of
    which it returns; the other stages write none."""
    args = chip_stage_time.make_inputs(32, 7, "cpu")
    out = torch.full((chip_stage_time.G, 32, chip_stage_time.O), float("nan"))
    total = probes.stage_sum(*args, stage="reduce", cdt=cdt, out=out)
    ref = probes.stage_forward_reference(*args[:3], args[3], None, "reduce", cdt)
    assert torch.equal(out, ref)
    assert float(total) == float(probes.stage_sum_reference(*args, stage="reduce", cdt=cdt))
    with pytest.raises(ValueError, match="only the 'reduce' stage"):
        probes.stage_sum(*args, stage="agg", cdt=cdt, out=out)
