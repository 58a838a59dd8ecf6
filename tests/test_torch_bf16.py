"""The port's bfloat16 conv path against the JAX package's fused bf16 path.

``compute_dtype: bfloat16`` (every ScanNet recipe) rounds the conv operands
to bfloat16 at fixed points and sums in float32
(``se3conv3d_tpu/ops/pallas/fused_equiv.py:_fwd_kernel`` / ``_bwd_kernel``
with ``cdt``, and their callers in ``se3conv3d_tpu/ops/pne_conv.py``).  On
the CPU the port runs its kernels' plain versions, which round at the same
points; the JAX side runs the Pallas kernels in interpret mode
(``FUSED_INTERPRET``).  The two then differ only by float32 summation order
(and by JAX's hi/lo bfloat16 position pair, about 16 bits, where the port
reads float32 positions), which can flip the bfloat16 rounding of a
geometry, pne, basis, dbasis or dpre entry by one bfloat16 ulp (2^-8
relative).  Hence the bounds: ``max |port - JAX| <= 1e-2 * max |JAX|`` and
``mean |port - JAX| <= 1e-3 * max |JAX|``, per output and per gradient
leaf (``1e-2 * max |JAX leaf|``).  A port that skipped the roundings would
sit within those bounds too, so each comparison is also held against JAX's
float32 path on the same inputs: the port's mean error against JAX bf16
must be at most half its mean error against JAX float32.

The plain versions are also held against a float64 numpy oracle that rounds
at the same points, the whole tiny ScanNet-shaped model's bf16 logits
against JAX's, and the recipe's ``compute_dtype`` against
``build_model_from_config`` and the neighborhood cache.  (The CUDA kernels are held against the
plain versions on the card, ``tests/test_torch_kernel_cuda.py``.)
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.special import erf

from test_torch_scannet import CLASSES, FEATS, HCFG, NAME, SMALL, _batch
from torch_port_helpers import randomize, t, to_torch_cloud, to_torch_hierarchy

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.core.frames import pca_frames
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.neighborhoods import knn_neighborhood as jknn
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec, presets
from se3conv3d_tpu_torch.models.spec import NeighborhoodProvider
from se3conv3d_tpu_torch.ops import pne_conv as ops
from se3conv3d_tpu_torch.train import config
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

K, Q, C, O = 8, 16, 12, 10
MAX_RTOL, MEAN_RTOL = 1e-2, 1e-3
CASES = {
    # name: (seed, G out-frames, F in-frames, M_out, masked query tail, Pallas tile_m)
    "g2_f2_masked_query_tail": (1, 2, 2, 70, 9, 64),
    "g1_f1": (2, 1, 1, 96, 0, 32),
    "g1_f2": (3, 1, 2, 80, 5, 32),
    "g2_f1": (4, 2, 1, 64, 0, 32),
}
ND, NN = 3.0, 0.11
LEAVES = ("feats", "proj_axes", "proj_biases", "conv_weights")


@jax.jit
def _framed(pts, mask, sel):
    jpc = JCloud(pts, mask)
    kn = jknn(jpc, jpc, 8)
    return JCloud(pts, mask, pca_frames(pts, kn.idx, kn.mask, select_idx=sel))


def _cloud(rng, b, n, tail, frames):
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32) * 2.0
    mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
    sel = np.argsort(rng.uniform(size=(b, n, 4)), -1)[..., :frames]
    return _framed(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(sel))


@functools.lru_cache(maxsize=None)
def _case(name):
    """Source cloud of 96 points (masked tail) with F frames, query cloud of
    ``M_out`` points (masked tail) with G frames, ball-query neighborhood,
    features and parameters (numpy seed)."""
    seed, g, f, m_out, q_tail, _ = CASES[name]
    rng = np.random.default_rng(seed)
    pc_in = _cloud(rng, 2, 96, (0, 7), f)
    pc_out = _cloud(rng, 2, m_out, (q_tail, 0), g)
    neigh = jax.jit(jball, static_argnums=(2, 3))(pc_in, pc_out, 0.5, K)
    feats = rng.normal(size=(2, 96, f, C)).astype(np.float32)
    pa = (rng.normal(size=(9, Q)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(Q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(C, Q, O)) * 0.1).astype(np.float32)
    return pc_in, pc_out, neigh, feats, pa, pb, w


def _jax_out(name, cdt):
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(name)
    return np.asarray(jops.fused_equiv_conv(
        pc_in, pc_out, neigh, *(jnp.asarray(x) for x in (feats, pa, pb, w)), jnp.asarray(ND),
        jnp.asarray(NN), tile_m=CASES[name][5], compute_dtype=cdt))


def _port_conv(name, params):
    pc_in, pc_out, neigh = _case(name)[:3]
    tn = Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)
    return ops.fused_equiv_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn, *params,
                                torch.tensor(ND), torch.tensor(NN), compute_dtype=torch.bfloat16)


def _hold(got, want_bf16, want_f32, what):
    """The bounds of the module note, and the cast-set discrimination."""
    scale = np.abs(want_bf16).max()
    assert scale > 0, what
    err = np.abs(got - want_bf16)
    assert err.max() <= MAX_RTOL * scale, (what, err.max(), scale)
    assert err.mean() <= MEAN_RTOL * scale, (what, err.mean(), scale)
    assert err.mean() <= 0.5 * np.abs(got - want_f32).mean(), (what, err.mean(),
                                                               np.abs(got - want_f32).mean())


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_conv_forward_matches_jax_fused_bf16(name, monkeypatch):
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    feats, pa, pb, w = _case(name)[3:]
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = _port_conv(name, [t(x) for x in (feats, pa, pb, w)])
    assert kfe.fused_equiv_fwd.launches == before  # CPU tensors launch no kernel
    assert got.dtype == torch.float32 and got.shape == (2, CASES[name][3], CASES[name][1], O)
    _hold(got.numpy(), _jax_out(name, jnp.bfloat16), _jax_out(name, None), name)


@functools.lru_cache(maxsize=None)
def _jax_grads(name, cdt, mode):
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(name)
    saved = jops.BWD_SCATTER_MODE
    jops.BWD_SCATTER_MODE = mode
    try:
        def jloss(params):
            out = jops.fused_equiv_conv(pc_in, pc_out, neigh, *params, jnp.asarray(ND),
                                        jnp.asarray(NN), tile_m=CASES[name][5],
                                        compute_dtype=cdt, lean_vjp=True)
            return jnp.sum(out * jnp.cos(out))

        return tuple(np.asarray(x) for x in jax.grad(jloss)(
            tuple(jnp.asarray(x) for x in (feats, pa, pb, w))))
    finally:
        jops.BWD_SCATTER_MODE = saved


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("name", ["g2_f2_masked_query_tail", "g1_f2"])
def test_bf16_conv_gradients_match_jax_pallas_backward(name, mode, monkeypatch):
    """All four gradients of ``sum(out * cos(out))`` through the port's bf16
    conv (the plain backward; 'sorted' sums the bfloat16 per-edge rows by the
    prefix sum) against ``jax.grad`` through the Pallas backward in
    interpret mode, in the same mode; the feature gradient comes back
    rounded to bfloat16."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", mode)
    want_bf16 = _jax_grads(name, jnp.bfloat16, mode)
    want_f32 = _jax_grads(name, None, "scatter")
    params = [t(x).requires_grad_() for x in _case(name)[3:]]
    out = _port_conv(name, params)
    (out * torch.cos(out)).sum().backward()
    d_feats = params[0].grad
    assert d_feats.dtype == torch.float32
    assert torch.equal(d_feats, d_feats.to(torch.bfloat16).float())  # rounded to bfloat16
    for p, wb, wf, leaf in zip(params, want_bf16, want_f32, LEAVES):
        _hold(p.grad.numpy(), wb, wf, f"{name} {mode} {leaf}")


def _bf(x):
    """float64 values rounded to bfloat16, as float64."""
    return torch.from_numpy(np.asarray(x, np.float64)).to(torch.bfloat16).double().numpy()


def _oracle(rel, rot6, feats, idx, mask, pa, pb, w, gout):
    """Float64 forward and backward of the conv, rounding to bfloat16 at the
    bf16 path's points: pa, pb and w as read; pne; basis; gout; dbasis; each
    edge's feature-gradient row; dpre."""
    b, m, k, g, _ = rel.shape
    f = rot6.shape[4]
    geo = np.concatenate([np.broadcast_to(rel[:, :, :, :, None], (b, m, k, g, f, 3)), rot6], -1)
    pre = geo @ _bf(pa) + _bf(pb)
    pne = _bf(0.5 * pre * (1.0 + erf(pre / np.sqrt(2.0))))
    bidx = np.arange(b)[:, None, None]
    edge = mask[:, :, :, None, None]
    gathered = feats[bidx, idx] * edge
    basis = _bf(np.einsum("bmkfc,bmkgfq->bmgcq", gathered, pne))
    wb = _bf(w)
    out = np.einsum("bmgcq,cqo->bmgo", basis, wb)
    go = _bf(gout)
    d_w = np.einsum("bmgcq,bmgo->cqo", basis, go)
    dbasis = _bf(np.einsum("bmgo,cqo->bmgcq", go, wb))
    d_edge = _bf(np.einsum("bmkgfq,bmgcq->bmkfc", pne, dbasis)) * edge
    d_feats = np.zeros(feats.shape)
    np.add.at(d_feats, (np.broadcast_to(bidx, idx.shape), idx), d_edge)
    dact = 0.5 * (1.0 + erf(pre / np.sqrt(2.0))) + pre * np.exp(-0.5 * pre * pre) / np.sqrt(2 * np.pi)
    dpne = np.einsum("bmkfc,bmgcq->bmkgfq", gathered, dbasis)
    dpre = _bf(dpne * dact) * mask[:, :, :, None, None, None]
    return out, (d_feats, np.einsum("bmkgfq,bmkgfd->dq", dpre, geo), dpre.sum((0, 1, 2, 3, 4)), d_w)


@pytest.mark.parametrize("g,f", [(1, 1), (2, 2), (1, 2)])
def test_bf16_plain_versions_match_a_float64_oracle(g, f):
    """``fused_equiv_fwd_reference`` / ``fused_equiv_bwd_reference`` on
    bfloat16 operands against :func:`_oracle`.  Their float32 sums can flip
    a rounding by one bfloat16 ulp where the oracle's float64 sum lies next
    to a rounding boundary, so each output is held within one ulp of its
    largest value (2^-7 * max |oracle|), and on average within 2^-7 / 32 of
    it: a version that skipped a rounding point sits near 2^-9 on average."""
    rng = np.random.default_rng(10 + g + 2 * f)
    b, m, n, k = 2, 40, 50, 6
    rel = _bf(rng.normal(size=(b, m, k, g, 3)) * 0.5)
    rot6 = _bf(rng.normal(size=(b, m, k, g, f, 6)) * 0.5)
    feats = _bf(rng.normal(size=(b, n, f, C)))
    idx = rng.integers(0, n, size=(b, m, k))
    mask = rng.uniform(size=(b, m, k)) < 0.7
    mask[:, -4:] = False
    pa, pb = rng.normal(size=(9, Q)) * 0.3, rng.normal(size=(Q,)) * 0.1
    w, gout = rng.normal(size=(C, Q, O)) * 0.1, rng.normal(size=(b, m, g, O))
    want_out, want_grads = _oracle(rel, rot6, feats, idx, mask, pa, pb, w, gout)

    def bf(x):
        return torch.from_numpy(x).to(torch.bfloat16)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    args = (bf(rel), bf(rot6), bf(feats), torch.from_numpy(idx), torch.from_numpy(mask),
            f32(pa), f32(pb), f32(w))
    got_out = kfe.fused_equiv_fwd(*args)
    got_grads = kfe.fused_equiv_bwd(*args, f32(gout))
    assert got_out.dtype == torch.float32 and all(x.dtype == torch.float32 for x in got_grads)
    for what, got, want in zip(("out",) + LEAVES, (got_out,) + got_grads, (want_out,) + want_grads):
        scale = np.abs(want).max()
        err = np.abs(got.double().numpy() - want)
        assert err.max() <= 2.0**-7 * scale, (what, err.max(), scale)
        assert err.mean() <= 2.0**-7 / 32 * scale, (what, err.mean(), scale)


def _bf16_specs():
    """The tiny ScanNet-shaped spec of ``tests/test_torch_scannet.py`` with
    bfloat16 convs, in both packages; the JAX one takes the fused path."""
    jspec = dataclasses.replace(jget_spec(NAME), **SMALL)
    jspec = dataclasses.replace(
        jspec,
        conv=dataclasses.replace(jspec.conv, compute_dtype="bfloat16", use_fused=True),
        conv_blocks=dataclasses.replace(jspec.conv_blocks, compute_dtype="bfloat16", use_fused=True))
    tspec = dataclasses.replace(get_model_spec(NAME), **SMALL)
    tspec = dataclasses.replace(
        tspec, conv=dataclasses.replace(tspec.conv, compute_dtype=torch.bfloat16),
        conv_blocks=dataclasses.replace(tspec.conv_blocks, compute_dtype=torch.bfloat16))
    return jspec, tspec


def test_bf16_model_logits_match_jax_fused_bf16(monkeypatch):
    """The tiny ScanNet-shaped model in bfloat16 through both packages on
    one JAX-built hierarchy, same weights and calibration: 24 bf16 convs
    whose rounding flips compound through the blocks, BN and the heads, so
    the bound is ``2e-2 * max |logits|`` (the float32 logits differ from
    the bf16 ones by several times that, which the mean error must stay
    well below)."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    pts, mask, feats, labels = _batch()
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}
    jspec, tspec = _bf16_specs()
    cfg = jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(n_frames=1, neigh_k=8))
    jmodel = JNet(jspec, num_in_feats=FEATS, num_classes=CLASSES)
    f32_model = JNet(dataclasses.replace(jget_spec(NAME), **SMALL), num_in_feats=FEATS,
                     num_classes=CLASSES)
    h, f0, out_pc, _, _ = jax.jit(JTrainer(f32_model, cfg, optax.identity(),
                                           donate_state=False)._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(f32_model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc,
        train=False)
    rng = np.random.default_rng(4)
    params, stats = randomize(v["params"], rng), randomize(v["batch_stats"], rng)
    _, mut = jax.jit(f32_model.apply, static_argnames=("train", "calibrate", "mutable"))(
        {"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0, out_pc,
        train=False, calibrate=True, mutable=("calib",))
    variables = {"params": params, "batch_stats": stats, "calib": mut["calib"]}
    want = np.asarray(jax.jit(jmodel.apply, static_argnames=("train",))(
        variables, h, f0, out_pc, train=False))
    want_f32 = np.asarray(jax.jit(f32_model.apply, static_argnames=("train",))(
        variables, h, f0, out_pc, train=False))

    model = FPNSegUNet(tspec, num_in_feats=FEATS, num_classes=CLASSES)
    model.load_state_dict(from_flax(*(jax.device_get(x) for x in (params, stats, mut["calib"]))))
    with torch.no_grad():
        got = model.eval()(to_torch_hierarchy(h), t(f0), to_torch_cloud(out_pc)).numpy()
    valid = np.asarray(out_pc.mask)
    scale = np.abs(want[valid]).max()
    err = np.abs(got - want)[valid]
    assert scale > 0.1
    assert err.max() <= 2e-2 * scale, (err.max(), scale)
    assert err.mean() <= 0.5 * np.abs(got - want_f32)[valid].mean()


def test_recipe_compute_dtype_builds_bf16_convs():
    """The ScanNet recipe's ``compute_dtype: bfloat16`` reaches every conv
    unedited; float32 and absent build float32 convs; float16 raises."""
    model = config.build_model_from_config(presets.SCANNET20_ROT_PCA_I_MODEL, FEATS, CLASSES,
                                           device="cpu", generator=torch.Generator().manual_seed(0))
    convs = [mod for mod in model.modules() if hasattr(mod, "conv_weights")]
    assert len(convs) == 32 and all(c.compute_dtype == torch.bfloat16 for c in convs)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    spec = presets.spec_from_model_dict(presets.SCANNET20_ROT_PCA_I_MODEL)
    assert spec.conv.compute_dtype == spec.conv_blocks.compute_dtype == torch.bfloat16
    f32 = {**presets.SCANNET20_ROT_PCA_I_MODEL, "compute_dtype": "float32"}
    assert presets.spec_from_model_dict(f32).conv.compute_dtype == torch.float32
    absent = {k: v for k, v in presets.SCANNET20_ROT_PCA_I_MODEL.items() if k != "compute_dtype"}
    assert presets.spec_from_model_dict(absent).conv_blocks.compute_dtype is None
    with pytest.raises(NotImplementedError):
        presets.spec_from_model_dict({**presets.SCANNET20_ROT_PCA_I_MODEL, "compute_dtype": "float16"})


def test_provider_caches_bf16_geometry_and_a_float32_conv_rebuilds():
    """A bf16 spec's provider caches its edge geometry in bfloat16 (half the
    bytes), as ``se3conv3d_tpu/models/spec.py`` caches the packed geometry;
    a float32 conv on that neighborhood rebuilds float32 geometry, with a
    warning, and gives the bits of a conv on the uncached neighborhood."""
    pts, mask, feats, _ = _batch()
    cfg = jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(n_frames=1, neigh_k=8))
    jmodel = JNet(dataclasses.replace(jget_spec(NAME), **SMALL), num_in_feats=FEATS,
                  num_classes=CLASSES)
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.zeros(mask.shape, jnp.int32)}
    h = to_torch_hierarchy(jax.jit(JTrainer(jmodel, cfg, optax.identity(),
                                            donate_state=False)._build)(jax.random.PRNGKey(3), jbatch)[0])
    _, tspec = _bf16_specs()
    nb = NeighborhoodProvider(h, tspec).get(0, 0, 0.16, "ball_query", 8)
    assert nb.equiv_rel.dtype == nb.equiv_rot.dtype == torch.bfloat16
    f32_nb = NeighborhoodProvider(h, dataclasses.replace(get_model_spec(NAME), **SMALL)).get(
        0, 0, 0.16, "ball_query", 8)
    assert f32_nb.equiv_rel.dtype == torch.float32
    pc = h.levels[0]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(pc.positions.shape[0], pc.capacity, 1, C, generator=gen)
    params = (torch.randn(9, Q, generator=gen) * 0.3, torch.randn(Q, generator=gen) * 0.1,
              torch.randn(C, Q, O, generator=gen) * 0.1, torch.tensor(ND), torch.tensor(NN))
    with pytest.warns(UserWarning, match="rebuilding"):
        got = ops.fused_equiv_conv(pc, pc, nb, x, *params)
    bare = dataclasses.replace(nb, equiv_rel=None, equiv_rot=None)
    assert torch.equal(got, ops.fused_equiv_conv(pc, pc, bare, x, *params))
    assert torch.equal(got, ops.fused_equiv_conv(pc, pc, f32_nb, x, *params))
