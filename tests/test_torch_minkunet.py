"""The port's dense-voxel ``MinkUNet34A`` (``se3conv3d_tpu_torch/models/minkunet.py``)
against the JAX package's, on the same numpy inputs: ``voxelize`` /
``devoxelize`` (means within 1e-6, occupancy and indices exact); with the JAX
model's weights carried over by ``utils.weights.minkunet_from_flax`` (the
kernel layouts, and the transposed convs flipped in space), the float32
port's logits within 1e-4 of max |logits| in eval and train mode and its BN
running statistics within 1e-5, and one train step's gradients within 1e-4
of each leaf's max |gradient| (a floor of 1e-2 of the global norm for
leaves whose true gradient is 0: a conv just before a train-mode BN); the
same for one ``_BasicBlock``, one down and one up alone (the fast check,
with the up's kernel loaded unflipped as its control), and the whole
model's control: the transposed convs' kernels loaded unflipped move the
logits far past the bound.

The whole model's reference is the JAX model in float64 (``jax.enable_x64``
around it alone), and its gradients are held against the port's in
float64: a float32 gradient through ~50 ReLUs over millions of voxels
meets a few pre-activations within 1e-7 of 0, whose sign rounding decides,
and one such flip moves a leaf by up to a few percent (in the float32 port
and in JAX alike, each against float64)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from se3conv3d_tpu.models import minkunet as jmink

from se3conv3d_tpu_torch.models import minkunet as tmink
from se3conv3d_tpu_torch.utils.weights import _flatten, minkunet_from_flax

torch.set_num_threads(2)

B, N, C, CLASSES = 2, 512, 3, 5
# the smallest grid at which the deepest level holds a few voxels per cloud:
# at (16, 8, 16) the JAX model's fourth down leaves an axis of extent 0, and
# a level of one voxel a cloud makes its BN statistics (two rows) too
# ill-conditioned to compare in float32
DIMS = (32, 32, 32)
LOGIT_RTOL, GRAD_RTOL, GRAD_FLOOR, BN_RTOL = 1e-4, 1e-4, 1e-2, 1e-5


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(size=(B, N, 3)) * 3.0 - 0.4).astype(np.float32)
    pts[1, :5] += 3.5  # outside the grid: clamped
    mask = np.ones((B, N), bool)
    mask[1, N - 40:] = False
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=(B, N))
    return pts, mask, feats, labels


def test_voxelize_and_devoxelize_match_jax():
    pts, mask, feats, _ = _batch(1)
    jgrid, jocc, jflat = jmink.voxelize(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), 0.1, DIMS)
    grid, occ, flat = tmink.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(feats),
                                     0.1, DIMS)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), rtol=0, atol=1e-6)
    back = tmink.devoxelize(grid, flat)
    np.testing.assert_allclose(back.numpy(), np.asarray(jmink.devoxelize(jgrid, jflat)), rtol=0, atol=1e-6)
    # masked points scatter nothing, and an all-masked cloud gives an empty grid
    grid0, occ0, _ = tmink.voxelize(torch.from_numpy(pts), torch.zeros(B, N, dtype=torch.bool),
                                    torch.from_numpy(feats), 0.1, DIMS)
    assert float(grid0.abs().sum()) == 0.0 and not occ0.any()


def _randomized(variables, seed):
    """Non-trivial BN scales, biases and running statistics."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, size=x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _leaf_errors(ours: dict, ref: dict, rtol: float, floor: float = 0.0) -> list:
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    bad = []
    for name, r in ref.items():
        err = float((ours[name] - r).abs().max())
        if not err <= rtol * max(float(r.abs().max()), floor):
            bad.append((name, err, float(r.abs().max())))
    return bad


@pytest.fixture(scope="module")
def jax_model():
    pts, mask, feats, labels = _batch()
    model = jmink.MinkUNet34A(num_classes=CLASSES, cell=0.1, grid_dims=DIMS)
    v = jax.jit(lambda *a: model.init(jax.random.PRNGKey(3), *a, train=False))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats))
    params, stats = _randomized(v["params"], 4), _randomized(v["batch_stats"], 5)
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), (params, stats))
        args = (jnp.asarray(pts, jnp.float64), jnp.asarray(mask), jnp.asarray(feats, jnp.float64))

        def loss_fn(params, stats):
            logits, upd = model.apply({"params": params, "batch_stats": stats}, *args, train=True,
                                      mutable=["batch_stats"])
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
            return jnp.sum(ls * mask) / jnp.sum(mask), (logits, upd["batch_stats"])

        (loss, (train_logits, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(*wide)
        eval_logits = jax.jit(lambda p, s: model.apply({"params": p, "batch_stats": s}, *args, train=False))(
            *wide)
        assert eval_logits.dtype == jnp.float64
        return dict(batch=(pts, mask, feats, labels), params=params, stats=stats, loss=float(loss),
                    train_logits=np.asarray(train_logits), eval_logits=np.asarray(eval_logits),
                    grads=jax.device_get(grads), new_stats=jax.device_get(new_stats))


def _port(params, stats, dtype=torch.float32):
    model = tmink.MinkUNet34A(CLASSES, C, cell=0.1, grid_dims=DIMS).to(dtype)
    model.load_state_dict(minkunet_from_flax(jax.device_get(params), jax.device_get(stats)))
    return model


@pytest.mark.slow  # the JAX float64 reference: ~2.5 min of XLA CPU convs
def test_minkunet_forward_and_train_step_match_jax(jax_model):
    j = jax_model
    pts, mask, feats, labels = (torch.from_numpy(np.asarray(x)) for x in j["batch"])
    model = _port(j["params"], j["stats"])
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(j["params"]))
    model.eval()
    with torch.no_grad():
        logits = model(pts, mask, feats)
    assert logits.shape == (B, N, CLASSES)
    span = np.abs(j["eval_logits"]).max()
    assert np.abs(logits.numpy() - j["eval_logits"]).max() <= LOGIT_RTOL * span

    model.train()
    with torch.no_grad():
        logits = model(pts, mask, feats)
    assert np.abs(logits.numpy() - j["train_logits"]).max() <= LOGIT_RTOL * np.abs(j["train_logits"]).max()
    ref_stats = {k: v for k, v in minkunet_from_flax(j["params"], j["new_stats"]).items()
                 if k.endswith((".mean", ".var"))}
    ours = {k: v.double() for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    assert not _leaf_errors(ours, ref_stats, BN_RTOL)
    before = minkunet_from_flax(j["params"], j["stats"])
    assert all(not torch.equal(v, before[k].double()) for k, v in ours.items())  # every statistic moved

    wide = _port(j["params"], j["stats"], torch.float64).train()
    logits = wide(pts.double(), mask, feats.double())
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, CLASSES), labels.reshape(-1), reduction="none")
    loss = (ce * mask.reshape(-1)).sum() / mask.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), j["loss"], rtol=1e-10)
    ref_grads = {k: v for k, v in minkunet_from_flax(j["grads"], j["stats"]).items()
                 if not k.endswith((".mean", ".var"))}
    ours = {name: p.grad for name, p in wide.named_parameters()}
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in ref_grads.values())))
    assert not _leaf_errors(ours, ref_grads, GRAD_RTOL, GRAD_FLOOR * norm)


@pytest.mark.slow  # shares the float64 reference
def test_unflipped_transposed_kernels_fail_the_logit_bound(jax_model):
    """The control: the ups' kernels permuted but not flipped."""
    j = jax_model
    pts, mask, feats, _ = (torch.from_numpy(np.asarray(x)) for x in j["batch"])
    model = _port(j["params"], j["stats"]).eval()
    with torch.no_grad():
        for conv, _ in model.ups:
            conv.weight.copy_(conv.weight.flip(2, 3, 4))
        logits = model(pts, mask, feats)
    span = np.abs(j["eval_logits"]).max()
    assert np.abs(logits.numpy() - j["eval_logits"]).max() > 100 * LOGIT_RTOL * span


class _JaxParts(fnn.Module):
    """One down, one ``_BasicBlock`` (with its 1x1 residual conv) and one
    up with its skip concat, as ``MinkUNet34A.__call__`` strings them."""

    @fnn.compact
    def __call__(self, x, occ, train: bool):
        x2 = jmink._conv(16, 2, stride=2)(x)
        occ2 = jmink._pool_occ(occ)
        x2 = fnn.relu(jmink._MaskedBN(16)(x2, occ2, train)) * occ2[..., None]
        x2 = jmink._BasicBlock(24)(x2, occ2, train)
        up = jmink._convtr(8)(x2)
        up = fnn.relu(jmink._MaskedBN(8)(up, occ, train)) * occ[..., None]
        return jnp.concatenate([up, x], -1)


class _TorchParts(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.down = torch.nn.ModuleList([tmink._conv(cin, 16, 2, stride=2), tmink._MaskedBN(16)])
        self.block = tmink._BasicBlock(16, 24)
        self.up = torch.nn.ModuleList([torch.nn.ConvTranspose3d(24, 8, 2, stride=2, bias=False),
                                       tmink._MaskedBN(8)])

    def forward(self, x, occ):
        occ2 = tmink._pool_occ(occ)
        x2 = tmink._masked(torch.relu(self.down[1](self.down[0](x), occ2)), occ2)
        x2 = self.block(x2, occ2)
        up = tmink._masked(torch.relu(self.up[1](self.up[0](x2), occ)), occ)
        return torch.cat([up, x], 1)


def _parts_state(params, stats) -> dict:
    """The parts' flax tree -> ``_TorchParts``' state_dict, through the
    MinkUNet converter's layout rules (a conv, a transposed conv, a BN)."""
    fp, fs = _flatten(params), _flatten(stats)

    def conv(k):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(fp[k]).transpose(4, 3, 0, 1, 2)))

    def bn(port, flax):
        return {f"{port}.norm.{n}": torch.from_numpy(np.array((fp if n in ("scale", "bias") else fs)[
            f"{flax}.MaskedBatchNorm_0.{n}"])) for n in ("scale", "bias", "mean", "var")}

    sd = {"down.0.weight": conv("Conv_0.kernel"), **bn("down.1", "_MaskedBN_0"),
          "block.conv1.weight": conv("_BasicBlock_0.Conv_0.kernel"), **bn("block.bn1", "_BasicBlock_0._MaskedBN_0"),
          "block.conv2.weight": conv("_BasicBlock_0.Conv_1.kernel"), **bn("block.bn2", "_BasicBlock_0._MaskedBN_1"),
          "block.down.0.weight": conv("_BasicBlock_0.Conv_2.kernel"),
          **bn("block.down.1", "_BasicBlock_0._MaskedBN_2"),
          "up.0.weight": torch.from_numpy(np.ascontiguousarray(
              np.flip(np.asarray(fp["ConvTranspose_0.kernel"]), (0, 1, 2)).transpose(3, 4, 0, 1, 2))),
          **bn("up.1", "_MaskedBN_1")}
    return sd


def _parts_case(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, 8, 16, 6)).astype(np.float32)
    occ = rng.uniform(size=(2, 8, 8, 16)) < 0.4
    return x * occ[..., None], occ


def test_unflipped_up_kernel_fails_the_parts_bound():
    """The fast control: the up's kernel permuted but not flipped."""
    x, occ = _parts_case()
    jm = _JaxParts()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(occ), False)
    params, stats = _randomized(v["params"], 8), _randomized(v["batch_stats"], 9)
    jout = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(occ), False))
    tm = _TorchParts(6)
    tm.load_state_dict(_parts_state(params, stats))
    tm.eval()
    with torch.no_grad():
        tm.up[0].weight.copy_(tm.up[0].weight.flip(2, 3, 4))
        tout = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(occ)).permute(0, 2, 3, 4, 1)
    assert np.abs(tout.numpy() - jout).max() > 100 * LOGIT_RTOL * np.abs(jout).max()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_block_down_and_up_match_jax(train):
    x, occ = _parts_case()
    jm = _JaxParts()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(occ), False)
    params, stats = _randomized(v["params"], 8), _randomized(v["batch_stats"], 9)
    jout, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(occ), train,
                         mutable=["batch_stats"])
    tm = _TorchParts(6)
    tm.load_state_dict(_parts_state(params, stats))
    tm.train(train)
    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_(True)
    with torch.set_grad_enabled(train):
        tout = tm(tx, torch.from_numpy(occ)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=0,
                               atol=LOGIT_RTOL * float(np.abs(np.asarray(jout)).max()))
    if train:
        new = _parts_state(params, upd["batch_stats"])
        for k, ref in new.items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(tm.state_dict()[k].numpy(), ref.numpy(), rtol=BN_RTOL, atol=1e-7,
                                           err_msg=k)
        # gradients of a fixed projection of the output
        proj = np.random.default_rng(10).normal(size=np.asarray(jout).shape).astype(np.float32)
        jgrad = jax.grad(lambda p: jnp.sum(jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                                     jnp.asarray(occ), True, mutable=["batch_stats"])[0]
                                           * proj))(params)
        (tout * torch.from_numpy(proj)).sum().backward()
        ref = {k: v for k, v in _parts_state(jgrad, stats).items() if not k.endswith((".mean", ".var"))}
        ours = {n: p.grad for n, p in tm.named_parameters()}
        norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
        assert not _leaf_errors(ours, ref, GRAD_RTOL, GRAD_FLOOR * norm)


def test_grid_dims_must_halve_four_times():
    with pytest.raises(ValueError, match="multiple of 16"):
        tmink.MinkUNet34A(CLASSES, C, grid_dims=(16, 8, 16))
