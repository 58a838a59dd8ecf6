"""The fused conv CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py``.
Tolerances: both sides sum in float32 in different orders, so
``max |kernel - plain| <= 1e-5 * max |plain|`` for the forward; the
backward's parameter gradients sum over every edge of the batch, so
``1e-4 * max |plain|`` for each of its four outputs.
"""
import pytest
import torch

from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

SHAPES = {
    # name: B, M, N, K, G, F, Q, C, O, valid-edge fraction
    "slice_like": (2, 300, 260, 32, 2, 2, 32, 32, 32, 0.7),
    "ragged_odd_widths": (3, 77, 50, 8, 2, 2, 16, 24, 20, 0.6),
    "g1_wide_out": (1, 40, 64, 12, 1, 1, 32, 70, 300, 0.8),  # two output blocks
    "many_neighbors_deep": (2, 33, 128, 40, 2, 2, 32, 256, 256, 0.5),
    "all_masked_tiles": (2, 64, 64, 16, 2, 2, 32, 32, 32, 0.0),
}
BWD_RTOL = 1e-4


def _inputs(b, m, n, k, g, f, q, c, o, frac, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    mask = torch.rand(b, m, k, generator=gen, device="cuda") < frac
    mask[:, -5:] = False  # a masked query tail
    return (rnd(b, m, k, g, 3) * 0.5, rnd(b, m, k, g, f, 6) * 0.5, rnd(b, n, f, c),
            torch.randint(0, n, (b, m, k), generator=gen, device="cuda"), mask,
            rnd(9, q) * 0.3, rnd(q) * 0.1, rnd(c, q, o) * (c * q) ** -0.5)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused conv kernels are CUDA-only")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_plain_version(name):
    _needs_card()
    args = _inputs(*SHAPES[name], seed=sorted(SHAPES).index(name))
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args)
        torch.cuda.synchronize()
        ref = kfe.fused_equiv_fwd_reference(*args)
    assert kfe.fused_equiv_fwd.launches == before + 1
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(ref.abs().max().item(), 1e-6), (err, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_kernel_matches_plain_version(name):
    _needs_card()
    args = _inputs(*SHAPES[name], seed=sorted(SHAPES).index(name))
    b, m, _, _, g, _, _, _, o, _ = SHAPES[name]
    gout = torch.randn(b, m, g, o, device="cuda", generator=torch.Generator(device="cuda").manual_seed(7))
    before = kfe.fused_equiv_bwd.launches
    got = kfe.fused_equiv_bwd(*args, gout)
    torch.cuda.synchronize()
    ref = kfe.fused_equiv_bwd_reference(*args, gout)
    assert kfe.fused_equiv_bwd.launches == before + 1
    for what, x, y in zip(("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights"), got, ref):
        assert x.shape == y.shape and torch.isfinite(x).all(), what
        if name == "all_masked_tiles":
            assert not x.any(), what  # no valid edge: every gradient is exactly zero
            continue
        err = (x - y).abs().max().item()
        assert err <= BWD_RTOL * y.abs().max().item(), (what, err, y.abs().max().item())


@pytest.mark.cuda
def test_backward_launches_the_backward_kernel_once():
    _needs_card()
    args = list(_inputs(*SHAPES["slice_like"], seed=0))
    for i in (2, 5, 6, 7):
        args[i].requires_grad_()
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    out = kfe.fused_equiv(*args)
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == (before[0] + 1, before[1])
    out.square().sum().backward()
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(args[i].grad is not None and args[i].grad.is_cuda for i in (2, 5, 6, 7))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take():
    _needs_card()
    args = list(_inputs(*SHAPES["slice_like"], seed=0))
    with pytest.raises(TypeError):
        kfe.fused_equiv_fwd(*args[:3], args[3].int(), *args[4:])
    with pytest.raises(ValueError):
        kfe.fused_equiv_fwd(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):
        kfe.fused_equiv_fwd(args[0].cpu(), *args[1:])
    gout = torch.zeros(2, 300, 2, 32, device="cuda")
    with pytest.raises(ValueError):
        kfe.fused_equiv_bwd(*args, gout[:, :-1])
    with pytest.raises(ValueError):
        kfe.fused_equiv_bwd(*args, gout.cpu())
