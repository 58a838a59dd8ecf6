"""The conv backward's live-row table: the query rows with at least one
valid edge, the only rows the backward works on.

CPU tensors run the kernel's plain version over every row, whatever the
table.  Held here: the table itself, that the plain backward over the
table's rows alone gives the plain backward over all rows (why skipping
the others is exact), the port's conv gradients on a fully masked query
tail against ``jax.grad`` through the Pallas backward (interpret mode, as
``tests/test_torch_conv.py`` runs it), and the neighborhood provider,
which attaches the table once per neighborhood, whatever the grad mode.
The forward's use of the table is held in ``tests/test_torch_fwd_live.py``;
the CUDA kernels on live rows against the plain version over all rows, on
the card, in ``tests/test_torch_kernel_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t, to_torch_cloud

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu.core.frames import pca_frames
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.neighborhoods import knn_neighborhood as jknn
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu_torch.core.hierarchy import FrameConfig, HierarchyConfig, build_hierarchy
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.models import NeighborhoodProvider, get_model_spec
from se3conv3d_tpu_torch.models import spec as spec_mod
from se3conv3d_tpu_torch.ops import pne_conv as ops

torch.set_num_threads(2)

# the plain backward over the live rows against over all rows: the same
# float32 terms, summed over fewer rows in another order, so 16 eps of the
# output's largest value
SAME_RTOL = 16 * float(np.finfo(np.float32).eps)


def _mask(seed, b, m, k, fills):
    """``[B, M, K]`` validity with a live prefix of ``fills[i]`` rows in
    example ``i`` (about 70% valid edges there) and a fully masked rest."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(b, m, k)) < 0.7
    for i, fill in enumerate(fills):
        mask[i, fill:] = False
    return mask


def test_live_row_table_lists_the_rows_with_a_valid_edge():
    mask = _mask(0, 4, 50, 6, (50, 17, 0, 31))
    mask[0, 5] = False  # a padded row inside a live prefix
    live = kfe.live_row_table(torch.from_numpy(mask))
    assert live.dtype == torch.int32 and live.dim() == 1 and live.is_contiguous()
    want = np.flatnonzero(mask.any(-1).reshape(-1))
    np.testing.assert_array_equal(live.numpy(), want)
    assert np.all(np.diff(live.numpy()) > 0)  # ascending b*M + m
    assert not np.isin(np.arange(100, 150), live.numpy()).any()  # the all-padded example
    assert kfe.live_row_table(torch.zeros(2, 3, 4, dtype=torch.bool)).numel() == 0


def _bwd_args(seed, b, m, n, k, g, fills):
    f, q, c, o = g, 8, 5, 7
    gen = torch.Generator().manual_seed(seed)
    mask = torch.from_numpy(_mask(seed, b, m, k, fills))
    idx = torch.randint(0, n, (b, m, k), generator=gen)
    idx = torch.where(mask, idx, torch.zeros_like(idx))  # as the searches clamp invalid slots
    args = [torch.randn(b, m, k, g, 3, generator=gen), torch.randn(b, m, k, g, f, 6, generator=gen),
            torch.randn(b, n, f, c, generator=gen), idx, mask,
            torch.randn(9, q, generator=gen) * 0.3, torch.randn(q, generator=gen) * 0.1,
            torch.randn(c, q, o, generator=gen) * 0.3]
    return args, torch.randn(b, m, g, o, generator=gen)


def _plain_backward_on_rows(args, gout, sorted_slot, live_rows):
    """The plain backward over the rows of ``live_rows`` only: they become
    one example of ``L`` query rows over the ``B*N`` sources of all
    examples, and its outputs go back to the shapes of the whole."""
    rel, rot6, feats, idx, mask, pa, pb, w = args
    b, m, k = idx.shape
    n, f, c = feats.shape[1:]
    rows = live_rows.long()
    example = rows // m

    def pick(x):
        return x.reshape(b * m, *x.shape[2:])[rows][None]

    idx_live = pick(idx) + (example * n)[None, :, None]
    # an identity slot table: the per-edge rows in live-row order
    order = None if sorted_slot is None else torch.arange(rows.numel() * k)[None]
    d_rows, d_pa, d_pb, d_w = kfe.fused_equiv_bwd_reference(
        pick(rel), pick(rot6), feats.reshape(1, b * n, f, c), idx_live, pick(mask), pa, pb, w,
        pick(gout), order)
    if sorted_slot is None:
        return d_rows.reshape(feats.shape), d_pa, d_pb, d_w
    target = (sorted_slot.reshape(b * m, k)[rows] + (example * (m * k))[:, None]).reshape(-1)
    d_feats = d_rows.new_zeros(b * m * k, f * c).index_copy_(0, target, d_rows[0])
    return d_feats.reshape(b, m * k, f * c), d_pa, d_pb, d_w


def test_wrapper_checks_the_table_it_is_given_without_a_host_sync():
    """``_live_rows``, which both CUDA wrappers call: it checks the table's
    device, dtype, rank, contiguity and length, and passes entries outside
    ``[0, B*M)`` on (the kernels skip them; a range check would cost a host
    synchronisation per conv)."""
    mask = torch.from_numpy(_mask(1, 3, 40, 5, (40, 12, 0)))
    live = kfe.live_row_table(mask)
    cpu = torch.device("cpu")
    assert kfe._live_rows(live, mask, 120, cpu) is live
    assert torch.equal(kfe._live_rows(None, mask, 120, cpu), live)
    out_of_range = torch.cat([live, torch.tensor([-1, 120, 2**31 - 1], dtype=torch.int32)])
    assert kfe._live_rows(out_of_range, mask, 120, cpu) is out_of_range
    for bad in (live.long(), live.float(), live[None], live[::2], torch.zeros(121, dtype=torch.int32)):
        with pytest.raises(ValueError):
            kfe._live_rows(bad, mask, 120, cpu)
    with pytest.raises(ValueError):
        kfe._live_rows(live, mask, 120, torch.device("meta"))
    with pytest.raises(ValueError):
        kfe._live_rows(live, mask, 2**31, cpu)


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_backward_is_the_same_with_or_without_the_table(mode, g, monkeypatch):
    args, gout = _bwd_args(3 + g, 3, 40, 30, 6, g, (40, 9, 0))
    slot = None
    if mode == "sorted":
        n = args[2].shape[1]
        slot = ops.backward_sort_tables(Neighborhood(args[3], args[4], args[4].any(-1)), n).bwd_slot
    live = kfe.live_row_table(args[4])
    assert 0 < live.numel() < 120
    whole = kfe.fused_equiv_bwd_reference(*args, gout, slot)
    on_live = _plain_backward_on_rows(args, gout, slot, live)
    # the wrapper runs the plain version over every row on CPU tensors,
    # with or without the table: once, on the very arguments it was given
    calls = []
    real = kfe.fused_equiv_bwd_reference
    monkeypatch.setattr(kfe, "fused_equiv_bwd_reference",
                        lambda *a: (calls.append(a), real(*a))[1])
    wrapped = kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot, live_rows=live)
    # ... and the default activation and geometry (gelu, no kernel points)
    assert len(calls) == 1 and calls[0][-2:] == ("gelu", None)
    assert all(x is y for x, y in zip(calls[0][:-2], (*args, gout, slot), strict=True))
    # two CPU calls of the same einsums need not agree bitwise (their
    # threads split the sums by the machine's load), so SAME_RTOL again
    for x, y, z in zip(whole, on_live, wrapped):
        assert x.shape == y.shape == z.shape
        assert (x - y).abs().max().item() <= SAME_RTOL * x.abs().max().item()
        assert (x - z).abs().max().item() <= SAME_RTOL * x.abs().max().item()
    # no live row: every gradient is zero
    empty = _plain_backward_on_rows(args, gout, slot, live[:0])
    assert all(x.shape == y.shape and not x.any() for x, y in zip(empty, whole))


def _tail_case(seed, g, q_tail):
    """Source cloud of 96 points (masked tail of 7), query cloud of 70 points
    whose last ``q_tail`` are padding, ball query with K=8, G=F=g frames."""
    rng = np.random.default_rng(seed)

    def cloud(n, tail):
        pts = rng.uniform(size=(2, n, 3)).astype(np.float32) * 2.0
        mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
        jpc = JCloud(jnp.asarray(pts), jnp.asarray(mask))
        kn = jknn(jpc, jpc, 8)
        sel = np.argsort(rng.uniform(size=(2, n, 4)), -1)[..., :g]
        return JCloud(jpc.positions, jpc.mask,
                      pca_frames(jpc.positions, kn.idx, kn.mask, select_idx=jnp.asarray(sel)))

    pc_in, pc_out = cloud(96, (0, 7)), cloud(70, q_tail)
    neigh = jball(pc_in, pc_out, 0.5, 8)
    params = (rng.normal(size=(2, 96, g, 24)).astype(np.float32),
              (rng.normal(size=(9, 16)) * 0.3).astype(np.float32),
              (rng.normal(size=(16,)) * 0.1).astype(np.float32),
              (rng.normal(size=(24, 16, 20)) * 0.1).astype(np.float32))
    return pc_in, pc_out, neigh, params


@pytest.mark.parametrize("g,q_tail", [(1, (45, 0)), (2, (60, 20))])
def test_conv_gradients_on_a_masked_query_tail_match_jax_pallas_backward(g, q_tail, monkeypatch):
    """Gradients of ``sum(out * cos(out))`` when most query rows are padding
    (no valid edge), the backward handed the live-row table, against
    ``jax.grad`` through the Pallas backward in interpret mode, at the
    gradient bounds of ``tests/test_torch_conv.py`` (atol 5e-4, rtol 5e-3)."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    pc_in, pc_out, neigh, params = _tail_case(11 + g, g, q_tail)
    nd, nn_ = 3.0, 0.11
    qmask = np.asarray(neigh.query_mask)
    assert not np.asarray(neigh.mask)[~qmask].any()  # padded query rows have no valid edge

    def jloss(p):
        out = jops.fused_equiv_conv(pc_in, pc_out, neigh, *p, jnp.asarray(nd), jnp.asarray(nn_),
                                    lean_vjp=True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(jloss)(tuple(jnp.asarray(x) for x in params))

    mask = t(neigh.mask)
    live = kfe.live_row_table(mask)
    assert live.numel() == int(mask.any(-1).sum()) < qmask.size
    tn = Neighborhood(t(neigh.idx), mask, t(neigh.query_mask), "ball_query", 0.5, live_rows=live)
    seen = []
    real = kfe.fused_equiv_bwd
    monkeypatch.setattr(kfe, "fused_equiv_bwd",
                        lambda *a: (seen.append(a[10] if len(a) > 10 else None), real(*a))[1])
    leaves = [t(x).requires_grad_() for x in params]
    out = ops.fused_equiv_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn, *leaves,
                               torch.tensor(nd), torch.tensor(nn_))
    (out * torch.cos(out)).sum().backward()
    assert seen and seen[0] is live  # the backward ran on the neighborhood's table
    for x, ref, name in zip(leaves, want, ("feats", "proj_axes", "proj_biases", "conv_weights")):
        assert np.abs(np.asarray(ref)).max() > 0, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-3,
                                   err_msg=name)


def _tiny_hierarchy():
    gen = torch.Generator().manual_seed(0)
    cfg = HierarchyConfig(0.08, (0.16, 0.32), (128, 64, 32), 0.1, 128,
                          FrameConfig(n_frames=2, neigh_k=8))
    pts = torch.rand(2, 150, 3, generator=gen)
    mask = torch.arange(150)[None] < torch.tensor([[150], [90]])
    h, *_ = build_hierarchy(pts, mask, None, cfg, generator=gen)
    return h


def test_provider_attaches_the_table_once_per_neighborhood(monkeypatch):
    h = _tiny_hierarchy()
    spec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), max_neighbors=8)
    calls = []
    real = spec_mod.live_row_table
    monkeypatch.setattr(spec_mod, "live_row_table", lambda m: (calls.append(1), real(m))[1])

    provider = NeighborhoodProvider(h, spec)
    first = provider.get(0, 0, 0.16, "ball_query", 8)
    again = provider.get(0, 0, 0.16, "ball_query", 8)
    down = provider.get(0, 1, 0.16, "ball_query", 8)
    assert again is first and len(calls) == 2  # one table per neighborhood, reused
    for nb in (first, down):
        np.testing.assert_array_equal(nb.live_rows.numpy(), kfe.live_row_table(nb.mask).numpy())
        assert 0 < nb.live_rows.numel() <= nb.mask.shape[0] * nb.mask.shape[1]
    assert first.live_rows.numel() < 2 * 128  # the example of 90 points leaves level 0 padded
    out = provider.to_cloud(1, h.levels[0], 0.24, "ball_query", 8)
    assert out.live_rows is not None and len(calls) == 3

    with torch.no_grad():  # the eval forwards walk the live rows too
        nb = NeighborhoodProvider(h, spec).get(0, 0, 0.16, "ball_query", 8)
    assert len(calls) == 4
    np.testing.assert_array_equal(nb.live_rows.numpy(), first.live_rows.numpy())
