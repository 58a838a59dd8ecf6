"""The conv forward on live rows: the query rows with at least one valid
edge, the only rows the forward's kernels work on (a padded row's output is
zero).

CPU tensors run the kernel's plain version over every row, whatever the
table.  Held here: that the plain forward over the table's rows alone gives
the plain forward over all rows, with zeros on the padded rows (why
skipping them is exact); the CPU wrapper's dispatch; the port's conv on a
fully masked query tail against the JAX forward through the Pallas kernel
(interpret mode, as ``tests/test_torch_conv.py`` runs it); that the
neighborhood provider attaches the table in every grad mode and that every
conv forward of a model is handed its neighborhood's table; and the kernel
build key, which follows the header the forward and backward share.  The
CUDA kernel on live rows is held against the plain version on the card in
``tests/test_torch_kernel_cuda.py``.
"""
import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_live_rows import SAME_RTOL, _bwd_args, _tail_case, _tiny_hierarchy
from torch_port_helpers import t, to_torch_cloud

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import build
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.models import FPNSegUNet, NeighborhoodProvider, get_model_spec
from se3conv3d_tpu_torch.ops import pne_conv as ops

torch.set_num_threads(2)


def _plain_forward_on_rows(args, live_rows):
    """The plain forward over the rows of ``live_rows`` only, as one example
    of ``L`` query rows over the ``B*N`` sources of all examples, scattered
    back into zeros of the whole output's shape."""
    rel, rot6, feats, idx, mask, pa, pb, w = args
    b, m, k = idx.shape
    n, f, c = feats.shape[1:]
    rows = live_rows.long()

    def pick(x):
        return x.reshape(b * m, *x.shape[2:])[rows][None]

    idx_live = pick(idx) + (rows // m * n)[None, :, None]
    got = kfe.fused_equiv_fwd_reference(pick(rel), pick(rot6), feats.reshape(1, b * n, f, c),
                                        idx_live, pick(mask), pa, pb, w)
    out = got.new_zeros(b * m, *got.shape[2:])
    return out.index_copy_(0, rows, got[0]).reshape(b, m, *got.shape[2:])


@pytest.mark.parametrize("g", [1, 2])
def test_plain_forward_is_the_same_over_the_live_rows_alone(g):
    args, _ = _bwd_args(13 + g, 3, 40, 30, 6, g, (40, 9, 0))
    live = kfe.live_row_table(args[4])
    assert 0 < live.numel() < 120
    whole = kfe.fused_equiv_fwd_reference(*args)
    on_live = _plain_forward_on_rows(args, live)
    assert whole.shape == on_live.shape == (3, 40, g, 7)
    assert (whole - on_live).abs().max().item() <= SAME_RTOL * whole.abs().max().item()
    padded = ~args[4].any(-1)
    assert padded.sum() > 40 and not whole[padded].any()  # padded rows are exactly zero
    assert whole[~padded].abs().amax(-1).amin() > 0
    assert not _plain_forward_on_rows(args, live[:0]).any()  # no live row: zeros


def test_cpu_forward_wrapper_runs_the_plain_version_whatever_the_table(monkeypatch):
    args, _ = _bwd_args(21, 2, 30, 25, 5, 2, (30, 11))
    calls = []
    real = kfe.fused_equiv_fwd_reference
    monkeypatch.setattr(kfe, "fused_equiv_fwd_reference", lambda *a: (calls.append(a), real(*a))[1])
    before = kfe.fused_equiv_fwd.launches
    live = kfe.live_row_table(args[4])
    for table in (live, None, live[:3], live.long()):  # a CPU call never reads it
        kfe.fused_equiv_fwd(*args, live_rows=table)
    # the very arguments, with the default activation and geometry (gelu, no kernel points)
    assert len(calls) == 4 and all(a[-2:] == ("gelu", None) for a in calls)
    assert all(x is y for a in calls for x, y in zip(a[:-2], args, strict=True))
    assert kfe.fused_equiv_fwd.launches == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("g,q_tail", [(1, (45, 0)), (2, (60, 20))])
def test_conv_on_a_masked_query_tail_matches_jax_pallas_forward(g, q_tail, monkeypatch):
    """The port's conv with most query rows padding (no valid edge), handed
    the live-row table, against the JAX conv through the Pallas forward in
    interpret mode, at the bounds of ``tests/test_torch_conv.py`` (atol
    2e-4, rtol 5e-5); padded rows are zero on both sides."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    pc_in, pc_out, neigh, params = _tail_case(31 + g, g, q_tail)
    nd, nn_ = 3.0, 0.11
    want = np.asarray(jops.fused_equiv_conv(pc_in, pc_out, neigh, *(jnp.asarray(x) for x in params),
                                            jnp.asarray(nd), jnp.asarray(nn_)))
    mask = t(neigh.mask)
    live = kfe.live_row_table(mask)
    tn = Neighborhood(t(neigh.idx), mask, t(neigh.query_mask), "ball_query", 0.5, live_rows=live)
    seen = []
    real = kfe.fused_equiv_fwd
    monkeypatch.setattr(kfe, "fused_equiv_fwd", lambda *a: (seen.append(a[8]), real(*a))[1])
    with torch.no_grad():
        got = ops.fused_equiv_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn,
                                   *(t(x) for x in params), torch.tensor(nd), torch.tensor(nn_))
    assert len(seen) == 1 and seen[0] is live  # the forward ran on the neighborhood's table
    padded = ~mask.any(-1).numpy()
    assert padded.sum() > 0 and np.abs(want).max() > 0.01
    assert not got.numpy()[padded].any() and not want[padded].any()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=5e-5)


@pytest.mark.parametrize("grad", [False, True])
def test_every_conv_forward_of_the_model_gets_its_neighborhoods_table(grad, monkeypatch):
    """A tiny DFaust-recipe model on the CPU, with autograd off (eval and
    calibration) and on (training): the provider attaches a table to each
    neighborhood it builds, and ``FusedEquivConv`` hands it to each of the
    9 conv forwards."""
    h = _tiny_hierarchy()
    spec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), num_blocks=(1, 1),
                               num_features=(8, 16), fpn_dec_feats=8, max_neighbors=8)
    model = FPNSegUNet(spec, num_in_feats=1, num_classes=5,
                       generator=torch.Generator().manual_seed(0)).eval()
    tables = []
    real_build = NeighborhoodProvider._build
    monkeypatch.setattr(NeighborhoodProvider, "_build",
                        lambda self, *a: (lambda nb: (tables.append(nb.live_rows), nb)[1])(real_build(self, *a)))
    seen = []
    real = kfe.fused_equiv_fwd
    monkeypatch.setattr(kfe, "fused_equiv_fwd", lambda *a: (seen.append((a[4], a[8])), real(*a))[1])
    f0 = torch.ones(*h.levels[0].positions.shape[:2], 2, 1)
    with torch.set_grad_enabled(grad):
        logits = model(h, f0, h.levels[0])
    assert torch.isfinite(logits).all() and logits.requires_grad == grad
    assert len(seen) == 9 and len(tables) >= 3
    for mask, live in seen:
        assert any(live is x for x in tables)  # the neighborhood's own table
        np.testing.assert_array_equal(live.numpy(), kfe.live_row_table(mask).numpy())


def test_build_key_follows_the_shared_header(tmp_path, monkeypatch):
    """The forward's and backward's library keys hash the headers they both
    include (the product's, which includes the common one): an edit to the
    common header (on a copy of ``csrc/``) moves both keys and leaves the
    prefix sum's; an edit to one source moves only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.SOURCES["fwd"].parent, csrc)
    monkeypatch.setattr(build, "SOURCES", {name: csrc / path.name for name, path in build.SOURCES.items()})
    header = csrc / "fused_equiv_common.cuh"
    assert [p.name for p in build._source_files(build.SOURCES["fwd"])] == ["fused_equiv_fwd.cu", "wg_product.cuh",
                                                                          header.name]
    assert [p.name for p in build._source_files(build.SOURCES["cumsum"])] == ["segsum_cumsum.cu"]

    def keys():
        return {name: build._lib_path(name) for name in build.SOURCES}

    before = keys()
    assert keys() == before  # the key is a function of the files
    header.write_text(header.read_text() + "\n// edited\n")
    edited = keys()
    assert edited["fwd"] != before["fwd"] and edited["bwd"] != before["bwd"]
    assert edited["cumsum"] == before["cumsum"]
    src = build.SOURCES["bwd"]
    src.write_text(src.read_text() + "\n// edited\n")
    again = keys()
    assert again["bwd"] != edited["bwd"] and again["fwd"] == edited["fwd"]
