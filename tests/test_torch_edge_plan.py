"""The conv backward's per-edge pass (``edge_kernel`` in
``kernels/csrc/fused_equiv_bwd.cu``): its launch plan and tiles, mirrored in
Python (``kernels.fused_equiv.edge_plan`` / ``edge_writes``), on the CPU.

The card tests (``tests/test_torch_edge_cuda.py``) hold the mirror equal to
the C plan; here it is held to its limits: every instantiation fits one
block's shared memory at its largest shapes, the recipes' shapes keep 4
blocks an SM, the padded row strides give fragment loads free of bank
conflicts, and the tiles write every (edge, column) exactly once.
"""
import itertools

import pytest

from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.kernels import product as kp

# (G, Q, K, kd, P): every instantiation at its limits (K*F = 768 at 64 pne
# columns, 432 at 128; P = 64; C does not enter: channels come in chunks)
LIMITS = [(2, 32, 768, 9, 0), (1, 64, 768, 9, 0), (4, 32, 432, 9, 0), (1, 128, 432, 9, 0), (3, 40, 432, 9, 0),
          (1, 64, 768, 3, 0), (1, 64, 768, 0, 64), (1, 64, 768, 0, 1), (1, 1, 1, 9, 0)]
# the recipes' shapes at kd = 9, 64 pne columns, K*F <= 64: ScanNet (G = F
# = 1, K = 24), DFaust 2F (G = F = 2, K = 16 and 32), MC 2F, mixF at F <= 2
RECIPES = [(1, 32, 24), (2, 32, 16), (2, 32, 32), (1, 32, 64), (2, 16, 32)]


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("shape", LIMITS)
def test_edge_plan_fits_one_block_at_its_limits(shape, elem):
    g, q, k, kd, p = shape
    plan = kfe.edge_plan(elem, g, q, k, kd, p)
    assert plan["fits"] and plan["smem_bytes"] <= kfe.SMEM_MAX == 232448
    assert plan["smem_bytes"] % 16 == 0 and plan["blocks_per_sm"] >= 1
    assert (plan["warps"], plan["stages"], plan["edges_per_round"], plan["channels_per_chunk"]) == (4, 2, 32, 32)
    assert plan["geo_rows"] % 16 == 0 and plan["geo_rows"] > (p if kd == 0 else kd)


@pytest.mark.parametrize("elem", [4, 2])
def test_edge_plan_keeps_four_blocks_an_sm_at_the_recipes_shapes(elem):
    for g, q, k in RECIPES:
        plan = kfe.edge_plan(elem, g, q, k, 9)
        assert plan["blocks_per_sm"] >= 4, (g, q, k, plan)
        assert 4 * (plan["smem_bytes"] + kfe.BLOCK_RESERVED) <= kfe.SM_SMEM


def test_edge_plan_refuses_what_no_instantiation_takes():
    for args in ((4, 4, 64, 32, 9), (4, 1, 65, 32, 3), (4, 1, 32, 32, 0, 0),
                 (4, 1, 32, 32, 0, 65), (4, 5, 16, 32, 9)):
        with pytest.raises(ValueError):
            kfe.edge_plan(*args)


def _conflict_free(addresses, width=1):
    """Word addresses of one warp's shared-memory load of ``width`` words a
    lane: free of bank conflicts (a 64-bit load is served a half-warp at a
    time)."""
    group = 32 // width
    for h in range(0, 32, group):
        banks = [(a + i) % 32 for a in addresses[h:h + group] for i in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("gq", [8, 32, 64, 96, 128])
def test_edge_row_strides_give_conflict_free_fragment_loads(gq):
    """The fragment loads of the three products, as the kernel addresses
    them, at the plan's strides (float32 in words; bfloat16 pairs in words,
    ldmatrix rows in 16-byte units)."""
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    s = kfe.EDGE_ROW_STRIDE
    gqs = kfe.edge_plan(4, 1, gq, 8, 9)["gq_stride"]
    assert gqs % 32 == 4
    # float32: dpne A (float2 pairs of channels 2t, 2t + 1) and B (rows 2t, 2t + 1)
    assert _conflict_free([r * s + 2 * t for r, t in lanes], 2)
    assert _conflict_free([2 * t * gqs + r for r, t in lanes])
    assert _conflict_free([(2 * t + 1) * gqs + r for r, t in lanes])
    # d_gathered A (pne rows) and B (dbasis rows, k = gq)
    assert _conflict_free([r * gqs + t for r, t in lanes])
    assert _conflict_free([r * gqs + t + 4 for r, t in lanes])
    # d_proj A (geometry pairs of edges 2t, 2t + 1) and B (dpre rows 2t, 2t + 1)
    assert _conflict_free([r * s + 2 * t for r, t in lanes], 2)
    assert _conflict_free([2 * t * gqs + r for r, t in lanes])
    gqs = kfe.edge_plan(2, 1, gq, 8, 9)["gq_stride"]
    assert gqs % 16 == 8
    # bfloat16: A and B pairs as 32-bit words; ldmatrix.trans rows as 16-byte units
    assert _conflict_free([(r * s + 2 * t) // 2 for r, t in lanes])
    assert _conflict_free([(r * gqs + 2 * t) // 2 for r, t in lanes])
    units = [i * gqs // 8 % 8 for i in range(8)]
    assert len(set(units)) == 8


EDGES, COLUMNS, CHANNELS = (1, 17, 24, 64, 128, 768), (8, 32, 64, 128), (5, 32, 64, 512)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("gq", COLUMNS)
def test_edge_tiles_write_every_place_once(gq, c):
    """For every edge count, the dpne tiles write each (edge, column) once,
    the d_gathered tiles each (edge, channel) once (scatter rows of 4
    channels; bfloat16 sorted rows of 8), and the d_proj partial each (d,
    q) once."""
    gqc = 64 if gq <= 64 else 128
    for e in EDGES:
        for sorted_bf16 in (False, True):
            w = kfe.edge_writes(e, gq, c, gqc, sorted_bf16=sorted_bf16)
            assert set(w["dpne"]) == set(itertools.product(range(e), range(gq)))
            assert set(w["d_feats"]) == set(itertools.product(range(e), range(c)))
            assert set(w["dpne"].values()) == set(w["d_feats"].values()) == {1}
    for q, d in ((gq, 9), (gq, 3), (min(gq, 64), 55)):
        w = kfe.edge_writes(1, gq, 8, gqc, q=q, d=d)
        assert set(w["d_proj"]) == set(itertools.product(range(d + 1), range(q)))
        assert set(w["d_proj"].values()) == {1}


def test_bwd_plan_takes_a_partial_a_block_of_the_walk():
    assert kp.EDGE_GRID == kfe.EDGE_GRID == 132 * 4
    for n_live, want in ((1, 1), (300, 300), (528, 528), (131072, 528)):
        assert kp.bwd_plan(n_live, 1, 32, 64, 64, 4)[2] == want
