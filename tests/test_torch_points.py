"""The ``(data, points)`` mesh of the port (``se3conv3d_tpu_torch/parallel``):
gloo ranks on the CPU whose rank side (``tests/torch_points_ranks.py``)
imports no JAX; one 2-rank group ``(data=1, points=2)`` and one 4-rank group
``(data=2, points=2)``, each in a module fixture.

* ``points_gather`` over a points row equals the whole tensor, and its
  gradient the sum over the row of each rank's cotangent at the rank's rows,
  for an even split, an uneven one (M = 7: rows 4 and 3) and one whose last
  slice is empty (M = 1); ``make_group(4, points=2)`` gives the JAX mesh's
  coordinates (rank ``r`` at ``divmod(r, 2)``) and one subgroup per points
  row; ``points=3`` of 4 raises JAX's error.
* A global max or min pool over a points row equals one process's, and its
  gradient splits evenly over the row's tied elements, ties across the
  ranks of a row included (features on a coarse grid of values).
* The tiny DFaust recipe (``dfaust_I_rot_pca_2F`` at 512 points, capacities
  512 ... 32, 16 neighbours) at ``(1, 2)`` on 2 bodies and at ``(2, 2)`` on
  4, the first body of each data row with its last 25% of points masked
  (so the points ranks hold different numbers of valid points), one
  calibration pass and one train step with the global batch's draws
  injected, equal the one-process step: the loss within 1e-6 relative, the
  gradients within 1e-5 of max(leaf, 1e-2 of the global norm), the BN
  statistics and calibration buffers within 1e-5 of their scale
  (``tests/test_torch_ddp.py``'s bounds), every rank's state bitwise
  equal.  Two controls fail that gate: each rank's convs reading only the
  source rows it owns, and each rank's own BN statistics.  A points row
  whose ranks drew different draws raises in ``Trainer.build``.
* ``dfaust_I_standard``'s tiny model on a ``(1, 2)`` group equals JAX's
  ``Trainer`` on ``make_mesh(2, points=2)`` (``shard_batch``) after one
  step, within the whole-model 2e-4.
* An eval step on ``(1, 2)``, put back together by ``host_local``, equals
  the one-process logits.
* ClassNet (the ModelNet40 tiny recipe) with average and with max pooling
  over the points: calibration, loss, gradients and logits on ``(1, 2)``
  equal one process (the train step's per-leaf 1e-4: ``class_norm``
  normalises over the batch's pooled rows), every rank of the row holding
  the same logits; its global equivariant feature vector, whose one-row
  extra level leaves the second slice empty, equals one process.
* ``LoRAttConv`` on a ``(1, 2)`` group's row slices of one cloud (the
  neighbours' query and value projections gathered over the row): output,
  input gradient and parameter gradients equal one process's.
* No tensor that a ``(1, 2)`` train step saves for its backward holds a
  whole level along any axis: the capacities are chosen so that no local
  slice, width or count equals a whole level's rows (the hierarchy's own
  positions and frames, which every rank holds whole, and the parameters
  are left out).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_ddp import (JAX_RTOL, LOSS_RTOL, STATE_RTOL, grad_gate, jax_standard_mesh,
                            state_gate)
from torch_port_helpers import modelnet_recipe

import torch_ddp_ranks as R
import torch_points_ranks as PR
from se3conv3d_tpu_torch.core.hierarchy import draw_hierarchy
from se3conv3d_tpu_torch.parallel import launch, local_rows, make_group, process_slice
from se3conv3d_tpu_torch.train.config import load_yaml_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 512
CLASS_GRAD_RTOL = 1e-4
# the memory case's capacities, odd: no rank's rows of one level (half, or
# half and one), nor those times the F = 2 frames, equal another level's
# rows or a width of the model
SAVED_CAPS, SAVED_OUT = [499, 221, 91, 41, 19], 481
# the conv paths: the kernels' (their plain versions on the CPU) and the plain one
PATHS = ("kernel", "plain")


def group(n: int):
    return make_group(n, devices=["cpu"] * n, points=2)


def dfaust_setup(b: int, data: int, caps=(512, 256, 128, 64, 32), out_cap=512, plain=False) -> dict:
    cfg = load_yaml_config(os.path.join(REPO, "configs/dfaust/dfaust_I_rot_pca_2F.yaml"))
    md = dict(cfg["Model"], capacities=list(caps), out_capacity=out_cap, max_neighbors=16)
    rng = np.random.default_rng(1)
    pts = (rng.standard_normal((b, N, 3)) * 0.3).astype(np.float32)
    pts[..., 1] *= 2.5
    mask = np.ones((b, N), bool)
    mask[:data, int(N * 0.75):] = False  # the first body of each data row
    batch = {"positions": pts, "mask": mask, "features": np.ones((b, N, 1), np.float32),
             "labels": rng.integers(0, 20, (b, N))}
    setup = dict(md=md, training=cfg["Training"], capacity=N, classes=20, batch=batch, steps=1,
                 slices=[list(range(b))], spec={"plain": True} if plain else {})
    setup = R.record_reference(setup, PR.setup_trainer(setup))
    setup["eval_draws"] = draw_hierarchy(R.recipe_trainer(md, cfg["Training"], N, 20).eval_hcfg, b, N,
                                         torch.Generator().manual_seed(12))
    return setup


def classnet_setup(pooling: str = "avg", global_vector: bool = False) -> dict:
    rec = modelnet_recipe()
    md = dict(rec["Model"])
    if global_vector:  # one extra level of one row past the trunk
        md.update(grid_subsamples=md["grid_subsamples"] + [5.0], capacities=md["capacities"] + [1])
    rng = np.random.default_rng(6)
    b, n = 4, 64
    mask = np.ones((b, n), bool)
    mask[1, n // 2:] = False  # one cloud's second half: its points rank holds none of it
    batch = {"positions": rng.standard_normal((b, n, 3)).astype(np.float32), "mask": mask,
             "features": np.ones((b, n, 1), np.float32), "labels": rng.integers(0, 40, b)}
    spec = dict(pooling_method=pooling, global_equiv_featurevector=global_vector)
    return PR.record(dict(md=md, training=rec["Training"], capacity=n, classes=40, batch=batch,
                          slices=[list(range(b))], spec=spec))


def attention_setup() -> dict:
    gen = torch.Generator().manual_seed(9)
    mask = torch.ones(1, 61, dtype=torch.bool)
    mask[0, 50:] = False
    return {"positions": torch.rand(1, 61, 3, generator=gen), "mask": mask,
            "features": torch.randn(1, 61, 8, generator=gen), "cotangent": torch.randn(1, 61, 8, generator=gen)}


def pool_cases() -> dict:
    """Features on a coarse grid of values, so that a cloud's extreme is
    tied across the ranks of a row and within one rank's rows; one cloud
    partly masked, one all masked."""
    gen = torch.Generator().manual_seed(4)
    cases = {}
    for name, shape in (("rows", (3, 9, 5)), ("frames", (3, 9, 2, 5))):
        whole = torch.randint(0, 3, shape, generator=gen).float()
        mask = torch.ones(3, 9, dtype=torch.bool)
        mask[1, 6:] = False
        mask[2] = False
        cases[name] = (whole, mask, torch.randn(3, shape[-1], generator=gen))
    return cases


def gather_cases() -> dict:
    gen = torch.Generator().manual_seed(3)
    return {f"M={m}": (torch.randn(2, m, 3, generator=gen), 40 + m) for m in (8, 7, 1)}


@pytest.fixture(scope="module")
def two():
    """Every case of the ``(1, 2)`` group, and its one-process references."""
    d12 = dfaust_setup(2, 1)
    saved = {path: dfaust_setup(1, 1, SAVED_CAPS, SAVED_OUT, plain=path == "plain") for path in PATHS}
    plain = dfaust_setup(2, 1, plain=True)
    std_setup, std_ref = jax_standard_mesh(points=2)
    classes = {k: classnet_setup(k) for k in ("avg", "max")}
    vector = classnet_setup(global_vector=True)
    att = attention_setup()
    refs = {"attention": PR.attention(0, att), "dfaust": PR.recipe_steps(0, d12), "plain": PR.recipe_steps(0, plain), "eval": PR.eval_logits(0, d12), "standard": std_ref,
            "vector": PR.global_vector(0, vector), **{k: PR.class_steps(0, v) for k, v in classes.items()}}
    cases = {"coords": ("coordinates", None), "gathers": ("gathers", gather_cases()), "pools": ("pools", pool_cases()),
             "dfaust": ("variants", d12), "eval": ("eval_logits", d12), "diverged": ("diverged_draws", d12), "standard": ("jax_standard_spec", std_setup),
             "avg": ("class_steps", classes["avg"]), "max": ("class_steps", classes["max"]),
             "vector": ("global_vector", vector), "plain": ("recipe_steps", plain), "attention": ("attention", att),
             **{f"saved_{path}": ("saved_rows", saved[path]) for path in PATHS}}
    return refs, launch(group(2), PR.suite, cases)


@pytest.fixture(scope="module")
def four():
    """Every case of the ``(2, 2)`` group, and its one-process references."""
    d22 = dfaust_setup(4, 2)
    ref = PR.recipe_steps(0, d22)
    d22["slices"] = [process_slice(list(range(4)), r, 2) for r in range(2)]
    cases = {"coords": ("coordinates", None), "gathers": ("gathers", gather_cases()), "pools": ("pools", pool_cases()),
             "dfaust": ("variants", d22)}
    return ref, launch(group(4), PR.suite, cases)


def check_gathers(ranks: list, points: int) -> None:
    for name, (whole, _) in gather_cases().items():
        row0 = [r["gathers"][name] for r in ranks[:points]]
        for got in row0:
            assert torch.equal(got["whole"], whole), name
            assert got["sized"] == whole.shape[1]  # the lengths gathered when not given
        # the whole tensor's gradient: the sum of the row's cotangents
        grad = sum(got["cot"] for got in row0)
        for got in row0:
            start, stop = got["rows"]
            torch.testing.assert_close(got["grad"], grad[:, start:stop], rtol=0, atol=1e-6)
    m7 = [r["gathers"]["M=7"]["rows"] for r in ranks[:points]]
    m1 = [r["gathers"]["M=1"]["rows"] for r in ranks[:points]]
    assert m7 == [(0, 4), (4, 7)] and m1 == [(0, 1), (1, 1)]


@pytest.mark.parametrize("size", [2, 4])
def test_points_gather_equals_the_whole_tensor_and_its_gradient(two, four, size):
    ranks = two[1] if size == 2 else four[1]
    check_gathers(ranks, 2)
    if size == 4:
        check_gathers(ranks[2:], 2)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("method", ["max", "min"])
def test_global_pool_extreme_splits_its_gradient_over_tied_ranks(two, four, size, method):
    """Each tied element of a row takes an even share of the gradient, as
    one process's ``amax`` / ``amin`` over the whole cloud gives it, ties
    across the ranks of a row included."""
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud, global_pool

    ranks = two[1] if size == 2 else four[1]
    for name, (whole, mask, cot) in pool_cases().items():
        x = whole.clone().requires_grad_(True)
        ref = global_pool(PointCloud(torch.zeros(mask.shape + (3,)), mask), x, method)
        (ref * 2 * cot).sum().backward()  # both ranks of a row take sum(pooled * cot)
        local = x.detach().reshape(3, 9, -1, whole.shape[-1])
        extreme = torch.amax if method == "max" else torch.amin
        low, high = extreme(local[:, :5], (1, 2)), extreme(local[:, 5:], (1, 2))
        assert bool((low[0] == high[0]).any()), "no tie across the two ranks"
        for got in (r["pools"][name, method] for r in ranks):
            assert torch.equal(got["pooled"], ref.detach()), name
            start = got["start"]
            stop = start + got["grad"].shape[1]
            torch.testing.assert_close(got["grad"], x.grad[:, start:stop], rtol=0, atol=1e-6)


def test_make_group_builds_the_data_points_grid(four):
    _, ranks = four
    for r, got in enumerate(r["coords"] for r in ranks):
        d, p = divmod(r, 2)
        assert got["rank"] == r and got["data"] == (d, 2) and got["points"] == (p, 2)
        assert got["row_sum"] == float(2 * d + 2 * d + 1)  # the ranks of its row only
        assert got["lengths"] == [10 + 2 * d, 11 + 2 * d]
        assert got["agree_same"] and not got["agree_rank"]
    g = make_group(4, devices=["cpu"] * 4, points=2)
    assert (g.size, g.data, g.points, g.backend) == (4, 2, 2, "gloo")
    with pytest.raises(ValueError, match="4 devices not divisible by points=3"):
        make_group(4, devices=["cpu"] * 4, points=3)


def gate(got: dict, ref: dict) -> tuple:
    loss = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return (loss, grad_gate(got["grads"], ref["grads"])[0], state_gate(got["calibrated"], ref["calibrated"])[0],
            state_gate(got["states"][0], ref["states"][0])[0])


@pytest.mark.parametrize("size", [2, 4])
def test_points_group_step_equals_the_one_process_step(two, four, size):
    ref, ranks = (two[0]["dfaust"], two[1]) if size == 2 else four
    loss, grad, calib, stats = gate(ranks[0]["dfaust"]["sound"], ref)
    assert loss <= LOSS_RTOL and grad <= STATE_RTOL and calib <= STATE_RTOL and stats <= STATE_RTOL
    assert abs(ranks[0]["dfaust"]["sound"]["grad_norms"][0] - ref["grad_norms"][0]) <= STATE_RTOL * ref["grad_norms"][0]
    for other in ranks[1:]:  # every rank holds the same state, bit for bit
        for name, x in ranks[0]["dfaust"]["sound"]["states"][0].items():
            assert torch.equal(x, other["dfaust"]["sound"]["states"][0][name]), name


def test_plain_path_step_equals_the_one_process_step(two):
    refs, ranks = two
    loss, grad, calib, stats = gate(ranks[0]["plain"], refs["plain"])
    assert loss <= LOSS_RTOL and grad <= STATE_RTOL and calib <= STATE_RTOL and stats <= STATE_RTOL
    for name, x in ranks[0]["plain"]["states"][0].items():
        assert torch.equal(x, ranks[1]["plain"]["states"][0][name]), name


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("control", ["own_rows_only", "per_rank_bn"])
def test_points_controls_fail_the_gate(two, four, size, control):
    ref, ranks = (two[0]["dfaust"], two[1]) if size == 2 else four
    loss, grad, _, stats = gate(ranks[0]["dfaust"][control], ref)
    assert loss > 10 * LOSS_RTOL and grad > 10 * STATE_RTOL and stats > 10 * STATE_RTOL


def test_build_raises_where_a_points_row_drew_different_draws(two):
    _, ranks = two
    for got in (r["diverged"] for r in ranks):
        assert "different hierarchy draws" in got["error"] and got["rows"] == 256


def test_standard_model_matches_the_jax_data_points_mesh(two):
    refs, ranks = two
    ref = refs["standard"]
    assert ref["grad_norm"] < 100.0  # unclipped: the gradients are the raw ones
    for got in (ranks[0]["standard"], ranks[1]["standard"]):
        assert abs(got["loss"] - ref["loss"]) <= JAX_RTOL * abs(ref["loss"])
        assert abs(got["grad_norm"] - ref["grad_norm"]) <= JAX_RTOL * ref["grad_norm"]
        assert grad_gate(got["grads"], ref["grads"])[0] <= JAX_RTOL
        for name, x in ref["stats"].items():
            np.testing.assert_allclose(got["state"][name].numpy(), x.numpy(), rtol=JAX_RTOL, atol=1e-6,
                                       err_msg=name)


def test_eval_step_put_back_together_equals_one_process(two):
    refs, ranks = two
    ref = refs["eval"]
    assert [r["eval"]["rows"] for r in ranks] == [N // 2, N // 2]
    scale = float(ref["logits"].abs().max())
    for got in (ranks[0]["eval"], ranks[1]["eval"]):
        assert torch.equal(got["mask"], ref["mask"]) and torch.equal(got["labels"], ref["labels"])
        assert torch.equal(got["out_idx"], ref["out_idx"])
        assert float((got["logits"] - ref["logits"]).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("pooling", ["avg", "max"])
def test_classnet_pooling_over_the_points_row_equals_one_process(two, pooling):
    refs, ranks = two
    ref = refs[pooling]
    for got in (ranks[0][pooling], ranks[1][pooling]):
        assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        assert grad_gate(got["grads"], ref["grads"])[0] <= CLASS_GRAD_RTOL
        assert state_gate(got["state"], ref["state"])[0] <= STATE_RTOL
        torch.testing.assert_close(got["logits"], ref["logits"], rtol=0, atol=2e-5 * float(ref["logits"].abs().max()))
    assert torch.equal(ranks[0][pooling]["logits"], ranks[1][pooling]["logits"])


def test_global_vector_on_its_one_row_level_equals_one_process(two):
    refs, ranks = two
    ref = refs["vector"]
    assert [r["vector"]["rows"] for r in ranks] == [1, 0]  # the second slice is empty
    assert state_gate(ranks[0]["vector"]["state"], ref["state"])[0] <= STATE_RTOL
    for got in (ranks[0]["vector"], ranks[1]["vector"]):
        torch.testing.assert_close(got["vector"], ref["vector"], rtol=0,
                                   atol=2e-5 * float(ref["vector"].abs().max()))


def test_attention_conv_on_a_points_row_equals_one_process(two):
    refs, ranks = two
    ref = refs["attention"]
    for got in (ranks[0]["attention"], ranks[1]["attention"]):
        for key in ("out", "d_feats"):
            torch.testing.assert_close(got[key], ref[key], rtol=0, atol=1e-5 * float(ref[key].abs().max()))
        for name, g in ref["grads"].items():
            torch.testing.assert_close(got["grads"][name], g, rtol=0, atol=1e-5 * float(g.abs().max()))


@pytest.mark.parametrize("path", PATHS)
def test_no_saved_tensor_holds_a_whole_level(two, path):
    _, ranks = two
    for r, got in enumerate(r[f"saved_{path}"] for r in ranks):
        whole = set(got["whole_rows"])
        assert got["level_rows"] == [b - a for a, b in (local_rows(m, r, 2) for m in got["whole_rows"])]
        assert set(SAVED_CAPS + [SAVED_OUT]) <= whole
        forbidden = whole | {2 * m for m in whole}  # a level, or a level times its frames
        bad = [s for s in got["shapes"] if forbidden & set(s)]
        assert not bad, bad
        # the saved activations are the rank's rows of the levels
        assert len(got["shapes"]) > 100 and any(got["level_rows"][0] in s for s in got["shapes"])
