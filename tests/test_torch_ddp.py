"""Data parallelism of the port (``se3conv3d_tpu_torch/parallel``): two gloo
ranks on the CPU (``torch.multiprocessing.spawn``, a ``FileStore``), whose
rank side (``tests/torch_ddp_ranks.py``) imports no JAX.

* The tiny DFaust recipe (``dfaust_I_rot_pca_2F`` at 512 points,
  capacities 512 ... 32, 16 neighbours) on a global batch of 4 bodies, two
  of them with their last 25% of points masked and both on rank 0
  (``process_slice``: rank 0 holds bodies 0 and 2), so the ranks hold
  different numbers of valid points: one
  calibration pass and one train step over the two ranks, with the global
  batch's hierarchy draws and DropPath keep masks injected at each rank's
  examples, equal the one-process step on the whole batch: the loss within
  1e-6 relative; every parameter's gradient (the one each rank applies,
  summed over the ranks) within 1e-5 of max(its leaf's max |value|, 1e-2 of
  the global norm: the floor of the gradient gate of
  ``tests/test_torch_train.py``, for leaves whose true gradient is 0); the
  BN running statistics within 1e-5 of each leaf's scale (a mean's: the
  larger of its max |value| and the root of its variance's max) and the
  calibration buffers within 1e-5 of each leaf's max |value|.  The
  parameters after the step are held through their gradients and by the
  ranks' bitwise agreement: one AdamW step divides each element of a
  gradient by its own size, so an element whose true gradient is 0 (its
  rounding noise differs between any two orders of summation) moves by up
  to the learning rate either way.
* Two controls fail that gate: each rank's own mean loss with its gradients
  averaged over the ranks (DDP's rule), and each rank's own BN statistics.
* Three steps on one batch leave the loss lower and the two ranks'
  parameters and statistics bitwise equal (the dry-run contract of
  ``__graft_entry__.py``).
* ``dfaust_I_standard``'s tiny model (no frames, so JAX's BN row count is
  the port's) over two ranks equals JAX's ``Trainer`` on a 2-device virtual
  mesh after one step, within the whole-model 2e-4.
* A ClassNet batch where rank 1 holds only all-masked fillers gives the
  one-process loss (within 1e-6) and gradients (the train step's per-leaf
  1e-4 of ``tests/test_torch_train.py``: ``class_norm`` normalises over
  the batch's 4 pooled rows) of the whole batch.
* Segmentation and classification voters over two ranks report the
  one-process metrics.
* The training CLI with ``--n_devices 2`` on the CPU; rank 0 alone writes
  the checkpoints (the JAX package writes from every process, a race on a
  shared disk: a deliberate deviation), and both ranks resume from them.
* The classification eval CLI with ``--n_devices 2``: both ranks report the
  accuracy of the global accumulator, which rank 0 writes whole (each rank
  votes its own shapes, with its own augmentation draws, so the numbers are
  not the one-process run's; the voters above hold the sums).
"""
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_port_helpers import (HCFG, NUM_CLASSES, TINY, capture_grads, droppath_interceptor, flat_tree,
                                jax_hierarchy_draws, modelnet_recipe, pop_keep_masks, randomize, t,
                                write_dfaust, write_modelnet, dfaust_recipe)

import torch_ddp_ranks as R
from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.parallel import make_mesh, shard_batch
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings, TrainState

from se3conv3d_tpu_torch.parallel import launch, make_group, process_slice
from se3conv3d_tpu_torch.tasks import test_class as tclass
from se3conv3d_tpu_torch.tasks import train as ttrain
from se3conv3d_tpu_torch.train.config import load_yaml_config
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, STATE_RTOL, GRAD_FLOOR = 1e-6, 1e-5, 1e-2
JAX_RTOL = 2e-4  # the whole-model bound against JAX
CLASS_GRAD_RTOL = 1e-4  # a train step's per-leaf bound (tests/test_torch_train.py)
B, N = 4, 512


def two_ranks():
    return make_group(2, devices=["cpu", "cpu"])


def grad_gate(got: dict, ref: dict) -> tuple:
    """Worst ``max|got - ref| / max(max|ref leaf|, GRAD_FLOOR * norm)``."""
    norm = float(torch.sqrt(sum((x.double() ** 2).sum() for x in ref.values())))
    assert set(got) == set(ref)
    return max((float((got[k] - x).abs().max()) / max(float(x.abs().max()), GRAD_FLOOR * norm), k)
               for k, x in ref.items())


def state_gate(got: dict, ref: dict) -> tuple:
    """Worst error of the BN statistics and calibration buffers, each over
    its leaf's scale."""
    worst = (0.0, "")
    for k, x in ref.items():
        name = k.rpartition(".")[2]
        if name == "mean":
            scale = max(float(x.abs().max()), float(ref[k[:-4] + "var"].max()) ** 0.5)
        elif name in ("var", "norm_neigh_dist", "norm_num_neighs", "trunc_frac"):
            scale = max(float(x.abs().max()), 1e-30)
        else:
            continue
        worst = max(worst, (float((got[k] - x).abs().max()) / scale, k))
    return worst


def dfaust_setup(steps: int, lr_from_max: bool = False) -> dict:
    cfg = load_yaml_config(os.path.join(REPO, "configs/dfaust/dfaust_I_rot_pca_2F.yaml"))
    md = dict(cfg["Model"], capacities=[512, 256, 128, 64, 32], out_capacity=512, max_neighbors=16)
    training = dict(cfg["Training"], div_factor=1.0) if lr_from_max else cfg["Training"]
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((B, N, 3)) * 0.3).astype(np.float32)
    pts[..., 1] *= 2.5
    mask = np.ones((B, N), bool)
    mask[[0, 2], int(N * 0.75):] = False  # both on rank 0
    batch = {"positions": pts, "mask": mask, "features": np.ones((B, N, 1), np.float32),
             "labels": rng.integers(0, 20, (B, N))}
    setup = dict(md=md, training=training, capacity=N, classes=20, batch=batch, steps=steps,
                 slices=[list(range(B))])
    return R.record_reference(setup)


def jax_standard_mesh(points: int = 1) -> tuple:
    """The tiny JAX standard model's one train step on a 2-device mesh (with
    ``points`` 2, the ``(data=1, points=2)`` mesh), and the port's setup for
    the same step (weights, draws, keep masks, each data coordinate's
    examples)."""
    cfg = jhier.HierarchyConfig(**HCFG)
    rng = np.random.default_rng(5)
    b, n = 4, 200
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32)
    pts[..., 1] *= 1.5
    mask = np.arange(n)[None] < np.array([n, 140, n, 120])[:, None]
    feats = rng.normal(size=(b, n, 1)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, size=(b, n)).astype(np.int32)
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask), "features": jnp.asarray(feats),
              "labels": jnp.asarray(labels)}
    spec = dataclasses.replace(jget_spec("FPNSegUNetMLPGeluFAUST"), **TINY, max_path_drop=0.5)
    model = JNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)
    plain = JTrainer(model, cfg, capture_grads(), TrainSettings(label_smoothing=0.2), donate_state=False)
    h, f0, out_pc, _, _ = jax.jit(plain._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc, train=False)
    rs = np.random.default_rng(4)
    params, stats = randomize(v["params"], rs), randomize(v["batch_stats"], rs)
    _, mut = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))(
        {"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0, out_pc, train=False,
        calibrate=True, mutable=("calib",))
    calib = jax.device_get(mut["calib"])
    tx = capture_grads()
    state = TrainState(step=np.zeros((), np.int32), params=jax.device_get(params),
                       batch_stats=jax.device_get(stats), calib=calib,
                       opt_state=jax.device_get(tx.init(params)))
    mesh = make_mesh(2, points=points)
    jtrainer = JTrainer(model, cfg, tx, TrainSettings(label_smoothing=0.2), mesh=mesh, donate_state=False)
    order = []
    key = jax.random.PRNGKey(7)
    with fnn.intercept_methods(droppath_interceptor(order, reference_bn=False)):
        new_state, metrics = jtrainer.train_step(state, shard_batch(mesh, jbatch), key)
    keep_masks, new_stats = pop_keep_masks(new_state.batch_stats, order)
    rng_h, _ = jax.random.split(jax.random.fold_in(key, 0))
    setup = dict(preset="FPNSegUNetMLPGeluFAUST", spec=dict(TINY, max_path_drop=0.5), classes=NUM_CLASSES,
                 hcfg=HCFG, state=from_flax(jax.device_get(params), jax.device_get(stats), calib),
                 batch={"positions": pts, "mask": mask, "features": feats, "labels": labels.astype(np.int64)},
                 draws=jax_hierarchy_draws(rng_h, cfg, b, n), masks=[t(m) for m in keep_masks],
                 slices=[process_slice(list(range(b)), r, 2 // points) for r in range(2 // points)])
    ref = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "grads": {k: torch.from_numpy(v) for k, v in flat_tree(new_state.opt_state).items()},
           "stats": {k: torch.from_numpy(v) for k, v in flat_tree(new_stats).items()}}
    return setup, ref


def classnet_setup() -> dict:
    rec = modelnet_recipe()
    rng = np.random.default_rng(6)
    b, n = 4, 64
    mask = np.ones((b, n), bool)
    mask[[1, 3]] = False  # rank 1's two clouds are fillers
    batch = {"positions": rng.standard_normal((b, n, 3)).astype(np.float32), "mask": mask,
             "features": np.ones((b, n, 1), np.float32), "labels": rng.integers(0, 40, b)}
    setup = R.record_reference(dict(md=rec["Model"], training=rec["Training"], capacity=n, classes=40,
                                    batch=batch, steps=1, slices=[list(range(b))]))
    setup["draws"], setup["masks"] = setup["draws"][0], setup["masks"][0]
    return setup


@pytest.fixture(scope="module")
def runs():
    """Every rank-side case in one 2-rank group, and its one-process
    references."""
    one = dfaust_setup(steps=1)
    three = dfaust_setup(steps=1, lr_from_max=True)
    three["draws"], three["masks"], three["steps"] = three["draws"] * 3, three["masks"] * 3, 3
    std_setup, std_ref = jax_standard_mesh()
    cls = classnet_setup()
    vote = {"classes": 5, "sizes": [30, 45, 20, 60, 25]}
    refs = {"one": R.recipe_steps(0, one), "classnet": R.class_loss(0, cls), "voters": R.voters(0, vote),
            "standard": std_ref}
    for setup in (one, three):
        setup["slices"] = [process_slice(list(range(B)), r, 2) for r in range(2)]
    cls["slices"] = [[0, 2], [1, 3]]
    cases = {"variants": ("suite_variants", one), "three": ("recipe_steps", three),
             "standard": ("spec_steps", std_setup), "classnet": ("class_loss", cls), "voters": ("voters", vote)}
    return refs, launch(two_ranks(), R.suite, cases)


def test_two_rank_step_equals_the_one_process_step(runs):
    refs, ranks = runs
    ref, got = refs["one"], ranks[0]["variants"]["sound"]
    assert abs(got["losses"][0] - ref["losses"][0]) <= LOSS_RTOL * abs(ref["losses"][0])
    assert abs(got["grad_norms"][0] - ref["grad_norms"][0]) <= STATE_RTOL * ref["grad_norms"][0]
    assert grad_gate(got["grads"], ref["grads"])[0] <= STATE_RTOL
    assert state_gate(got["calibrated"], ref["calibrated"])[0] <= STATE_RTOL
    assert state_gate(got["states"][0], ref["states"][0])[0] <= STATE_RTOL
    # both ranks hold the same state, bit for bit
    for name, x in got["states"][0].items():
        assert torch.equal(x, ranks[1]["variants"]["sound"]["states"][0][name]), name


@pytest.mark.parametrize("control", ["per_rank_mean", "per_rank_bn"])
def test_controls_fail_the_gate(runs, control):
    refs, ranks = runs
    ref, got = refs["one"], ranks[0]["variants"][control]
    loss_err = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    assert loss_err > 10 * LOSS_RTOL
    assert grad_gate(got["grads"], ref["grads"])[0] > 10 * STATE_RTOL
    if control == "per_rank_bn":
        assert state_gate(got["states"][0], ref["states"][0])[0] > 10 * STATE_RTOL


def test_three_steps_lower_the_loss_and_keep_the_ranks_bitwise_equal(runs):
    _, ranks = runs
    a, b = ranks[0]["three"], ranks[1]["three"]
    assert a["losses"] == b["losses"] and a["losses"][-1] < a["losses"][0]
    for step in range(3):
        for name, x in a["states"][step].items():
            assert torch.equal(x, b["states"][step][name]), (step, name)


def test_standard_model_matches_the_jax_two_device_mesh(runs):
    refs, ranks = runs
    ref = refs["standard"]
    for got in (ranks[0]["standard"], ranks[1]["standard"]):
        assert abs(got["loss"] - ref["loss"]) <= JAX_RTOL * abs(ref["loss"])
        assert abs(got["grad_norm"] - ref["grad_norm"]) <= JAX_RTOL * ref["grad_norm"]
        assert ref["grad_norm"] < 100.0  # unclipped: the gradients are the raw ones
        assert grad_gate(got["grads"], ref["grads"])[0] <= JAX_RTOL
        for name, x in ref["stats"].items():
            np.testing.assert_allclose(got["state"][name].numpy(), x.numpy(), rtol=JAX_RTOL, atol=1e-6,
                                       err_msg=name)


def test_classnet_rank_of_fillers_gives_the_one_process_loss(runs):
    refs, ranks = runs
    ref = refs["classnet"]
    for got in (ranks[0]["classnet"], ranks[1]["classnet"]):
        assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        # class_norm takes its statistics over the 4 pooled rows
        assert grad_gate(got["grads"], ref["grads"])[0] <= CLASS_GRAD_RTOL


def test_voters_over_two_ranks_report_the_one_process_metrics(runs):
    refs, ranks = runs
    ref = refs["voters"]
    assert ref["index"] == (0, 1) and ref["scenes"] == [0, 1, 2, 3, 4]
    assert [ranks[r]["voters"]["index"] for r in range(2)] == [(0, 2), (1, 2)]
    assert ranks[0]["voters"]["scenes"] == [0, 2, 4] and ranks[1]["voters"]["scenes"] == [1, 3]
    for got in (ranks[0]["voters"], ranks[1]["voters"]):
        assert got["acc"] == ref["acc"] and got["class_acc"] == ref["class_acc"]
        np.testing.assert_array_equal(got["accum"], ref["accum"])
        for k, v in ref["seg"].items():
            np.testing.assert_array_equal(np.asarray(got["seg"][k]), np.asarray(v), err_msg=k)


def _dfaust_cli(tmp_path):
    root = write_dfaust(tmp_path / "data", n_train=4, n_test=3)
    recipe = dfaust_recipe()
    recipe["Training"].update(num_epochs=2, batch_size=4)
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(recipe))
    return ["--conf_file", str(conf), "--data_folder", root, "--log_folder", str(tmp_path / "log")]


def test_train_cli_over_two_ranks_writes_from_rank_zero_and_resumes(tmp_path):
    argv = _dfaust_cli(tmp_path) + ["--n_devices", "2"]
    # the CLI's rank body with the checkpoint writes recorded: epoch 0 is the
    # run's last, so it validates and saves (the first best)
    first = launch(two_ranks(), R.train_recording_saves, argv + ["--max_epochs", "1"], {})
    assert first[0]["saves"] == [0] and first[1]["saves"] == []  # rank 0 alone writes
    assert first[0]["restores"] == first[1]["restores"] == []
    assert first[0]["trainer_step"] == first[1]["trainer_step"] == 1  # 4 bodies, one global batch
    (h0,), (h1,) = first[0]["history"], first[1]["history"]
    assert h0["losses"] == h1["losses"] and h0["val"]["miou"] == h1["val"]["miou"]
    for name, x in first[0]["state"].items():
        assert torch.equal(x, first[1]["state"][name]), name
    assert (tmp_path / "log" / "config.yaml").exists()
    # the CLI itself resumes both ranks from rank 0's checkpoint
    resumed = ttrain.main(argv + ["--resume"], device="cpu")
    assert [r["rank"] for r in resumed] == [0, 1]
    assert resumed[0]["trainer_step"] == resumed[1]["trainer_step"] == 2
    (h0,), (h1,) = resumed[0]["history"], resumed[1]["history"]
    assert h0["epoch"] == 1 and h0["losses"] == h1["losses"] and h0["val"]["miou"] == h1["val"]["miou"]
    assert resumed[0]["checkpoints"][0] == 0
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        ttrain.main(argv, devices=["cpu"])


def test_class_eval_cli_over_two_ranks_matches_one_process(tmp_path):
    root = write_modelnet(tmp_path / "data", n_pts=64)
    recipe = modelnet_recipe()
    recipe["Training"]["num_epochs"] = 1
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(recipe))
    log = str(tmp_path / "log")
    ttrain.main(["--conf_file", str(conf), "--data_folder", root, "--log_folder", log], device="cpu")
    argv = ["--conf_file", "configs/modelnet40/modelnet40_test_rot.yaml", "--data_folder", root,
            "--log_folder", log, "--vote_epochs", "2"]
    ranks = tclass.main(argv + ["--save_output", str(tmp_path / "two"), "--n_devices", "2"], device="cpu")
    assert ranks[0]["summary"] == ranks[1]["summary"]
    # the saved accumulator is the global one: a row for every test shape
    saved = np.loadtxt(tmp_path / "two" / "accum_logits.txt")
    assert saved.shape == (3, 40) and np.all(np.abs(saved).sum(1) > 0)
    labels = [0, 1, 2]  # write_modelnet: one test shape per class, in class order
    assert ranks[0]["summary"]["accuracy"] == float(np.mean(saved.argmax(1) == labels))
