"""The port's run loop (``se3conv3d_tpu_torch/train/run.py``) against the JAX
package's, without running a JAX step: both ``Experiment``s built on one
tiny recipe and fixture draw the same batches (bitwise, epoch after epoch,
through ``init_state``, ``calibrate`` and ``train_epoch``) and the same
``mix_n_frames`` sequence; the learning rates of both, which differ by
design (the one-cycle factors); metrics, the neighbor-cap certificate and
checkpoints; and the port's refusal to train on the CPU unasked."""
import copy
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from se3conv3d_tpu.nn.conv import check_neighbor_caps as jcheck_caps
from se3conv3d_tpu.train import metrics as jmetrics
from se3conv3d_tpu.train.run import Experiment as JExperiment
from se3conv3d_tpu.train.schedule import onecycle as jonecycle

from se3conv3d_tpu_torch.nn.conv import check_neighbor_caps
from se3conv3d_tpu_torch.tasks.train import main
from se3conv3d_tpu_torch.train import metrics as tmetrics
from se3conv3d_tpu_torch.train.checkpoint import CheckpointManager
from se3conv3d_tpu_torch.train.run import Experiment
from se3conv3d_tpu_torch.train.schedule import onecycle

from torch_port_helpers import (dfaust_recipe, modelnet_recipe, scannet_recipe, write_dfaust,
                                write_modelnet, write_scannet)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "dfaust": (dfaust_recipe, lambda p: write_dfaust(p, n_train=5, n_test=3)),
    "dfaust_mixF": (lambda: dfaust_recipe(mix=True), lambda p: write_dfaust(p, n_train=6, n_test=2)),
    "modelnet40": (modelnet_recipe, lambda p: write_modelnet(p, n_pts=64)),
    "scannet20": (scannet_recipe, lambda p: write_scannet(p, n_train=4, n_val=2, n_pts=(500, 900))),
}


def both(name, tmp_path):
    make, fixture = RECIPES[name]
    root = fixture(tmp_path / "data")
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(make()))
    jexp = JExperiment(str(conf), root, log_folder=str(tmp_path / "jlog"))
    texp = Experiment(str(conf), root, log_folder=str(tmp_path / "tlog"), device="cpu")
    return jexp, texp


class JaxRecorder:
    """Stands in for the JAX ``Trainer``: records each batch and frame count."""

    def __init__(self, log, n_frames=None):
        self.log, self.n_frames = log, n_frames

    def init(self, key, batch):
        self.log.append(("init", batch, None))
        return type("State", (), {"calib": {}})()

    def calibration_step(self, state, batch, key):
        self.log.append(("calibrate", batch, None))
        return state

    def train_step(self, state, batch, key):
        self.log.append(("train", batch, self.n_frames))
        return state, {"loss": np.float32(0.0)}


class TorchRecorder:
    def __init__(self, log):
        self.log = log

    def calibration_step(self, batch, generator=None):
        self.log.append(("calibrate", batch, None))

    def train_step(self, batch, generator=None, n_frames=None):
        self.log.append(("train", batch, n_frames))
        return {"loss": torch.tensor(0.0)}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_batches_and_frame_counts_are_the_jax_run_loops(name, tmp_path):
    jexp, texp = both(name, tmp_path)
    jlog, tlog = [], []
    jexp.trainer = JaxRecorder(jlog)
    jexp._trainer_for_frames = lambda f: JaxRecorder(jlog, f)
    texp.trainer = TorchRecorder(tlog)
    # the port's init_state only draws its batch: record what it draws
    batches = texp._batches
    texp._batches = lambda ds, train, times=None: _recording(batches(ds, train, times), tlog, ds, texp)
    state = jexp.init_state()
    texp.init_state()
    state = jexp.calibrate(state)
    texp.calibrate()
    for epoch in range(3):
        jexp.train_epoch(state, epoch)
        texp.train_epoch(epoch)
    texp._batches = batches
    assert [k for k, _, _ in tlog] == [k for k, _, _ in jlog]
    assert len(jlog) >= 1 + 1 + 3 * texp.steps_per_epoch
    for (kind, jb, jf), (_, tb, tf) in zip(jlog, tlog):
        assert jf == tf, kind
        for key in ("positions", "mask", "features", "labels"):
            got = tb[key].numpy() if isinstance(tb[key], torch.Tensor) else tb[key]
            np.testing.assert_array_equal(got, np.asarray(jb[key]), err_msg=f"{kind} {key}")
            if isinstance(tb[key], torch.Tensor):
                assert tb[key].dtype == {"positions": torch.float32, "mask": torch.bool,
                                         "features": torch.float32, "labels": torch.int64}[key]
    if name == "dfaust_mixF":
        counts = [f for kind, _, f in tlog if kind == "train"]
        assert set(counts) <= {1, 2, 4} and len(set(counts)) > 1
    # the eval stream, and the raw batches with every key
    for _ in range(2):
        for jb, tb in zip(jexp._batches(jexp.val_ds, False), texp._batches(texp.val_ds, False),
                          strict=True):
            assert list(jb) == list(tb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
                assert tb[k].dtype == jb[k].dtype


def _recording(stream, log, ds, exp):
    """Record the first batch of ``init_state`` (which the port does not
    hand to a trainer), pass every batch on."""
    first = not any(kind == "init" for kind, _, _ in log)
    for batch in stream:
        if first and ds is exp.train_ds:
            log.append(("init", exp._put(batch), None))
            first = False
        yield batch


def _schedule_count_set(state, count):
    """``state`` with every ``ScaleByScheduleState.count`` set to ``count``."""
    if isinstance(state, optax.ScaleByScheduleState):
        return state._replace(count=jnp.asarray(count, state.count.dtype))
    if hasattr(state, "_fields"):
        return type(state)(*(_schedule_count_set(getattr(state, f), count) for f in state._fields))
    if isinstance(state, tuple):
        return tuple(_schedule_count_set(s, count) for s in state)
    return state


def jax_lr(tx, step):
    """The learning rate of ``tx``'s update number ``step``: a unit gradient
    on a zero parameter with fresh Adam moments moves it by ``-lr``."""
    params = {"w": jnp.zeros((1,), jnp.float32)}
    state = _schedule_count_set(tx.init(params), step)
    updates, _ = tx.update({"w": jnp.ones((1,), jnp.float32)}, state, params)
    return -float(updates["w"][0]) * (1.0 + 1e-8)


@pytest.mark.parametrize("name", ["dfaust", "modelnet40"])
def test_one_cycle_factors_deviate_from_the_jax_run_loop(name, tmp_path):
    """Records a deviation (ROADMAP.md Queue 3, one-cycle factors): the JAX
    run loop (``se3conv3d_tpu/train/run.py:137-144``) passes neither
    ``div_factor`` nor ``final_div_factor`` to its optimizer, so it trains
    every recipe with 25 / 1e4; the port's run loop honours the recipe's
    (10 / 1000 for DFaust and ScanNet, 100 / 10000 for ModelNet40)."""
    jexp, texp = both(name, tmp_path)
    tr = texp.tr
    total = texp.steps_per_epoch * int(tr["num_epochs"])
    assert jexp._steps_per_epoch() * int(tr["num_epochs"]) == total
    max_lr, pct = float(tr["max_lr"]), float(tr["pct_start"])
    div, final = float(tr["div_factor"]), float(tr["final_div_factor"])
    assert (div, final) != (25.0, 1e4)
    port = texp.optimizer.scheduler.lr_lambdas[0]
    assert texp.optimizer.lr == pytest.approx(max_lr / div, rel=1e-12)
    for step in (0, total - 1, total):  # the first update, the last, and the rate it ends at
        jax_rate = jax_lr(jexp._tx, step)
        assert jax_rate == pytest.approx(jonecycle(max_lr, total, pct)(step), rel=1e-5)
        assert jax_rate == pytest.approx(onecycle(max_lr, total, pct, 25.0, 1e4)(step), rel=1e-5)
        assert port(step) == pytest.approx(onecycle(max_lr, total, pct, div, final)(step), rel=1e-12)
    assert port(0) == pytest.approx(max_lr / div, rel=1e-12)
    assert jax_lr(jexp._tx, 0) == pytest.approx(max_lr / 25, rel=1e-5)  # a float32 update
    assert port(total) == pytest.approx(max_lr / (div * final))
    assert jax_lr(jexp._tx, total) == pytest.approx(max_lr / 25e4, rel=1e-5)


def test_metrics_are_the_jax_ones():
    rng = np.random.default_rng(0)
    c = 7
    metrics_j = jmetrics.SemSegMetrics.empty(c)
    metrics_t = tmetrics.SemSegMetrics.empty(c)
    for b in range(3):
        pred = rng.integers(0, c, (4, 50))
        labels = rng.integers(0, c, (4, 50))
        labels[0, :5] = c + 2  # out of range: counts for nothing, as one_hot's zero rows
        mask = rng.random((4, 50)) < 0.8
        mask[3] = False  # a filler cloud
        metrics_j = metrics_j.update(jnp.asarray(pred), jnp.asarray(labels), jnp.asarray(mask))
        metrics_t = metrics_t.update(torch.as_tensor(pred), labels, torch.as_tensor(mask))
    for f in ("intersection", "union", "gt_count", "pred_count"):
        np.testing.assert_array_equal(getattr(metrics_t, f), np.asarray(getattr(metrics_j, f)))
    ds = type("DS", (), {"mask_classes": [0]})()
    for class_mask in (None, jmetrics.dataset_class_mask(ds, c)):
        np.testing.assert_array_equal(
            tmetrics.dataset_class_mask(ds, c) if class_mask is not None else None, class_mask)
        sj, st = metrics_j.summary(class_mask), metrics_t.summary(class_mask)
        assert list(sj) == list(st)
        for k in sj:
            np.testing.assert_allclose(st[k], sj[k], rtol=0, atol=1e-12)
    logits = rng.standard_normal((9, 40)).astype(np.float32)
    labels = rng.integers(0, 40, 9)
    labels[:3] = logits[:3].argmax(-1)
    assert float(tmetrics.accuracy(torch.as_tensor(logits), torch.as_tensor(labels))) == pytest.approx(
        float(jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels))), abs=1e-12)


def test_neighbor_cap_report_is_the_jax_one():
    calib = {"encoder": {"conv_0": {"trunc_frac": np.float32(0.05), "norm_neigh_dist": np.float32(1)},
                         "block_1_0": {"spatial_conv": {"trunc_frac": np.float32(0.005)}}},
             "seg_conv": {"trunc_frac": np.float32(0.5)}}
    flat = {"encoder.conv_0.trunc_frac": torch.tensor(0.05), "encoder.conv_0.norm_neigh_dist": torch.tensor(1.0),
            "encoder.block_1_0.spatial_conv.trunc_frac": torch.tensor(0.005),
            "seg_conv.trunc_frac": torch.tensor(0.5)}
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jcheck_caps(calib)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = check_neighbor_caps(flat)
    assert got.keys() == want.keys() == {"encoder/conv_0", "seg_conv"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert [w.category for w in tw] == [UserWarning]
    assert check_neighbor_caps(flat, threshold=0.9) == {}


@pytest.mark.parametrize("capacity", [2048, 6000, 96])
def test_eval_trainer_capacity_is_the_jax_one(capacity, tmp_path):
    jexp, texp = both("dfaust", tmp_path)
    got = texp.make_eval_trainer(capacity).eval_hcfg
    want = jexp.make_eval_trainer(capacity).eval_hcfg
    assert (got.capacities, got.out_capacity) == (want.capacities, want.out_capacity)
    assert got.frames.n_frames == want.frames.n_frames and got.cell_sizes == want.cell_sizes
    assert texp.make_eval_trainer(capacity).model is texp.model


def test_checkpoint_manager_keeps_the_newest_and_loads_weights_only(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore() == (None, None)
    state = {"model": {"w": torch.arange(4.0)}, "optimizer": {"acc": None, "micro_step": 0}}
    for step in (0, 4, 2, 9, 7):
        mgr.save(step, copy.deepcopy(state), {"epoch": step, "best": 0.5 * step},
                 {"Model": {"RefFrames": {"mix_n_frames": {4: 0.15}}}})
    assert mgr.all_steps() == [4, 7, 9] and mgr.latest_step() == 9
    got, meta = mgr.restore()
    assert meta == {"epoch": 9, "best": 4.5}
    assert torch.equal(got["model"]["w"], state["model"]["w"])
    assert mgr.load(4)["config"]["Model"]["RefFrames"]["mix_n_frames"] == {4: 0.15}
    assert sorted(os.listdir(mgr.directory)) == ["ckpt_4.pt", "ckpt_7.pt", "ckpt_9.pt"]


def test_no_card_means_no_silent_cpu_run(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = write_dfaust(tmp_path / "data", n_train=2, n_test=1)
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(dfaust_recipe()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(str(conf), root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--conf_file", str(conf), "--data_folder", root, "--log_folder", str(tmp_path / "log")])
    assert not (tmp_path / "log").exists()
    # data parallelism: an Experiment of N ranks runs inside one of them
    with pytest.raises(RuntimeError, match="runs as one of 2 ranks"):
        Experiment(str(conf), root, n_devices=2, device="cpu")
