"""The evaluation CLIs as a whole against the JAX package's voters.

A tiny DFaust recipe (``tests/test_torch_run_validate.py``) and a tiny
ModelNet40 one, with the tiny models of ``torch_port_helpers`` in both
packages: the JAX ``init_state`` parameters (randomised so every layer
shows) and BN statistics, calibrated by the JAX run loop, make checkpoint
A; B is A with its parameters perturbed.  Both are carried across with
``utils.weights.from_flax`` into the port's ``ckpt_{step}.pt`` files beside
the recipe's ``config.yaml``.  The JAX voter runs two vote epochs of a
test-regime YAML over the ensemble (B, A), newest first; the port's
``tasks.test_seg.main`` / ``tasks.test_class.main`` run the same YAML on
the log folder with ``--checkpoints 2 --vote_epochs 2`` on the CPU, their
hierarchy draws injected from the JAX key whose integer seeds each
generator.  Each accumulator must lie within 2e-4 of its maximum (the
repo's whole-model bound) of JAX's, and the metrics must equal JAX's but
where a prediction differs at a near-tie of the JAX logits.  Without a
card, both CLIs raise unless asked for the CPU."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from se3conv3d_tpu.models import ClassNet as JClassNet
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.train import Trainer as JTrainer
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train.evaluate import ClassificationVoter as JClassVoter
from se3conv3d_tpu.train.evaluate import SegmentationVoter as JSegVoter
from se3conv3d_tpu.train.metrics import SemSegMetrics as JSemSegMetrics
from se3conv3d_tpu.train.run import Experiment as JExperiment

from se3conv3d_tpu_torch.models import ClassNet, FPNSegUNet, presets
from se3conv3d_tpu_torch.tasks import test_class, test_seg
from se3conv3d_tpu_torch.train import run as trun
from se3conv3d_tpu_torch.train.checkpoint import CheckpointManager
from se3conv3d_tpu_torch.train.config import dump_yaml_config
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

from test_torch_run_validate import tiny_recipe
from torch_port_helpers import (TINY, jax_hierarchy_draws, modelnet_recipe, randomize, write_dfaust,
                                write_modelnet)

torch.set_num_threads(2)

BOUND = 2e-4
RF = {"pca": True, "neigh_method": "knn", "neigh_kwargs": {"neigh_k": 8}, "n_frames": 2}


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) * (1 + 0.1 * rng.standard_normal(np.shape(x)))).astype(np.asarray(x).dtype),
        params)


def jax_states(recipe, test_cfg, root, tmp_path, net):
    """The JAX run loop on the merged recipe with its tiny model: states A
    (randomised, calibrated) and B (perturbed), and the Experiment."""
    merged, _ = jconfig.merge_test_config(recipe, test_cfg)
    jexp = JExperiment(merged, root, log_folder=str(tmp_path / "jlog"))
    jexp.model = net(dataclasses.replace(jexp.model.spec, **TINY), jexp.num_in_feats, jexp.num_classes)
    jexp.trainer = JTrainer(jexp.model, jexp.hcfg, jexp.trainer.tx, jexp.trainer.settings,
                            eval_hierarchy_config=jexp.eval_hcfg)
    state = jexp.init_state()
    rng = np.random.default_rng(6)
    state = state.replace(params=randomize(state.params, rng), batch_stats=randomize(state.batch_stats, rng))
    a = jexp.calibrate(state)
    b = a.replace(params=perturbed(a.params, 7))
    return jexp, a, b


def write_port_run(log, recipe, states):
    """The port's log folder: the recipe's ``config.yaml`` and one
    checkpoint per state (steps 0, 1, ...)."""
    log.mkdir()
    dump_yaml_config(recipe, str(log / "config.yaml"))
    ckpt = CheckpointManager(str(log / "ckpt"))
    for step, st in enumerate(states):
        sd = from_flax(*jax.device_get((st.params, st.batch_stats, st.calib)))
        ckpt.save(step, {"model": {k: torch.as_tensor(v) for k, v in sd.items()}})


@pytest.fixture()
def tiny_port(monkeypatch):
    """The port's run loop builds the tiny model of the recipe's preset, and
    each eval takes the JAX draws of its generator's seed from the JAX
    config ``ctx.jax_cfg``; ``ctx.seeds`` holds the seeds seen."""
    def build(md, num_in_feats, num_classes, device=None, generator=None):
        spec = dataclasses.replace(presets.spec_from_model_dict(md), **TINY)
        net = ClassNet if md["model"] in presets.CLASS_PRESETS else FPNSegUNet
        return net(spec, num_in_feats, num_classes).to(device)

    ctx = types.SimpleNamespace(seeds=[], jax_cfg=None)
    original = Trainer.eval_ensemble

    def eval_ensemble(self, batch, members, generator=None, draws=None):
        seed = generator.initial_seed()
        ctx.seeds.append(seed)
        b, n = batch["positions"].shape[:2]
        draws = jax_hierarchy_draws(jax.random.PRNGKey(seed), ctx.jax_cfg, b, n)
        return original(self, batch, members, draws=draws)

    monkeypatch.setattr(trun, "build_model_from_config", build)
    monkeypatch.setattr(Trainer, "eval_ensemble", eval_ensemble)
    return ctx


def assert_near(got, want):
    scale = np.abs(want).max()
    assert scale > 0.1 and np.abs(got - want).max() <= BOUND * scale, (np.abs(got - want).max(), scale)


def test_test_seg_matches_the_jax_voter_on_a_carried_ensemble(tmp_path, tiny_port):
    root = write_dfaust(tmp_path / "data", n_train=4, n_test=3, n_pts=128, seed=5)
    recipe = tiny_recipe()
    test_cfg = {"Testing": {"num_epochs": 2, "RefFrames": RF},
                "Dataset": {"dataset": "dfaust", "num_points": 128,
                            "test_aug_file": "configs.dfaust.DFaust_DS_Aug_Val_SO3"}}
    jexp, a, b = jax_states(recipe, test_cfg, root, tmp_path, JNet)
    jvoter = JSegVoter(jexp.trainer, jexp.val_ds, jexp.num_classes, jexp.capacity,
                       trainer_factory=jexp.make_eval_trainer, process_index=0, process_count=1)
    for epoch in range(2):
        jvoter.run_epoch([b, a], epoch)

    write_port_run(tmp_path / "log", recipe, [a, b])
    conf = tmp_path / "test.yaml"
    conf.write_text(yaml.safe_dump(test_cfg))
    tiny_port.jax_cfg = jexp.eval_hcfg
    voter, summary = test_seg.main(["--conf_file", str(conf), "--data_folder", root, "--log_folder",
                                    str(tmp_path / "log"), "--checkpoints", "2", "--vote_epochs", "2"],
                                   device="cpu")
    assert tiny_port.seeds == [e * 100003 + i for e in range(2) for i in range(3)]
    labels = [jexp.val_ds[i]["labels"] for i in range(3)]
    differ, preds = 0, []
    for i in range(3):
        got, want = voter.accum[i].numpy(), jvoter.accum[i]
        assert_near(got, want)
        jp, tp = want.argmax(-1), got.argmax(-1)
        off = np.nonzero(jp != tp)[0]
        differ += len(off)
        gap = want[off, jp[off]] - want[off, tp[off]]
        assert (gap <= BOUND * np.abs(want).max()).all()
        preds.append((tp, want.sum(-1) != 0))
    want = jvoter.metrics(labels)
    if differ:  # near-ties only: the JAX metric of the port's predictions
        m = JSemSegMetrics.empty(jexp.num_classes)
        for (tp, seen), lab in zip(preds, labels):
            m = m.update_np(tp, lab, seen)
        want = m.summary()
    np.testing.assert_array_equal(summary["iou_per_class"], want["iou_per_class"])
    for k in ("miou", "macc", "overall_acc"):
        assert summary[k] == want[k], k


def tiny_modelnet_recipe():
    recipe = modelnet_recipe()
    recipe["Model"].update(init_subsample=0.1, grid_subsamples=[0.2, 0.4], capacities=[64, 32, 16])
    return recipe


def test_test_class_matches_the_jax_voter_on_a_carried_ensemble(tmp_path, tiny_port, capsys):
    root = write_modelnet(tmp_path / "data", n_pts=64)
    recipe = tiny_modelnet_recipe()
    test_cfg = {"Testing": {"num_epochs": 2, "batch_size": 2, "RefFrames": RF},
                "Dataset": {"dataset": "modelnet40", "num_points": 64,
                            "test_aug_file": "configs.modelnet40.MN40_DS_Aug_test_rot3D"}}
    jexp, a, b = jax_states(recipe, test_cfg, root, tmp_path, JClassNet)
    assert len(jexp.val_ds) == 3  # batches of 2: the second padded with its last shape
    jvoter = JClassVoter(jexp.trainer, jexp.val_ds, jexp.num_classes, jexp.capacity, batch_size=2,
                         process_index=0, process_count=1)
    for epoch in range(2):
        jvoter.run_epoch([b, a], epoch)

    write_port_run(tmp_path / "log", recipe, [a, b])
    conf = tmp_path / "test.yaml"
    conf.write_text(yaml.safe_dump(test_cfg))
    tiny_port.jax_cfg = jexp.eval_hcfg
    out_dir = tmp_path / "out"
    voter, summary = test_class.main(["--conf_file", str(conf), "--data_folder", root, "--log_folder",
                                      str(tmp_path / "log"), "--checkpoints", "2", "--vote_epochs", "2",
                                      "--save_output", str(out_dir)], device="cpu")
    assert tiny_port.seeds == [e * 99991 + s for e in range(2) for s in (0, 2)]
    assert_near(voter.accum, jvoter.accum)
    np.testing.assert_array_equal(voter.labels, jvoter.labels)
    jp, tp = jvoter.accum.argmax(-1), voter.accum.argmax(-1)
    off = np.nonzero(jp != tp)[0]
    gap = jvoter.accum[off, jp[off]] - jvoter.accum[off, tp[off]]
    assert (gap <= BOUND * np.abs(jvoter.accum).max()).all()
    if not len(off):
        assert summary["accuracy"] == jvoter.accuracy()
        assert summary["class_accuracy"] == jvoter.class_accuracy()
    out = capsys.readouterr().out
    assert f"Acc: {summary['accuracy'] * 100:.2f}" in out and "Class Acc: " in out
    np.testing.assert_array_equal(np.loadtxt(out_dir / "accum_logits.txt"), voter.accum)
    assert (out_dir / "class_acc_list.txt").exists()
    assert (out_dir / "results.txt").read_text().startswith("Acc: ")


@pytest.mark.parametrize("cli", [test_seg, test_class])
def test_the_clis_raise_without_a_card_unless_asked_for_the_cpu(tmp_path, cli):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--conf_file", "configs/dfaust/dfaust_test.yaml", "--data_folder", str(tmp_path)])
