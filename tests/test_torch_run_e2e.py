"""The port's training CLI end to end on the CPU (``main([...])`` with
``device="cpu"``, a test-only argument of ``Experiment``): tiny DFaust,
ModelNet40 and ScanNet recipes from their YAML files through calibration,
epochs, validation, ``config.yaml`` and checkpoints, then a resume whose
state equals the saved one bitwise and whose schedule continues."""
import math
import os

import numpy as np
import pytest
import torch
import yaml

from se3conv3d_tpu_torch.data import loaders as tload
from se3conv3d_tpu_torch.tasks.train import main
from se3conv3d_tpu_torch.train import run as trun
from se3conv3d_tpu_torch.train.config import load_yaml_config

from torch_port_helpers import (dfaust_recipe, modelnet_recipe, scannet_recipe, write_dfaust,
                                write_modelnet, write_scannet)

torch.set_num_threads(2)


def cli(conf, root, log, *extra):
    return ["--conf_file", str(conf), "--data_folder", str(root), "--log_folder", str(log), *extra]


def write_recipe(tmp_path, recipe, **training):
    recipe["Training"].update(training)
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(recipe))
    return conf


def assert_same_state(state, saved):
    """``state`` and ``saved`` (checkpoint payloads) bitwise equal."""
    assert state["model"].keys() == saved["model"].keys()
    for k, v in saved["model"].items():
        assert torch.equal(state["model"][k], v), k
    opt, sopt = state["optimizer"], saved["optimizer"]
    assert opt["micro_step"] == sopt["micro_step"]
    assert opt["scheduler"] == sopt["scheduler"]
    assert opt["adamw"]["param_groups"] == sopt["adamw"]["param_groups"]
    assert opt["adamw"]["state"].keys() == sopt["adamw"]["state"].keys()
    for i, s in sopt["adamw"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt["adamw"]["state"][i][k], s[k]), (i, k)
    assert state["trainer_step"] == saved["trainer_step"]


@pytest.fixture()
def restored(monkeypatch):
    """Each resumed run's state right after ``restore``, as a payload copy."""
    seen = []
    original = trun.Experiment.restore

    def restore(self, step=None):
        meta = original(self, step)
        seen.append({k: _clone(v) for k, v in self.state_payload().items()})
        return meta

    monkeypatch.setattr(trun.Experiment, "restore", restore)
    return seen


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def test_dfaust_cli_trains_checkpoints_and_resumes_bitwise(tmp_path, restored, capsys):
    root = write_dfaust(tmp_path / "data", n_train=4, n_test=2)
    conf = write_recipe(tmp_path, dfaust_recipe(), num_epochs=4, save_models_frequency=50, val_freq=2)
    log = tmp_path / "log"
    exp = main(cli(conf, root, log, "--max_epochs", "2"), device="cpu")
    out = capsys.readouterr().out
    assert "epoch 0: loss=" in out and "epoch 1: loss=" in out and "val_miou=" in out
    assert "epoch 2" not in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    # calibration ran: every conv's buffers were set
    flags = [v for k, v in exp.model.state_dict().items() if k.endswith("initialized")]
    assert flags and all(bool(f) for f in flags)
    saved_cfg = load_yaml_config(str(log / "config.yaml"))
    assert saved_cfg == exp.cfg == yaml.safe_load((log / "config.yaml").read_text())
    assert exp.ckpt.all_steps() == [1]  # validated at epoch 1 (val_freq 2): the best
    saved = exp.ckpt.load()
    assert saved["metadata"]["epoch"] == 1 and 0.0 <= saved["metadata"]["best"] <= 1.0
    assert saved["config"] == exp.cfg
    assert_same_state(exp.state_payload(), saved["state"])
    assert saved["state"]["optimizer"]["scheduler"]["last_epoch"] == 2 * exp.steps_per_epoch
    assert exp.host_split.keys() == {"load", "collate", "copy", "step"}
    assert all(len(v) == exp.steps_per_epoch for v in exp.host_split.values())

    resumed = main(cli(conf, root, log, "--resume", "--max_epochs", "1"), device="cpu")
    assert len(restored) == 1
    assert_same_state(restored[0], saved["state"])
    out = capsys.readouterr().out
    assert "epoch 2: loss=" in out and "epoch 3" not in out
    # the schedule went on from the saved step, one update per batch
    assert resumed.optimizer.scheduler.last_epoch == 3 * resumed.steps_per_epoch
    assert resumed.trainer.step == 3 * resumed.steps_per_epoch
    # no calibration on a resume: the buffers are the saved ones
    for k, v in saved["state"]["model"].items():
        if k.endswith(("norm_neigh_dist", "norm_num_neighs", "trunc_frac")):
            assert torch.equal(resumed.model.state_dict()[k], v), k


def test_modelnet40_cli_reports_accuracy_and_reads_its_npz_cache(tmp_path, restored, capsys):
    root = write_modelnet(tmp_path / "data", n_pts=64)
    conf = write_recipe(tmp_path, modelnet_recipe(), num_epochs=2, val_freq=1)
    log = tmp_path / "log"
    exp = main(cli(conf, root, log, "--max_epochs", "1"), device="cpu")
    assert os.path.exists(os.path.join(root, "tmp_train_64.npz"))
    assert os.path.exists(os.path.join(root, "tmp_test_64.npz"))
    assert not exp.train_ds.from_cache
    val = exp.validate()
    assert val.keys() == {"accuracy"} and 0.0 <= val["accuracy"] <= 1.0
    assert "val_accuracy=" in capsys.readouterr().out
    assert exp.ckpt.all_steps() == [0]
    again = main(cli(conf, root, log, "--resume", "--max_epochs", "1"), device="cpu")
    assert again.train_ds.from_cache and again.val_ds.from_cache
    assert_same_state(restored[0], exp.ckpt.load(0)["state"])
    assert "epoch 1: loss=" in capsys.readouterr().out


def test_scannet_cli_trains_scene_by_scene(tmp_path, capsys):
    root = write_scannet(tmp_path / "data", n_train=3, n_val=2, n_pts=(500, 900))
    conf = write_recipe(tmp_path, scannet_recipe(), num_epochs=1, num_batches=2)
    exp = main(cli(conf, root, tmp_path / "log"), device="cpu")
    out = capsys.readouterr().out
    assert "epoch 0: loss=" in out and "val_miou=" in out
    assert exp.trainer.scan_scenes and exp.trainer.ignore_label == 0
    assert exp.trainer.step == 2
    miou = float(out.split("val_miou=")[1].split()[0])
    assert 0.0 <= miou <= 1.0
    summary = exp.validate()
    assert summary["iou_per_class"].shape == (21,) and np.isfinite(summary["miou"])
    assert exp.ckpt.all_steps() == [0]
    assert isinstance(exp.val_ds, tload.ScanNetDataset)
