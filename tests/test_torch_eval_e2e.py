"""The evaluation CLIs end to end on the CPU: tiny DFaust, ScanNet and
ModelNet40 runs trained by ``tasks.train.main(..., device="cpu")``, then
evaluated from their log folders with a test-regime YAML by
``tasks.test_seg.main`` / ``tasks.test_class.main``.  The ScanNet fixture
holds a val scene above the tiny recipe's capacity of 1,024 points, so a
bucket trainer is built; it holds segment files, so ``--smooth_segments``
runs; ``--save_output`` writes the text results and one benchmark label
file per scene with one ScanNet-20 id per raw point; a split without
labels gives predictions and no metrics."""
import os
import shutil

import numpy as np
import torch
import yaml

from se3conv3d_tpu_torch.tasks import test_class, test_seg
from se3conv3d_tpu_torch.tasks.train import main as train_main
from se3conv3d_tpu_torch.utils.scannet_io import SCANNET_CLASS_IDS_20

from torch_port_helpers import (dfaust_recipe, modelnet_recipe, scannet_recipe, write_dfaust,
                                write_modelnet, write_scannet)

torch.set_num_threads(2)


def train(tmp_path, recipe, root, **training):
    recipe["Training"].update(training)
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(recipe))
    log = tmp_path / "log"
    train_main(["--conf_file", str(conf), "--data_folder", str(root), "--log_folder", str(log)],
               device="cpu")
    return log


def test_dfaust_run_evaluates_with_its_test_regime(tmp_path, capsys):
    """``configs/dfaust/dfaust_test.yaml`` as written (one vote) over a
    2-checkpoint ensemble: the accumulator is the sum of its members."""
    root = write_dfaust(tmp_path / "data", n_train=4, n_test=2)
    # a checkpoint at epoch 0 (save frequency), another at the last epoch's validation
    log = train(tmp_path, dfaust_recipe(), root, num_epochs=2, val_freq=5, save_models_frequency=1)
    assert sorted(os.listdir(log / "ckpt")) == ["ckpt_0.pt", "ckpt_1.pt"]
    argv = ["--conf_file", "configs/dfaust/dfaust_test.yaml", "--data_folder", root, "--log_folder",
            str(log), "--save_output", str(tmp_path / "out")]
    capsys.readouterr()
    voter, summary = test_seg.main(argv + ["--checkpoints", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "vote epoch 1/1" in out and "mIoU: " in out and "left_thigh" in out
    assert 0.0 <= summary["miou"] <= 1.0
    assert [a.shape for a in voter.accum] == [(96, 20), (96, 20)]
    assert (tmp_path / "out" / "results.txt").read_text().startswith("mIoU: ")
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "out" / "per_class_iou.txt"), summary["iou_per_class"])
    # each member alone, on the same seeds: their sum is the ensemble's
    singles = []
    for n in (1, 2):
        shutil.copytree(log, tmp_path / f"log{n}")
        if n == 2:
            os.remove(tmp_path / "log2" / "ckpt" / "ckpt_1.pt")
        argv1 = argv[:5] + [str(tmp_path / f"log{n}")]
        singles.append(test_seg.main(argv1, device="cpu")[0])
    for i in range(2):
        both = singles[0].accum[i] + singles[1].accum[i]
        torch.testing.assert_close(voter.accum[i], both, rtol=1e-12, atol=0)


def test_scannet_run_evaluates_whole_scenes_through_a_bucket(tmp_path, capsys):
    # trained on scenes within the capacity (its validation pads them to it),
    # evaluated on val scenes of 500 and 1,500 points
    log = train(tmp_path, scannet_recipe(), write_scannet(tmp_path / "train_data", n_pts=(500, 900)),
                num_epochs=1, num_batches=1)
    root = write_scannet(tmp_path / "data", n_train=3, n_val=2, n_pts=(500, 1500))
    test_yaml = yaml.safe_load(open("configs/scannet/scannet20_test_pca_I_SO2.yaml"))
    test_yaml["Testing"]["RefFrames"]["neigh_kwargs"]["neigh_k"] = 8
    conf = tmp_path / "test.yaml"
    conf.write_text(yaml.safe_dump(test_yaml))
    out_dir = tmp_path / "preds"
    argv = ["--conf_file", str(conf), "--data_folder", root, "--log_folder", str(log), "--vote_epochs", "2"]
    voter, summary = test_seg.main(argv + ["--smooth_segments", "--save_output", str(out_dir)], device="cpu")
    assert sorted(voter.bucket_trainers) == [16384]  # the 1,500-point val scene
    assert voter.trainer.eval_hcfg.frames.fixed_axis == 2 and voter.trainer.eval_hcfg.frames.neigh_k == 8
    assert 0.0 <= summary["miou"] <= 1.0 and summary["iou_per_class"].shape == (21,)
    out = capsys.readouterr().out
    assert "vote epoch 2/2" in out and "(masked)" in out
    names = [l.strip() for l in open(os.path.join(root, "scannet_val.txt"))]
    for name, n in zip(names, (500, 1500)):
        ids = np.loadtxt(out_dir / f"{name}.txt", dtype=np.int64)
        assert ids.shape == (n,) and np.isin(ids, SCANNET_CLASS_IDS_20).all()
        assert np.loadtxt(out_dir / f"{name}_colored.txt").shape == (n, 6)
    assert (out_dir / "results.txt").exists()
    # the smoothed metrics differ from the plain ones on the same accumulators
    plain = voter.metrics([s["labels"] for s in voter.dataset.scenes])
    assert plain["miou"] != summary["miou"] or plain["overall_acc"] != summary["overall_acc"]

    # a split without labels: predictions only
    os.makedirs(os.path.join(root, "test"))
    for name in names:
        shutil.copy(os.path.join(root, "val", name + ".npz"), os.path.join(root, "test", name + ".npz"))
    shutil.copy(os.path.join(root, "scannet_val.txt"), os.path.join(root, "scannet_test.txt"))
    test_yaml["Dataset"]["split"] = "test"
    conf.write_text(yaml.safe_dump(test_yaml))
    voter, summary = test_seg.main(argv + ["--vote_epochs", "1", "--save_output", str(tmp_path / "bench")],
                                   device="cpu")
    assert summary is None and "skipping metrics" in capsys.readouterr().out
    assert not (tmp_path / "bench" / "results.txt").exists()
    assert np.loadtxt(tmp_path / "bench" / f"{names[1]}.txt").shape == (1500,)


def test_modelnet40_run_evaluates_with_its_test_regime(tmp_path, capsys):
    """``configs/modelnet40/modelnet40_test_rot.yaml`` (SO(3) test
    rotations, batches of 24) for two votes over three test shapes."""
    root = write_modelnet(tmp_path / "data", n_pts=64)
    log = train(tmp_path, modelnet_recipe(), root, num_epochs=1)
    out_dir = tmp_path / "out"
    voter, summary = test_class.main(["--conf_file", "configs/modelnet40/modelnet40_test_rot.yaml",
                                      "--data_folder", root, "--log_folder", str(log), "--vote_epochs", "2",
                                      "--save_output", str(out_dir)], device="cpu")
    assert voter.batch_size == 24 and voter.accum.shape == (3, 40)
    assert (voter.accum != 0).any(1).all() and 0.0 <= summary["accuracy"] <= 1.0
    out = capsys.readouterr().out
    assert "vote epoch 2/2: acc=" in out and "Class Acc: " in out
    assert np.loadtxt(out_dir / "accum_logits.txt").shape == (3, 40)
