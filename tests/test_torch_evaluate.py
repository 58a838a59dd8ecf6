"""The port's voting evaluation against the JAX package's, logic only.

* Both packages' ``SegmentationVoter`` and ``ClassificationVoter`` run with
  stub trainers that return seeded logits, masks and ``out_idx`` (seeded
  by the member and by the JAX key's integer, which the port's generator
  carries as its seed), on the same stub datasets: the accumulators must be
  bitwise equal, and so must the metrics (with and without segment
  smoothing and a class mask), the capacity buckets built and the batches
  each trainer received.
* The two deviations from the JAX package that the port records: a
  ``votes_per_step`` that does not divide the vote count (JAX's CLI runs
  more votes than asked, the port's exactly as many), and a dataset
  without ``get_num_pts`` whose draws vary in size (JAX indexes out of
  bounds, the port raises naming the scene).
* ``is_test_config`` on every YAML file of ``configs/`` and
  ``merge_test_config`` on each test regime with the training recipes its
  name pairs with, read by the port's YAML reader and by PyYAML, and the
  merged eval ``HierarchyConfig`` field by field.
* The vote-epoch augmentations: the port's and the JAX package's eval
  datasets over three vote epochs of ``ScanNet_DS_Aug_Test``,
  ``MN40_DS_Aug_test_rot3D`` and ``DFaust_DS_Aug_Val_SO3``, their epoch
  counters stepped as each voter steps them: the samples bitwise equal.
"""
import dataclasses
import glob
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train import evaluate as jevaluate
from se3conv3d_tpu.train import run as jrun

from se3conv3d_tpu_torch.models import presets
from se3conv3d_tpu_torch.train import config as tconfig
from se3conv3d_tpu_torch.train import evaluate as tevaluate
from se3conv3d_tpu_torch.train import run as trun

from torch_port_helpers import write_dfaust, write_modelnet, write_scannet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CLASSES = 5


# --- stubs shared by both packages' voters ---------------------------------------


class SceneSet:
    """Scenes of ``sizes`` points whose every draw crops a seeded share of
    them (``valid_ids``), with ``get_num_pts``; ``crop=False`` returns the
    whole scene in its order and no ``valid_ids``; ``sizes_by_draw``
    (scene -> sizes of its successive draws) makes the draws vary."""

    def __init__(self, sizes, crop=True, num_pts=True, seed=0, sizes_by_draw=None):
        self.sizes = list(sizes)
        self.crop = crop
        self.rng = np.random.default_rng(seed)
        self.epochs = 0
        self.draws = [0] * len(sizes)
        self.sizes_by_draw = sizes_by_draw
        if num_pts:
            self.get_num_pts = lambda i: self.sizes[i]

    def __len__(self):
        return len(self.sizes)

    def increase_epoch_counter(self):
        self.epochs += 1

    def __getitem__(self, i):
        n = self.sizes[i]
        if self.sizes_by_draw is not None:
            n = self.sizes_by_draw[i][self.draws[i]]
        self.draws[i] += 1
        out = {}
        if self.crop:
            keep = np.sort(self.rng.choice(n, size=int(n * self.rng.uniform(0.6, 0.9)), replace=False))
            out["valid_ids"] = keep.astype(np.int32)
            n = len(keep)
        out.update(positions=self.rng.normal(size=(n, 3)).astype(np.float32),
                   features=self.rng.normal(size=(n, 2)).astype(np.float32),
                   labels=self.rng.integers(0, CLASSES, n).astype(np.int32),
                   scene_id=np.int32(i), segments=self.rng.integers(0, 7, n).astype(np.int32))
        return out


def fake_out(member, seed, mask, cap, full_out=False):
    """Seeded logits ``[B, M, CLASSES]`` float32 with an output mask and a
    permutation of the capacity as ``out_idx`` (pads included, so the
    ``idx < n_raw`` filter shows); ``full_out``: the output cloud is the raw
    one, in order, every row valid."""
    b = mask.shape[0]
    rng = np.random.default_rng([member, seed, cap])
    m = cap if full_out else cap // 2
    logits = rng.normal(size=(b, m, CLASSES)).astype(np.float32)
    if full_out:
        return {"logits": logits, "mask": np.ones((b, m), bool),
                "out_idx": np.broadcast_to(np.arange(cap, dtype=np.int32), (b, cap)).copy()}
    out_mask = np.arange(m)[None] < rng.integers(m // 2, m, b)[:, None]
    idx = np.stack([rng.permutation(cap)[:m] for _ in range(b)]).astype(np.int32)
    return {"logits": logits, "mask": out_mask, "out_idx": idx}


def key_int(key) -> int:
    data = np.asarray(jax.random.key_data(key))
    assert data[0] == 0
    return int(data[1])


class JaxStubTrainer:
    def __init__(self, cap, full_out=False):
        self.cap, self.full_out, self.batches = cap, full_out, []

    def eval_step(self, state, batch, key):
        if state == 0:  # each batch once (an ensemble calls once per member)
            self.batches.append({k: np.asarray(v) for k, v in batch.items()})
        seed = key_int(key)
        if "labels" in batch and np.asarray(batch["labels"]).ndim == 1:  # classification
            rng = np.random.default_rng([state, seed])
            return {"logits": rng.normal(size=(batch["mask"].shape[0], CLASSES)).astype(np.float32)}
        return fake_out(state, seed, np.asarray(batch["mask"]), self.cap, self.full_out)


class PortStubTrainer:
    def __init__(self, cap, full_out=False):
        self.cap, self.full_out, self.batches = cap, full_out, []
        self.device = torch.device("cpu")
        self.loaded = None
        self.loads = 0

    def load_member(self, state_dict):
        self.loaded = state_dict
        self.loads += 1

    def eval_ensemble(self, batch, members, generator=None, draws=None):
        self.batches.append({k: v.numpy() for k, v in batch.items()})
        seed = generator.initial_seed()
        outs = []
        for member in members:
            m = (member if member is not None else self.loaded)["id"]
            if batch["labels"].dim() == 1:
                rng = np.random.default_rng([m, seed])
                outs.append({"logits": torch.from_numpy(
                    rng.normal(size=(batch["mask"].shape[0], CLASSES)).astype(np.float32))})
            else:
                outs.append({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                             fake_out(m, seed, batch["mask"].numpy(), self.cap, self.full_out).items()})
        return outs


def assert_same_batches(jax_batches, port_batches):
    assert len(jax_batches) == len(port_batches)
    for jb, pb in zip(jax_batches, port_batches):
        for k in ("positions", "mask", "features"):
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        if "labels" in jb:
            np.testing.assert_array_equal(pb["labels"], jb["labels"].astype(np.int64))


def make_voters(sizes, capacity, votes_per_step, crop=True, num_pts=True, full_out=False,
                sizes_by_draw=None):
    built = {"jax": [], "port": []}
    voters = {}
    for side, stub, mod in (("jax", JaxStubTrainer, jevaluate), ("port", PortStubTrainer, tevaluate)):
        def factory(cap, side=side, stub=stub):
            trainer = stub(cap, full_out)
            built[side].append((cap, trainer))
            return trainer
        ds = SceneSet(sizes, crop=crop, num_pts=num_pts, sizes_by_draw=sizes_by_draw)
        voters[side] = mod.SegmentationVoter(stub(capacity, full_out), ds, CLASSES, capacity,
                                             trainer_factory=factory, process_index=0,
                                             process_count=1, votes_per_step=votes_per_step)
    return voters["jax"], voters["port"], built


@pytest.mark.parametrize("votes_per_step", [1, 2])
def test_segmentation_voter_accumulates_the_jax_sums_bitwise(votes_per_step):
    """Cropped draws remapped by ``valid_ids``, buffers sized by
    ``get_num_pts``, scenes of 30,000 and 8,000 points (cropped to 60-90%) above the capacity of
    4,096 (bucket trainers at 32,768 and 16,384, each built once), a
    2-member ensemble and two vote epochs."""
    sizes = [3000, 30000, 8000, 1000]
    jv, tv, built = make_voters(sizes, 4096, votes_per_step)
    jstates, tstates = [0, 1], [{"id": 0}, {"id": 1}]
    for epoch in range(2):
        jv.run_epoch(jstates, epoch)
        tv.run_epoch(tstates, epoch)
    assert [c for c, _ in built["jax"]] == [c for c, _ in built["port"]] == [32768, 16384]
    assert sorted(tv.bucket_trainers) == [16384, 32768]
    assert_same_batches(jv.trainer.batches, tv.trainer.batches)
    for (_, jt), (_, pt) in zip(built["jax"], built["port"]):
        assert_same_batches(jt.batches, pt.batches)
        assert len(pt.batches) == 2
    assert jv.dataset.epochs == tv.dataset.epochs == 2
    for i, n in enumerate(sizes):
        assert tv.accum[i].dtype == torch.float64 and tv.accum[i].shape == (n, CLASSES)
        np.testing.assert_array_equal(tv.accum[i].numpy(), jv.accum[i])
        assert np.count_nonzero(jv.accum[i].sum(-1)) > n // 4

    # metrics: plain, smoothed over segments, with a class mask
    rng = np.random.default_rng(3)
    labels = [rng.integers(0, CLASSES, n).astype(np.int32) for n in sizes]
    labels[3] = None  # an unlabeled scene counts for nothing
    segments = [rng.integers(0, 50, n).astype(np.int32) for n in sizes]
    class_mask = np.array([False, True, True, True, True])
    for kwargs in ({}, {"segments": segments, "smooth": True}, {"class_mask": class_mask},
                   {"segments": segments, "class_mask": class_mask, "smooth": True}):
        want, got = jv.metrics(labels, **kwargs), tv.metrics(labels, **kwargs)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {sorted(kwargs)}")


def test_segmentation_voter_on_whole_scenes_without_get_num_pts():
    """A DFaust-like dataset: no ``get_num_pts``, no ``valid_ids``, the
    output cloud the raw one; one member given as a single state."""
    sizes = [96, 96, 96]
    jv, tv, built = make_voters(sizes, 128, 1, crop=False, num_pts=False, full_out=True)
    for epoch in range(3):
        jv.run_epoch(0, epoch)
        tv.run_epoch({"id": 0}, epoch)
    assert built == {"jax": [], "port": []}
    assert tv.trainer.loads == 3  # one load per vote epoch, not per scene
    for i in range(len(sizes)):
        np.testing.assert_array_equal(tv.accum[i].numpy(), jv.accum[i])


def test_segment_smooth_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(5000, 21))
    segments = rng.integers(0, 300, 5000)
    segments[segments == 17] = 18  # an id with no point
    np.testing.assert_array_equal(tevaluate.segment_smooth(logits, segments),
                                  jevaluate.segment_smooth(logits, segments))


class ShapeSet:
    def __init__(self, n, seed=0):
        self.rng = np.random.default_rng(seed)
        self.labels = np.random.default_rng(seed + 1).integers(0, CLASSES, n)
        self.epochs = 0

    def __len__(self):
        return len(self.labels)

    def increase_epoch_counter(self):
        self.epochs += 1

    def __getitem__(self, i):
        n = 50
        return {"positions": self.rng.normal(size=(n, 3)).astype(np.float32),
                "features": np.ones((n, 1), np.float32), "label": np.int32(self.labels[i]),
                "scene_id": np.int32(i)}


def test_classification_voter_matches_jax():
    """Seven shapes in batches of three: the trailing batch is padded with
    its last shape and only its real shape accumulates; a 2-member
    ensemble over two epochs; the accuracies."""
    jt, tt = JaxStubTrainer(64), PortStubTrainer(64)
    jv = jevaluate.ClassificationVoter(jt, ShapeSet(7), CLASSES, 64, batch_size=3,
                                       process_index=0, process_count=1)
    tv = tevaluate.ClassificationVoter(tt, ShapeSet(7), CLASSES, 64, batch_size=3)
    for epoch in range(2):
        jv.run_epoch([0, 1], epoch)
        tv.run_epoch([{"id": 0}, {"id": 1}], epoch)
    assert len(tt.batches) == 6 and all(b["mask"].shape == (3, 64) for b in tt.batches)
    np.testing.assert_array_equal(tt.batches[2]["positions"][1], tt.batches[2]["positions"][0])
    assert_same_batches(jt.batches, tt.batches)
    np.testing.assert_array_equal(tv.accum, jv.accum)
    np.testing.assert_array_equal(tv.labels, jv.labels)
    assert tv.accuracy() == jv.accuracy()
    assert tv.class_accuracy() == jv.class_accuracy()
    np.testing.assert_array_equal(tv.per_class_accuracy(), jv.per_class_accuracy())


# --- the deviations the port records ----------------------------------------------


def test_draws_of_varying_size_without_get_num_pts_raise_where_jax_indexes_out_of_bounds():
    """JAX sizes a scene's buffer by its first draw (``train/evaluate.py:127``)
    and indexes out of bounds when a later draw is larger; the port raises
    ``ValueError`` naming the scene."""
    by_draw = {0: [10, 10], 1: [10, 12]}
    jv, tv, _ = make_voters([10, 10], 16, 1, crop=False, num_pts=False, full_out=True,
                            sizes_by_draw=by_draw)
    jv.run_epoch(0, 0)
    tv.run_epoch({"id": 0}, 0)
    with pytest.raises(IndexError):
        jv.run_epoch(0, 1)
    with pytest.raises(ValueError, match="scene 1: a draw of 12 points"):
        tv.run_epoch({"id": 0}, 1)


class CliExperiment:
    """A stand-in ``Experiment`` for the two CLIs' vote loops: three scenes
    of 96 points and a stub trainer that records its batches."""

    def __init__(self, cfg, data_folder, log_folder=None, **kwargs):
        port = kwargs.get("device") is not None
        self.trainer = (PortStubTrainer if port else JaxStubTrainer)(128, full_out=True)
        self.val_ds = SceneSet([96, 96, 96], crop=False, num_pts=False)
        self.num_classes, self.capacity = CLASSES, 128
        self.dataset_name, self.ds_cfg, self.tr = "dfaust", cfg["Dataset"], cfg["Training"]
        CliExperiment.last = self

    def make_eval_trainer(self, cap):
        raise AssertionError("no scene is above the capacity")


def test_votes_per_step_that_does_not_divide_the_votes(tmp_path, monkeypatch, capsys):
    """``--vote_epochs 5 --votes_per_step 2``: the JAX CLI runs 3 groups of 2,
    6 votes (``tasks/test_seg.py:131``); the port's runs 2 + 2 + 1."""
    from tasks import test_seg as jcli
    from se3conv3d_tpu_torch.tasks import test_seg as tcli

    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump({"Training": {"batch_size": 2}, "Dataset": {"dataset": "dfaust"},
                                    "Model": {"model": "FPNSegUNetMLPGeluRotEqFAUST"}}))
    argv = ["--conf_file", str(conf), "--data_folder", str(tmp_path), "--vote_epochs", "5",
            "--votes_per_step", "2"]
    votes = {}
    for side, mod in (("jax", jcli), ("port", tcli)):
        monkeypatch.setattr(mod, "Experiment", CliExperiment)
        monkeypatch.setattr(mod, "restore_ensemble", lambda exp, n, side=side: [0 if side == "jax" else {"id": 0}])
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["test_seg.py"] + argv)
            mod.main()
        else:
            mod.main(argv, device="cpu")
        steps = [b["mask"].shape[0] for b in CliExperiment.last.trainer.batches]
        votes[side] = sum(steps) // 3
        out = capsys.readouterr().out
        assert "vote epoch 5/5" in out and "mIoU:" in out
    assert votes == {"jax": 6, "port": 5}
    assert tcli.vote_groups(5, 2) == [2, 2, 1] and tcli.vote_groups(4, 2) == [2, 2]
    assert tcli.vote_groups(3, 1) == [1, 1, 1]


# --- test-regime configs ----------------------------------------------------------

YAMLS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))
# each test regime and the training recipes its name pairs with
TEST_PAIRS = [(f"configs/scannet/scannet20_test_{t}_{r}.yaml", f"configs/scannet/scannet20_{train}.yaml")
              for t, train in (("pca_I", "rot_pca_I"), ("pca_SO2", "rot_pca_SO2"), ("rot_I", "rot_I"),
                               ("rot_SO2", "rot_SO2"), ("standard_I", "standard_I"),
                               ("standard_SO2", "standard_SO2"))
              for r in (("I", "SO2") if t.endswith("_I") else ("SO2",))]
TEST_PAIRS += [("configs/modelnet40/modelnet40_test_rot.yaml", f"configs/modelnet40/modelnet40_{r}.yaml")
               for r in ("pca_2F", "MC_2F")]
TEST_PAIRS += [("configs/modelnet40/modelnet40_test_standard.yaml",
                "configs/modelnet40/modelnet40_standard.yaml")]
TEST_PAIRS += [("configs/dfaust/dfaust_test.yaml", f"configs/dfaust/dfaust_I_{r}.yaml")
               for r in ("rot_pca_2F", "rot_pca_mixF", "rot_MC_2F", "rot_MC_mixF", "standard")]


def test_every_test_regime_has_its_pairs():
    tests = {p for p in YAMLS if "_test" in p}
    assert len(YAMLS) == 26 and tests == {t for t, _ in TEST_PAIRS} and len(TEST_PAIRS) == 17


@pytest.mark.parametrize("path", YAMLS)
def test_is_test_config_matches_jax(path):
    ours = tconfig.load_yaml_config(os.path.join(REPO, path))
    ref = jconfig.load_yaml_config(os.path.join(REPO, path))
    assert tconfig.is_test_config(ours) == jconfig.is_test_config(ref) == ("_test" in path)


def fields_of(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = fields_of(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("test_yaml,train_yaml", TEST_PAIRS)
def test_merge_test_config_matches_jax(test_yaml, train_yaml):
    """The merged recipe and ``Testing`` section equal JAX's (each package
    reading with its own reader), and so does the merged eval hierarchy
    config, field by field (the port's frame config has fields JAX's lacks:
    each of JAX's fields is compared)."""
    load = lambda mod, p: mod.load_yaml_config(os.path.join(REPO, p))  # noqa: E731
    ours, testing = tconfig.merge_test_config(load(tconfig, train_yaml), load(tconfig, test_yaml))
    ref, ref_testing = jconfig.merge_test_config(load(jconfig, train_yaml), load(jconfig, test_yaml))
    assert ours == ref and testing == ref_testing
    assert ours["Dataset"]["test_aug_file"] == load(jconfig, test_yaml)["Dataset"]["test_aug_file"]
    seg = ours["Dataset"]["dataset"] != "modelnet40"
    cap = int(ours["Model"].get("out_capacity", 131072)) if ours["Dataset"]["dataset"].startswith(
        "scannet") else int(ours["Dataset"]["num_points"])
    got = presets.hierarchy_config_from_model_dict(ours["Model"], cap, train=False, with_output=seg)
    want = jconfig.hierarchy_config_from_model_dict(ref["Model"], cap, train=False, with_output=seg)
    got_f, want_f = fields_of(got), fields_of(want)
    assert got_f.keys() == want_f.keys()
    for k, v in want_f.items():
        if isinstance(v, dict):
            assert {f: got_f[k][f] for f in v} == v, k
        else:
            assert got_f[k] == v, k
    if "RefFrames" in (testing or {}):
        assert ours["Model"]["RefFrames"]["test_n_frames"] == testing["RefFrames"]["n_frames"]
        assert got.frames.n_frames == testing["RefFrames"]["n_frames"]
        assert got.frames.fixed_axis == 2 and got.frames.neigh_k == testing["RefFrames"].get(
            "neigh_kwargs", {}).get("neigh_k", got.frames.neigh_k)


# --- the vote-epoch augmentations -------------------------------------------------

AUG_CASES = {
    "scannet": ({"dataset": "scannet20", "test_split": "val", "test_aug_file": "configs.scannet.ScanNet_DS_Aug_Test",
                 "test_aug_color_file": "None"}, lambda root: write_scannet(root, n_train=1, n_val=2)),
    "modelnet40": ({"dataset": "modelnet40", "num_points": 80,
                    "test_aug_file": "configs.modelnet40.MN40_DS_Aug_test_rot3D"},
                   lambda root: write_modelnet(root)),
    "dfaust": ({"dataset": "dfaust", "num_points": 96, "test_aug_file": "configs.dfaust.DFaust_DS_Aug_Val_SO3"},
               lambda root: write_dfaust(root, n_train=1, n_test=3)),
}


@pytest.mark.parametrize("name", sorted(AUG_CASES))
def test_vote_epoch_samples_match_jax(tmp_path, name):
    """Three vote epochs, the epoch counter stepped once before each as both
    voters step it, every sample of the eval split drawn in the voters'
    order: bitwise equal (ScanNet's test-time sweep of 30 z-angles is
    indexed by that counter)."""
    ds_cfg, write = AUG_CASES[name]
    root = write(tmp_path / "data")
    ours = trun.make_datasets(ds_cfg, root, "val")
    ref = jrun.make_datasets(ds_cfg, root, "val")
    assert len(ours) == len(ref) >= 2
    for _ in range(3):
        ours.increase_epoch_counter()
        ref.increase_epoch_counter()
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} sample {i} {k}")
