"""The port's offline preprocessing (``se3conv3d_tpu_torch/preprocess``)
against the JAX package's on the same inputs: the cases of
``tests/test_preprocess.py`` run through both, every output bitwise equal
(even surface sampling, the joint-label merge, labelled clouds, the AMASS
train and test archive readers, the pose parameters), and the regenerated
DFaust files read back by the port's ``DFaustDataset`` as the JAX package's
loader reads the JAX files.  No SMPL model is needed: the poser is
injected, and ``pose_smpl_body`` raises the same error on both sides
without ``smplx``."""
import io
import tarfile

import numpy as np
import pytest
import torch

from se3conv3d_tpu import preprocess as jpre
from se3conv3d_tpu.data import DFaustDataset as JDFaust

from se3conv3d_tpu_torch import preprocess as tpre
from se3conv3d_tpu_torch.data import DFaustDataset


def _unit_cube_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]])
    return v, f


def _height_lbs(v):
    lbs = np.zeros((len(v), 24))
    for i, vert in enumerate(v):
        lbs[i, 0 if vert[2] < 0.5 else 5] = 1.0
    return lbs


def test_surface_sampling_and_label_merge_match_jax():
    v, f = _unit_cube_mesh()
    for seed in range(3):
        got = tpre.sample_surface_even(v, f, 500, np.random.default_rng(seed))
        ref = jpre.sample_surface_even(v, f, 500, np.random.default_rng(seed))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    w = np.random.default_rng(4).uniform(size=(300, 24))
    w[:24] = np.eye(24)
    np.testing.assert_array_equal(tpre.merge_joint_labels(w), jpre.merge_joint_labels(w))
    assert set(tpre.merge_joint_labels(np.eye(24))) & {10, 11, 22, 23} == set()


def test_labelled_cloud_and_loader_roundtrip_match_jax(tmp_path):
    v, f = _unit_cube_mesh()
    lbs = _height_lbs(v)
    pts, labels = tpre.sample_labelled_cloud(v, f, lbs, count=300, rng=np.random.default_rng(1))
    jpts, jlabels = jpre.sample_labelled_cloud(v, f, lbs, count=300, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(labels, jlabels)
    assert pts.dtype == np.float32 and labels.dtype == np.int64
    for side, save in (("port", tpre.save_model_files), ("jax", jpre.save_model_files)):
        save(str(tmp_path / side / "train"), 0, pts, labels)
    # the port's files read by the port's loader as the JAX ones by the JAX loader
    sample = DFaustDataset(str(tmp_path / "port"), num_pts=300, split="train")[0]
    jsample = JDFaust(str(tmp_path / "jax"), num_pts=300, split="train")[0]
    assert sample.keys() == jsample.keys()
    for k in sample:
        np.testing.assert_array_equal(np.asarray(sample[k]), np.asarray(jsample[k]))
    assert set(np.unique(sample["labels"])) <= {0, 5}


def _fake_sequence(rng, t, fname):
    return {"fname": fname,
            "markers": rng.standard_normal((t, 67, 3)).astype(np.float32),
            "poses": rng.standard_normal((t, 156)).astype(np.float32),
            "trans": rng.standard_normal((t, 3)).astype(np.float32),
            "betas": rng.standard_normal(16).astype(np.float32)}


def _same_frames(a, b):
    assert a.fnames == b.fnames
    for k in ("markers", "poses", "trans", "betas"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_amass_readers_and_pose_params_match_jax(tmp_path):
    import joblib

    rng = np.random.default_rng(0)
    joblib.dump([_fake_sequence(rng, 3, "a"), _fake_sequence(rng, 2, "b")],
                tmp_path / "DFaust_67_train.pth.tar")
    frames = tpre.load_amass_train(str(tmp_path))
    _same_frames(frames, jpre.load_amass_train(str(tmp_path)))
    assert len(frames) == 5 and frames.fnames == ["a", "a", "a", "b", "b"]
    for got, ref in zip(tpre.iter_pose_params(frames), jpre.iter_pose_params(frames), strict=True):
        assert got.keys() == ref.keys() and got["fname"] == ref["fname"]
        for k in ("global_orient", "body_pose", "betas"):
            np.testing.assert_array_equal(got[k], ref[k])
        assert got["body_pose"].shape == (69,) and (got["body_pose"][-6:] == 0).all()

    d = tmp_path / "MPI_Limits"
    d.mkdir()

    def payload(name):
        return {"fname": name, **{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                                  for k, s in (("markers", (67, 3)), ("poses", (156,)), ("trans", (3,)),
                                               ("betas", (16,)))}}

    for tar_name, members in (("b.tar", [("s2", payload("f2")), ("s3", payload("f3"))]),
                              ("a.tar", [("s1", payload("f1"))])):
        with tarfile.open(d / tar_name, "w") as tf:
            for key, obj in members:
                buf = io.BytesIO()
                torch.save(obj, buf)
                info = tarfile.TarInfo(name=f"{key}.input.pth")
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
    frames = tpre.load_amass_test(str(tmp_path))
    _same_frames(frames, jpre.load_amass_test(str(tmp_path)))
    assert frames.fnames == ["f1", "f2", "f3"]
    with pytest.raises(FileNotFoundError):
        tpre.load_amass_test(str(tmp_path), subdir="missing")


def test_regenerate_dfaust_matches_jax_and_loads(tmp_path):
    import joblib

    rng = np.random.default_rng(2)
    joblib.dump([_fake_sequence(rng, 2, "seq")], tmp_path / "DFaust_67_train.pth.tar")
    frames = tpre.load_amass_train(str(tmp_path))
    v, f = _unit_cube_mesh()
    lbs = np.zeros((len(v), 24))
    lbs[np.arange(len(v)), np.arange(len(v)) % 24] = 1.0

    def pose_fn(params):  # a fake SMPL: the cube moved by the global orient
        return v + params["global_orient"][None, :], f, lbs

    for side, regen in (("port", tpre.regenerate_dfaust), ("jax", jpre.regenerate_dfaust)):
        assert regen(frames, str(tmp_path / side / "train"), pose_fn=pose_fn, num_points=200) == 2
    for i in range(2):
        for kind in ("pc", "labels"):
            got = torch.load(tmp_path / "port" / "train" / f"model_{i}_{kind}.pt")
            ref = torch.load(tmp_path / "jax" / "train" / f"model_{i}_{kind}.pt")
            assert got.dtype == ref.dtype and torch.equal(got, ref)
    sample = DFaustDataset(str(tmp_path / "port"), augmentations=[], num_pts=128, split="train")[0]
    jsample = JDFaust(str(tmp_path / "jax"), augmentations=[], num_pts=128, split="train")[0]
    for k in sample:
        np.testing.assert_array_equal(np.asarray(sample[k]), np.asarray(jsample[k]))
    with pytest.raises(ValueError, match="model_folder"):
        tpre.regenerate_dfaust(frames, str(tmp_path / "x"))


def test_pose_smpl_body_needs_smplx_on_both_sides():
    try:
        import smplx  # noqa: F401
        pytest.skip("smplx is installed: the error path does not apply")
    except ImportError:
        pass
    args = (np.zeros(10), np.zeros(3), np.zeros(69), "/nonexistent")
    with pytest.raises(ImportError) as got:
        tpre.pose_smpl_body(*args)
    with pytest.raises(ImportError) as ref:
        jpre.pose_smpl_body(*args)
    assert str(got.value) == str(ref.value)
