"""The port's data pipeline against the JAX package's, bitwise: the 12
augmentations and ``AugPipeline`` with every augmentation module under
``configs/``, on the native library's path and on the numpy path;
``pad_collate``, ``mix3d_merge``, ``MaxPointsBatchSampler`` and
``pad_samples_to``; the DFaust, ModelNet40 (the port reading its ``.npz``
cache, JAX its txt files) and ScanNet datasets on synthetic fixtures."""
import glob
import importlib
import os

import numpy as np
import pytest

import se3conv3d_tpu.native as jnative
from se3conv3d_tpu.data import augment as jaug
from se3conv3d_tpu.data import loaders as jload
from se3conv3d_tpu.parallel import multihost as jmulti

from se3conv3d_tpu_torch import native as tnative
from se3conv3d_tpu_torch.data import augment as taug
from se3conv3d_tpu_torch.data import loaders as tload

from torch_port_helpers import write_dfaust, write_modelnet, write_scannet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a, b, where="value"):
    """Bitwise equal, dtype and structure included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic)) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Both packages on the native library, or both on the numpy path."""
    if request.param == "native":
        if jnative.load_library() is None or tnative.load_library() is None:
            pytest.fail("a native library did not build (g++ missing?)")
    else:
        monkeypatch.setattr(jnative, "elastic_distortion", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "elastic_distortion", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "select_nearest", lambda *a, **k: None)
    return request.param


def cloud(seed, n=600, scale=(2.0, 1.6, 1.0)):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(size=(n, 3)) * np.asarray(scale)).astype(np.float32)
    extras = [rng.standard_normal((n, 3)).astype(np.float32),
              rng.uniform(size=(n, 3)).astype(np.float32),
              rng.integers(0, 21, n).astype(np.int32)]
    return pts, extras


ALL_EXTRAS = [True, True, True]  # the crops subset the labels too; maps take [n, 3] extras only
AUGS = {
    "CenterAug": dict(p_axes=[True, False, True], p_method="max", p_apply_extra_tensors=[True, True]),
    "RotationAug": dict(p_prob=0.9, p_axis=1, p_min_angle=-0.5, p_max_angle=1.5,
                        p_apply_extra_tensors=[True, False, False]),
    "RotationAug3D": dict(p_apply_extra_tensors=[True, False, False]),
    "MirrorAug": dict(p_mirror_prob=0.3, p_axes=[True, True, True], p_apply_extra_tensors=[True, True]),
    "NoiseAug": dict(p_stddev=0.01, p_clip=0.015, p_apply_extra_tensors=[True, True, False]),
    "LinearAug": dict(p_min_a=0.8, p_max_a=1.2, p_min_b=-0.1, p_max_b=0.1,
                      p_apply_extra_tensors=[False, True, False]),
    "TranslationAug": dict(p_max_aabb_ratio=np.array([0.5, 0.5, 0.0]),
                           p_apply_extra_tensors=[False, True, False]),
    "STDDevNormAug": dict(p_new_std=0.7, p_apply_extra_tensors=[True, False, False]),
    "DropAug": dict(p_drop_prob=0.2, p_keep_zeros=False, p_apply_extra_tensors=ALL_EXTRAS),
    "CropPtsAug": dict(p_max_pts=400, p_crop_ratio=0.9, p_apply_extra_tensors=ALL_EXTRAS),
    "CropBoxAug": dict(p_min_crop_size=0.6, p_max_crop_size=1.2, p_apply_extra_tensors=ALL_EXTRAS),
    "ElasticDistortionAug": dict(p_granularity=[0.2, 0.4], p_magnitude=[0.1, 0.3],
                                 p_apply_extra_tensors=ALL_EXTRAS),
}


def test_every_augmentation_is_covered():
    assert set(AUGS) == set(jaug.AugPipeline._REGISTRY) == set(taug.AugPipeline._REGISTRY)


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmentation_is_bitwise_the_jax_one(name, path):
    for seed in range(3):
        pts, extras = cloud(seed)
        j = getattr(jaug, name)(**AUGS[name])(np.random.default_rng(seed), pts.copy(),
                                              [e.copy() for e in extras])
        t = getattr(taug, name)(**AUGS[name])(np.random.default_rng(seed), pts.copy(),
                                              [e.copy() for e in extras])
        same(t, j, name)


def test_drop_keep_zeros_and_schedules_are_bitwise_the_jax_ones():
    pts, extras = cloud(7)
    specs = [("DropAug", dict(p_drop_prob=0.3, p_keep_zeros=True, p_apply_extra_tensors=ALL_EXTRAS)),
             ("RotationAug", dict(p_axis=2, p_angle_values=[0.1, 0.7])),
             ("LinearAug", dict(p_a_values=[[1.1], [0.9]], p_b_values=[[0.0], [0.2]]))]
    for name, kw in specs:
        ja, ta = getattr(jaug, name)(**kw), getattr(taug, name)(**kw)
        for _ in range(2):
            same(ta(np.random.default_rng(3), pts.copy(), list(extras)),
                 ja(np.random.default_rng(3), pts.copy(), list(extras)), name)
            ja.increase_epoch_counter()
            ta.increase_epoch_counter()


def test_crop_with_ties_at_the_cut_takes_the_sort():
    # a grid has many equal distances: the native selection refuses them
    g = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = g.astype(np.float32)
    d2 = ((pts - pts[100]) ** 2).sum(1)
    assert tnative.select_nearest(d2, 300) is None
    assert tnative.select_nearest(d2 + np.arange(len(d2), dtype=np.float32) * 1e-3, 300) is not None
    before = tnative.calls["select_nearest"]
    for seed in range(4):
        kw = dict(p_max_pts=300, p_apply_extra_tensors=[True])
        same(taug.CropPtsAug(**kw)(np.random.default_rng(seed), pts, [g]),
             jaug.CropPtsAug(**kw)(np.random.default_rng(seed), pts, [g]))
    assert tnative.calls["select_nearest"] == before


def test_native_select_keeps_what_the_sort_keeps():
    rng = np.random.default_rng(5)
    for n, k in ((1000, 300), (50, 49), (10, 10), (10, 20)):
        d2 = rng.uniform(size=n).astype(np.float32)
        keep = np.ones(n, bool)
        keep[np.argsort(d2)[k:]] = False
        np.testing.assert_array_equal(tnative.select_nearest(d2, k), keep)


AUG_MODULES = sorted(os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
                     for p in glob.glob(os.path.join(REPO, "configs", "*", "*_Aug*.py")))


def pipeline_input(module, seed):
    """A cloud and the extras the module's dataset passes (its flags' length)."""
    pts, (normals, rgb, labels) = cloud(seed, n=900, scale=(2.5, 2.0, 1.2))
    if "Color" in module:  # ScanNet colour pipeline: the colours are the points
        return rgb, []
    if "scannet" in module:
        return pts, [normals, rgb, labels]
    if "modelnet40" in module:
        return pts, [normals]
    return pts, []


@pytest.mark.parametrize("module", AUG_MODULES + ["MN40_BASE_AUGMENTATIONS"])
def test_aug_pipeline_of_each_module_is_bitwise_the_jax_one(module, path):
    if module == "MN40_BASE_AUGMENTATIONS":
        augs = jload.MN40_BASE_AUGMENTATIONS
        assert tload.MN40_BASE_AUGMENTATIONS == augs
    else:
        augs = importlib.import_module(module).DS_AUGMENTS
    jp, tp = jaug.AugPipeline(augs), taug.AugPipeline(augs)
    for seed in range(3):
        pts, extras = pipeline_input(module, seed)
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):  # one generator through two clouds
            same(tp.augment(tr, pts.copy(), [e.copy() for e in extras]),
                 jp.augment(jr, pts.copy(), [e.copy() for e in extras]), module)


def test_native_library_serves_the_scannet_pipeline():
    augs = importlib.import_module("configs.scannet.ScanNet_DS_Aug").DS_AUGMENTS
    before = dict(tnative.calls)
    pts, extras = cloud(0, n=5000, scale=(3.0, 2.5, 1.5))
    # 5000 points: CropPtsAug keeps 0.8 of them
    crop = [dict(a, p_max_pts=3000) if a["name"] == "CropPtsAug" else a for a in augs]
    rng = np.random.default_rng(1)
    for _ in range(4):
        taug.AugPipeline(crop).augment(rng, pts.copy(), list(extras))
    assert tnative.calls["elastic_distortion"] > before["elastic_distortion"]
    assert tnative.calls["select_nearest"] == before["select_nearest"] + 4


# --------------------------------------------------------------- collation


def samples(seed, sizes, scalar_label=False):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        s = {"positions": rng.standard_normal((n, 3)).astype(np.float32),
             "features": rng.standard_normal((n, 2)).astype(np.float32),
             "scene_id": np.int32(i), "mix3d": bool(rng.random() < 0.6)}
        if scalar_label:
            s["label"] = np.int32(rng.integers(40))
        else:
            s["labels"] = rng.integers(0, 21, n).astype(np.int32)
        out.append(s)
    return out


def test_pad_collate_and_pad_samples_to_are_bitwise_the_jax_ones():
    for sizes, cap in (((30, 17, 41), None), ((5, 9), 64), ((1000,), None)):
        for scalar in (False, True):
            s = samples(1, sizes, scalar)
            same(tload.pad_collate(s, capacity=cap, bucket=256),
                 jload.pad_collate(s, capacity=cap, bucket=256))
            same(tload.pad_samples_to(list(s), len(s) + 2), jmulti.pad_samples_to(list(s), len(s) + 2))
            same(tload.pad_samples_to([], 2, template=s[0]), jmulti.pad_samples_to([], 2, template=s[0]))
    with pytest.raises(ValueError):
        tload.pad_collate(samples(0, (70,)), capacity=64)
    with pytest.raises(ValueError):
        tload.pad_samples_to(samples(0, (3, 4)), 1)
    assert tload.round_up_bucket(1025) == jload.round_up_bucket(1025) == 2048


def test_mix3d_merge_is_bitwise_the_jax_one():
    for seed in range(4):
        s = samples(seed, (30, 17, 41, 12, 50))
        for cap in (None, 64, 100):
            same(tload.mix3d_merge(s, capacity=cap), jload.mix3d_merge(s, capacity=cap))


# ---------------------------------------------------------------- datasets


def test_dfaust_dataset_is_bitwise_the_jax_one(tmp_path):
    root = write_dfaust(tmp_path, n_train=3, n_test=2, n_pts=120)
    augs = importlib.import_module("configs.dfaust.DFaust_DS_Aug_SO3").DS_AUGMENTS
    for split in ("train", "test"):
        j = jload.DFaustDataset(root, augs, num_pts=100, split=split)
        t = tload.DFaustDataset(root, augs, num_pts=100, split=split)
        assert len(t) == len(j)
        for _ in range(2):
            for i in range(len(j)):
                same(t[i], j[i], f"{split}[{i}]")
    labels = tload.DFaustDataset(root, (), num_pts=120)[0]["labels"]
    assert labels.max() <= 19 and labels.dtype == np.int32


def test_modelnet40_dataset_reads_its_npz_cache_bitwise_as_jax_reads_the_txt(tmp_path):
    root = write_modelnet(tmp_path / "port")
    jroot = write_modelnet(tmp_path / "jax")
    augs = importlib.import_module("configs.modelnet40.MN40_DS_Aug").DS_AUGMENTS
    first = tload.ModelNet40Dataset(root, augs, num_pts=64, split="train")
    assert not first.from_cache and os.path.exists(os.path.join(root, "tmp_train_64.npz"))
    t = tload.ModelNet40Dataset(root, augs, num_pts=64, split="train")
    assert t.from_cache and not any(p.endswith(".h5") for p in os.listdir(root))
    j = jload.ModelNet40Dataset(jroot, augs, num_pts=64, split="train", create_tmp_file=False)
    assert len(t) == len(j) == 6 and t.class_names == j.class_names
    for arr in ("pts", "normals", "model_class"):
        same(getattr(t, arr), getattr(j, arr), arr)
        same(getattr(first, arr), getattr(j, arr), arr)
    for _ in range(2):
        for i in range(len(j)):
            same(t[i], j[i], f"train[{i}]")
    for kw in (dict(use_ones_features=False), dict(use_ones_features=False, use_coords_as_features=False)):
        tt = tload.ModelNet40Dataset(root, (), num_pts=64, split="test", **kw)
        jj = jload.ModelNet40Dataset(jroot, (), num_pts=64, split="test", create_tmp_file=False, **kw)
        same(tt[1], jj[1])


@pytest.mark.parametrize("segments", [False, True])
def test_scannet_dataset_and_sampler_are_bitwise_the_jax_ones(tmp_path, segments, path):
    root = write_scannet(tmp_path, n_train=4, n_val=2, n_pts=(600, 1500))
    geo = [dict(a, p_max_pts=700) if a["name"] == "CropPtsAug" else a
           for a in importlib.import_module("configs.scannet.ScanNet_DS_Aug").DS_AUGMENTS]
    geo.append({"name": "CropBoxAug", "p_prob": 0.5, "p_min_crop_size": 1.0,
                "p_max_crop_size": 2.0, "p_apply_extra_tensors": [True, True, True, True]})
    color = importlib.import_module("configs.scannet.ScanNet_Color_DS_Aug").DS_AUGMENTS
    kw = dict(dataset="scannet20", augmentations=geo, color_augmentations=color, prob_mix3d=0.5,
              split="train", load_segments=segments)
    j, t = jload.ScanNetDataset(root, **kw), tload.ScanNetDataset(root, **kw)
    assert t.mask_classes == j.mask_classes == [0] and len(t) == len(j) == 4
    for _ in range(2):
        for i in range(len(j)):
            same(t[i], j[i], f"scene {i}")
    for budget, scenes, max_pts, ratio in ((2500, 0, 800, 1.0), (1500, 1, 0, 0.8)):
        sk = dict(num_batches=5, max_points_per_batch=budget, max_scenes_per_batch=scenes,
                  max_scene_pts=max_pts, pts_crop_ratio=ratio, seed=11)
        js = jload.MaxPointsBatchSampler(dataset=j, **sk)
        ts = tload.MaxPointsBatchSampler(dataset=t, **sk)
        assert len(ts) == len(js) == 5
        for _ in range(2):  # the two-list bookkeeping carries over epochs
            assert [list(map(int, b)) for b in ts] == [list(map(int, b)) for b in js]
    val = dict(kw, split="val", augmentations=(), color_augmentations=(), prob_mix3d=0.0)
    same(tload.ScanNetDataset(root, **val)[1], jload.ScanNetDataset(root, **val)[1])


def test_native_voxel_keys_and_crop_are_the_jax_librarys():
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 2, (700, 3)).astype(np.float32)
    same(tnative.voxel_keys(pts, 0.3), jnative.voxel_keys(pts, 0.3))
    for seed in (1, 7):
        same(tnative.crop_nearest(pts, 200, seed), jnative.crop_nearest(pts, 200, seed))
    same(tnative.elastic_distortion(pts, [0.5], [0.1], seed=3),
         jnative.elastic_distortion(pts, [0.5], [0.1], seed=3))
