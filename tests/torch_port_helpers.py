"""Shared helpers of the port's parity tests: the JAX package's random draws
and hierarchies carried over to the PyTorch port as tensors, the tiny
FPNSegUNetMLPGeluRotEqFAUST that the whole-model tests share, and the
interceptor that captures a JAX train step's gradients and DropPath draws."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from se3conv3d_tpu.nn.blocks import DropPath as JDropPath
from se3conv3d_tpu.nn.norm import MaskedBatchNorm as JBatchNorm

from se3conv3d_tpu_torch.core.grid import SubsampleMap
from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, HierarchyDraws
from se3conv3d_tpu_torch.core.pointcloud import PointCloud


def t(x):
    """numpy / jax array -> torch tensor (a copy; int32 indices widen to int64)."""
    if x is None:
        return None
    a = np.array(x)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def to_torch_cloud(pc) -> PointCloud:
    return PointCloud(t(pc.positions), t(pc.mask), t(pc.frames))


def to_torch_map(m) -> SubsampleMap:
    return SubsampleMap(t(m.cell_id), t(m.src_mask), t(m.n_cells), t(m.out_mask),
                        t(m.chosen_idx), m.rnd)


def to_torch_hierarchy(h) -> Hierarchy:
    return Hierarchy(
        tuple(to_torch_cloud(p) for p in h.levels),
        tuple(to_torch_map(m) for m in h.maps),
        h.levels_radii,
    )


def jax_frame_draws(key, fcfg, batch: int, cap: int) -> torch.Tensor:
    """The draws ``se3conv3d_tpu.core.hierarchy.attach_frames(key, ...)``
    makes for a cloud ``[batch, cap]``, in the port's injected form
    (``se3conv3d_tpu_torch.core.hierarchy.draw_frames``)."""
    s = 2 if fcfg.fixed_axis else 4
    f = fcfg.n_frames
    if not fcfg.pca:
        if fcfg.fixed_axis:  # planar_rotations: one uniform angle per (b, n, f)
            return t(jax.random.uniform(key, (batch * cap * f,))).reshape(batch, cap, f)
        # random_quaternions: one normal 4-vector per (b, n, f)
        return t(jax.random.normal(key, (batch * cap * f, 4))).reshape(batch, cap, f, 4)
    if fcfg.global_frames:  # shuffle_and_select_frames over [B, 4] candidates
        return t(jax.random.uniform(key, (batch, s)))
    return t(jax.random.uniform(key, (batch, cap, s)))


def jax_hierarchy_draws(key, cfg, batch: int, n: int) -> HierarchyDraws:
    """The random numbers ``se3conv3d_tpu.core.hierarchy.build_hierarchy(key,
    ...)`` draws, in the port's injected form (no frame draws where
    ``cfg.frames`` is None: the standard models)."""
    num = cfg.num_levels
    keys = jax.random.split(key, 2 * num + 2)
    caps = cfg.resolve_capacities(n)
    out_cap = cfg.out_capacity or n
    rngs = jax.random.split(keys[num], batch)
    framed = cfg.frames is not None
    return HierarchyDraws(
        level_frames=[jax_frame_draws(keys[i], cfg.frames, batch, caps[i]) for i in range(num)]
        if framed else [],
        out_uniforms=t(jnp.stack([jax.random.uniform(r, (out_cap,)) for r in rngs])),
        out_frames=jax_frame_draws(keys[num + 1], cfg.frames, batch, out_cap) if framed else None,
    )


# the tiny model of the whole-model tests: two trunk levels, widths <= 16
TINY = dict(patch_num_levels=1, patch_num_features=(8,), num_blocks=(1, 1),
            num_features=(8, 16), fpn_dec_feats=8, max_neighbors=8)
HCFG = dict(init_cell_size=0.08, cell_sizes=(0.16, 0.32), capacities=(128, 64, 32),
            out_cell_size=0.1, out_capacity=128)
NUM_CLASSES = 5


def tiny_batch(seed=0, b=2, n=200):
    """``(positions, mask, features, labels)`` numpy arrays; the second
    cloud has a masked tail of 30 points."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32)
    pts[..., 1] *= 1.5
    mask = np.arange(n)[None] < np.array([n, n - 30])[:, None]
    feats = rng.normal(size=(b, n, 1)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, size=(b, n)).astype(np.int32)
    return pts, mask, feats, labels


def randomize(tree, rng):
    """Non-trivial values for every leaf that init leaves degenerate
    (skip gammas 1e-6, BN identity), so every layer shows in the logits."""
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "gamma":
            return (rng.normal(size=x.shape) * 0.5).astype(x.dtype)
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, size=x.shape).astype(x.dtype)
        if name in ("bias", "mean", "proj_biases"):
            return (rng.normal(size=x.shape) * 0.1).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


# --- capturing a JAX train step ---------------------------------------------


def capture_grads():
    """An optax transformation that applies no update and keeps the
    gradients as its state, so the JAX train step hands them back."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def droppath_interceptor(order, reference_bn):
    """Records each train-mode DropPath draw (as ``batch_stats`` variable
    ``keep``, in trace order) and, with ``reference_bn``, gives
    ``MaskedBatchNorm`` the reference's (valid points x frames) row count."""

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if isinstance(mod, JDropPath) and args[1] and mod.drop_prob > 0.0:
            x = args[0]
            keep = 1.0 - mod.drop_prob
            u = jax.random.uniform(mod.make_rng("droppath"), (x.shape[0],) + (1,) * (x.ndim - 1), x.dtype)
            mask = jnp.floor(keep + u)
            mod.put_variable("batch_stats", "keep", mask.reshape(x.shape[0]))
            order.append(mod.scope.path)
            return x / keep * mask
        if reference_bn and isinstance(mod, JBatchNorm) and args[2] and not mod.is_initializing():
            x, mask = args[0], args[1]
            rows = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).astype(x.dtype)
            rows = jnp.broadcast_to(rows, x.shape[:-1] + (1,))
            axes = tuple(range(x.ndim - 1))
            count = jnp.maximum(jnp.sum(rows), 1.0)
            mean = jnp.sum(x * rows, axis=axes) / count
            var = jnp.sum(rows * (x - mean) ** 2, axis=axes) / count
            unbiased = var * (count / jnp.maximum(count - 1.0, 1.0))
            mom = mod.momentum
            mod.put_variable("batch_stats", "mean",
                             (1 - mom) * mod.get_variable("batch_stats", "mean") + mom * mean)
            mod.put_variable("batch_stats", "var",
                             (1 - mom) * mod.get_variable("batch_stats", "var") + mom * unbiased)
            y = (x - mean) * jax.lax.rsqrt(var + mod.eps)
            return y * mod.get_variable("params", "scale") + mod.get_variable("params", "bias")
        return next_fun(*args, **kwargs)

    return intercept


def flat_tree(tree):
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {".".join(p.key for p in path): np.asarray(x) for path, x in flat}


def pop_keep_masks(batch_stats, order):
    """Remove the recorded keep masks from ``batch_stats``; returns them in
    call order."""
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(batch_stats))
    masks = []
    for path in order:
        node = stats
        for name in path[:-1]:
            node = node[name]
        masks.append(node[path[-1]].pop("keep"))
        if not node[path[-1]]:
            del node[path[-1]]
    return masks, stats


# --- on-disk dataset fixtures, in each loader's format ------------------------


def write_dfaust(root, n_train=4, n_test=2, n_pts=96, seed=0):
    """DFaust ``{train,test}/model_{i}_{pc,labels}.pt`` (labels 0..21, so the
    loader's shift of labels above 9 shows)."""
    import os
    rng = np.random.default_rng(seed)
    for split, n_models in (("train", n_train), ("test", n_test)):
        d = os.path.join(str(root), split)
        os.makedirs(d, exist_ok=True)
        for i in range(n_models):
            pts = rng.standard_normal((n_pts, 3)).astype(np.float32) * 0.3
            pts[:, 1] *= 2.5
            labels = rng.integers(0, 22, n_pts).astype(np.int64)
            torch.save(torch.from_numpy(pts), os.path.join(d, f"model_{i}_pc.pt"))
            torch.save(torch.from_numpy(labels), os.path.join(d, f"model_{i}_labels.pt"))
    return str(root)


def write_modelnet(root, classes=("airplane", "night_stand", "car"), per_class=(2, 1),
                   n_pts=80, seed=1):
    """ModelNet40 txt format: ``modelnet40_shape_names.txt``, the split lists
    and ``{class}/{class}_{k:04d}.txt`` rows ``x,y,z,nx,ny,nz``;
    ``per_class`` shapes of each class for (train, test)."""
    import os
    rng = np.random.default_rng(seed)
    root = str(root)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    k = 0
    for split, count in zip(("train", "test"), per_class):
        names = []
        for cls in classes:
            os.makedirs(os.path.join(root, cls), exist_ok=True)
            for _ in range(count):
                k += 1
                name = f"{cls}_{k:04d}"
                data = rng.standard_normal((n_pts, 6)).astype(np.float32)
                np.savetxt(os.path.join(root, cls, name + ".txt"), data, delimiter=",")
                names.append(name)
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def write_scannet(root, n_train=3, n_val=2, n_pts=(400, 700), seed=0, segments=True):
    """ScanNet npz scenes (``points``, ``normals``, ``colors``,
    ``labels_20``) under ``{train,val}/``, the split lists,
    ``color_stats.txt`` and, with ``segments``, ``segments/*_seg.npz``;
    scene i holds ``n_pts[0] + i * step`` points in a room of 3 x 2.5 x 1.5."""
    import os
    rng = np.random.default_rng(seed)
    root = str(root)
    os.makedirs(os.path.join(root, "segments"), exist_ok=True)
    with open(os.path.join(root, "color_stats.txt"), "w") as f:
        f.write("0.5,0.45,0.4\n0.25,0.2,0.3\n")
    k = 0
    for split, count in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        names = []
        for i in range(count):
            n = int(np.linspace(n_pts[0], n_pts[1], max(count, 2))[i])
            name = f"scene{k:04d}_00"
            k += 1
            pts = rng.uniform(0, 1, (n, 3)) * np.array([3.0, 2.5, 1.5])
            np.savez(os.path.join(root, split, name + ".npz"),
                     points=pts.astype(np.float32),
                     normals=rng.standard_normal((n, 3)).astype(np.float32),
                     colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                     labels_20=rng.integers(0, 21, n).astype(np.int32))
            if segments:
                np.savez(os.path.join(root, "segments", name + "_seg.npz"),
                         segments=rng.integers(0, 40, n).astype(np.int64))
            names.append(name)
        with open(os.path.join(root, f"scannet_{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


# --- tiny recipes of the run-loop tests (each loader's dataset, tiny capacities) ---

RF_PCA = {"pca": True, "neigh_method": "knn", "neigh_kwargs": {"neigh_k": 8}, "fixed_axis": False,
          "train_n_frames": 1, "test_n_frames": 1}
TRAINING = {"num_epochs": 3, "weight_decay": 0.0001, "max_lr": 0.005, "pct_start": 0.3,
            "div_factor": 10.0, "final_div_factor": 1000.0, "clip_grads": 100.0,
            "label_smoothing": 0.2, "save_models_frequency": 1, "val_freq": 1}


def dfaust_recipe(mix=False):
    rf = dict(RF_PCA, pca=not mix, mix_n_frames={4: 0.15, 2: 0.35, 1: 0.5}) if mix else RF_PCA
    return {
        "Training": dict(TRAINING, batch_size=2),
        "Dataset": {"dataset": "dfaust", "num_points": 96,
                    "train_aug_file": "configs.dfaust.DFaust_DS_Aug_SO3",
                    "test_aug_file": "configs.dfaust.DFaust_DS_Aug_Val"},
        "Model": {"model": "FPNSegUNetMLPGeluRotEqFAUST", "max_drop_path": 0.2,
                  "init_subsample": 0.1, "output_subsample": 0.12,
                  "grid_subsamples": [0.2, 0.4, 0.6, 0.8], "capacities": [96, 48, 24, 16, 8],
                  "out_capacity": 96, "max_neighbors": 8, "RefFrames": rf},
    }


def modelnet_recipe():
    return {
        "Training": dict(TRAINING, batch_size=2, div_factor=100.0, final_div_factor=10000.0),
        "Dataset": {"dataset": "modelnet40", "num_points": 64,
                    "train_aug_file": "configs.modelnet40.MN40_DS_Aug",
                    "test_aug_file": "configs.modelnet40.MN40_DS_Aug_test"},
        "Model": {"model": "ClassNetRotEquivMLPGELU19Former", "max_drop_path": 0.2,
                  "init_subsample": 0.05, "grid_subsamples": [0.1, 0.2, 0.4, 0.8, 1.2],
                  "capacities": [64, 64, 32, 16, 8, 8], "max_neighbors": 8,
                  "RefFrames": dict(RF_PCA, train_n_frames=2, test_n_frames=2)},
    }


def scannet_recipe():
    return {
        "Training": dict(TRAINING, num_batches=3, pts_per_batch=2000, scan_scenes=True),
        "Dataset": {"dataset": "scannet20", "train_split": "train", "test_split": "val",
                    "train_aug_file": "configs.scannet.ScanNet_DS_Aug",
                    "train_aug_color_file": "configs.scannet.ScanNet_Color_DS_Aug",
                    "test_aug_file": "configs.scannet.ScanNet_DS_Aug_Val",
                    "test_aug_color_file": "None", "prob_mix3d": 0.5,
                    "train_scene_crop_ratio": 0.8, "train_scene_max_pts": 900},
        "Model": {"model": "FPNSegUNetMLPGeluRotEqScanNet", "compute_dtype": "bfloat16",
                  "max_drop_path": 0.2, "init_subsample": 0.1, "output_subsample": 0.1,
                  "grid_subsamples": [0.2, 0.4, 0.8, 1.6], "capacities": [1024, 256, 64, 32, 32],
                  "out_capacity": 1024, "max_neighbors": 8,
                  "RefFrames": dict(RF_PCA, fixed_axis=2)},
    }
