"""Dataset loaders + padded-batch collation (host side, numpy), copied
from ``se3conv3d_tpu/data/loaders.py`` so the port imports nothing of the
JAX package; the same files and seeds give the same bits in both.

Counterparts of reference ``data_sets/loaders/``: ``ModelNet40DS`` (txt ->
cache), ``DFaustDS`` (torch ``.pt`` point/label pairs), ``ScanNetDS``
(npz scenes preloaded to RAM, color normalisation, geometric + color aug
pipelines, valid-id tracking through crops, Mix3D scene mixing) and
``ScanNetMaxPtsSampler`` (point-budget batch packing).  Batches are padded
``[B, N_cap, ...]`` arrays with masks, as in the JAX package.

The one departure: ``ModelNet40Dataset`` caches the parsed txt files as
``tmp_{split}_{num_pts}.npz`` (numpy), where the JAX package writes
``tmp_{split}_{num_pts}.h5``, an HDF5 file, which would need a package the
port does not use.  Also here: :func:`pad_samples_to`, the single-process
part of ``se3conv3d_tpu/parallel/multihost.py:pad_samples_to``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .augment import AugPipeline

__all__ = [
    "pad_collate",
    "round_up_bucket",
    "ModelNet40Dataset",
    "DFaustDataset",
    "ScanNetDataset",
    "MaxPointsBatchSampler",
    "mix3d_merge",
    "pad_samples_to",
    "MN40_BASE_AUGMENTATIONS",
    "SCANNET20_CLASS_NAMES",
    "DFAUST_CLASS_NAMES",
]

# Reference ``loaders/ModelNet40.py:9-53``.
MN40_BASE_AUGMENTATIONS = [
    {"name": "CenterAug", "p_apply_extra_tensors": [False]},
    {"name": "RotationAug", "p_prob": 1.0, "p_axis": 0,
     "p_min_angle": -np.pi / 24.0, "p_max_angle": np.pi / 24.0,
     "p_apply_extra_tensors": [True]},
    {"name": "RotationAug", "p_prob": 1.0, "p_axis": 2,
     "p_min_angle": -np.pi / 24.0, "p_max_angle": np.pi / 24.0,
     "p_apply_extra_tensors": [True]},
    {"name": "NoiseAug", "p_prob": 1.0, "p_stddev": 0.01,
     "p_apply_extra_tensors": [False]},
    {"name": "LinearAug", "p_prob": 1.0, "p_min_a": 0.9, "p_max_a": 1.1,
     "p_min_b": 0.0, "p_max_b": 0.0, "p_channel_independent": True,
     "p_apply_extra_tensors": [False]},
    {"name": "MirrorAug", "p_prob": 1.0, "p_mirror_prob": 0.5,
     "p_axes": [True, False, True], "p_apply_extra_tensors": [True]},
]

# Reference ``loaders/ScanNet.py:211-216``.
# Official ScanNet-200 class list (reference ScanNet.py:217-228).
SCANNET200_CLASS_NAMES = ['unannotated', 'wall', 'chair', 'floor', 'table', 'door', 'couch', 'cabinet', 'shelf', 'desk', 'office chair', 'bed', 'pillow', 'sink', 'picture', 'window', 'toilet', 'bookshelf', 'monitor', 'curtain', 'book', 'armchair', 'coffee table', 'box', 'refrigerator', 'lamp', 'kitchen cabinet', 'towel', 'clothes', 'tv', 'nightstand', 'counter', 'dresser', 'stool', 'cushion', 'plant', 'ceiling', 'bathtub', 'end table', 'dining table', 'keyboard', 'bag', 'backpack', 'toilet paper', 'printer', 'tv stand', 'whiteboard', 'blanket', 'shower curtain', 'trash can', 'closet', 'stairs', 'microwave', 'stove', 'shoe', 'computer tower', 'bottle', 'bin', 'ottoman', 'bench', 'board', 'washing machine', 'mirror', 'copier', 'basket', 'sofa chair', 'file cabinet', 'fan', 'laptop', 'shower', 'paper', 'person', 'paper towel dispenser', 'oven', 'blinds', 'rack', 'plate', 'blackboard', 'piano', 'suitcase', 'rail', 'radiator', 'recycling bin', 'container', 'wardrobe', 'soap dispenser', 'telephone', 'bucket', 'clock', 'stand', 'light', 'laundry basket', 'pipe', 'clothes dryer', 'guitar', 'toilet paper holder', 'seat', 'speaker', 'column', 'bicycle', 'ladder', 'bathroom stall', 'shower wall', 'cup', 'jacket', 'storage bin', 'coffee maker', 'dishwasher', 'paper towel roll', 'machine', 'mat', 'windowsill', 'bar', 'toaster', 'bulletin board', 'ironing board', 'fireplace', 'soap dish', 'kitchen counter', 'doorframe', 'toilet paper dispenser', 'mini fridge', 'fire extinguisher', 'ball', 'hat', 'shower curtain rod', 'water cooler', 'paper cutter', 'tray', 'shower door', 'pillar', 'ledge', 'toaster oven', 'mouse', 'toilet seat cover dispenser', 'furniture', 'cart', 'storage container', 'scale', 'tissue box', 'light switch', 'crate', 'power outlet', 'decoration', 'sign', 'projector', 'closet door', 'vacuum cleaner', 'candle', 'plunger', 'stuffed animal', 'headphones', 'dish rack', 'broom', 'guitar case', 'range hood', 'dustpan', 'hair dryer', 'water bottle', 'handicap bar', 'purse', 'vent', 'shower floor', 'water pitcher', 'mailbox', 'bowl', 'paper bag', 'alarm clock', 'music stand', 'projector screen', 'divider', 'laundry detergent', 'bathroom counter', 'object', 'bathroom vanity', 'closet wall', 'laundry hamper', 'bathroom stall door', 'ceiling light', 'trash bin', 'dumbbell', 'stair rail', 'tube', 'bathroom cabinet', 'cd case', 'closet rod', 'coffee kettle', 'structure', 'shower head', 'keyboard piano', 'case of water bottles', 'coat rack', 'storage organizer', 'folded chair', 'fire alarm', 'power strip', 'calendar', 'poster', 'potted plant', 'luggage', 'mattress']

SCANNET20_CLASS_NAMES = [
    "unannotated", "wall", "floor", "cabinet", "bed", "chair", "sofa",
    "table", "door", "window", "bookshelf", "picture", "counter", "desk",
    "curtain", "refrigerator", "shower curtain", "toilet", "sink",
    "bathtub", "otherfurniture",
]

# Reference ``loaders/AMASS_DFAUST.py:120-142`` (labels 10, 11, 22 removed).
DFAUST_CLASS_NAMES = [
    "butt", "left_thigh", "right_thigh", "mid_belly", "left_calf",
    "right_calf", "upper_belly", "right_foot", "left_foot", "upper_thorax",
    "neck", "right_shoulder", "left_shoulder", "head", "right_upper_arm",
    "left_upper_arm", "right_forearm", "left_forearm", "right_hand",
    "left_hand",
]


def round_up_bucket(n: int, bucket: int = 1024) -> int:
    return ((n + bucket - 1) // bucket) * bucket


def pad_collate(
    samples: Sequence[Dict[str, np.ndarray]],
    capacity: Optional[int] = None,
    bucket: int = 1024,
) -> Dict[str, np.ndarray]:
    """Stack variable-length samples into a padded batch with a mask.

    Each sample dict has ``positions [n, 3]`` plus optional per-point
    arrays (``features``, ``labels``, ``segments``, ``valid_ids``) and
    optional scalars (``label``, ``scene_id``).  Per-point int arrays pad
    with 0 (mask them downstream).
    """
    ns = [s["positions"].shape[0] for s in samples]
    cap = capacity if capacity is not None else round_up_bucket(max(ns), bucket)
    if max(ns) > cap:
        raise ValueError(
            f"sample with {max(ns)} points exceeds the batch capacity "
            f"{cap}; crop upstream or evaluate it at a larger capacity "
            "bucket (SegmentationVoter does this automatically)"
        )
    b = len(samples)
    out: Dict[str, np.ndarray] = {}
    out["mask"] = np.zeros((b, cap), bool)
    for i, n in enumerate(ns):
        out["mask"][i, :n] = True

    per_point = [
        k for k in samples[0]
        if isinstance(samples[0][k], np.ndarray)
        and samples[0][k].ndim >= 1
        and samples[0][k].shape[0] == ns[0]
    ]
    for k in per_point:
        first = samples[0][k]
        shape = (b, cap) + first.shape[1:]
        buf = np.zeros(shape, first.dtype)
        for i, s in enumerate(samples):
            buf[i, : ns[i]] = s[k]
        out[k] = buf

    for k in samples[0]:
        if k not in per_point:
            out[k] = np.asarray([s[k] for s in samples])
    return out


class ModelNet40Dataset:
    """ModelNet40 (normal-resampled txt format) with an npz cache.

    Reference ``loaders/ModelNet40.py:80-201``: per-sample txt
    ``x,y,z,nx,ny,nz`` truncated to ``num_pts``.  The reference LOADER
    returns normals(+coords) as features, but every shipped
    classification task replaces them with constant ones before the
    model (``tasks/Classification/train_rot.py:117-120``,
    ``train_standard.py:134``) — global-frame normal vectors in the
    feature channel would break the rot-equivariant path's invariance
    under SO(3) test rotations (measured: a 25-pt accuracy gap on the
    synthetic 40-class set).  ``use_ones_features=True`` (the default)
    reproduces the task behavior; set it False for the loader-level
    normals(+coords) payload.

    The parsed files are cached in ``tmp_{split}_{num_pts}.npz`` (arrays
    ``points``, ``normals``, ``model_class``) beside them, read on later
    runs (``from_cache``); the JAX package keeps the same arrays in HDF5.
    """

    def __init__(
        self,
        data_folder: str,
        augmentations: Sequence[dict] = (),
        num_pts: int = 1024,
        split: str = "train",
        create_tmp_file: bool = True,
        use_coords_as_features: bool = True,
        use_ones_features: bool = True,
        seed: int = 0,
    ):
        self.path = data_folder
        self.num_pts = num_pts
        self.coords_as_features = use_coords_as_features
        self.ones_features = use_ones_features
        self.aug = AugPipeline(augmentations) if augmentations else None
        self.rng = np.random.default_rng(seed)

        with open(os.path.join(data_folder, "modelnet40_shape_names.txt")) as f:
            self.class_names = [l.rstrip() for l in f]

        tmp = os.path.join(data_folder, f"tmp_{split}_{num_pts}.npz")
        self.from_cache = os.path.exists(tmp)
        if self.from_cache:
            with np.load(tmp) as cached:
                self.pts = cached["points"]
                self.normals = cached["normals"]
                self.model_class = cached["model_class"]
        else:
            with open(os.path.join(data_folder, f"modelnet40_{split}.txt")) as f:
                file_list = [l.rstrip() for l in f]
            pts, normals, classes = [], [], []
            for name in file_list:
                cls = "_".join(name.split("_")[:-1])
                data = np.loadtxt(
                    os.path.join(data_folder, cls, name + ".txt"), delimiter=","
                )[:num_pts].astype(np.float32)
                pts.append(data[:, 0:3])
                normals.append(data[:, 3:])
                classes.append(self.class_names.index(cls))
            self.pts = np.asarray(pts, np.float32)
            self.normals = np.asarray(normals, np.float32)
            self.model_class = np.asarray(classes, np.int32)
            if create_tmp_file:
                # written whole under another name, then renamed: a reader
                # never finds half a cache
                part = tmp[: -len(".npz")] + f".{os.getpid()}.part.npz"
                np.savez(part, points=self.pts, normals=self.normals,
                         model_class=self.model_class)
                os.replace(part, tmp)

    def __len__(self):
        return len(self.pts)

    def increase_epoch_counter(self):
        if self.aug:
            self.aug.increase_epoch_counter()

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        pts = self.pts[idx].copy()
        normals = self.normals[idx].copy()
        if self.aug:
            pts, _, extras = self.aug.augment(self.rng, pts, [normals])
            normals = extras[0]
        if self.ones_features:
            feats = np.ones((pts.shape[0], 1), np.float32)
        elif self.coords_as_features:
            feats = np.concatenate([normals, pts], -1)
        else:
            feats = normals
        return {
            "positions": pts.astype(np.float32),
            "features": feats.astype(np.float32),
            "label": np.int32(self.model_class[idx]),
            "scene_id": np.int32(idx),
        }


class DFaustDataset:
    """DFaust/AMASS body-part segmentation point clouds.

    Reference ``loaders/AMASS_DFAUST.py:83-196``: ``model_{i}_pc.pt`` /
    ``model_{i}_labels.pt`` torch files, labels > 9 remapped by -2
    (classes 10/11/22 unused), constant-1 features; train split =
    ``train/`` dir (DFaust), test = ``test/`` (MPI_Limits OOD).
    """

    def __init__(
        self,
        data_folder: str,
        augmentations: Sequence[dict] = (),
        num_pts: int = 1024,
        split: str = "train",
        seed: int = 0,
    ):
        sub = "train" if split == "train" else "test"
        self.path = os.path.join(data_folder, sub)
        self.num_pts = num_pts
        files = [f for f in os.listdir(self.path) if f.endswith(".pt")]
        self.length = len(files) // 2
        self.aug = AugPipeline(augmentations) if augmentations else None
        self.rng = np.random.default_rng(seed)
        self.class_names = DFAUST_CLASS_NAMES

    def __len__(self):
        return self.length

    def increase_epoch_counter(self):
        if self.aug:
            self.aug.increase_epoch_counter()

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        pts = (
            torch.load(
                os.path.join(self.path, f"model_{idx}_pc.pt"), map_location="cpu",
                weights_only=True,
            )
            .numpy()
            .astype(np.float32)[: self.num_pts]
        )
        labels = (
            torch.load(
                os.path.join(self.path, f"model_{idx}_labels.pt"), map_location="cpu",
                weights_only=True,
            )
            .numpy()
            .astype(np.int64)[: self.num_pts]
        )
        labels = np.where(labels > 9, labels - 2, labels)
        if self.aug:
            pts, _, _ = self.aug.augment(self.rng, pts, [])
        return {
            "positions": pts,
            "features": np.ones((pts.shape[0], 1), np.float32),
            "labels": labels.astype(np.int32),
            "scene_id": np.int32(idx),
        }


class ScanNetDataset:
    """ScanNet semantic segmentation scenes (npz, preloaded to RAM).

    Reference ``loaders/ScanNet.py:151-420``: color normalisation from
    ``color_stats.txt``, scannet20/200 class lists, geometric + color aug
    pipelines, valid-point-id tracking through crop augs, per-scene Mix3D
    coin flip.
    """

    def __init__(
        self,
        data_folder: str,
        dataset: str = "scannet20",
        augmentations: Sequence[dict] = (),
        color_augmentations: Sequence[dict] = (),
        prob_mix3d: float = 0.8,
        split: str = "train",
        load_segments: bool = False,
        pt_coords_as_feats: bool = False,
        scale_pt_feats: float = 1.0 / 5.0,
        seed: int = 0,
    ):
        self.path = data_folder
        self.dataset = dataset
        self.split = split
        self.prob_mix3d = prob_mix3d
        self.load_segments = load_segments
        self.pt_coords_as_feats = pt_coords_as_feats
        self.scale_pt_feats = scale_pt_feats
        self.data_aug_enabled = True
        self.aug = AugPipeline(augmentations) if augmentations else None
        self.color_aug = (
            AugPipeline(color_augmentations) if color_augmentations else None
        )
        self.rng = np.random.default_rng(seed)
        if dataset == "scannet200":
            self.class_names = list(SCANNET200_CLASS_NAMES)
        else:
            self.class_names = list(SCANNET20_CLASS_NAMES)
        self.mask_classes = [0]
        if dataset == "scannet200" and "train" not in split:
            # classes absent from the val/test annotation set are masked
            # out of metrics (reference ScanNet.py:231-237)
            only_train = [
                "bicycle", "storage container", "candle", "guitar case",
                "purse", "alarm clock", "music stand", "cd case",
                "structure", "storage organizer", "luggage",
            ]
            self.mask_classes += [
                self.class_names.index(c) for c in only_train
            ]

        with open(os.path.join(data_folder, "color_stats.txt")) as f:
            lines = f.readlines()
        self.color_mean = np.asarray(
            [float(x) for x in lines[0].rstrip().split(",")[:3]]
        )
        self.color_std = np.asarray(
            [float(x) for x in lines[1].rstrip().split(",")[:3]]
        )

        # Per-class frequency stats (reference ``ScanNet.py:256-263``).
        # Loaded-but-unused there too (no shipped task consumes them);
        # exposed for class-balanced losses, optional like the reference.
        stats_file = os.path.join(
            data_folder,
            "label_20_stats.txt" if dataset == "scannet20" else "label_200_stats.txt",
        )
        self.label_stats = None
        if os.path.exists(stats_file):
            with open(stats_file) as f:
                self.label_stats = np.asarray(
                    [float(l.rstrip()) for l in f], np.float32
                )

        self.file_list: List[str] = []
        self.scenes: List[dict] = []
        splits = ["train", "val"] if split == "train+val" else [split]
        for sp in splits:
            with open(os.path.join(data_folder, f"scannet_{sp}.txt")) as f:
                names = [l.rstrip() for l in f]
            for name in names:
                m = np.load(os.path.join(data_folder, sp, name + ".npz"))
                scene = {
                    "points": m["points"].astype(np.float32),
                    "normals": m["normals"].astype(np.float32),
                    "colors": m["colors"].astype(np.float32),
                }
                if load_segments:
                    seg = np.load(
                        os.path.join(data_folder, "segments", name + "_seg.npz")
                    )
                    _, seg_ids = np.unique(seg["segments"], return_inverse=True)
                    scene["segments"] = seg_ids.astype(np.int32)
                if sp != "test":
                    key = "labels_20" if dataset == "scannet20" else "labels_200"
                    scene["labels"] = m[key].astype(np.int32)
                self.file_list.append(name)
                self.scenes.append(scene)

    def __len__(self):
        return len(self.scenes)

    def get_num_pts(self, idx: int) -> int:
        return self.scenes[idx]["points"].shape[0]

    def increase_epoch_counter(self):
        for p in (self.aug, self.color_aug):
            if p:
                p.increase_epoch_counter()

    def enable_data_augmentations(self, enable: bool):
        self.data_aug_enabled = enable

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.scenes[idx]
        pts = s["points"][:, :3].copy()
        normals = s["normals"][:, :3].copy()
        rgb = ((s["colors"][:, :3] - self.color_mean) / self.color_std).astype(
            np.float32
        )
        valid_ids = np.arange(pts.shape[0], dtype=np.int32)
        segments = s.get("segments")
        labels = s.get("labels")

        if self.data_aug_enabled and self.aug:
            # Extras order matches the reference aug configs'
            # p_apply_extra_tensors flags: [normals, rgb, (segments),
            # (labels)] (``loaders/ScanNet.py:348-407``); surviving point
            # ids are tracked through crop params like the reference.
            extras = [normals, rgb]
            if segments is not None:
                extras.append(segments)
            if labels is not None:
                extras.append(labels)
            pts, params, extras = self.aug.augment(self.rng, pts, extras)
            normals, rgb = extras[0], extras[1]
            i = 2
            if segments is not None:
                segments = extras[i]
                i += 1
            if labels is not None:
                labels = extras[i]
            for aug_name, aug_params in params:
                if aug_name == "CropPtsAug":
                    valid_ids = valid_ids[aug_params[0]]
                elif aug_name == "CropBoxAug":
                    valid_ids = valid_ids[aug_params[0]]
        if self.data_aug_enabled and self.color_aug:
            rgb, _, _ = self.color_aug.augment(self.rng, rgb, [])

        feats = np.concatenate([normals, rgb], -1)
        if self.pt_coords_as_feats:
            feats = np.concatenate([feats, pts * self.scale_pt_feats], -1)

        out = {
            "positions": pts.astype(np.float32),
            "features": feats.astype(np.float32),
            "valid_ids": valid_ids.astype(np.int32),
            "scene_id": np.int32(idx),
            "mix3d": bool(self.rng.random() < self.prob_mix3d),
        }
        if labels is not None:
            out["labels"] = labels.astype(np.int32)
        if segments is not None:
            out["segments"] = segments.astype(np.int32)
        return out


def mix3d_merge(
    samples: Sequence[Dict[str, np.ndarray]],
    capacity: Optional[int] = None,
) -> List[Dict[str, np.ndarray]]:
    """Merge consecutive scenes flagged ``mix3d`` into one batch element
    (Mix3D scene mixing; reference ScanNet collate,
    ``loaders/ScanNet.py:104-130``: a flagged scene is concatenated with
    the next one, at most two scenes per element).

    ``capacity``: skip merges whose combined point count would overflow
    the padded per-element capacity.  The reference is ragged and never
    faces this; in the padded design two budget-packed scenes can exceed
    ``capacities[0]`` (e.g. pts_per_batch 2x the capacity), and an
    unmergeable pair must stay two elements rather than crash
    ``pad_collate``."""
    merged: List[Dict[str, np.ndarray]] = []
    i = 0
    while i < len(samples):
        cur = samples[i]
        fits = capacity is None or (
            i + 1 < len(samples)
            and cur["positions"].shape[0]
            + samples[i + 1]["positions"].shape[0] <= capacity
        )
        if bool(cur.get("mix3d", False)) and i + 1 < len(samples) and fits:
            nxt = samples[i + 1]
            out = {}
            for k in cur:
                if k == "mix3d":
                    continue
                a, b = cur[k], nxt[k]
                if isinstance(a, np.ndarray) and a.ndim >= 1 and a.shape[0] == cur["positions"].shape[0]:
                    out[k] = np.concatenate([a, b], 0)
                else:
                    out[k] = a
            merged.append(out)
            i += 2
        else:
            merged.append({k: v for k, v in cur.items() if k != "mix3d"})
            i += 1
    return merged


class MaxPointsBatchSampler:
    """Greedy point-budget batch packing with two-list epoch bookkeeping
    (reference ``ScanNetMaxPtsSampler``, ``loaders/ScanNet.py:423-507``)."""

    def __init__(
        self,
        num_batches: int,
        max_points_per_batch: int,
        dataset,
        max_scene_pts: int = 0,
        pts_crop_ratio: float = 1.0,
        seed: int = 0,
        max_scenes_per_batch: int = 0,
    ):
        self.num_batches = num_batches
        self.max_points = max_points_per_batch
        # 0 = unbounded (reference semantics); evaluators pass 1 so a val
        # batch is ALWAYS one scene — the greedy packer would otherwise
        # co-pack small scenes under the point budget, an eval memory
        # regime nothing measures (each scene pads toward capacity).
        self.max_scenes = max_scenes_per_batch
        self.dataset = dataset
        self.rng = np.random.default_rng(seed)
        self.room_pts = []
        for i in range(len(dataset)):
            n = dataset.get_num_pts(i)
            cap = max_scene_pts if max_scene_pts > 0 else n
            self.room_pts.append(min(cap, int(n * pts_crop_ratio)))
        self.list1 = list(range(len(dataset)))
        self.list2 = list(range(len(dataset)))

    def _take(self, lst, idx):
        lst.remove(idx)
        if lst is self.list1 and not self.list1:
            self.list1 = self.list2
            self.list2 = list(range(len(self.dataset)))

    def __iter__(self):
        room_pts = np.asarray(self.room_pts)
        batches = []
        for _ in range(self.num_batches):
            idx = self.list1[self.rng.integers(len(self.list1))]
            self._take(self.list1, idx)
            batch = [idx]
            accum = self.room_pts[idx]
            while not (self.max_scenes and len(batch) >= self.max_scenes):
                left = self.max_points - accum
                valid = np.zeros(len(self.dataset), bool)
                if self.list1:
                    valid[np.asarray(self.list1)] = True
                valid[room_pts >= left] = False
                from_list1 = True
                if not valid.any():
                    valid = np.zeros(len(self.dataset), bool)
                    if self.list2:
                        valid[np.asarray(self.list2)] = True
                    valid[room_pts >= left] = False
                    from_list1 = False
                if not valid.any():
                    break
                choices = np.nonzero(valid)[0]
                pick = int(choices[self.rng.integers(len(choices))])
                batch.append(pick)
                accum += self.room_pts[pick]
                self._take(self.list1 if from_list1 else self.list2, pick)
                if abs(self.max_points - accum) < 50000:
                    break
            batches.append(batch)
        return iter(batches)

    def __len__(self):
        return self.num_batches


def _empty_like_sample(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An all-masked filler with ``sample``'s keys: zero rows of each
    per-point array, zeros of each scalar."""
    n = sample["positions"].shape[0]
    out: Dict[str, np.ndarray] = {}
    for k, v in sample.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[k] = np.zeros((0,) + v.shape[1:], v.dtype)
        else:
            out[k] = np.zeros_like(np.asarray(v))
    return out


def pad_samples_to(
    samples: List[Dict[str, np.ndarray]],
    target: int,
    template: Optional[Dict[str, np.ndarray]] = None,
) -> List[Dict[str, np.ndarray]]:
    """Pad a sample list to ``target`` with empty (all-masked) samples;
    no-op when already there.  ``template`` gives the filler's keys and
    shapes when the list is empty."""
    if len(samples) > target:
        raise ValueError(
            f"{len(samples)} samples exceed the agreed count {target}"
        )
    if not samples:
        if template is None:
            raise ValueError(
                "cannot pad an empty sample list without a template"
            )
        return [_empty_like_sample(template) for _ in range(target)]
    filler = _empty_like_sample(samples[0])
    return samples + [filler] * (target - len(samples))
