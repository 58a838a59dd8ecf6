"""End-to-end training loop (counterpart of ``se3conv3d_tpu/train/run.py``).

The per-epoch skeleton mirrors the reference's ``train_dfaust_rot.py:436-683``:
recipe -> datasets -> model -> calibration ("pre-process") pass -> epochs
of train steps with the one-cycle schedule stepped per update -> periodic
validation and checkpoints.  What it keeps from the JAX package: the
dataset -> task mapping, the batch capacity and steps per epoch, the batch
stream (ScanNet's point-budget sampler with one scene per eval batch, the
fixed batches of the other datasets), drawn in the same order from one
``np.random.default_rng(0)`` so that the same seed gives the same batches,
and the ``mix_n_frames`` draw from the same generator between batches.

What changes for PyTorch: the model is built on the card unless the caller
asks for the CPU (``device="cpu"``), and raises without one; the optimizer
honours the recipe's ``div_factor`` / ``final_div_factor`` (the JAX run
loop trains every recipe with 25 / 1e4); one ``Trainer`` serves every frame
count; batches become tensors on the model's device; the hierarchy and
DropPath draws come from one explicit ``torch.Generator``, reseeded from
the run's seed at the start of calibration, of each epoch and of each
validation (and offset by the rank), so a resumed run draws what an
uninterrupted one would; a resumed run keeps the checkpoint's best metric.

Data parallelism (``n_devices`` N > 1): the ``Experiment`` is one of N
ranks of a ``parallel.mesh`` group (the training CLI's ``--n_devices``
starts them, one process per card; ``parallel.launch`` does it from
Python), on the rank's device.  Every rank runs the same seeded sampler,
so all draw the same epoch order, the same ScanNet batches and the same
``mix_n_frames`` counts, and each takes its ``process_slice`` of every
global batch, padded with all-masked fillers to ``local_batch_size`` (the
JAX package's multi-host ``_batches``, Mix3D merging inside the local
slice); the train step is the global batch's (``train.trainer``);
validation counts each rank's slice and sums with ``cross_host_sum``.  Rank
0 alone writes ``config.yaml`` and the checkpoints, the others wait at a
barrier, and every rank restores (the JAX package writes from every
process, a race on a shared disk; ``tests/test_torch_ddp.py`` records the
deviation).  The ``(data, points)`` mesh is not ported.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core.hierarchy import HierarchyConfig
from ..data import (
    DFaustDataset,
    MaxPointsBatchSampler,
    ModelNet40Dataset,
    ScanNetDataset,
    mix3d_merge,
    pad_collate,
    pad_samples_to,
)
from ..models.presets import hierarchy_config_from_model_dict, mix_n_frames
from ..nn.conv import check_neighbor_caps
from ..parallel.mesh import barrier, in_group, rank, rank_device, world_size
from ..parallel.multihost import cross_host_sum, local_batch_size, process_slice
from ..utils.logging import StepTimer, WandbLogger
from .checkpoint import CheckpointManager
from .config import build_model_from_config, dump_yaml_config, load_augmentations, load_yaml_config
from .metrics import SemSegMetrics, dataset_class_mask
from .schedule import optimizer_from_training
from .trainer import Trainer, draw_n_frames, to_tensors

__all__ = ["Experiment", "make_datasets", "restore_ensemble"]

_NUM_CLASSES = {"dfaust": 20, "scannet20": 21, "scannet200": 201, "modelnet40": 40}
# the run's seed: the model's init and the hierarchy and DropPath draws
# (the JAX run loop's keys are PRNGKey(0)-style constants too)
SEED = 0
# which draws a reseed is for (see Experiment._reseed)
_CALIBRATION, _TRAIN, _VALIDATION = range(3)


def make_datasets(ds_cfg: dict, data_folder: str, split: str, load_segments: bool = False):
    """Instantiate the dataset named by the ``Dataset`` section."""
    name = ds_cfg["dataset"]
    train = split == "train"
    aug_key = "train_aug_file" if train else "test_aug_file"
    augs = load_augmentations(ds_cfg.get(aug_key))
    if name == "modelnet40":
        return ModelNet40Dataset(data_folder, augs, num_pts=int(ds_cfg.get("num_points", 1024)),
                                 split="train" if train else "test")
    if name == "dfaust":
        return DFaustDataset(data_folder, augs, num_pts=int(ds_cfg.get("num_points", 4096)),
                             split="train" if train else "test")
    if name in ("scannet20", "scannet200"):
        color_key = "train_aug_color_file" if train else "test_aug_color_file"
        return ScanNetDataset(
            data_folder,
            dataset=name,
            augmentations=augs,
            color_augmentations=load_augmentations(ds_cfg.get(color_key)),
            prob_mix3d=float(ds_cfg.get("prob_mix3d", 0.0)) if train else 0.0,
            split=ds_cfg.get("train_split", "train") if train else ds_cfg.get("test_split", "val"),
            load_segments=load_segments,
        )
    raise KeyError(name)


def _resolve_device(device) -> torch.device:
    if device is None and in_group():
        return rank_device()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port trains on an NVIDIA GPU; pass "
                               "Experiment(..., device='cpu') to run its plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


class Experiment:
    """One training run driven by a recipe (a YAML path or a config dict).

    Args:
      conf_file: the recipe's YAML file, or its dict.
      data_folder: the dataset's folder, in its loader's format.
      n_devices: None or 1, or N > 1: this process is one of the N ranks
        of a data-parallel group (module note), which must be joined.
      log_folder: where ``config.yaml`` and ``ckpt/`` go (default: the
        recipe's ``Training.log_folder``).
      device: None (the card, which must exist) or a device to run on, e.g.
        ``"cpu"``.
    """

    def __init__(self, conf_file, data_folder: str, n_devices: Optional[int] = None,
                 log_folder: Optional[str] = None, device=None):
        if n_devices is not None and n_devices > 1 and world_size() != n_devices:
            raise RuntimeError(
                f"Experiment(n_devices={n_devices}) runs as one of {n_devices} ranks: start them "
                f"with parallel.launch(parallel.make_group({n_devices}), fn), as the training "
                f"CLI's --n_devices does (this process is one of {world_size()})")
        self.cfg = dict(conf_file) if isinstance(conf_file, dict) else load_yaml_config(conf_file)
        self.tr = self.cfg["Training"]
        self.ds_cfg = self.cfg["Dataset"]
        self.md = self.cfg["Model"]
        self.data_folder = data_folder
        self.dataset_name = self.ds_cfg["dataset"]
        self.task = "classification" if self.dataset_name == "modelnet40" else "segmentation"
        self.num_classes = _NUM_CLASSES[self.dataset_name]
        self.log_folder = log_folder or self.tr.get("log_folder", "./logs/run")
        self.device = _resolve_device(device)

        self.train_ds = make_datasets(self.ds_cfg, data_folder, "train")
        self.val_ds = make_datasets(self.ds_cfg, data_folder, "val")

        sample = self.train_ds[0]  # draws from the dataset's generator, as the JAX package does
        self.num_in_feats = sample["features"].shape[-1]
        self.capacity = self._batch_capacity()
        seg = self.task == "segmentation"
        self.hcfg: HierarchyConfig = hierarchy_config_from_model_dict(
            self.md, self.capacity, train=True, with_output=seg)
        self.eval_hcfg: HierarchyConfig = hierarchy_config_from_model_dict(
            self.md, self.capacity, train=False, with_output=seg)
        self.model = build_model_from_config(
            self.md, self.num_in_feats, self.num_classes, device=self.device,
            generator=torch.Generator().manual_seed(SEED))

        self.steps_per_epoch = self._steps_per_epoch()
        total_steps = self.steps_per_epoch * int(self.tr["num_epochs"])
        self.optimizer = optimizer_from_training(self.model.parameters(), self.tr, max(total_steps, 1))
        mask_classes = getattr(self.train_ds, "mask_classes", None)
        self._trainer_kwargs = dict(
            label_smoothing=float(self.tr.get("label_smoothing", 0.0)),
            # the dataset declares which class the loss ignores
            ignore_label=mask_classes[0] if mask_classes else None,
            optimizer=self.optimizer,
            scan_scenes=bool(self.tr.get("scan_scenes", False)),
        )
        self.trainer = Trainer(self.model, self.hcfg, self.eval_hcfg, **self._trainer_kwargs)
        self.ckpt = CheckpointManager(os.path.join(self.log_folder, "ckpt"))
        self.rng = np.random.default_rng(0)
        self.generator = torch.Generator(device=self.device)
        # per-epoch frame-count draw (reference ``train_dfaust_rot.py:119-125``)
        self.mix_frames = mix_n_frames(self.md)
        # host-clock seconds per train batch of the last epoch, by phase
        self.host_split: Dict[str, List[float]] = {}
        # one record per epoch run: train metrics and, where it ran, validation
        self.history: List[dict] = []
        self._last_val_cloud = None

    def make_eval_trainer(self, capacity: int) -> Trainer:
        """Eval-only trainer at another scene capacity (full-scene inference
        buckets; the parameters do not depend on it)."""
        return Trainer(self.model, self.hcfg, self.eval_hcfg.with_capacity(capacity),
                       **self._trainer_kwargs)

    def _reseed(self, kind: int, index: int) -> torch.Generator:
        # each rank draws for its own clouds
        return self.generator.manual_seed(SEED * 1_000_003 + kind * 100_003 + index
                                          + rank() * 10_000_019)

    # ------------------------------------------------------------- batching
    def _batch_capacity(self) -> int:
        if self.dataset_name.startswith("scannet"):
            return int(self.md.get("out_capacity", 131072))
        return int(self.ds_cfg.get("num_points", 4096))

    def _steps_per_epoch(self) -> int:
        if self.dataset_name.startswith("scannet"):
            return int(self.tr.get("num_batches", 250))
        return max(len(self.train_ds) // int(self.tr["batch_size"]), 1)

    def _load(self, dataset, ids, times: Optional[Dict[str, float]]) -> list:
        t0 = time.perf_counter()
        samples = [dataset[int(i)] for i in ids]
        if times is not None:
            times["load"] = times.get("load", 0.0) + time.perf_counter() - t0
        return samples

    def _collate(self, samples, times: Optional[Dict[str, float]]) -> dict:
        t0 = time.perf_counter()
        batch = pad_collate(samples, capacity=self.capacity)
        if times is not None:
            times["collate"] = times.get("collate", 0.0) + time.perf_counter() - t0
        return batch

    def _batches(self, dataset, train: bool, times: Optional[Dict[str, float]] = None
                 ) -> Iterator[dict]:
        """Host-side stream of padded numpy batches; ``times`` (when given)
        adds up the seconds spent loading (with augmentation) and collating."""
        if self.dataset_name.startswith("scannet"):
            sampler = MaxPointsBatchSampler(
                num_batches=self.steps_per_epoch if train else len(dataset),
                # the full point budget in training; one scene per eval batch,
                # as the reference's eval scripts run it
                max_points_per_batch=(int(self.tr.get("pts_per_batch", 750000)) if train
                                      else int(self.capacity)),
                max_scenes_per_batch=0 if train else 1,
                dataset=dataset,
                max_scene_pts=int(self.ds_cfg.get("train_scene_max_pts", 0)) if train else 0,
                pts_crop_ratio=(float(self.ds_cfg.get("train_scene_crop_ratio", 1.0)) if train
                                else 1.0),
                seed=int(self.rng.integers(1 << 31)),
            )
            keep = ("positions", "features", "labels", "scene_id")
            for scene_ids in sampler:
                # every rank draws the same global batch and loads its slice;
                # Mix3D merges within the slice
                target = local_batch_size(len(scene_ids))
                samples = mix3d_merge(self._load(dataset, process_slice(scene_ids), times),
                                      capacity=self.capacity)
                samples = [{k: v for k, v in s.items() if k in keep} for s in samples]
                if world_size() == 1:  # one process: whatever Mix3D left
                    target = len(samples)
                # an empty slice still gives all-masked fillers shaped like a sample
                template = samples[0] if samples else {
                    k: v for k, v in dataset[scene_ids[0]].items() if k in keep}
                yield self._collate(pad_samples_to(samples, max(target, len(samples)), template),
                                    times)
        else:
            bs = int(self.tr["batch_size"])
            order = self.rng.permutation(len(dataset)) if train else np.arange(len(dataset))
            for i in range(0, len(order) - bs + 1 if train else len(order), bs):
                samples = self._load(dataset, process_slice(order[i : i + bs]), times)
                # a rank with an empty slice of a tail batch: any example is the template
                template = samples[0] if samples else dataset[int(order[i])]
                samples = pad_samples_to(samples, local_batch_size(min(bs, len(order) - i)),
                                         template)
                batch = self._collate(samples, times)
                if "label" in batch and "labels" not in batch:
                    batch["labels"] = batch.pop("label")  # classification: one label per cloud
                yield batch

    def _put(self, batch: dict) -> dict:
        """The keys a step reads, as tensors on the model's device."""
        return to_tensors(batch, self.device)

    # --------------------------------------------------------------- phases
    def init_state(self) -> None:
        """The model is built with its init; this draws the first train
        batch as the JAX package's ``init_state`` does, so that the batch
        streams of the two run loops stay in step."""
        next(self._batches(self.train_ds, True))

    def calibrate(self, num_batches: Optional[int] = None) -> Dict[str, float]:
        """The reference's pre-process epoch (``train_dfaust_rot.py:172-218``):
        calibration steps over ``Training.calib_batches`` batches (default
        10, ``'full'`` the whole epoch), then the neighbor-cap certificate;
        returns its report."""
        if num_batches is None:
            cfg = self.tr.get("calib_batches", 10)
            num_batches = self.steps_per_epoch if cfg == "full" else int(cfg)
        gen = self._reseed(_CALIBRATION, 0)
        for i, batch in enumerate(self._batches(self.train_ds, True)):
            if i >= num_batches:
                break
            self.trainer.calibration_step(self._put(batch), gen)
        return check_neighbor_caps(self.model)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        gen = self._reseed(_TRAIN, epoch)
        losses: List[float] = []
        times: Dict[str, float] = {}
        split: Dict[str, List[float]] = {"load": [], "collate": [], "copy": [], "step": []}
        t0 = time.time()
        for i, batch in enumerate(self._batches(self.train_ds, True, times)):
            if i >= self.steps_per_epoch:
                break
            n_frames = draw_n_frames(self.mix_frames, self.rng) if self.mix_frames else None
            t1 = time.perf_counter()
            dev_batch = self._put(batch)
            t2 = time.perf_counter()
            out = self.trainer.train_step(dev_batch, gen, n_frames=n_frames)
            losses.append(float(out["loss"]))  # waits for the step
            split["step"].append(time.perf_counter() - t2)
            split["copy"].append(t2 - t1)
            for k in ("load", "collate"):
                split[k].append(times.pop(k, 0.0))
        self.host_split = split
        return {"loss": float(np.mean(losses)) if losses else float("nan"), "losses": losses,
                "epoch_time_s": time.time() - t0}

    def validate(self) -> dict:
        gen = self._reseed(_VALIDATION, 0)
        if self.task == "classification":
            correct, total = 0, 0
            for batch in self._batches(self.val_ds, False):
                out = self.trainer.eval_step(self._put(batch), gen)
                # all-masked filler clouds count for nothing
                valid = out["mask"].any(1)
                pred = out["logits"].argmax(-1)
                correct += int(((pred == out["labels"]) & valid).sum())
                total += int(valid.sum())
            # each rank counted its slices (no-op in one process)
            correct, total = cross_host_sum((correct, total))
            return {"accuracy": int(correct) / max(int(total), 1)}
        metrics = SemSegMetrics.empty(self.num_classes)
        self._last_val_cloud = None
        for batch in self._batches(self.val_ds, False):
            out = self.trainer.eval_step(self._put(batch), gen)
            pred = out["logits"].argmax(-1).cpu().numpy()
            labels = out["labels"].cpu().numpy()
            mask = out["mask"].cpu().numpy()
            if self._last_val_cloud is None:
                # first cloud of the first batch, for the wandb panels
                # (reference train_dfaust_rot.py:340-366)
                pos = batch["positions"][0]
                if "out_idx" in out:  # logits live on the subsampled output cloud
                    pos = pos[np.clip(out["out_idx"][0].cpu().numpy(), 0, len(pos) - 1)]
                m0 = mask[0].astype(bool)
                n_keep = min(int(m0.sum()), pred.shape[1])
                self._last_val_cloud = (pos[: len(m0)][m0][:n_keep], pred[0][m0][:n_keep],
                                        labels[0][m0][:n_keep])
            metrics = metrics.update(pred, labels, mask)
        metrics = cross_host_sum(metrics)
        return metrics.summary(dataset_class_mask(self.val_ds, self.num_classes))

    # ---------------------------------------------------------- checkpoints
    def state_payload(self) -> dict:
        """What a checkpoint holds of the run's state."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "trainer_step": self.trainer.step}

    def save(self, epoch: int, best: float) -> str:
        """Rank 0 writes checkpoint ``epoch``; every rank waits for it."""
        if rank() == 0:
            self.ckpt.save(epoch, self.state_payload(), {"epoch": epoch, "best": best}, self.cfg)
        barrier()
        return self.ckpt.path(epoch)

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """Load checkpoint ``step`` (default: the latest) into the model, the
        optimizer and the trainer; returns its metadata, or None where no
        checkpoint is stored."""
        state, meta = self.ckpt.restore(step, map_location=self.device)
        if state is None:
            return None
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.trainer.step = int(state["trainer_step"])
        return meta or {}

    # ------------------------------------------------------------------ run
    def run(self, resume: bool = False, max_epochs: Optional[int] = None,
            profile_dir: Optional[str] = None) -> dict:
        """The training loop; returns the last validation's metrics.

        ``profile_dir``: a ``torch.profiler`` trace of one training epoch
        (the second, or the first when only one runs) into
        ``{profile_dir}/trace.json``.
        """
        lead = rank() == 0
        if lead:
            os.makedirs(self.log_folder, exist_ok=True)
            # the resolved recipe beside the checkpoints, for the eval CLIs
            dump_yaml_config(self.cfg, os.path.join(self.log_folder, "config.yaml"))
        barrier()

        self.init_state()
        start_epoch, best = 0, -float("inf")
        if resume:
            meta = self.restore()
            if meta is not None:
                start_epoch = int(meta.get("epoch", 0)) + 1
                best = float(meta.get("best", best))
        if start_epoch == 0:
            self.calibrate()

        num_epochs = int(self.tr["num_epochs"])
        if max_epochs is not None:
            num_epochs = min(num_epochs, start_epoch + max_epochs)
        val_freq = int(self.tr.get("val_freq", 5))
        save_freq = int(self.tr.get("save_models_frequency", 50))
        wandb = WandbLogger(project=self.tr.get("wandb_project") if lead else None, config=self.cfg,
                            name=os.path.basename(self.log_folder))
        profile_epoch = min(start_epoch + 1, num_epochs - 1) if profile_dir and lead else None
        val: dict = {}
        key = "accuracy" if self.task == "classification" else "miou"
        for epoch in range(start_epoch, num_epochs):
            profiler = StepTimer(trace_dir=profile_dir) if epoch == profile_epoch else None
            if profiler is not None:
                profiler.start_trace()
            train_metrics = self.train_epoch(epoch)
            if profiler is not None:
                print(f"profiler trace for epoch {epoch} -> {profiler.stop_trace()}", flush=True)
            log = {"train/loss": train_metrics["loss"]}
            line = (f"epoch {epoch}: loss={train_metrics['loss']:.4f} "
                    f"({train_metrics['epoch_time_s']:.1f}s)")
            if (epoch + 1) % val_freq == 0 or epoch == num_epochs - 1:
                val = self.validate()
                line += f" val_{key}={val[key]:.4f}"
                log[f"val/{key}"] = val[key]
                if val[key] > best:
                    best = val[key]
                    self.save(epoch, best)
                if wandb.active and self._last_val_cloud is not None:
                    pos, pred_c, lbl_c = self._last_val_cloud
                    wandb.log_cloud("val_point_cloud_pred", pos, pred_c, self.num_classes, step=epoch)
                    if epoch < val_freq:  # ground truth once
                        wandb.log_cloud("val_point_cloud_gt", pos, lbl_c, self.num_classes,
                                        step=epoch)
            elif (epoch + 1) % save_freq == 0:
                self.save(epoch, best)
            self.history.append({"epoch": epoch, **train_metrics,
                                 **({"val": val} if f"val/{key}" in log else {})})
            wandb.log(log, step=epoch)
            if lead:
                print(line, flush=True)
        wandb.finish()
        return val


def restore_ensemble(exp: Experiment, n_checkpoints: int) -> List[dict]:
    """The model ``state_dict`` of each of the newest ``n_checkpoints``
    checkpoints of ``exp``, newest first, on its device: a checkpoint
    ensemble (reference ``tasks/Classification/test_rot.py:73-156``, the
    JAX package's ``tasks/test_seg.py:restore_ensemble``)."""
    steps = exp.ckpt.all_steps()
    if not steps:
        raise SystemExit(f"no checkpoint under {exp.ckpt.directory}")
    return [exp.ckpt.load(step, map_location=exp.device)["state"]["model"]
            for step in steps[-n_checkpoints:][::-1]]
