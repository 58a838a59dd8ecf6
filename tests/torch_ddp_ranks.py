"""The rank side of ``tests/test_torch_ddp.py`` and
``tests/test_torch_multihost.py``: functions that run in each rank of a
``se3conv3d_tpu_torch.parallel`` group (and, with the whole batch, in the
test's own process as the one-process reference).  They import torch and the
port only, never JAX: the ranks are new processes, and JAX is neither needed
nor wanted there."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from se3conv3d_tpu_torch.core.hierarchy import HierarchyConfig, HierarchyDraws
from se3conv3d_tpu_torch.models import presets
from se3conv3d_tpu_torch.nn import norm as tnorm
from se3conv3d_tpu_torch.nn.blocks import DropPathDraws
from se3conv3d_tpu_torch.parallel import mesh
from se3conv3d_tpu_torch.parallel.multihost import cross_host_sum
from se3conv3d_tpu_torch.train import schedule
from se3conv3d_tpu_torch.train.config import build_model_from_config
from se3conv3d_tpu_torch.train.evaluate import ClassificationVoter, SegmentationVoter
from se3conv3d_tpu_torch.train.trainer import Trainer

KEYS = ("positions", "mask", "features", "labels")


def take(batch: dict, idx: Sequence[int]) -> dict:
    """The examples ``idx`` of a numpy batch, as tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(batch[k])[list(idx)])) for k in KEYS
            if k in batch}


def take_draws(draws: Optional[HierarchyDraws], idx: Sequence[int]) -> Optional[HierarchyDraws]:
    if draws is None:
        return None
    pick = (lambda x: None if x is None else x[list(idx)])
    return HierarchyDraws([pick(x) for x in draws.level_frames], pick(draws.out_uniforms),
                          pick(draws.out_frames))


class Recording(DropPathDraws):
    """Generator draws, kept in call order for a replay."""

    def __init__(self, generator):
        super().__init__(generator)
        self.masks: List[torch.Tensor] = []

    def keep_mask(self, batch, keep, like):
        mask = super().keep_mask(batch, keep, like)
        self.masks.append(mask.clone())
        return mask


class PerRankMeanTrainer(Trainer):
    """A control: each rank's own mean loss, its gradients averaged over the
    ranks (DDP's rule), the BN statistics still global."""

    def backward(self, h, f0, out_pc, out_labels, drops):
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        total, count = self._loss_parts(self._forward(h, f0, out_pc, drops=drops), out_labels, out_pc)
        loss = total / count.clamp(min=1.0)
        loss.backward()
        self.sum_grads()
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(mesh.world_size())
        return mesh.group_sum_(loss.detach().clone()) / mesh.world_size()


@contextlib.contextmanager
def per_rank_bn():
    """A control: every BN takes its own rank's rows only."""
    saved = tnorm.rank_sum
    tnorm.rank_sum = lambda x, dims, *extras: (x.sum(dims),) + extras
    try:
        yield
    finally:
        tnorm.rank_sum = saved


def state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def recipe_trainer(md: dict, training: dict, capacity: int, num_classes: int, lr_steps: int = 100,
                   per_rank_mean: bool = False):
    """A seeded model of the ``Model`` section ``md`` on the CPU and its
    trainer."""
    model = build_model_from_config(md, 1, num_classes, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    opt = schedule.optimizer_from_training(model.parameters(), training, lr_steps)
    cls = PerRankMeanTrainer if per_rank_mean else Trainer
    return cls(model, presets.hierarchy_config_from_model_dict(md, capacity, train=True),
               label_smoothing=float(training.get("label_smoothing", 0.0)), optimizer=opt)


def recipe_steps(rank: int, setup: dict, variant: str = "sound") -> dict:
    """One calibration step and ``setup["steps"]`` train steps of the recipe
    ``setup["md"]`` on this rank's examples ``setup["slices"][rank]`` of the
    global batch, with the global batch's injected draws taken at those
    examples.  ``variant``: "sound", or a control, "per_rank_mean" /
    "per_rank_bn".  Returns the state after calibration and after each step,
    the losses and gradient norms, and the first step's gradients."""
    idx = setup["slices"][rank]
    trainer = recipe_trainer(setup["md"], setup["training"], setup["capacity"], setup["classes"],
                             per_rank_mean=variant == "per_rank_mean")
    ctx = per_rank_bn() if variant == "per_rank_bn" else contextlib.nullcontext()
    out = {"losses": [], "grad_norms": [], "states": []}
    with ctx:
        batch = take(setup["batch"], idx)
        trainer.calibration_step(batch, draws=take_draws(setup["calib_draws"], idx))
        out["calibrated"] = state(trainer.model)
        for step, (draws, masks) in enumerate(zip(setup["draws"], setup["masks"])):
            res = trainer.train_step(batch, draws=take_draws(draws, idx),
                                     drop_masks=[m[list(idx)] for m in masks])
            out["losses"].append(float(res["loss"]))
            out["grad_norms"].append(float(res["grad_norm"]))
            out["states"].append(state(trainer.model))
            if step == 0:
                out["grads"] = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    return out


def record_reference(setup: dict) -> dict:
    """``setup`` with the global batch's draws for ``recipe_steps``:
    hierarchy draws for calibration and each step, and each step's DropPath
    keep masks, recorded from a seeded one-process forward."""
    from se3conv3d_tpu_torch.core.hierarchy import draw_hierarchy

    trainer = recipe_trainer(setup["md"], setup["training"], setup["capacity"], setup["classes"])
    batch = take(setup["batch"], range(len(setup["batch"]["mask"])))
    b, n = batch["mask"].shape
    gen = torch.Generator().manual_seed(11)
    cfg: HierarchyConfig = trainer.hcfg
    setup["calib_draws"] = draw_hierarchy(cfg, b, n, gen)
    setup["draws"], setup["masks"] = [], []
    for _ in range(setup["steps"]):
        setup["draws"].append(draw_hierarchy(cfg, b, n, gen))
        rec = Recording(torch.Generator().manual_seed(len(setup["masks"]) + 20))
        h, f0, out_pc, out_labels, _ = trainer.build(batch, draws=setup["draws"][-1])
        trainer.backward(h, f0, out_pc, out_labels, rec)
        setup["masks"].append(rec.masks)
    return setup


def spec_steps(rank: int, setup: dict) -> dict:
    """One train step of an ``FPNSegUNet`` of preset ``setup["preset"]``
    with ``setup["spec"]`` fields, weights ``setup["state"]`` and hierarchy
    ``HierarchyConfig(**setup["hcfg"])``, on this rank's examples with the
    injected draws: loss, gradient norm, gradients and BN statistics."""
    from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec

    idx = setup["slices"][rank]
    spec = dataclasses.replace(get_model_spec(setup["preset"]), **setup["spec"])
    model = FPNSegUNet(spec, num_in_feats=1, num_classes=setup["classes"])
    model.load_state_dict(setup["state"])
    opt = schedule.make_optimizer(model.parameters(), 5e-3, 100, clip_grad_norm=100.0)
    trainer = Trainer(model, HierarchyConfig(**setup["hcfg"]), label_smoothing=0.2, optimizer=opt)
    res = trainer.train_step(take(setup["batch"], idx), draws=take_draws(setup["draws"], idx),
                             drop_masks=[m[list(idx)] for m in setup["masks"]])
    return {"loss": float(res["loss"]), "grad_norm": float(res["grad_norm"]),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": state(model)}


def class_loss(rank: int, setup: dict) -> dict:
    """One train-mode forward and backward of a seeded ClassNet recipe on
    this rank's clouds ``setup["slices"][rank]`` (a rank may hold only
    all-masked fillers): the loss and the gradients."""
    trainer = recipe_trainer(setup["md"], setup["training"], setup["capacity"], setup["classes"])
    idx = setup["slices"][rank]
    batch = take(setup["batch"], idx)
    h, f0, out_pc, out_labels, _ = trainer.build(batch, draws=take_draws(setup["draws"], idx))
    loss = trainer.backward(h, f0, out_pc, out_labels,
                            DropPathDraws(keep_masks=[m[list(idx)] for m in setup["masks"]]))
    return {"loss": float(loss), "grads": {n: p.grad.clone() for n, p in trainer.model.named_parameters()}}


# --- voters with a stub trainer -------------------------------------------------------


class StubScenes:
    """A segmentation dataset of ``n`` scenes of ``sizes[i]`` points; the
    labels are fixed, the positions re-drawn per epoch."""

    def __init__(self, sizes, classes, seed=0):
        rng = np.random.default_rng(seed)
        self.sizes, self.epoch = sizes, 0
        self.labels = [rng.integers(0, classes, s) for s in sizes]

    def __len__(self):
        return len(self.sizes)

    def increase_epoch_counter(self):
        self.epoch += 1

    def get_num_pts(self, i):
        return self.sizes[i]

    def __getitem__(self, i):
        rng = np.random.default_rng(1000 * self.epoch + i)
        n = self.sizes[i]
        return {"positions": rng.normal(size=(n, 3)).astype(np.float32),
                "features": np.ones((n, 1), np.float32), "labels": self.labels[i],
                "label": np.int64(self.labels[i][0])}


class StubTrainer:
    """Eval steps whose logits are a fixed projection of the positions (per
    point, or of each cloud's mean), so they do not depend on how the
    scenes are split over the ranks."""

    device = torch.device("cpu")

    def __init__(self, classes, clouds=False):
        self.clouds = clouds
        self.w = torch.randn(3, classes, generator=torch.Generator().manual_seed(0))

    def load_member(self, state_dict):
        pass

    def eval_ensemble(self, batch, members, generator=None, draws=None):
        pos, mask = batch["positions"], batch["mask"]
        if self.clouds:
            pos = (pos * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp(min=1)
        return [{"logits": pos @ self.w, "mask": mask} for _ in members]


def voters(rank: int, setup: dict) -> dict:
    """Two vote epochs of a segmentation and a classification voter over
    stub scenes, each rank voting its share (process index and count from
    the group, or the whole set outside one): the global metrics."""
    seg = SegmentationVoter(StubTrainer(setup["classes"]), StubScenes(setup["sizes"], setup["classes"]),
                            setup["classes"], capacity=max(setup["sizes"]))
    cls = ClassificationVoter(StubTrainer(setup["classes"], clouds=True),
                              StubScenes(setup["sizes"], setup["classes"], seed=1), setup["classes"],
                              capacity=max(setup["sizes"]), batch_size=2)
    for epoch in range(2):
        seg.run_epoch(None, epoch)
        cls.run_epoch(None, epoch)
    ds = seg.dataset
    return {"seg": seg.metrics(ds.labels), "acc": cls.accuracy(), "class_acc": cls.class_accuracy(),
            "accum": cls.global_accum()[0], "scenes": [i for i, a in enumerate(seg.accum) if a is not None],
            "index": (seg.process_index, seg.process_count)}


def sums(rank: int, values: dict) -> dict:
    """``cross_host_sum`` of this rank's accumulators ``values[rank]``."""
    return cross_host_sum(values[rank])


def launch_sums(values: dict) -> list:
    """:func:`sums` over two gloo ranks on the CPU."""
    return mesh.launch(mesh.make_group(2, devices=["cpu", "cpu"]), sums, values)


def suite(rank: int, cases: dict) -> dict:
    """Every case of ``cases`` (name: (function name, argument)) in one
    group, in order."""
    torch.set_num_threads(2)
    return {name: globals()[fn](rank, arg) for name, (fn, arg) in cases.items()}


def suite_variants(rank: int, setup: dict) -> dict:
    """``recipe_steps`` in the sound form and both controls."""
    return {v: recipe_steps(rank, setup, v) for v in ("sound", "per_rank_mean", "per_rank_bn")}


def train_recording_saves(rank: int, argv, experiment_kwargs: dict) -> dict:
    """The training CLI's rank body, with every checkpoint write recorded:
    which ranks wrote, the restored step, the final parameters."""
    from se3conv3d_tpu_torch.tasks import train as cli
    from se3conv3d_tpu_torch.train.checkpoint import CheckpointManager

    saves, restores = [], []
    save, restore = CheckpointManager.save, CheckpointManager.restore

    def recording_save(self, step, *a, **k):
        saves.append(step)
        return save(self, step, *a, **k)

    def recording_restore(self, *a, **k):
        out = restore(self, *a, **k)
        restores.append(None if out[1] is None else dict(out[1]))
        return out

    CheckpointManager.save, CheckpointManager.restore = recording_save, recording_restore
    try:
        exp = cli._train(argv, dict(experiment_kwargs))
    finally:
        CheckpointManager.save, CheckpointManager.restore = save, restore
    return {"saves": saves, "restores": restores, "trainer_step": exp.trainer.step,
            "state": state(exp.model), "history": exp.history}
