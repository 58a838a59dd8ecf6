"""The rank side of ``tests/test_torch_points.py``: functions that run in each
rank of a ``(data, points)`` group of ``se3conv3d_tpu_torch.parallel`` (and,
with the whole batch, in the test's own process as the one-process
reference).  They import torch and the port only, never JAX, as
``tests/torch_ddp_ranks.py`` does."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import torch

import torch_ddp_ranks as R
from se3conv3d_tpu_torch.core.hierarchy import draw_hierarchy
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.models import ClassNet, FPNSegUNet, presets
from se3conv3d_tpu_torch.nn.blocks import DropPathDraws
from se3conv3d_tpu_torch.parallel import mesh
from se3conv3d_tpu_torch.parallel.multihost import host_local, shard_points
from se3conv3d_tpu_torch.train import schedule
from se3conv3d_tpu_torch.train.trainer import Trainer


def setup_trainer(setup: dict):
    """``torch_ddp_ranks.recipe_trainer`` of the setup's recipe, with the
    spec fields ``setup["spec"]`` where it has them (``plain``: every conv
    on the plain path, ``use_fused=False``)."""
    if not setup.get("spec"):
        return R.recipe_trainer(setup["md"], setup["training"], setup["capacity"], setup["classes"])
    md, fields = setup["md"], dict(setup["spec"])
    spec = presets.spec_from_model_dict(md)
    if fields.pop("plain", False):
        fields.update(conv=dataclasses.replace(spec.conv, use_fused=False),
                      conv_blocks=dataclasses.replace(spec.conv_blocks, use_fused=False))
    spec = dataclasses.replace(spec, **fields)
    net = ClassNet if md["model"] in presets.CLASS_PRESETS else FPNSegUNet
    model = net(spec, 1, setup["classes"], generator=torch.Generator().manual_seed(0))
    opt = schedule.optimizer_from_training(model.parameters(), setup["training"], 100)
    return Trainer(model, presets.hierarchy_config_from_model_dict(md, setup["capacity"], train=True),
                   label_smoothing=float(setup["training"].get("label_smoothing", 0.0)), optimizer=opt)


def record(setup: dict) -> dict:
    """``setup`` with the global batch's draws: the hierarchy draws of the
    calibration pass and of one step, and that step's DropPath keep masks,
    recorded from a seeded one-process train-mode forward."""
    trainer = setup_trainer(setup)
    batch = R.take(setup["batch"], range(len(setup["batch"]["mask"])))
    b, n = batch["mask"].shape
    gen = torch.Generator().manual_seed(11)
    setup["calib_draws"] = draw_hierarchy(trainer.hcfg, b, n, gen)
    setup["draws"] = draw_hierarchy(trainer.hcfg, b, n, gen)
    rec = R.Recording(torch.Generator().manual_seed(20))
    h, f0, out_pc, _, _ = trainer.build(batch, draws=setup["draws"])
    trainer.model.train()
    with torch.no_grad():
        trainer._forward(h, f0, out_pc, drops=rec)
    setup["masks"] = rec.masks
    return setup


def rank_batch(batch: dict, idx) -> dict:
    """This rank's share of a numpy batch: its examples ``idx`` (its data
    coordinate's), then its rows of every per-point array."""
    return shard_points(R.take(batch, idx))


@contextlib.contextmanager
def own_rows_only():
    """A control: each rank's conv layers read only the source rows it owns
    (the other ranks' rows of the gathered level are zeros)."""
    saved = kfe.gather_points

    def own(x, dim, total):
        start, stop = mesh.local_rows(total)
        shape = list(x.shape)
        shape[dim] = total
        whole = x.new_zeros(shape)
        whole.narrow(dim, start, stop - start).copy_(x)
        return whole

    kfe.gather_points = own
    try:
        yield
    finally:
        kfe.gather_points = saved


def variant_context(variant: str):
    if variant == "own_rows_only":
        return own_rows_only()
    if variant == "per_rank_bn":
        return R.per_rank_bn()
    return contextlib.nullcontext()


def recipe_steps(rank: int, setup: dict, variant: str = "sound") -> dict:
    """One calibration step and ``setup["steps"]`` train steps of the recipe
    ``setup["md"]`` on this rank's share of the global batch (its data
    coordinate's examples ``setup["slices"][data rank]``, its rows of each),
    with the global batch's injected draws at those examples.  ``variant``:
    "sound", or a control, "own_rows_only" / "per_rank_bn".  Returns what
    ``torch_ddp_ranks.recipe_steps`` returns."""
    idx = setup["slices"][mesh.data_rank()]
    trainer = setup_trainer(setup)
    out = {"losses": [], "grad_norms": [], "states": []}
    with variant_context(variant):
        batch = rank_batch(setup["batch"], idx)
        trainer.calibration_step(batch, draws=R.take_draws(setup["calib_draws"], idx))
        out["calibrated"] = R.state(trainer.model)
        for step, (draws, masks) in enumerate(zip(setup["draws"], setup["masks"])):
            res = trainer.train_step(batch, draws=R.take_draws(draws, idx),
                                     drop_masks=[m[list(idx)] for m in masks])
            out["losses"].append(float(res["loss"]))
            out["grad_norms"].append(float(res["grad_norm"]))
            out["states"].append(R.state(trainer.model))
            if step == 0:
                out["grads"] = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    return out


def variants(rank: int, setup: dict) -> dict:
    """``recipe_steps`` in the sound form and both controls."""
    return {v: recipe_steps(rank, setup, v) for v in ("sound", "own_rows_only", "per_rank_bn")}


def eval_logits(rank: int, setup: dict) -> dict:
    """One eval step of the recipe's seeded model on this rank's share, with
    the injected eval draws: the logits, mask and labels put back together
    over the points row (``host_local``), and the rank's own row count."""
    idx = setup["slices"][mesh.data_rank()]
    trainer = R.recipe_trainer(setup["md"], setup["training"], setup["capacity"], setup["classes"])
    out = trainer.eval_step(rank_batch(setup["batch"], idx), draws=R.take_draws(setup["eval_draws"], idx))
    return {"rows": int(out["logits"].shape[1]), "logits": host_local(out["logits"]),
            "mask": host_local(out["mask"]), "labels": host_local(out["labels"]),
            "out_idx": host_local(out["out_idx"])}


def class_steps(rank: int, setup: dict) -> dict:
    """A ClassNet recipe's calibration pass and one train-mode forward and
    backward on this rank's share of the clouds (no optimizer step): the
    loss, the gradients, the state and the eval logits (every rank of a
    points row holds the whole ``[B, classes]``)."""
    idx = setup["slices"][mesh.data_rank()]
    trainer = setup_trainer(setup)
    batch = rank_batch(setup["batch"], idx)
    trainer.calibration_step(batch, draws=R.take_draws(setup["calib_draws"], idx))
    h, f0, out_pc, out_labels, _ = trainer.build(batch, draws=R.take_draws(setup["draws"], idx))
    loss = trainer.backward(h, f0, out_pc, out_labels,
                            DropPathDraws(keep_masks=[m[list(idx)] for m in setup["masks"]]))
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    logits = trainer.eval_step(batch, draws=R.take_draws(setup["draws"], idx))["logits"]
    return {"loss": float(loss), "grads": grads, "state": R.state(trainer.model), "logits": logits}


def global_vector(rank: int, setup: dict) -> dict:
    """ClassNet's global equivariant feature vector (an eval-mode forward
    after one calibration pass) on this rank's share: the rank's rows of the
    extra level, and the whole level put back together."""
    idx = setup["slices"][mesh.data_rank()]
    trainer = setup_trainer(setup)
    batch = rank_batch(setup["batch"], idx)
    trainer.calibration_step(batch, draws=R.take_draws(setup["calib_draws"], idx))
    h, f0, out_pc, _, _ = trainer.build(batch, draws=R.take_draws(setup["draws"], idx), train=False)
    trainer.model.eval()
    with torch.no_grad():
        x = trainer.model(h, f0)
    return {"rows": int(x.shape[1]), "vector": host_local(x), "state": R.state(trainer.model)}


def saved_rows(rank: int, setup: dict) -> dict:
    """One train step's saved tensors (``saved_tensors_hooks``): the shape of
    each, apart from the parameters and from views of the hierarchy's
    positions and frames."""
    idx = setup["slices"][mesh.data_rank()]
    trainer = setup_trainer(setup)
    batch = rank_batch(setup["batch"], idx)
    h, f0, out_pc, out_labels, _ = trainer.build(batch, draws=R.take_draws(setup["draws"][0], idx))
    skip = {p.untyped_storage().data_ptr() for p in trainer.model.parameters()}
    for pc in list(h.levels) + [out_pc]:
        for t in (pc.source.positions, pc.source.frames):
            if t is not None:
                skip.add(t.untyped_storage().data_ptr())
    shapes: List[tuple] = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in skip:
            shapes.append(tuple(t.shape))
        return t

    drops = DropPathDraws(keep_masks=[m[list(idx)] for m in setup["masks"][0]])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        trainer.backward(h, f0, out_pc, out_labels, drops)
    return {"shapes": shapes, "level_rows": [pc.capacity for pc in h.levels] + [out_pc.capacity],
            "whole_rows": [pc.source.capacity for pc in h.levels] + [out_pc.source.capacity]}


def diverged_draws(rank: int, setup: dict) -> dict:
    """``Trainer.build`` on this rank's share with a generator seeded by the
    rank, so the points row's draws differ: the error each rank raises
    (None where it raised none); then the same with one seed, which builds."""
    trainer = setup_trainer(setup)
    batch = rank_batch(setup["batch"], setup["slices"][mesh.data_rank()])
    try:
        trainer.build(batch, torch.Generator().manual_seed(rank))
        error = None
    except RuntimeError as e:
        error = str(e)
    h, *_ = trainer.build(batch, torch.Generator().manual_seed(5))
    return {"error": error, "rows": h.levels[0].capacity}


def attention(rank: int, setup: dict) -> dict:
    """A ``LoRAttConv`` (seeded, calibrated) on this rank's rows of one
    cloud, over a kNN table from the whole cloud to those rows: the output
    and the input's gradient put back together over the points row, and
    the parameters' gradients summed over the group (each rank's part of
    the sum ``out * cotangent``)."""
    from se3conv3d_tpu_torch.core.neighborhoods import knn_neighborhood
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.models.seg_unet import init_parameters
    from se3conv3d_tpu_torch.nn.attention import LoRAttConv

    whole = PointCloud(setup["positions"], setup["mask"])
    pc = whole.row_slice(*mesh.local_rows(whole.capacity))
    rows = slice(pc.start, pc.start + pc.capacity)
    conv = LoRAttConv(setup["features"].shape[-1], 8, num_basis=8, num_heads=2)
    gen = torch.Generator().manual_seed(3)
    conv.reset_parameters(gen)
    init_parameters(conv, gen)
    neigh = knn_neighborhood(whole, pc, 8)
    feats = setup["features"][:, rows].clone().requires_grad_(True)
    conv(pc, pc, feats, neigh, calibrate=True)
    out = conv(pc, pc, feats, neigh)
    (out * setup["cotangent"][:, rows]).sum().backward()
    grads = {n: mesh.group_sum_(p.grad.clone()) for n, p in conv.named_parameters()}
    return {"out": host_local(out.detach()), "d_feats": host_local(feats.grad), "grads": grads}


def gathers(rank: int, cases: dict) -> dict:
    """``points_gather`` forward and backward on each case ``name: (whole
    [B, M, C] tensor, seed of the cotangent)``: this rank's rows in, the
    whole level out; the backward of ``sum(gathered * cotangent_r)`` with a
    cotangent per rank, whose sum over the points row is the whole tensor's
    gradient."""
    out = {}
    for name, (whole, seed) in cases.items():
        start, stop = mesh.local_rows(whole.shape[1])
        x = whole[:, start:stop].clone().requires_grad_(True)
        got = mesh.points_gather(x, 1, whole.shape[1])
        cot = torch.randn(whole.shape, generator=torch.Generator().manual_seed(seed + mesh.rank()))
        (got * cot).sum().backward()
        out[name] = {"whole": got.detach(), "grad": x.grad, "rows": (start, stop), "cot": cot,
                     "sized": mesh.points_gather(x.detach(), 1).shape[1]}
    return out


def pools(rank: int, cases: dict) -> dict:
    """``core.pointcloud.global_pool`` by max and by min over this rank's
    rows of each case ``name: (whole [B, M, ...] features, mask [B, M],
    cotangent of the pooled [B, C])``: the pooled vectors and the gradient
    of ``sum(pooled * cotangent)`` at this rank's rows."""
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud, global_pool

    out = {}
    for name, (whole, mask, cot) in cases.items():
        pc = PointCloud(torch.zeros(mask.shape + (3,)), mask)
        part = pc.row_slice(*mesh.local_rows(pc.capacity))
        for method in ("max", "min"):
            x = whole[:, part.start:part.start + part.capacity].clone().requires_grad_(True)
            pooled = global_pool(part, x, method)
            (pooled * cot).sum().backward()
            out[name, method] = {"pooled": pooled.detach(), "grad": x.grad, "start": part.start}
    return out


def coordinates(rank: int, _arg=None) -> dict:
    """This rank's coordinates, its points row's lengths and one sum over
    the row (the subgroups)."""
    row_sum = mesh.points_sum(torch.tensor([float(rank)]))
    return {"rank": mesh.rank(), "data": (mesh.data_rank(), mesh.data_size()),
            "points": (mesh.points_rank(), mesh.points_size()), "row_sum": float(row_sum),
            "lengths": mesh.points_lengths(10 + rank), "agree_same": mesh.points_agree(7),
            "agree_rank": mesh.points_agree(rank)}


def suite(rank: int, cases: dict) -> dict:
    """Every case of ``cases`` (name: (function name, argument)) in one
    group, in order."""
    torch.set_num_threads(2)
    return {name: globals()[fn](rank, arg) for name, (fn, arg) in cases.items()}


def jax_standard_spec(rank: int, setup: dict) -> dict:
    """``torch_ddp_ranks.spec_steps`` on this rank's share (its examples and
    rows)."""
    import dataclasses

    from se3conv3d_tpu_torch.core.hierarchy import HierarchyConfig
    from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    idx = setup["slices"][mesh.data_rank()]
    spec = dataclasses.replace(get_model_spec(setup["preset"]), **setup["spec"])
    model = FPNSegUNet(spec, num_in_feats=1, num_classes=setup["classes"])
    model.load_state_dict(setup["state"])
    opt = schedule.make_optimizer(model.parameters(), 5e-3, 100, clip_grad_norm=100.0)
    trainer = Trainer(model, HierarchyConfig(**setup["hcfg"]), label_smoothing=0.2, optimizer=opt)
    res = trainer.train_step(rank_batch(setup["batch"], idx), draws=R.take_draws(setup["draws"], idx),
                             drop_masks=[m[list(idx)] for m in setup["masks"]])
    return {"loss": float(res["loss"]), "grad_norm": float(res["grad_norm"]),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}, "state": R.state(model)}
