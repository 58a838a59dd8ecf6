#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's DFaust segmentation eval and training paths
(``se3conv3d_tpu_torch``) at the full widths of
``configs/dfaust/dfaust_I_rot_pca_2F.yaml``:

1. builds the fused conv kernels (forward and backward) from
   ``kernels/csrc`` with ``nvcc``, one process per source, in parallel;
2. holds the forward kernel against its plain PyTorch version at the
   slice's two extreme conv shapes and at the JAX bench's conv shape;
3. builds the model with a seeded init and runs one calibration step and a
   few eval steps on a synthetic batch of 32 body-like clouds of 4096
   points, counting the kernel's launches (21 per forward);
4. checks that a global rotation of the hierarchy leaves the logits
   unchanged;
5. checks that the same model and hierarchy on the CPU (plain path) give
   the same logits at B=2;
6. holds the backward kernel against its plain PyTorch version at the
   three shapes of phase 2;
7. trains a fresh model with the recipe's ``Training`` section: one
   calibration step, then a few ``Trainer.train_step`` calls on the same
   batch, counting 21 forward and 21 backward kernel launches per step and
   checking finite losses and gradients and moved BN statistics;
8. checks that one train-mode forward and backward at B=2 gives the same
   parameter gradients on the card and on the CPU (plain path), with the
   same hierarchy and DropPath keep masks.

Run from the repository root: ``python3 chip_smoke.py``.  Exits non-zero,
printing no result, without a CUDA device or outside the repository.  The
last line of a passing run is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH, POINTS, CLASSES = 32, 4096, 20
EVAL_STEPS = 5
TRAIN_STEPS = 5
CONVS_PER_FORWARD = 21
# kernel vs plain: max |kernel - plain| <= KERNEL_RTOL * max |plain| (both
# float32; they sum up to 64 edges x 32 basis x 256 channels in other orders)
KERNEL_RTOL = 1e-5
# whole-model logits: card vs CPU and rotated vs unrotated, max abs over the
# valid output points (the repo's whole-model bound is 2e-4; rotating the
# positions re-rounds every float32 offset, hence the looser invariance bound)
CPU_ATOL, ROT_ATOL = 2e-4, 1e-3
# backward kernel vs plain, each of its four outputs: the parameter
# gradients sum over up to 131,072 rows (B*M*G) in other orders
BWD_RTOL = 1e-4
# parameter gradients, card vs CPU, per leaf: max |card - cpu| <=
# GRAD_RTOL * max(max |cpu leaf|, GRAD_FLOOR * global norm).  The floor
# covers leaves whose true gradient is 0 (a bias just before a train-mode
# BN): they hold only rounding noise.
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def conv_inputs(b, m, n, k, g, f, q, c, o, seed, dev):
    """Random operands of one conv with ~70% valid edges."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=dev)

    rel = rnd(b, m, k, g, 3) * 0.5
    rot6 = rnd(b, m, k, g, f, 6) * 0.5
    feats = rnd(b, n, f, c)
    idx = torch.randint(0, n, (b, m, k), generator=gen, device=dev)
    mask = torch.rand(b, m, k, generator=gen, device=dev) < 0.7
    pa = rnd(9, q) * 0.3
    pb = rnd(q) * 0.1
    w = rnd(c, q, o) * (1.0 / (c * q) ** 0.5)
    return rel, rot6, feats, idx, mask, pa, pb, w


def body_batch(b: int, n: int, seed: int) -> dict:
    """Synthetic DFaust-format batch: points on the surfaces of a jittered
    1.7 m body of ellipsoids, constant-1 features, 20 height-band labels."""
    rng = np.random.default_rng(seed)
    parts = [  # center, semi-axes (meters)
        ((0.0, 0.15, 0.0), (0.17, 0.30, 0.11)),   # torso
        ((0.0, 0.58, 0.0), (0.09, 0.12, 0.10)),   # head
        ((-0.38, 0.30, 0.0), (0.24, 0.05, 0.05)),  # arms
        ((0.38, 0.30, 0.0), (0.24, 0.05, 0.05)),
        ((-0.10, -0.52, 0.0), (0.07, 0.36, 0.07)),  # legs
        ((0.10, -0.52, 0.0), (0.07, 0.36, 0.07)),
    ]
    area = np.array([a[0] * a[1] + a[1] * a[2] + a[0] * a[2] for _, a in parts])
    pts = np.empty((b, n, 3), np.float32)
    for i in range(b):
        part = rng.choice(len(parts), size=n, p=area / area.sum())
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        center = np.array([parts[p][0] for p in part]) + rng.normal(0, 0.02, (len(parts), 3))[part]
        axes = np.array([parts[p][1] for p in part]) * rng.uniform(0.9, 1.1)
        pts[i] = center + d * axes + rng.normal(0, 0.003, (n, 3))
    y = pts[..., 1]
    labels = np.clip((y - y.min()) / (y.max() - y.min()) * CLASSES, 0, CLASSES - 1).astype(np.int64)
    return {
        "positions": torch.from_numpy(pts),
        "mask": torch.ones(b, n, dtype=torch.bool),
        "features": torch.ones(b, n, 1),
        "labels": torch.from_numpy(labels),
    }


def to_device(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def seeded_model(model_cls, spec, dev):
    """The recipe's model with a seeded init and seeded skip gammas (init
    leaves them at 1e-6), so every block shows in the logits and gradients."""
    model = model_cls(spec, num_in_feats=1, num_classes=CLASSES,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for pname, p in model.named_parameters():
            if pname.endswith("gamma"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return model.to(dev)


def max_rel_err(got, ref) -> tuple:
    """``(max |got - ref|, max |got - ref| / max |ref|)``."""
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    import se3conv3d_tpu_torch
    if Path(se3conv3d_tpu_torch.__file__).resolve().parent.parent != REPO:
        print("chip_smoke: run it from the repository that holds it", file=sys.stderr)
        return 1
    from se3conv3d_tpu_torch.core.hierarchy import rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.rotation import random_rotations
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import FPNSegUNet
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    class RecordedDraws(DropPathDraws):
        """Generator draws, kept (on the CPU) in call order for a replay."""

        def __init__(self, generator):
            super().__init__(generator)
            self.masks = []

        def keep_mask(self, batch, keep, like):
            mask = super().keep_mask(batch, keep, like)
            self.masks.append(mask.cpu())
            return mask

    torch.backends.cuda.matmul.allow_tf32 = False  # plain path in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    libs = kfe.build_libraries(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{[str(p.relative_to(REPO)) for p in libs.values()]} [{card}]", flush=True)

    # 2. kernel vs plain
    shapes = {
        # name: B, M, N, K, G, F, Q, C, O
        "level1_block_conv": (32, 2048, 2048, 32, 2, 2, 32, 32, 32),
        "level4_block_conv": (32, 128, 128, 32, 2, 2, 32, 256, 256),
        "jax_bench_conv": (1, 65536, 65536, 16, 2, 2, 32, 64, 64),
    }
    compared = {}
    with torch.no_grad():
        for i, (name, shp) in enumerate(shapes.items()):
            args = conv_inputs(*shp, seed=10 + i, dev=dev)
            got = kfe.fused_equiv_fwd(*args)
            ref = kfe.fused_equiv_fwd_reference(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            rel = err / max(scale, 1e-30)
            ms = cuda_ms(lambda: kfe.fused_equiv_fwd(*args), 20)
            plain_ms = cuda_ms(lambda: kfe.fused_equiv_fwd_reference(*args), 5)
            compared[name] = dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms)
            print(f"kernel_vs_plain {name} B,M,N,K,G,F,Q,C,O={shp}: max_abs_err={err:.3e} "
                  f"max|plain|={scale:.3e} max_rel_err={rel:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} [{card}]", flush=True)
            if not (rel <= KERNEL_RTOL and torch.isfinite(got).all()):
                raise SystemExit(f"kernel disagrees with its plain version at {name}")
            del args, got, ref
            torch.cuda.empty_cache()

    # 3. the slice at full width
    model_dict = presets.DFAUST_I_ROT_PCA_2F_MODEL
    spec = presets.spec_from_model_dict(model_dict)
    model = seeded_model(FPNSegUNet, spec, dev).eval()
    hcfg = presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True)
    eval_hcfg = presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=False)
    trainer = Trainer(model, hcfg, eval_hcfg, label_smoothing=0.2)
    batch = to_device(body_batch(BATCH, POINTS, seed=2), dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    h, _, out_pc, _, _ = trainer.build(batch, gen, train=False)
    occupancy = [int(pc.mask.sum(1).max()) for pc in h.levels] + [int(out_pc.mask.sum(1).max())]
    caps = [pc.capacity for pc in h.levels] + [out_pc.capacity]
    print(f"slice: max valid points per level {occupancy} of capacities {caps}")
    if any(o > c or o == 0 for o, c in zip(occupancy, caps)):
        raise SystemExit("synthetic batch overflows (or empties) a level")

    torch.cuda.reset_peak_memory_stats()
    kfe.fused_equiv_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.calibration_step(batch, gen)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    after_calib = kfe.fused_equiv_fwd.launches
    step_s, outs = [], None
    for _ in range(EVAL_STEPS):
        t0 = time.perf_counter()
        outs = trainer.eval_step(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = kfe.fused_equiv_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    logits = outs["logits"]
    median_s = statistics.median(step_s)
    print(f"slice: calibration_step {calib_s:.4f} s, eval_step median {median_s:.4f} s "
          f"(all {[round(s, 4) for s in step_s]}), {BATCH * POINTS / median_s:.1f} input points/s, "
          f"peak memory {peak / 2**30:.3f} GiB, loss {float(outs['loss']):.4f} [{card}]")
    print(f"slice: kernel launches {launches} = {after_calib} (calibration) + "
          f"{launches - after_calib} ({EVAL_STEPS} eval steps) [{card}]")
    if after_calib != CONVS_PER_FORWARD or launches != CONVS_PER_FORWARD * (1 + EVAL_STEPS):
        raise SystemExit(f"expected {CONVS_PER_FORWARD} kernel launches per forward")
    if tuple(logits.shape) != (BATCH, POINTS, CLASSES) or not torch.isfinite(logits).all():
        raise SystemExit(f"bad logits: shape {tuple(logits.shape)}")
    calib_ok = all(bool(m.initialized) for m in model.modules() if hasattr(m, "initialized"))
    if not calib_ok:
        raise SystemExit("a conv was not calibrated")

    # 4. rotation invariance and 5. card vs CPU, on two clouds
    small = to_device(body_batch(2, POINTS, seed=4), dev)
    h, f0, out_pc, _, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(5), train=False)
    with torch.no_grad():
        base = model(h, f0, out_pc)
        rot = random_rotations(1, generator=torch.Generator().manual_seed(6))[0].to(dev)
        rotated = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
        valid = out_pc.mask
        rot_err = (base - rotated).abs()[valid].max().item()
        spread = (base[valid].max() - base[valid].min()).item()
        print(f"invariance: max |logits - logits(rotated)| = {rot_err:.3e} (bound {ROT_ATOL}); "
              f"logits span {spread:.3e} over the valid points [{card}]")
        if not rot_err <= ROT_ATOL:
            raise SystemExit("logits change under a global rotation")
        cpu_model = copy.deepcopy(model).cpu()
        cpu_logits = cpu_model(h.to("cpu"), f0.cpu(), out_pc.to("cpu"))
        cpu_err = (base.cpu() - cpu_logits).abs()[valid.cpu()].max().item()
        print(f"card_vs_cpu: max |logits(card) - logits(cpu)| = {cpu_err:.3e} "
              f"(bound {CPU_ATOL}), max |logits| = {base.abs().max().item():.3e} [{card}]")
        if not cpu_err <= CPU_ATOL:
            raise SystemExit("card and CPU logits disagree")

    del model, trainer, outs, logits, base, rotated, cpu_model, cpu_logits, h, f0, out_pc
    torch.cuda.empty_cache()

    # 6. backward kernel vs plain
    bwd_compared = {}
    for i, (name, shp) in enumerate(shapes.items()):
        args = conv_inputs(*shp, seed=20 + i, dev=dev)
        b, m, _, _, g_, _, _, _, o = shp
        gout = torch.randn(b, m, g_, o, device=dev, generator=torch.Generator(device=dev).manual_seed(30 + i))
        got = kfe.fused_equiv_bwd(*args, gout)
        ref = kfe.fused_equiv_bwd_reference(*args, gout)
        torch.cuda.synchronize()
        errs = {what: max_rel_err(x, y) for what, x, y in
                zip(("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights"), got, ref)}
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        del got, ref
        ms = cuda_ms(lambda: kfe.fused_equiv_bwd(*args, gout), 10)
        plain_ms = cuda_ms(lambda: kfe.fused_equiv_bwd_reference(*args, gout), 3)
        bwd_compared[name] = dict(max_abs_err=max(e[0] for e in errs.values()),
                                  max_rel_err=max(e[1] for e in errs.values()), ms=ms, plain_ms=plain_ms)
        print(f"bwd_kernel_vs_plain {name} B,M,N,K,G,F,Q,C,O={shp}: "
              + " ".join(f"{w}: max_abs_err={e[0]:.3e} max_rel_err={e[1]:.3e}" for w, e in errs.items())
              + f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (bound {BWD_RTOL}) [{card}]", flush=True)
        if not (finite and all(e[1] <= BWD_RTOL for e in errs.values())):
            raise SystemExit(f"backward kernel disagrees with its plain version at {name}")
        del args, gout
        torch.cuda.empty_cache()

    # 7. the training slice at full width
    training = presets.DFAUST_I_ROT_PCA_2F_TRAINING
    model = seeded_model(FPNSegUNet, spec, dev)
    opt = schedule.optimizer_from_training(model.parameters(), training, TRAIN_STEPS)
    trainer = Trainer(model, hcfg, eval_hcfg, label_smoothing=training["label_smoothing"],
                      optimizer=opt)
    gen = torch.Generator(device=dev).manual_seed(7)
    bns = {n: mod for n, mod in model.named_modules() if isinstance(mod, MaskedBatchNorm)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfe.fused_equiv_fwd.launches = kfe.fused_equiv_bwd.launches = 0
    trainer.calibration_step(batch, gen)
    bn_before = {n: mod.mean.clone() for n, mod in bns.items()}
    train_fwd_calib = kfe.fused_equiv_fwd.launches
    step_s, per_step = [], []
    for step in range(TRAIN_STEPS):
        lr = opt.lr
        before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        fwd_n = kfe.fused_equiv_fwd.launches - before[0]
        bwd_n = kfe.fused_equiv_bwd.launches - before[1]
        per_step.append((loss, gnorm, fwd_n, bwd_n))
        print(f"train: step {step} lr {lr:.6e} loss {loss:.6f} grad_norm {gnorm:.6f} "
              f"launches fwd {fwd_n} bwd {bwd_n} time {step_s[-1]:.4f} s [{card}]", flush=True)
    train_fwd, train_bwd = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    train_peak = torch.cuda.max_memory_allocated()
    train_median = statistics.median(step_s)
    print(f"train: calibration launches {train_fwd_calib}; train_step median {train_median:.4f} s "
          f"(all {[round(x, 4) for x in step_s]}), {BATCH * POINTS / train_median:.1f} input points/s, "
          f"peak memory {train_peak / 2**30:.3f} GiB; launches fwd {train_fwd} bwd {train_bwd} "
          f"[{card}]", flush=True)
    if not all(np.isfinite(lo) and np.isfinite(gn) for lo, gn, _, _ in per_step):
        raise SystemExit("non-finite loss or gradients in a train step")
    if train_fwd_calib != CONVS_PER_FORWARD or any(
            (f_, b_) != (CONVS_PER_FORWARD, CONVS_PER_FORWARD) for _, _, f_, b_ in per_step):
        raise SystemExit(f"expected {CONVS_PER_FORWARD} forward and backward kernel launches per step")
    still = [n for n, mod in bns.items() if torch.equal(mod.mean, bn_before[n])]
    print(f"train: {len(bns) - len(still)} of {len(bns)} BN running means moved")
    if still:
        raise SystemExit(f"BN running mean did not move: {still[:5]}")

    # 8. parameter gradients, card vs CPU, on two clouds
    small = to_device(body_batch(2, POINTS, seed=4), dev)
    h, f0, out_pc, out_labels, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(8))
    cpu_model = copy.deepcopy(model).cpu()
    draws = RecordedDraws(torch.Generator(device=dev).manual_seed(9))
    card_loss = float(trainer.backward(h, f0, out_pc, out_labels, draws))
    cpu_trainer = Trainer(cpu_model, hcfg, label_smoothing=training["label_smoothing"])
    cpu_loss = float(cpu_trainer.backward(h.to("cpu"), f0.cpu(), out_pc.to("cpu"), out_labels.cpu(),
                                          DropPathDraws(keep_masks=draws.masks)))
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    norm = float(schedule.global_norm(list(cpu_grads.values())))
    worst, worst_name = 0.0, None
    for n, p in model.named_parameters():
        ref = cpu_grads[n]
        if p.grad is None or ref is None or not torch.isfinite(p.grad).all():
            raise SystemExit(f"missing or non-finite gradient for {n}")
        ratio = (p.grad.cpu() - ref).abs().max().item() / max(ref.abs().max().item(), GRAD_FLOOR * norm)
        if ratio > worst:
            worst, worst_name = ratio, n
    print(f"grads_card_vs_cpu: loss card {card_loss:.6f} cpu {cpu_loss:.6f}; {len(cpu_grads)} leaves, "
          f"global norm {norm:.6f}, {len(draws.masks)} DropPath masks; worst max|card - cpu| / "
          f"max(max|cpu leaf|, {GRAD_FLOOR} * norm) = {worst:.3e} at {worst_name} "
          f"(bound {GRAD_RTOL}) [{card}]", flush=True)
    if not (worst <= GRAD_RTOL and abs(card_loss - cpu_loss) <= GRAD_RTOL * abs(cpu_loss)):
        raise SystemExit("card and CPU gradients disagree")

    lvl1, bwd1 = compared["level1_block_conv"], bwd_compared["level1_block_conv"]
    print(json.dumps({"kernels": [{
        "name": "fused_equiv_fwd",
        "route": "cuda",
        "source": "se3conv3d_tpu_torch/kernels/csrc/fused_equiv_fwd.cu",
        "replaces": "se3conv3d_tpu/ops/pallas/fused_equiv.py:196",
        "launches": launches + train_fwd,
        "launches_by_path": {"eval": launches, "train": train_fwd},
        "max_abs_err": max(v["max_abs_err"] for v in compared.values()),
        "ms": lvl1["ms"],
        "plain_ms": lvl1["plain_ms"],
    }, {
        "name": "fused_equiv_bwd",
        "route": "cuda",
        "source": "se3conv3d_tpu_torch/kernels/csrc/fused_equiv_bwd.cu",
        "replaces": "se3conv3d_tpu/ops/pallas/fused_equiv.py:227",
        "launches": train_bwd,
        "launches_by_path": {"train": train_bwd},
        "max_abs_err": max(v["max_abs_err"] for v in bwd_compared.values()),
        "ms": bwd1["ms"],
        "plain_ms": bwd1["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
