#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's DFaust segmentation eval and training paths
(``se3conv3d_tpu_torch``) at the full widths of
``configs/dfaust/dfaust_I_rot_pca_2F.yaml``, then its ScanNet-20 eval and
``scan_scenes`` training paths at the full widths and capacities of
``configs/scannet/scannet20_rot_pca_I.yaml`` (in float32: the port's
conv kernels take no bf16 yet):

1. builds the three kernel sources (conv forward, conv backward, blocked
   prefix sum) from ``kernels/csrc`` with ``nvcc``, one process per source,
   in parallel;
2. holds the forward kernel against its plain PyTorch version at the
   slice's two extreme conv shapes and at the JAX bench's conv shape, checks
   that two calls give the same bits, and times ``torch.matmul`` for its
   weight contraction over the same live rows;
3. builds the model with a seeded init and runs one calibration step and a
   few eval steps on a synthetic batch of 32 body-like clouds of 4096
   points, counting the kernel's launches (21 per forward);
4. checks that a global rotation of the hierarchy leaves the logits
   unchanged;
5. checks that the same model and hierarchy on the CPU (plain path) give
   the same logits at B=2;
6. holds the backward kernel against its plain PyTorch version at the
   three shapes of phase 2, in both feature-gradient output modes, with
   ``torch.matmul`` for its two products;
7. trains a fresh model with the recipe's ``Training`` section: one
   calibration step, then a few ``Trainer.train_step`` calls on the same
   batch, counting 21 forward and 21 backward kernel launches per step and
   checking finite losses and gradients and moved BN statistics;
8. checks that one train-mode forward and backward at B=2 gives the same
   parameter gradients on the card and on the CPU (plain path), with the
   same hierarchy and DropPath keep masks;
9. holds the conv kernels against their plain versions at the ScanNet
   level-0 and level-4 block convs and at a padded level-0 conv (the
   first 22,563 of 131,072 rows live, as the fullest synthetic room), the
   forward bitwise equal over two calls, the backward in both
   feature-gradient output modes (atomic scatter; rows at their sorted
   slots), each with its device ms per pass, and times ``torch.matmul``
   for their products over the same live rows beside them;
10. holds the prefix-sum kernel against its plain version on the sorted
    buffers of the ScanNet level-0 and level-4 block convs (level 0 in
    bfloat16 too) and of the DFaust level-0 conv (B=32), checks that 10
    more calls give the same bits, times ``torch.cumsum`` and a float32
    copy of the same rows beside it with each shape's share of its bound,
    and holds ``sorted_segment_sum`` against ``index_add_`` on the same
    rows (the kernel's device ms per call at these shapes come last, from
    a CUDA graph of 5 calls);
11. holds the grid neighbor searches against brute force on one
    full-capacity synthetic room (same neighbor sets per row, away from
    distance ties) and times both;
12. builds the ScanNet model with ``build_model_from_config`` (on the card
    by default), runs a calibration step and eval steps on one room (32
    conv launches per forward, each given its neighborhood's live-row
    table), checks rotation invariance, and card vs CPU logits on a smaller
    room whose capacities still take the grid;
13. trains with ``scan_scenes`` on 6 rooms x 120,000 points, the two
    feature-gradient modes in turns (scatter, sorted, sorted, scatter, ...),
    counting 192 forward and 192 backward launches per step and 192 prefix
    sums in sorted mode only, and checking finite losses and moved BN means;
    then one step per mode split on the host clock (with the live rows the
    192 forwards and 192 backwards walked against their capacity rows, each
    given its neighborhood's table) and one under ``torch.profiler`` (device
    ms by kernel and per forward and backward pass);
14. checks that the two modes give the same parameter gradients on one
    room, with the same hierarchy and DropPath keep masks.

Run from the repository root: ``python3 chip_smoke.py``.  Exits non-zero,
printing no result, without a CUDA device or outside the repository.  The
last line of a passing run is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
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
# ScanNet: 6 rooms of the recipe's train_scene_max_pts per step (720,000 of
# its 750,000 pts_per_batch); 32 convs per forward (19 blocks, 4 down, 4
# decoder, 4 FPN, the head); steps per backward mode
SCENES, SCENE_POINTS, SCANNET_CONVS = 6, 120_000, 32
SCANNET_MODE_ORDER = ("scatter", "sorted", "sorted", "scatter", "scatter", "sorted")
SCANNET_EVAL_STEPS = 3
# the smaller room of the card-vs-CPU logits: capacities that still take
# the grid searches (level 0 and the output cloud at 16,384 >= 8,192)
SMALL_ROOM_POINTS, SMALL_CAPS = 30_000, [16384, 4096, 1024, 256, 64]
# blocked prefix sum vs plain: float32 sums of up to 3.1M rows in other
# orders; each side carries about eps * log2(E) * max |prefix|.  A bfloat16
# payload is held at the same bound: both sides widen the same values
CUMSUM_RTOL = 1e-5
# calls after the first that must give its bits (the scan's offsets are
# fixed sums of the tiles' aggregates)
CUMSUM_REPEATS = 10
# sorted_segment_sum vs index_add_: a prefix difference carries about eps *
# |prefix| at each end, so the bound is 256 eps * max |prefix|
SEGSUM_EPS_FACTOR = 256
# published float32 peak outside the tensor cores and HBM rate of one H100
# SXM at 700 W (NVIDIA's H100 datasheet), for the bound of each kernel
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
# the dense TF32 tensor-core peak of the same sheet; the forward's weight
# contraction and the backward's two products run in 3xTF32 (three TF32
# products per float32 one)
PEAK_TF32_FLOPS = 495e12
# kernel vs plain: max |kernel - plain| <= KERNEL_RTOL * max |plain| (both
# float32; they sum up to 64 edges x 32 basis x 256 channels in other orders,
# the kernel's weight contraction in 3xTF32)
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


def room_scene(n: int, seed: int, size=None) -> dict:
    """One synthetic ScanNet-like room of ``n`` points: a floor and four
    walls of a 4-8 m x 4-8 m x 2.5-3 m room (or ``size``) plus 10-20 boxes
    standing on the floor (furniture), points sampled by area over their
    visible faces.  Features are the surface normals and a per-surface color
    in [0, 1] with noise (6 channels, as the recipe's normals + rgb); labels
    are 1 for walls, 2 for the floor and one of 3-20 per box, with about 5%
    set to 0, which the loss ignores."""
    rng = np.random.default_rng(seed)
    w, d, h = size if size is not None else (*rng.uniform(4.0, 8.0, 2), rng.uniform(2.5, 3.0))
    faces = []  # (origin, edge u, edge v, normal, label)

    def rect(origin, u, v, normal, label):
        faces.append((np.array(origin, float), np.array(u, float), np.array(v, float),
                      np.array(normal, float), label))

    rect((0, 0, 0), (w, 0, 0), (0, d, 0), (0, 0, 1), 2)  # floor
    rect((0, 0, 0), (0, d, 0), (0, 0, h), (1, 0, 0), 1)  # walls, normals into the room
    rect((w, 0, 0), (0, d, 0), (0, 0, h), (-1, 0, 0), 1)
    rect((0, 0, 0), (w, 0, 0), (0, 0, h), (0, 1, 0), 1)
    rect((0, d, 0), (w, 0, 0), (0, 0, h), (0, -1, 0), 1)
    for _ in range(rng.integers(10, 21)):
        sx, sy = rng.uniform(0.4, min(2.0, w / 3)), rng.uniform(0.4, min(2.0, d / 3))
        sz = rng.uniform(0.4, 1.8)
        x0, y0 = rng.uniform(0.1, w - sx - 0.1), rng.uniform(0.1, d - sy - 0.1)
        label = int(rng.integers(3, 21))
        rect((x0, y0, sz), (sx, 0, 0), (0, sy, 0), (0, 0, 1), label)  # top
        rect((x0, y0, 0), (0, sy, 0), (0, 0, sz), (-1, 0, 0), label)
        rect((x0 + sx, y0, 0), (0, sy, 0), (0, 0, sz), (1, 0, 0), label)
        rect((x0, y0, 0), (sx, 0, 0), (0, 0, sz), (0, -1, 0), label)
        rect((x0, y0 + sy, 0), (sx, 0, 0), (0, 0, sz), (0, 1, 0), label)
    area = np.array([np.linalg.norm(u) * np.linalg.norm(v) for _, u, v, _, _ in faces])
    face = rng.choice(len(faces), size=n, p=area / area.sum())
    colors = rng.uniform(0.0, 1.0, (len(faces), 3))
    uv = rng.uniform(size=(n, 2))
    origin, eu, ev, normal = (np.stack([f[i] for f in faces])[face] for i in range(4))
    pts = origin + uv[:, :1] * eu + uv[:, 1:] * ev + rng.normal(0.0, 0.005, (n, 3))
    rgb = np.clip(colors[face] + rng.normal(0.0, 0.03, (n, 3)), 0.0, 1.0)
    labels = np.array([f[4] for f in faces])[face]
    labels[rng.uniform(size=n) < 0.05] = 0
    return {
        "positions": torch.from_numpy(pts.astype(np.float32)),
        "mask": torch.ones(n, dtype=torch.bool),
        "features": torch.from_numpy(np.concatenate([normal, rgb], 1).astype(np.float32)),
        "labels": torch.from_numpy(labels.astype(np.int64)),
    }


def stack_scenes(scenes) -> dict:
    return {k: torch.stack([s[k] for s in scenes]) for k in scenes[0]}


def to_device(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def seeded_model(model_cls, spec, dev):
    """The recipe's model with a seeded init and seeded skip gammas."""
    model = model_cls(spec, num_in_feats=1, num_classes=CLASSES,
                      generator=torch.Generator().manual_seed(0))
    return seed_gammas(model).to(dev)


def conv_bounds(shape, mask) -> dict:
    """Least times of one conv forward and backward on the card: the larger
    of bytes / HBM rate (each input read once, each output written once)
    and FLOPs / float32 peak, counting the valid edges of ``mask`` and its
    live rows (the query rows with a valid edge): a padded row needs no
    work, so its geometry, ``gout`` row and products are not counted.

    FLOPs as in ``PERF.md``: per valid edge and frame pair the pne
    (``2*9*Q``) and basis (``2*Q*C``) products, per live point and
    out-frame the weight contraction (``2*C*Q*O``).  The backward counts,
    per edge, pne and basis once, ``dpne`` and ``d_feats`` (``2*Q*C`` each)
    and ``d_proj``/``d_bias`` (``2*10*Q``), and per live point the ``d_w``
    and ``dbasis`` products (``2*C*Q*O`` each).  The forward's weight
    contraction and the backward's two products run on tensor cores in
    3xTF32, so the bounds take them at that ceiling (``PEAK_TF32_FLOPS /
    3``) and the rest at the float32 peak; ``bound_f32_ms`` takes every FLOP
    at the float32 peak.
    """
    b, m, n, k, g, f, q, c, o = shape
    edges = float(mask.sum()) * g * f
    live = float(mask.any(-1).sum())
    point_flops = 2.0 * live * g * c * q * o
    fwd_flops = 2 * edges * q * (9 + c) + point_flops
    bwd_edge_flops = 2 * edges * q * (9 + 3 * c + 10)
    bwd_flops = bwd_edge_flops + 2 * point_flops
    geo = live * (4.0 * k * g * (3 + 6 * f) + 9.0 * k)  # rel, rot6, idx, mask of the live rows
    params = 4.0 * (10 * q + c * q * o)
    fwd_bytes = geo + 4.0 * b * n * f * c + params + 4.0 * b * m * g * o
    # + gout's live rows, d_feats, d_params
    bwd_bytes = geo + 4.0 * b * n * f * c + params + 4.0 * live * g * o + 4.0 * b * n * f * c + params
    tf32x3 = PEAK_TF32_FLOPS / 3
    fwd_ops_s = (fwd_flops - point_flops) / PEAK_F32_FLOPS + point_flops / tf32x3
    bwd_ops_s = bwd_edge_flops / PEAK_F32_FLOPS + 2 * point_flops / tf32x3
    out = {}
    for name, flops, ops_s, nbytes in (("fwd", fwd_flops, fwd_ops_s, fwd_bytes),
                                       ("bwd", bwd_flops, bwd_ops_s, bwd_bytes)):
        t_ops, t_bytes = ops_s * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                         else "bytes", gflop=flops / 1e9, live_rows=int(live),
                         bound_f32_ms=max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3)
    return out


def products_matmul_ms(rows: int, conv_weights, seed: int) -> float:
    """The yardstick of the conv backward's two products: ``torch.matmul``
    in full float32 (TF32 off, set here) for ``d_w = basis^T . gout`` and
    ``dbasis = gout . W^T`` over ``rows`` live rows (seeded operands of the
    kernel's shapes; the time does not depend on their values)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c, q, o = conv_weights.shape
    gen = torch.Generator(device=conv_weights.device).manual_seed(seed)
    basis = torch.randn(rows, c * q, device=conv_weights.device, generator=gen)
    gout = torch.randn(rows, o, device=conv_weights.device, generator=gen)
    w2 = conv_weights.reshape(c * q, o)
    return cuda_ms(lambda: (torch.matmul(basis.t(), gout), torch.matmul(gout, w2.t())), 10)


def product_matmul_ms(rows: int, conv_weights, seed: int) -> float:
    """The yardstick of the conv forward's weight contraction:
    ``torch.matmul`` in full float32 (TF32 off, set here) for ``out =
    basis . W`` over ``rows`` live rows x out-frames (seeded operands of the
    kernel's shapes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c, q, o = conv_weights.shape
    gen = torch.Generator(device=conv_weights.device).manual_seed(seed)
    basis = torch.randn(rows, c * q, device=conv_weights.device, generator=gen)
    w2 = conv_weights.reshape(c * q, o)
    return cuda_ms(lambda: torch.matmul(basis, w2), 10)


def max_rel_err(got, ref) -> tuple:
    """``(max |got - ref|, max |got - ref| / max |ref|)``."""
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def seed_gammas(model):
    """Seeded skip gammas (init leaves them at 1e-6), so every block shows
    in the logits and gradients."""
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for pname, p in model.named_parameters():
            if pname.endswith("gamma"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return model


SCANNET_SHAPES = {
    # name: B, M, N, K, G, F, Q, C, O (the level-0 and level-4 block convs)
    "scannet_level0_block_conv": (1, 131072, 131072, 24, 1, 1, 32, 64, 64),
    "scannet_level4_block_conv": (1, 512, 512, 24, 1, 1, 32, 320, 320),
}
# phase 9 also runs the level-0 block conv at the fill of the fullest
# synthetic room (22,563 of 131,072 level-0 points): name: (shape, live rows)
SCANNET_PADDED = {
    "scannet_level0_padded_block_conv": ("scannet_level0_block_conv", 22_563),
}
# the conv forward's and backward's passes: (name, substrings of its
# kernel's name); both libraries build basis_kernel and tf32x3_gemm, told
# apart by their template arguments
FWD_PASSES = (("basis_kernel", ("basis_kernel<", "false>")),
              ("product", ("tf32x3_gemm<true, false",)), ("sum_splits", ("sum_splits",)))
BWD_PASSES = (("basis_kernel", ("basis_kernel<", "true>")), ("d_w product", ("tf32x3_gemm<false, false",)),
              ("dbasis product", ("tf32x3_gemm<true, true",)), ("edge_kernel", ("edge_kernel",)),
              ("sum_partials", ("sum_partials",)))
# the prefix sum's single kernel ('sorted' mode only)
CUMSUM_PASSES = (("scan_kernel", ("scan_kernel<",)),)


def cumsum_cases() -> dict:
    """Phase 10's prefix-sum inputs, ``name: ((B, E, C), payload dtype)``.
    A conv's sorted buffer is ``[B, M*K, F*C]``: the ScanNet level-0 and
    level-4 block convs (level 0 in bfloat16 too, the recipe's compute
    dtype), and the DFaust recipe's level-0 conv (capacity x max_neighbors
    edges, in-frames x the level-0 width, B=32)."""
    from se3conv3d_tpu_torch.models import presets

    cases = {name.replace("block_conv", "edges"): ((b, m * k, f * c), torch.float32)
             for name, (b, m, _, k, _, f, _, c, _) in SCANNET_SHAPES.items()}
    cases["scannet_level0_edges_bf16"] = (cases["scannet_level0_edges"][0], torch.bfloat16)
    model = presets.DFAUST_I_ROT_PCA_2F_MODEL
    width = presets.spec_from_model_dict(model).num_features[0]
    cases["dfaust_level0_edges"] = ((BATCH, model["capacities"][0] * model["max_neighbors"],
                                     model["RefFrames"]["train_n_frames"] * width), torch.float32)
    return cases


def device_rows(prof) -> list:
    """``(device ms, launches, kernel name)`` of a ``torch.profiler`` run,
    largest first."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    return sorted(rows, reverse=True)


def pass_ms(rows, passes=BWD_PASSES) -> dict:
    """Device ms of each pass of ``passes`` in ``device_rows`` output."""
    return {name: sum(ms for ms, _, key in rows if all(tag in key for tag in tags))
            for name, tags in passes}


def dfaust_eval(card, dev, batch) -> tuple:
    """3. the DFaust recipe's eval path at full width: a seeded model, one
    calibration step and ``EVAL_STEPS`` eval steps on ``batch``, counting 21
    forward conv launches per forward and checking the logits and the
    calibration.  Returns ``(trainer, {step_s, all_s, peak_gib, launches})``."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import FPNSegUNet, presets
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model_dict = presets.DFAUST_I_ROT_PCA_2F_MODEL
    model = seeded_model(FPNSegUNet, presets.spec_from_model_dict(model_dict), dev).eval()
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=False),
                      label_smoothing=0.2)
    gen = torch.Generator(device=dev).manual_seed(3)

    h, _, out_pc, _, _ = trainer.build(batch, gen, train=False)
    occupancy = [int(pc.mask.sum(1).max()) for pc in h.levels] + [int(out_pc.mask.sum(1).max())]
    caps = [pc.capacity for pc in h.levels] + [out_pc.capacity]
    print(f"slice: max valid points per level {occupancy} of capacities {caps}")
    if any(o > c or o == 0 for o, c in zip(occupancy, caps)):
        raise SystemExit("synthetic batch overflows (or empties) a level")
    del h, out_pc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfe.fused_equiv_fwd.launches = 0
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
    if not all(bool(m.initialized) for m in model.modules() if hasattr(m, "initialized")):
        raise SystemExit("a conv was not calibrated")
    return trainer, dict(step_s=median_s, all_s=step_s, peak_gib=peak / 2**30, launches=launches)


def dfaust_train(card, dev, batch) -> tuple:
    """7. the DFaust recipe's training at full width: a fresh seeded model
    and the recipe's ``Training`` section, one calibration step, then
    ``TRAIN_STEPS`` train steps on ``batch``, counting 21 forward and 21
    backward conv launches per step and checking finite losses and moved BN
    means.  Returns ``(trainer, {step_s, all_s, peak_gib, launches})``."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import FPNSegUNet, presets
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model_dict, training = presets.DFAUST_I_ROT_PCA_2F_MODEL, presets.DFAUST_I_ROT_PCA_2F_TRAINING
    model = seeded_model(FPNSegUNet, presets.spec_from_model_dict(model_dict), dev)
    opt = schedule.optimizer_from_training(model.parameters(), training, TRAIN_STEPS)
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=False),
                      label_smoothing=training["label_smoothing"], optimizer=opt)
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
    return trainer, dict(step_s=train_median, all_s=step_s, peak_gib=train_peak / 2**30,
                         launches=(train_fwd, train_bwd))


def scannet_rooms(dev) -> dict:
    """The ``SCENES`` synthetic rooms of ``SCENE_POINTS`` points of the
    ScanNet phases (numpy seeds 100-105), stacked on the card."""
    return to_device(stack_scenes([room_scene(SCENE_POINTS, 100 + i) for i in range(SCENES)]), dev)


def scannet_trainer(dev, room0):
    """Phase 13's trainer: the ScanNet recipe in float32, a fresh seeded
    model from ``build_model_from_config``, its optimizer over
    ``len(SCANNET_MODE_ORDER)`` steps and ``scan_scenes``, calibrated on
    ``room0``."""
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.config import build_model_from_config
    from se3conv3d_tpu_torch.train.trainer import Trainer

    s_model = {**presets.SCANNET20_ROT_PCA_I_MODEL, "compute_dtype": "float32"}
    s_training = presets.SCANNET20_ROT_PCA_I_TRAINING
    model = seed_gammas(build_model_from_config(s_model, presets.SCANNET_NUM_FEATURES,
                                                presets.SCANNET20_NUM_CLASSES,
                                                generator=torch.Generator().manual_seed(0)))
    opt = schedule.optimizer_from_training(model.parameters(), s_training, len(SCANNET_MODE_ORDER))
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(s_model, SCENE_POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(s_model, SCENE_POINTS, train=False),
                      label_smoothing=s_training["label_smoothing"],
                      ignore_label=presets.SCANNET20_IGNORE_LABEL, optimizer=opt,
                      scan_scenes=s_training["scan_scenes"])
    trainer.calibration_step(room0, torch.Generator(device=dev).manual_seed(120))
    return trainer


def forward_vs_plain(card, label, shp, args, live, bounds, seed) -> dict:
    """The forward kernel on the live rows ``live`` vs its plain version
    (over every row), two calls bitwise equal, and its time beside the plain
    version's and ``torch.matmul``'s for its weight contraction over the
    same live rows; fails the run on a disagreement."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    g = shp[4]
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args, live_rows=live)
        again = kfe.fused_equiv_fwd(*args, live_rows=live)
        ref = kfe.fused_equiv_fwd_reference(*args)
        torch.cuda.synchronize()
        err = max_rel_err(got, ref)
        finite, same = bool(torch.isfinite(got).all()), torch.equal(got, again)
        del got, again, ref
        ms = cuda_ms(lambda: kfe.fused_equiv_fwd(*args, live_rows=live), 20)
        plain_ms = cuda_ms(lambda: kfe.fused_equiv_fwd_reference(*args), 3)
    lib_ms = product_matmul_ms(live.numel() * g, args[7], seed)
    print(f"{label} B,M,N,K,G,F,Q,C,O={shp}: {live.numel()} live of {shp[0] * shp[1]} rows; "
          f"max_abs_err={err[0]:.3e} max_rel_err={err[1]:.3e} (bound {KERNEL_RTOL}); two calls "
          f"bitwise equal: {same}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']}, {bounds['gflop']:.2f} GFLOP, the weight "
          f"contraction at the 3xTF32 tensor-core ceiling; {bounds['bound_f32_ms']:.4f} with every "
          f"FLOP at the float32 peak); torch.matmul float32 (no TF32) for basis . W over the same "
          f"live rows {lib_ms:.4f} ms [{card}]", flush=True)
    if not (finite and same and err[1] <= KERNEL_RTOL):
        raise SystemExit(f"forward kernel disagrees with its plain version at {label}")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err[0], max_rel_err=err[1],
                library_ms=lib_ms, **bounds)


def scannet_conv_kernels(card, dev) -> dict:
    """9. conv forward and backward kernels vs plain at the ScanNet shapes,
    given the live-row table as the main path gives it, the forward bitwise
    equal over two calls, the backward in both feature-gradient output
    modes, and ``torch.matmul`` for their products.  (Their passes' device
    ms come last, in :func:`scannet_conv_passes`: a ``torch.profiler`` run
    slows the kernel launches that follow it, and the train steps are timed
    in between.)"""
    from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.ops.pne_conv import backward_sort_tables

    names = ("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights")
    out = {}
    for i, (name, (shp, n_live)) in enumerate(scannet_conv_cases().items()):
        b, m, n, k, g, f, q, c, o = shp
        args, gout = scannet_conv_args(i, shp, n_live, dev)
        live = kfe.live_row_table(args[4])
        bounds = conv_bounds(shp, args[4])
        fwd = forward_vs_plain(card, f"scannet_fwd_kernel_vs_plain {name}", shp, args, live,
                               bounds["fwd"], 57 + i)

        tabs = backward_sort_tables(Neighborhood(args[3], args[4], args[4].any(-1)), n)
        got = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
        ref = kfe.fused_equiv_bwd_reference(*args, gout)
        got_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live)
        ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot)
        summed = segsum.sorted_segment_sum(got_s[0], tabs.bwd_run_start, tabs.bwd_run_end)
        prefix_scale = float(segsum.blocked_cumsum(got_s[0]).abs().max())
        torch.cuda.synchronize()
        errs = {w: max_rel_err(x, y) for w, x, y in zip(names, got, ref)}
        errs_s = {w: max_rel_err(x, y) for w, x, y in zip(("d_sorted_rows",) + names[1:], got_s, ref_s)}
        # the segment sums against the plain scatter: prefix differences, so
        # the bound is SEGSUM_EPS_FACTOR * eps * max |prefix|, not relative
        seg_err = float((summed.reshape(ref[0].shape) - ref[0]).abs().max())
        seg_limit = SEGSUM_EPS_FACTOR * torch.finfo(torch.float32).eps * prefix_scale
        finite = all(bool(torch.isfinite(x).all()) for x in (*got, *got_s))
        again = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
        same_params = all(torch.equal(x, y) and torch.equal(x, z)
                          for x, y, z in zip(got[1:], got_s[1:], again[1:]))
        del got, ref, got_s, ref_s, summed, again
        bwd_ms = cuda_ms(lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live), 10)
        bwd_sorted_ms = cuda_ms(
            lambda: kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live), 10)
        bwd_plain = cuda_ms(lambda: kfe.fused_equiv_bwd_reference(*args, gout), 3)
        lib_ms = products_matmul_ms(live.numel() * g, args[7], 55 + i)
        for mode, e in (("scatter", errs), ("sorted", errs_s)):
            print(f"scannet_bwd_kernel_vs_plain {name} mode {mode}: "
                  + " ".join(f"{w}: max_abs_err={v[0]:.3e} max_rel_err={v[1]:.3e}" for w, v in e.items())
                  + f" (bound {BWD_RTOL}) [{card}]", flush=True)
        print(f"scannet_bwd_kernel_vs_plain {name} mode sorted: d_feats by segment sums of the rows: "
              f"max_abs_err={seg_err:.3e} (bound {seg_limit:.3e} = {SEGSUM_EPS_FACTOR} eps x max|prefix| "
              f"{prefix_scale:.3e}) [{card}]", flush=True)
        print(f"scannet_bwd_kernel_vs_plain {name}: {live.numel()} live of {b * m} rows; kernel_ms "
              f"scatter {bwd_ms:.4f} sorted-rows {bwd_sorted_ms:.4f} plain_ms {bwd_plain:.4f} "
              f"bound_ms={bounds['bwd']['bound_ms']:.4f} ({bounds['bwd']['bound_by']}, "
              f"{bounds['bwd']['gflop']:.2f} GFLOP, the two products at the 3xTF32 tensor-core "
              f"ceiling; {bounds['bwd']['bound_f32_ms']:.4f} with every FLOP at the float32 peak); "
              f"torch.matmul float32 (no TF32) for "
              f"d_w and dbasis over the same live rows {lib_ms:.4f} ms; parameter gradients equal "
              f"across modes and calls: {same_params} [{card}]", flush=True)
        if not (finite and same_params and seg_err <= seg_limit
                and all(v[1] <= BWD_RTOL for e in (errs, errs_s) for v in e.values())):
            raise SystemExit(f"backward kernel disagrees with its plain version at {name}")
        out[name] = dict(
            fwd=fwd,
            bwd=dict(ms=bwd_ms, ms_sorted_rows=bwd_sorted_ms, plain_ms=bwd_plain,
                     max_abs_err=max(v[0] for e in (errs, errs_s) for v in e.values()),
                     segment_sum_max_abs_err=seg_err, products_library_ms=lib_ms, **bounds["bwd"]),
        )
        del args, gout, tabs, live
        torch.cuda.empty_cache()
    return out


def scannet_conv_cases() -> dict:
    """Phase 9's convs: ``name: (shape, live rows per example or None)``."""
    cases = {name: (shp, None) for name, shp in SCANNET_SHAPES.items()}
    cases.update({name: (SCANNET_SHAPES[base], live) for name, (base, live) in SCANNET_PADDED.items()})
    return cases


def scannet_conv_args(i, shp, n_live, dev) -> tuple:
    """The seeded operands and ``gout`` of phase 9's ``i``-th conv; rows past
    ``n_live`` (if given) are padding, with no valid edge."""
    b, m, n, k, g, f, q, c, o = shp
    args = list(conv_inputs(*shp, seed=40 + i, dev=dev))
    if n_live is not None:
        args[4][:, n_live:] = False
    args[3] = torch.where(args[4], args[3], torch.zeros_like(args[3]))  # invalid slots hold 0
    gout = torch.randn(b, m, g, o, device=dev, generator=torch.Generator(device=dev).manual_seed(50 + i))
    return args, gout


def scannet_conv_passes(card, dev, conv: dict) -> None:
    """Device ms of each conv forward and backward pass at phase 9's shapes
    (``torch.profiler`` over 3 calls each), into ``conv[name]["fwd"]`` and
    ``conv[name]["bwd"]``."""
    from torch.profiler import ProfilerActivity, profile

    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    for i, (name, (shp, n_live)) in enumerate(scannet_conv_cases().items()):
        args, gout = scannet_conv_args(i, shp, n_live, dev)
        live = kfe.live_row_table(args[4])
        with torch.no_grad():
            runs = {"fwd": (lambda: kfe.fused_equiv_fwd(*args, live_rows=live), FWD_PASSES),
                    "bwd": (lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live), BWD_PASSES)}
            for what, (fn, passes) in runs.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                conv[name][what]["passes_ms"] = {p: ms / 3 for p, ms in
                                                 pass_ms(device_rows(prof), passes).items()}
        fwd, bwd = conv[name]["fwd"], conv[name]["bwd"]
        print(f"scannet_fwd_passes {name}: device ms per call "
              + ", ".join(f"{p} {ms:.4f}" for p, ms in fwd["passes_ms"].items())
              + f" (torch.matmul for the product {fwd['library_ms']:.4f}) [{card}]", flush=True)
        print(f"scannet_bwd_passes {name}: device ms per call "
              + ", ".join(f"{p} {ms:.4f}" for p, ms in bwd["passes_ms"].items())
              + f" (products: {bwd['passes_ms']['d_w product'] + bwd['passes_ms']['dbasis product']:.4f}; "
              f"torch.matmul {bwd['products_library_ms']:.4f}) [{card}]", flush=True)
        del args, gout, live
        torch.cuda.empty_cache()


def graph_ms(fn, side, calls: int = 5) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured on the stream
    ``side`` in one CUDA graph, whose replays (CUDA events, median of 5)
    hold no host time."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, 5) / calls
    del graph
    torch.cuda.empty_cache()
    return ms


def cumsum_device_ms(card, dev, cumsum: dict) -> None:
    """Device ms per call of the prefix-sum kernel at phase 10's shapes
    (``graph_ms``), into ``cumsum[name]``: the CUDA-event times there also
    hold each call's host time, which exceeds the kernel's at the level-4
    shape."""
    from se3conv3d_tpu_torch.kernels import segsum

    gen = torch.Generator(device=dev).manual_seed(61)
    side = torch.cuda.Stream()
    for name, (shape, dtype) in cumsum_cases().items():
        x = torch.randn(*shape, device=dev, generator=gen).to(dtype)
        y = torch.empty(x.shape, dtype=torch.float32, device=dev)
        c = cumsum[name]
        c["device_ms"] = ms = graph_ms(lambda: segsum.blocked_cumsum(x), side)
        c["copy_device_ms"] = copy_ms = graph_ms(lambda: y.copy_(x), side)
        print(f"cumsum_device_ms {name}: {ms:.4f} ms per call in a CUDA graph of 5 calls "
              f"({100 * c['bound_ms'] / ms:.1f}% of the {c['bound_ms']:.4f} ms bound; a float32 copy "
              f"of the same rows {copy_ms:.4f}, {100 * c['bound_ms'] / copy_ms:.1f}%; CUDA events "
              f"per call {c['ms']:.4f}) [{card}]", flush=True)
        del x, y
        torch.cuda.empty_cache()


def scannet_cumsum(card, dev) -> dict:
    """10. prefix-sum kernel vs plain (and torch.cumsum), and the segment sums
    vs index_add_ on the same per-edge rows."""
    from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.ops.pne_conv import backward_sort_tables

    out = {}
    gen = torch.Generator(device=dev).manual_seed(60)
    for name, (shape, dtype) in cumsum_cases().items():
        x = torch.randn(*shape, device=dev, generator=gen).to(dtype)
        x = x[0] if shape[0] == 1 else x  # [E, C], as the ScanNet step's single room
        got = segsum.blocked_cumsum(x)
        ref = segsum.blocked_cumsum_reference(x)
        torch.cuda.synchronize()
        err = max_rel_err(got, ref)
        finite = bool(torch.isfinite(got).all())
        same = all(torch.equal(segsum.blocked_cumsum(x), got) for _ in range(CUMSUM_REPEATS))
        del got, ref
        ms = cuda_ms(lambda: segsum.blocked_cumsum(x), 20)
        plain_ms = cuda_ms(lambda: segsum.blocked_cumsum_reference(x), 5)
        lib_ms = cuda_ms(lambda: torch.cumsum(x, -2, dtype=torch.float32), 3)
        # the card's reachable rate for the same bytes: a float32 copy of x
        y = torch.empty(x.shape, dtype=torch.float32, device=dev)
        copy_ms = cuda_ms(lambda: y.copy_(x), 20)
        del y
        # bytes: each payload element read once, each float32 output written once
        bound_ms = x.numel() * (x.element_size() + 4) / PEAK_BYTES_PER_S * 1e3
        print(f"cumsum_kernel_vs_plain {name} {list(shape)} {str(dtype)[6:]}: max_abs_err={err[0]:.3e} "
              f"max_rel_err={err[1]:.3e} (bound {CUMSUM_RTOL}); {CUMSUM_REPEATS} more calls bitwise "
              f"equal: {same}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} torch.cumsum_ms={lib_ms:.4f} "
              f"bound_ms={bound_ms:.4f} (bytes; {100 * bound_ms / ms:.1f}% of it; a float32 copy of "
              f"x {copy_ms:.4f}) [{card}]", flush=True)
        if not (finite and same and err[1] <= CUMSUM_RTOL):
            raise SystemExit(f"prefix-sum kernel disagrees with its plain version, or with itself, at {name}")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_share=bound_ms / ms, copy_ms=copy_ms, max_abs_err=err[0])
        del x
        torch.cuda.empty_cache()

    # segment sums of the level-0 conv's per-edge rows vs index_add_ of the same rows
    b, m, n, k = SCANNET_SHAPES["scannet_level0_block_conv"][:4]
    c = SCANNET_SHAPES["scannet_level0_block_conv"][7]
    idx = torch.randint(0, n, (b, m, k), generator=gen, device=dev)
    mask = torch.rand(b, m, k, generator=gen, device=dev) < 0.7
    idx = torch.where(mask, idx, torch.zeros_like(idx))
    tabs = backward_sort_tables(Neighborhood(idx, mask, mask.any(-1)), n)
    rows = torch.randn(m * k, c, device=dev, generator=gen) * mask.reshape(-1, 1)
    srt = rows[tabs.bwd_perm[0]].contiguous()
    flat = idx.reshape(-1)
    seg = segsum.sorted_segment_sum(srt, tabs.bwd_run_start[0], tabs.bwd_run_end[0])
    lib = torch.zeros(n, c, device=dev).index_add_(0, flat, rows)
    scale = float(segsum.blocked_cumsum(srt).abs().max())
    err = float((seg - lib).abs().max())
    limit = SEGSUM_EPS_FACTOR * torch.finfo(torch.float32).eps * scale
    seg_ms = cuda_ms(lambda: segsum.sorted_segment_sum(srt, tabs.bwd_run_start[0], tabs.bwd_run_end[0]), 20)
    lib_ms = cuda_ms(lambda: torch.zeros(n, c, device=dev).index_add_(0, flat, rows), 20)
    # bound: read the sorted rows and the two int64 run tables once, write the sums once
    seg_bound = (4.0 * m * k * c + 16.0 * n + 4.0 * n * c) / PEAK_BYTES_PER_S * 1e3
    print(f"segment_sum_vs_index_add scannet_level0 [{m * k} x {c}] -> [{n} x {c}]: max_abs_err="
          f"{err:.3e} (bound {limit:.3e} = {SEGSUM_EPS_FACTOR} eps x max|prefix| {scale:.3e}) "
          f"sorted_segment_sum_ms={seg_ms:.4f} index_add_ms={lib_ms:.4f} bound_ms={seg_bound:.4f} "
          f"(bytes) [{card}]", flush=True)
    if not err <= limit:
        raise SystemExit("sorted segment sums disagree with index_add_")
    out["segment_sum_level0"] = dict(ms=seg_ms, library_ms=lib_ms, max_abs_err=err, bound_ms=seg_bound)
    return out


def compare_neighbors(grid, brute, src_pos, query_pos) -> tuple:
    """``(rows equal, rows differing only by a distance tie at the cut)``;
    raises on any other difference."""
    def sets(nb_idx, nb_mask):
        return torch.sort(torch.where(nb_mask, nb_idx, torch.full_like(nb_idx, -1)), -1).values

    def kth(nb_idx, nb_mask):
        d2 = ((src_pos[0][nb_idx[0]] - query_pos[0][:, None, :]) ** 2).sum(-1)
        return torch.where(nb_mask[0], d2, torch.zeros_like(d2)).amax(-1)

    differ = (sets(*grid) != sets(*brute)).any(-1)[0]
    ties = 0
    if bool(differ.any()):
        dg, db = kth(*grid)[differ], kth(*brute)[differ]
        same_count = grid[1][0][differ].sum(-1) == brute[1][0][differ].sum(-1)
        tie = same_count & ((dg - db).abs() <= 1e-6 * db.clamp(min=1e-12))
        if not bool(tie.all()):
            raise SystemExit(f"grid and brute-force neighbors differ on {int((~tie).sum())} rows")
        ties = int(tie.sum())
    return int((~differ).sum()), ties


def scannet_grid_vs_brute(card, h, out_pc, spacing) -> dict:
    """11. grid searches vs brute force on one full-capacity room."""
    from se3conv3d_tpu_torch.core import neighborhoods as nb

    lvl0 = h.levels[0]
    radius = 2.0 * spacing
    cases = {
        "level0_self_ball_query_r0.2_k24": (
            lambda: nb.ball_query_neighborhood(lvl0, lvl0, radius, 24),
            lambda: nb._chunked_topk_neighbors(lvl0.positions, lvl0.mask, lvl0.positions,
                                               lvl0.mask, 24, radius ** 2, 1024), lvl0),
        "level0_self_knn16_frames": (
            lambda: nb.knn_neighborhood(lvl0, lvl0, 16,
                                        grid_cell_size=nb.SUBSAMPLED_SPACING_FACTOR * spacing),
            lambda: nb._chunked_topk_neighbors(lvl0.positions, lvl0.mask, lvl0.positions,
                                               lvl0.mask, 16, None, 1024), lvl0),
        "output_cloud_to_level0_ball_query": (
            lambda: nb.ball_query_neighborhood(lvl0, out_pc, radius, 24),
            lambda: nb._chunked_topk_neighbors(lvl0.positions, lvl0.mask, out_pc.positions,
                                               out_pc.mask, 24, radius ** 2, 1024), out_pc),
    }
    out = {}
    for name, (grid_fn, brute_fn, query) in cases.items():
        grid, brute = grid_fn(), brute_fn()
        equal, ties = compare_neighbors((grid.idx, grid.mask), brute[:2], lvl0.positions,
                                        query.positions)
        grid_ms, brute_ms = cuda_ms(grid_fn, 3), cuda_ms(brute_fn, 3)
        rows = int(query.mask.sum())
        print(f"grid_vs_brute {name}: {equal} of {query.capacity} rows equal ({rows} valid queries), "
              f"{ties} differ only by a distance tie at the cut; grid {grid_ms:.3f} ms, brute force "
              f"{brute_ms:.3f} ms [{card}]", flush=True)
        out[name] = dict(grid_ms=grid_ms, brute_ms=brute_ms, tie_rows=ties)
    return out


def occupancy_line(h, out_pc) -> str:
    occ = [int(pc.mask.sum(1).max()) for pc in h.levels] + [int(out_pc.mask.sum(1).max())]
    caps = [pc.capacity for pc in h.levels] + [out_pc.capacity]
    if any(o >= c or o == 0 for o, c in zip(occ, caps)):
        raise SystemExit(f"a synthetic room fills (or empties) a level: {occ} of {caps}")
    return f"max valid points per level {occ[:-1]} of capacities {caps[:-1]}; output cloud {occ[-1]} of {caps[-1]}"


class SharedSearches:
    """Neighbor tables of one forward, reused by a later one.

    Under ``recording()`` every search of the model's neighborhood provider
    keeps its ``(idx, mask, trunc)``; under ``replaying()`` the searches,
    called in the same order, return those tables instead, while the
    provider recomputes the edge geometry on the clouds it is given.  A
    rotated forward that replays the unrotated one's tables checks the
    model's invariance apart from the searches: a global rotation re-rounds
    every float32 position, and a source at the radius or at the cap (the
    nearest ``max_neighbors``) can fall on the other side.  Under
    ``watching()`` the searches run and keep their tables, and
    ``rows_that_differ()`` counts the rows that differ from the recorded
    ones.
    """

    def __init__(self):
        self.tables, self.watched, self._mode, self._next = [], [], None, 0

    @contextlib.contextmanager
    def _patched(self, mode):
        from se3conv3d_tpu_torch.models import spec

        saved = spec.ball_query_neighborhood, spec.knn_neighborhood
        self._mode, self._next = mode, 0
        spec.ball_query_neighborhood, spec.knn_neighborhood = (self._wrap(f) for f in saved)
        try:
            yield
        finally:
            spec.ball_query_neighborhood, spec.knn_neighborhood = saved
            self._mode = None

    def recording(self):
        return self._patched("record")

    def replaying(self):
        return self._patched("replay")

    def watching(self):
        return self._patched("watch")

    def _wrap(self, search):
        def run(*args, **kwargs):
            nb = search(*args, **kwargs)
            if self._mode == "replay":
                idx, mask, trunc = self.tables[self._next]
                self._next += 1
                return dataclasses.replace(nb, idx=idx, mask=mask, trunc=trunc)
            (self.tables if self._mode == "record" else self.watched).append((nb.idx, nb.mask, nb.trunc))
            return nb
        return run

    def rows_that_differ(self) -> int:
        def sets(idx, mask):
            return torch.sort(torch.where(mask, idx, torch.full_like(idx, -1)), -1).values

        return sum(int((sets(*a[:2]) != sets(*b[:2])).any(-1).sum())
                   for a, b in zip(self.tables, self.watched))


def scannet_eval(card, dev, model, trainer, scene, kfe, num_classes) -> dict:
    """12. calibration and eval steps on one room, rotation invariance, and
    card vs CPU logits on a smaller room."""
    from se3conv3d_tpu_torch.core.hierarchy import rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.rotation import random_rotations

    gen = torch.Generator(device=dev).manual_seed(70)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfe.fused_equiv_fwd.launches = 0
    with watching_live_rows(kfe, "fused_equiv_fwd") as seen:
        t0 = time.perf_counter()
        trainer.calibration_step(scene, gen)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        calib_launches = kfe.fused_equiv_fwd.launches
        step_s, outs = [], None
        for _ in range(SCANNET_EVAL_STEPS):
            t0 = time.perf_counter()
            outs = trainer.eval_step(scene, gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    launches = kfe.fused_equiv_fwd.launches
    check_live_rows(card, "calibration and eval, conv forwards", seen, SCANNET_CONVS * (1 + SCANNET_EVAL_STEPS))
    peak = torch.cuda.max_memory_allocated()
    median_s = statistics.median(step_s)
    logits = outs["logits"]
    print(f"scannet_eval: calibration_step {calib_s:.4f} s, eval_step median {median_s:.4f} s (all "
          f"{[round(s, 4) for s in step_s]}), {SCENE_POINTS / median_s:.1f} input points/s, peak "
          f"memory {peak / 2**30:.3f} GiB, loss {float(outs['loss']):.4f}; fwd kernel launches "
          f"{launches} = {calib_launches} + {launches - calib_launches} [{card}]", flush=True)
    if calib_launches != SCANNET_CONVS or launches != SCANNET_CONVS * (1 + SCANNET_EVAL_STEPS):
        raise SystemExit(f"expected {SCANNET_CONVS} forward kernel launches per ScanNet forward")
    if tuple(logits.shape) != (1, trainer.eval_hcfg.out_capacity, num_classes) \
            or not torch.isfinite(logits).all():
        raise SystemExit(f"bad ScanNet logits: shape {tuple(logits.shape)}")

    h, f0, out_pc, _, _ = trainer.build(scene, torch.Generator(device=dev).manual_seed(71), train=False)
    rot = random_rotations(1, generator=torch.Generator().manual_seed(72))[0].to(dev)
    searches = SharedSearches()
    with torch.no_grad(), searches.recording():
        base = model(h, f0, out_pc)
    with torch.no_grad(), searches.watching():
        rotated = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
    with torch.no_grad(), searches.replaying():
        rotated_shared = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
    valid = out_pc.mask
    own = (base - rotated).abs()[valid].amax(-1)
    rot_err = (base - rotated_shared).abs()[valid].max().item()
    print(f"scannet_invariance: max |logits - logits(rotated)| = {rot_err:.3e} (bound {ROT_ATOL}) over "
          f"{int(valid.sum())} valid output points, the rotated forward reusing the unrotated "
          f"forward's neighbor tables (its geometry recomputed); with its own searches "
          f"{own.max().item():.3e}, {int((own > 1e-5).sum())} points above 1e-5, "
          f"{searches.rows_that_differ()} neighbor rows that flipped at the "
          f"radius or the cap under float32 rounding of the rotated positions [{card}]", flush=True)
    if not rot_err <= ROT_ATOL:
        raise SystemExit("ScanNet logits change under a global rotation")
    del base, rotated, h, f0, out_pc

    small_cfg = dataclasses.replace(trainer.eval_hcfg, capacities=tuple(SMALL_CAPS),
                                    out_capacity=SMALL_CAPS[0])
    room = to_device({k: v[None] for k, v in room_scene(SMALL_ROOM_POINTS, 73, (4.0, 4.0, 2.5)).items()}, dev)
    h, f0, out_pc, _, _ = type(trainer)(model, small_cfg).build(
        room, torch.Generator(device=dev).manual_seed(74), train=False)
    print(f"scannet_card_vs_cpu room: {occupancy_line(h, out_pc)}")
    with torch.no_grad():
        card_logits = model(h, f0, out_pc)
        t0 = time.perf_counter()
        cpu_logits = copy.deepcopy(model).cpu()(h.to("cpu"), f0.cpu(), out_pc.to("cpu"))
        cpu_s = time.perf_counter() - t0
    cpu_err = (card_logits.cpu() - cpu_logits).abs()[out_pc.mask.cpu()].max().item()
    print(f"scannet_card_vs_cpu: max |logits(card) - logits(cpu)| = {cpu_err:.3e} (bound {CPU_ATOL}), "
          f"max |logits| {card_logits.abs().max().item():.3e}; CPU forward {cpu_s:.1f} s [{card}]",
          flush=True)
    if not cpu_err <= CPU_ATOL:
        raise SystemExit("ScanNet card and CPU logits disagree")
    return dict(launches=launches, eval_s=median_s, peak_gib=peak / 2**30)


def scannet_train(card, dev, trainer, batch, kfe, segsum, ops) -> dict:
    """13. scan_scenes train steps, the two backward modes in turns."""
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm

    model = trainer.model
    gen = torch.Generator(device=dev).manual_seed(80)
    bns = {n: mod for n, mod in model.named_modules() if isinstance(mod, MaskedBatchNorm)}
    bn_before = {n: mod.mean.clone() for n, mod in bns.items()}
    counts = {mode: [0, 0, 0] for mode in ("scatter", "sorted")}
    times = {mode: [] for mode in counts}
    peaks = {mode: 0 for mode in counts}
    want_fwd = SCANNET_CONVS * SCENES
    for step, mode in enumerate(SCANNET_MODE_ORDER):
        ops.BWD_SCATTER_MODE = mode
        lr = trainer.optimizer.lr
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kfe.fused_equiv_fwd.launches = kfe.fused_equiv_bwd.launches = segsum.blocked_cumsum.launches = 0
        t0 = time.perf_counter()
        out = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches, segsum.blocked_cumsum.launches)
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        peak = torch.cuda.max_memory_allocated()
        print(f"scannet_train: step {step} mode {mode} lr {lr:.6e} loss {loss:.6f} grad_norm {gnorm:.6f} "
              f"launches fwd {n[0]} bwd {n[1]} cumsum {n[2]} time {dt:.4f} s peak "
              f"{peak / 2**30:.3f} GiB [{card}]", flush=True)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise SystemExit("non-finite loss or gradients in a ScanNet train step")
        want = (want_fwd, want_fwd, want_fwd if mode == "sorted" else 0)
        if n != want:
            raise SystemExit(f"ScanNet train step in mode {mode}: launches {n}, expected {want}")
        times[mode].append(dt)
        peaks[mode] = max(peaks[mode], peak)
        for j in range(3):
            counts[mode][j] += n[j]
    ops.BWD_SCATTER_MODE = "scatter"
    result = {}
    for mode in counts:
        med = statistics.median(times[mode])
        print(f"scannet_train: mode {mode}: step median {med:.4f} s (all {[round(x, 4) for x in times[mode]]}), "
              f"{SCENES * SCENE_POINTS / med:.1f} input points/s, peak memory {peaks[mode] / 2**30:.3f} GiB, "
              f"float32 [{card}]", flush=True)
        result[mode] = dict(step_s=med, peak_gib=peaks[mode] / 2**30, launches=counts[mode])
    still = [n for n, mod in bns.items() if torch.equal(mod.mean, bn_before[n])]
    print(f"scannet_train: {len(bns) - len(still)} of {len(bns)} BN running means moved")
    if still:
        raise SystemExit(f"BN running mean did not move: {still[:5]}")
    return result


@contextlib.contextmanager
def watching_live_rows(kfe, name="fused_equiv_bwd"):
    """Within: each call of the conv wrapper ``name`` (``fused_equiv_fwd``
    or ``fused_equiv_bwd``) records ``(live rows it was given, or -1 if
    none, capacity rows B*M)``."""
    real, seen = getattr(kfe, name), []
    at = {"fused_equiv_fwd": 8, "fused_equiv_bwd": 10}[name]  # live_rows' position

    def watched(*args, **kwargs):
        live = kwargs.get("live_rows", args[at] if len(args) > at else None)
        seen.append((-1 if live is None else live.numel(), args[4].shape[0] * args[4].shape[1]))
        return real(*args, **kwargs)

    # the wrapper counts its launches on the module's attribute `name`:
    # here that is `watched`, which carries the count and hands it back
    watched.launches = real.launches
    setattr(kfe, name, watched)
    try:
        yield seen
    finally:
        setattr(kfe, name, real)
        real.launches = watched.launches


def check_live_rows(card, label, seen, want) -> tuple:
    """Prints the live rows ``seen`` walked against their capacity rows and
    fails the run unless there were ``want`` calls, each given a table."""
    live, cap = sum(x[0] for x in seen if x[0] > 0), sum(x[1] for x in seen)
    print(f"scannet_live_rows: {label}: {len(seen)} calls walked {live} live rows of {cap} "
          f"capacity rows ({100.0 * live / max(cap, 1):.2f}%) [{card}]", flush=True)
    if len(seen) != want or any(x[0] < 0 for x in seen):
        raise SystemExit(f"{label}: a conv was not given its neighborhood's live-row table")
    return live, cap


def scannet_split(card, dev, trainer, batch, ops, drop_path_draws, kfe) -> dict:
    """Host-clock split of one scan_scenes step per backward mode, with a
    synchronise at each boundary: per room the hierarchy build, the
    train-mode forward with the loss, and the backward; then the optimizer.
    Also counts the live rows the step's conv forwards and backwards walked
    against their capacity rows; each must have been given its
    neighborhood's table (no host synchronisation per conv)."""
    from se3conv3d_tpu_torch.train.losses import masked_segmentation_loss_parts

    model, gen = trainer.model, torch.Generator(device=dev).manual_seed(85)
    out = {}
    for mode in ("scatter", "sorted"):
        ops.BWD_SCATTER_MODE = mode
        parts = {"build": 0.0, "forward": 0.0, "backward": 0.0}
        model.train()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        with watching_live_rows(kfe, "fused_equiv_fwd") as fwd_seen, watching_live_rows(kfe) as seen:
            for i in range(batch["mask"].shape[0]):
                t0 = time.perf_counter()
                h, f0, out_pc, labels, _ = trainer.build({k: v[i : i + 1] for k, v in batch.items()}, gen)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                total, _ = masked_segmentation_loss_parts(
                    model(h, f0, out_pc, drops=drop_path_draws(gen)), labels, out_pc.mask,
                    trainer.label_smoothing, trainer.ignore_label)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                total.backward()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                parts["build"] += t1 - t0
                parts["forward"] += t2 - t1
                parts["backward"] += t3 - t2
        t0 = time.perf_counter()
        trainer.optimizer.step()
        torch.cuda.synchronize()
        parts["optimizer"] = time.perf_counter() - t0
        out[mode] = {k: v * 1e3 for k, v in parts.items()}
        print(f"scannet_split: mode {mode}, ms per step of {batch['mask'].shape[0]} rooms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in out[mode].items()) + f" [{card}]", flush=True)
        check_live_rows(card, f"train mode {mode}, conv forwards", fwd_seen, SCANNET_CONVS * SCENES)
        live, cap = check_live_rows(card, f"train mode {mode}, conv backwards", seen,
                                    SCANNET_CONVS * SCENES)
        out[mode]["live_rows"], out[mode]["capacity_rows"] = live, cap
    ops.BWD_SCATTER_MODE = "scatter"
    return out


def scannet_profile(card, trainer, batch, ops) -> dict:
    """Device time by kernel over one scan_scenes train step per backward
    mode (``torch.profiler``): the busy total, the idle share of the
    step's wall time, the kernels that take the most, and the conv
    forward's and backward's passes."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=batch["mask"].device).manual_seed(87)
    out = {}
    for mode in ("scatter", "sorted"):
        ops.BWD_SCATTER_MODE = mode
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        fwd_passes, passes = pass_ms(rows, FWD_PASSES), pass_ms(rows)
        print(f"scannet_profile: mode {mode}: step {wall_ms:.1f} ms under the profiler, device busy "
              f"{busy:.1f} ms ({100 * (1 - busy / wall_ms):.1f}% idle), {sum(r[1] for r in rows)} kernel "
              f"launches [{card}]", flush=True)
        for ms, n, key in rows[:14]:
            print(f"scannet_profile:   {ms:9.2f} ms {n:6d}x {key[:110]}")
        cumsum = pass_ms(rows, CUMSUM_PASSES)
        for what, ps in (("forward", fwd_passes), ("backward", passes), ("prefix sum", cumsum)):
            print(f"scannet_profile: mode {mode}: conv {what} {sum(ps.values()):.2f} ms: "
                  + ", ".join(f"{p} {ms:.2f}" for p, ms in ps.items()) + f" [{card}]", flush=True)
        out[mode] = dict(wall_ms=wall_ms, busy_ms=busy, fwd_passes_ms=fwd_passes, bwd_passes_ms=passes,
                         cumsum_ms=cumsum, top=[(k[:110], ms, n) for ms, n, k in rows[:14]])
    ops.BWD_SCATTER_MODE = "scatter"
    return out


def scannet_mode_grads(card, dev, trainer, scene, ops, recorded_draws, drop_path_draws) -> None:
    """14. one room's parameter gradients, sorted vs scatter mode, with the
    same hierarchy and DropPath keep masks."""
    from se3conv3d_tpu_torch.train import schedule

    model = trainer.model
    h, f0, out_pc, out_labels, _ = trainer.build(scene, torch.Generator(device=dev).manual_seed(90))
    draws = recorded_draws(torch.Generator(device=dev).manual_seed(91))
    ops.BWD_SCATTER_MODE = "scatter"
    scatter_loss = float(trainer.backward(h, f0, out_pc, out_labels, draws))
    scatter = {n: p.grad.clone() for n, p in model.named_parameters()}
    ops.BWD_SCATTER_MODE = "sorted"
    sorted_loss = float(trainer.backward(h, f0, out_pc, out_labels, drop_path_draws(keep_masks=draws.masks)))
    ops.BWD_SCATTER_MODE = "scatter"
    norm = float(schedule.global_norm(list(scatter.values())))
    worst, worst_name = 0.0, None
    for n, p in model.named_parameters():
        ref = scatter[n]
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise SystemExit(f"missing or non-finite sorted-mode gradient for {n}")
        ratio = (p.grad - ref).abs().max().item() / max(ref.abs().max().item(), GRAD_FLOOR * norm)
        if ratio > worst:
            worst, worst_name = ratio, n
    print(f"scannet_grads_sorted_vs_scatter: loss {sorted_loss:.6f} vs {scatter_loss:.6f}; "
          f"{len(scatter)} leaves, global norm {norm:.6f}, {len(draws.masks)} DropPath masks; worst "
          f"max|sorted - scatter| / max(max|leaf|, {GRAD_FLOOR} * norm) = {worst:.3e} at {worst_name} "
          f"(bound {GRAD_RTOL}) [{card}]", flush=True)
    if not (worst <= GRAD_RTOL and abs(sorted_loss - scatter_loss) <= GRAD_RTOL * abs(scatter_loss)):
        raise SystemExit("sorted and scatter gradients disagree")


def run_scannet(card, dev, recorded_draws, drop_path_draws) -> dict:
    """Phases 9-14 (the ScanNet slice); returns their measurements."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.ops import pne_conv as ops
    from se3conv3d_tpu_torch.train.config import build_model_from_config
    from se3conv3d_tpu_torch.train.trainer import Trainer

    # 9.-10. the ScanNet conv shapes, the prefix sum and the segment sums
    scan_conv = scannet_conv_kernels(card, dev)
    scan_cumsum = scannet_cumsum(card, dev)
    torch.cuda.empty_cache()

    # 11.-12. the ScanNet model on synthetic rooms: grid searches, eval path
    s_model = {**presets.SCANNET20_ROT_PCA_I_MODEL, "compute_dtype": "float32"}
    s_training = presets.SCANNET20_ROT_PCA_I_TRAINING
    s_hcfg = presets.hierarchy_config_from_model_dict(s_model, SCENE_POINTS, train=True)
    s_eval_hcfg = presets.hierarchy_config_from_model_dict(s_model, SCENE_POINTS, train=False)
    feats, classes = presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES
    rooms = scannet_rooms(dev)
    model = seed_gammas(build_model_from_config(s_model, feats, classes,
                                                generator=torch.Generator().manual_seed(0)))
    if next(model.parameters()).device.type != dev.type:
        raise SystemExit("build_model_from_config did not put the model on the card")
    trainer = Trainer(model, s_hcfg, s_eval_hcfg, label_smoothing=s_training["label_smoothing"],
                      ignore_label=presets.SCANNET20_IGNORE_LABEL)
    for i in range(SCENES):
        h, _, out_pc, _, _ = trainer.build({k: v[i : i + 1] for k, v in rooms.items()},
                                           torch.Generator(device=dev).manual_seed(110 + i), train=False)
        print(f"scannet room {i}: {occupancy_line(h, out_pc)}", flush=True)
    room0 = {k: v[:1] for k, v in rooms.items()}
    h, _, out_pc, _, _ = trainer.build(room0, torch.Generator(device=dev).manual_seed(110), train=False)
    grid = scannet_grid_vs_brute(card, h, out_pc, s_hcfg.init_cell_size)
    del h, out_pc
    scan_eval = scannet_eval(card, dev, model, trainer, room0, kfe, classes)
    del model, trainer
    torch.cuda.empty_cache()

    # 13.-14. scan_scenes training, the two backward modes in turns
    trainer = scannet_trainer(dev, room0)
    scan_train = scannet_train(card, dev, trainer, rooms, kfe, segsum, ops)
    scan_train["split_ms"] = scannet_split(card, dev, trainer, rooms, ops, drop_path_draws, kfe)
    scan_train["profile"] = scannet_profile(card, trainer, rooms, ops)
    scannet_mode_grads(card, dev, trainer, room0, ops, recorded_draws, drop_path_draws)
    del trainer, rooms
    torch.cuda.empty_cache()
    scannet_conv_passes(card, dev, scan_conv)
    cumsum_device_ms(card, dev, scan_cumsum)

    return dict(conv=scan_conv, cumsum=scan_cumsum, grid=grid, eval=scan_eval, train=scan_train)


def kernels_line(dfaust: dict, scan: dict) -> dict:
    """The ``{"kernels": [...]}`` object: every kernel with its launches on
    the main paths, its error against its plain version, and its times."""
    compared, bwd_compared = dfaust["fwd"], dfaust["bwd"]
    scan_conv, scan_cumsum, scan_train = scan["conv"], scan["cumsum"], scan["train"]
    lvl0 = SCANNET_SHAPES["scannet_level0_block_conv"]
    fwd0, bwd0 = scan_conv["scannet_level0_block_conv"]["fwd"], scan_conv["scannet_level0_block_conv"]["bwd"]
    fwd_paths = {"dfaust_eval": dfaust["eval_launches"], "dfaust_train": dfaust["train_fwd"],
                 "scannet_eval": scan["eval"]["launches"],
                 "scannet_train_scatter": scan_train["scatter"]["launches"][0],
                 "scannet_train_sorted": scan_train["sorted"]["launches"][0]}
    bwd_paths = {"dfaust_train": dfaust["train_bwd"], "scannet_train_scatter": scan_train["scatter"]["launches"][1],
                 "scannet_train_sorted": scan_train["sorted"]["launches"][1]}
    cumsum_paths = {"scannet_train_scatter": scan_train["scatter"]["launches"][2],
                    "scannet_train_sorted": scan_train["sorted"]["launches"][2]}
    at = f"scannet level-0 block conv B,M,N,K,G,F,Q,C,O={lvl0}"
    by_shape_fwd = {**compared, **{k: v["fwd"] for k, v in scan_conv.items()}}
    by_shape_bwd = {**bwd_compared, **{k: v["bwd"] for k, v in scan_conv.items()}}
    c0 = scan_cumsum["scannet_level0_edges"]
    return {"kernels": [{
        "name": "fused_equiv_fwd",
        "route": "cuda",
        "source": "se3conv3d_tpu_torch/kernels/csrc/fused_equiv_fwd.cu",
        "replaces": "se3conv3d_tpu/ops/pallas/fused_equiv.py:196",
        "launches": sum(fwd_paths.values()),
        "launches_by_path": fwd_paths,
        "max_abs_err": max(v["max_abs_err"] for v in by_shape_fwd.values()),
        "ms": fwd0["ms"], "plain_ms": fwd0["plain_ms"],
        "bound_ms": fwd0["bound_ms"], "bound_by": fwd0["bound_by"], "bound_f32_ms": fwd0["bound_f32_ms"],
        "library_ms": fwd0["library_ms"],
        "library_call": "torch.matmul, float32 without TF32, for the weight contraction basis . W "
                        "over the same live rows (no PyTorch call computes the whole forward)",
        "at": at, "by_shape": by_shape_fwd,
    }, {
        "name": "fused_equiv_bwd",
        "route": "cuda",
        "source": "se3conv3d_tpu_torch/kernels/csrc/fused_equiv_bwd.cu",
        "replaces": "se3conv3d_tpu/ops/pallas/fused_equiv.py:227",
        "launches": sum(bwd_paths.values()),
        "launches_by_path": bwd_paths,
        "max_abs_err": max(v["max_abs_err"] for v in by_shape_bwd.values()),
        "ms": bwd0["ms"], "plain_ms": bwd0["plain_ms"],
        "bound_ms": bwd0["bound_ms"], "bound_by": bwd0["bound_by"], "bound_f32_ms": bwd0["bound_f32_ms"],
        "library_ms": bwd0["products_library_ms"],
        "library_call": "torch.matmul, float32 without TF32, for the d_w and dbasis products "
                        "over the same live rows (no PyTorch call computes the whole backward)",
        "at": at, "by_shape": by_shape_bwd,
    }, {
        "name": "blocked_cumsum",
        "route": "cuda",
        "source": "se3conv3d_tpu_torch/kernels/csrc/segsum_cumsum.cu",
        "replaces": "se3conv3d_tpu/ops/pallas/segsum.py:38",
        "launches": sum(cumsum_paths.values()),
        "launches_by_path": cumsum_paths,
        "max_abs_err": max(v["max_abs_err"] for v in scan_cumsum.values()),
        "ms": c0["ms"], "plain_ms": c0["plain_ms"],
        "bound_ms": c0["bound_ms"], "bound_by": "bytes", "library_ms": c0["library_ms"],
        "library_call": "torch.cumsum along the rows with a float32 output",
        "at": f"scannet level-0 edges [{lvl0[1] * lvl0[3]} x {lvl0[7]}]", "by_shape": scan_cumsum,
    }], "scannet": {"eval": scan["eval"], "train": scan_train, "grid_vs_brute": scan["grid"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    import se3conv3d_tpu_torch
    if Path(se3conv3d_tpu_torch.__file__).resolve().parent.parent != REPO:
        print("chip_smoke: run it from the repository that holds it", file=sys.stderr)
        return 1
    from se3conv3d_tpu_torch.core.hierarchy import rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
    from se3conv3d_tpu_torch.core.rotation import random_rotations
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels.build import build_libraries
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws
    from se3conv3d_tpu_torch.ops.pne_conv import backward_sort_tables
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
    libs = build_libraries(verbose=True)
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
    for i, (name, shp) in enumerate(shapes.items()):
        args = conv_inputs(*shp, seed=10 + i, dev=dev)
        compared[name] = forward_vs_plain(card, f"kernel_vs_plain {name}", shp, args,
                                          kfe.live_row_table(args[4]), conv_bounds(shp, args[4])["fwd"],
                                          15 + i)
        del args
        torch.cuda.empty_cache()

    # 3. the slice at full width
    model_dict = presets.DFAUST_I_ROT_PCA_2F_MODEL
    hcfg = presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True)
    batch = to_device(body_batch(BATCH, POINTS, seed=2), dev)
    trainer, dfaust_eval_run = dfaust_eval(card, dev, batch)
    model, launches = trainer.model, dfaust_eval_run["launches"]

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

    del model, trainer, base, rotated, cpu_model, cpu_logits, h, f0, out_pc
    torch.cuda.empty_cache()

    # 6. backward kernel vs plain
    bwd_compared = {}
    for i, (name, shp) in enumerate(shapes.items()):
        args = conv_inputs(*shp, seed=20 + i, dev=dev)
        b, m, _, _, g_, _, _, _, o = shp
        gout = torch.randn(b, m, g_, o, device=dev, generator=torch.Generator(device=dev).manual_seed(30 + i))
        got = kfe.fused_equiv_bwd(*args, gout)
        ref = kfe.fused_equiv_bwd_reference(*args, gout)
        # the sorted-slot output mode, and the parameter gradients bitwise
        # equal across modes and calls
        slot = backward_sort_tables(Neighborhood(args[3], args[4], args[4].any(-1)), shp[2]).bwd_slot
        got_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot)
        ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=slot)
        again = kfe.fused_equiv_bwd(*args, gout)
        torch.cuda.synchronize()
        errs = {what: max_rel_err(x, y) for what, x, y in
                zip(("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights"), got, ref)}
        errs["d_sorted_rows"] = max_rel_err(got_s[0], ref_s[0])
        finite = all(bool(torch.isfinite(x).all()) for x in (*got, got_s[0]))
        same_params = all(torch.equal(x, y) and torch.equal(x, z)
                          for x, y, z in zip(got[1:], got_s[1:], again[1:]))
        del got, ref, got_s, ref_s, again, slot
        ms = cuda_ms(lambda: kfe.fused_equiv_bwd(*args, gout), 10)
        plain_ms = cuda_ms(lambda: kfe.fused_equiv_bwd_reference(*args, gout), 3)
        bounds = conv_bounds(shp, args[4])["bwd"]
        lib_ms = products_matmul_ms(bounds["live_rows"] * g_, args[7], 35 + i)
        bwd_compared[name] = dict(max_abs_err=max(e[0] for e in errs.values()),
                                  max_rel_err=max(e[1] for e in errs.values()), ms=ms, plain_ms=plain_ms,
                                  products_library_ms=lib_ms, **bounds)
        print(f"bwd_kernel_vs_plain {name} B,M,N,K,G,F,Q,C,O={shp}: "
              + " ".join(f"{w}: max_abs_err={e[0]:.3e} max_rel_err={e[1]:.3e}" for w, e in errs.items())
              + f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (bound {BWD_RTOL}); bound_ms="
              f"{bounds['bound_ms']:.4f} ({bounds['bound_by']}, the two products at the 3xTF32 "
              f"tensor-core ceiling; {bounds['bound_f32_ms']:.4f} with every FLOP at the float32 "
              f"peak); torch.matmul float32 for d_w and dbasis "
              f"{lib_ms:.4f} ms; parameter gradients equal across modes and calls: {same_params} "
              f"[{card}]", flush=True)
        if not (finite and same_params and all(e[1] <= BWD_RTOL for e in errs.values())):
            raise SystemExit(f"backward kernel disagrees with its plain version at {name}")
        del args, gout
        torch.cuda.empty_cache()

    # 7. the training slice at full width
    training = presets.DFAUST_I_ROT_PCA_2F_TRAINING
    trainer, dfaust_steps = dfaust_train(card, dev, batch)
    model = trainer.model
    train_fwd, train_bwd = dfaust_steps["launches"]

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

    del model, trainer, cpu_model, h, f0, out_pc, out_labels, small, batch
    torch.cuda.empty_cache()

    scan = run_scannet(card, dev, RecordedDraws, DropPathDraws)
    dfaust = dict(fwd=compared, bwd=bwd_compared, eval_launches=launches, train_fwd=train_fwd,
                  train_bwd=train_bwd)
    print(json.dumps(kernels_line(dfaust, scan)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
