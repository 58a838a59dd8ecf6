#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's DFaust segmentation eval and training paths
(``se3conv3d_tpu_torch``) at the full widths of
``configs/dfaust/dfaust_I_rot_pca_2F.yaml``; the Monte-Carlo mixed-frame-count
recipe ``configs/dfaust/dfaust_I_rot_MC_mixF.yaml`` as written (random
SO(3) frames, 1, 2 or 4 frames per micro-batch, two micro-batches per
optimizer step), with the conv kernels at G = F = 4; the ScanNet-20 recipe
with random planar frames, ``configs/scannet/scannet20_rot_I.yaml``; then
the ScanNet-20 eval and ``scan_scenes`` training paths at the full widths
and capacities of ``configs/scannet/scannet20_rot_pca_I.yaml``, as the
recipe is written (``compute_dtype: bfloat16``: the conv kernels' bfloat16
operand path) and in float32 beside it; and the standard (non-equivariant)
models of ``configs/dfaust/dfaust_I_standard.yaml`` and
``configs/scannet/scannet20_standard_I.yaml`` (bfloat16 convs), whose
convs run both kernels' standard-geometry (kD = 3) instantiations; and the
ModelNet40 classification recipes
``configs/modelnet40/modelnet40_{pca_2F,MC_2F,standard}.yaml`` (ClassNet,
widths up to 512); and the other conv kinds of the JAX ``PNEConv`` on the
DFaust models: the relu, sin and linear activations and the kernel-point
convs through the kernels, the XLA-path kinds in PyTorch ops.  In the
order they run:

1. builds the six kernel sources (conv forward, conv backward, blocked
   prefix sum, and the three probe sources) from ``kernels/csrc`` with
   ``nvcc``, one process per source, in parallel;
32. (right after phase 1) the probe kernels that replace the Pallas
   kernels of ``experiments/chip_stage_time.py``, ``bisect_fused.py`` and
   ``chip_stream.py``: first the three entry points as a user runs them
   (``python -m se3conv3d_tpu_torch.experiments.chip_stage_time`` for each
   stage in float32 and bfloat16 at M = 65,536, ``.bisect_fused`` with
   every probe, ``.chip_stream``), with every launch counter at 0 before
   and each kernel required after; then the staged forward in tile-sum
   mode at that size, every stage in float32 and bfloat16, against its
   plain version (scalars within 1e-6 / 1e-5 of the sum of their terms'
   magnitudes, bfloat16 under half its no-rounding control), two calls
   bitwise equal, the stage split; ``bisect_fused``'s stage tensors at MP =
   1024 and b1-b5 within 1e-5 of max |plain| (b1 also within 1e-6 (1 +
   |ref|) of float64 at each of 400,004 points), bitwise repeats; the column
   sums of ``chip_stream``'s three arrays against float64 (1e-6 of each
   column's sum of |x|), bitwise repeats, the read rate beside
   ``torch.sum``; the staged forward's registers per instantiation;
2. holds the forward kernel against its plain PyTorch version at the
   slice's two extreme conv shapes and at the JAX bench's conv shape, in
   float32 and in bfloat16 (against the plain version's bfloat16 rounding,
   and apart from the plain version with no bfloat16 rounding, the
   control), checks that two calls give the same bits, and times
   ``torch.matmul`` in the same dtype for its weight contraction over the
   same live rows;
3. builds the model with a seeded init and runs one calibration step and a
   few eval steps on a synthetic batch of 32 body-like clouds of 4096
   points, counting the kernel's launches (21 per forward);
4. checks that a global rotation of the hierarchy leaves the logits
   unchanged;
5. checks that the same model and hierarchy on the CPU (plain path) give
   the same logits at B=2; then 4 and 5 again with every BN's running
   statistics seeded from its own input (the logits of a fresh model
   hardly depend on its convs), each beside a control it must fail: the
   frames left unrotated, the first conv's kernel planted with another
   activation (:func:`dfaust_model_gates`);
6. holds the backward kernel against its plain PyTorch version at the
   three shapes of phase 2, in float32 and in bfloat16 (with the control of
   phase 2), in both feature-gradient output modes (atomic scatter; rows at
   their sorted slots, summed by ``sorted_segment_sum``) with its
   parameter gradients bitwise equal across modes and calls, and times
   ``torch.matmul`` for its two products;
7. trains a fresh model with the recipe's ``Training`` section: one
   calibration step, then a few ``Trainer.train_step`` calls on the same
   batch, counting 21 forward and 21 backward kernel launches per step and
   checking finite losses and gradients and moved BN statistics; before
   them the same for the recipe with ``compute_dtype: bfloat16`` (every
   launch a bfloat16 one), whose step times are printed beside the float32
   ones, the first step of each left out (the DFaust recipe computes in
   float32);
8. checks that one train-mode forward and backward at B=2 gives the same
   parameter gradients on the card and on the CPU (plain path), with the
   same hierarchy and DropPath keep masks;
15. holds both conv kernels at G = F = 4 (their 128-column instantiations)
    against their plain versions at the mixF recipe's level-0 (B=16,
    M=N=4096, C=O=32) and level-4 (M=N=128, C=O=256) block convs at the
    synthetic bodies' fill, in float32 and in bfloat16 (with the control of
    phase 2): the forward bitwise equal over two calls, the backward in both
    output modes with its parameter gradients bitwise equal across modes
    and calls, each timed beside its bound, its plain version and
    ``torch.matmul`` in the same dtype for its products;
16. builds the mixF recipe's model with ``build_model_from_config`` (on the
    card by default), runs a calibration step at ``train_n_frames`` and
    eval steps at ``test_n_frames`` on 16 bodies, prints a
    ``draw_n_frames`` sequence, then trains with the recipe's ``Training``
    section (``accum_grads: 2``) over micro-batches at the forced frame
    counts 4, 4, 4, 2, 2, 2, 1, 1, 1, 4, 2, 1 (six optimizer steps): per
    micro-batch 21 forward and 21 backward launches at G = F, the
    parameters bitwise unchanged after each first micro-batch of a step and
    all moved after each second, the schedule advanced once per step, every
    BN running mean moved, the micro-batch time per F (the first of each F
    left out) and the peak; then at F = 4 on two clouds rotation invariance
    (with the frames left unrotated as the control), card vs CPU logits and
    card vs CPU parameter gradients, at the bounds of phases 4, 5 and 8;
17. builds ``scannet20_rot_I``'s bfloat16 model (one random frame about z
    per point), runs phase 12 on it with a rotation about z, and one
    ``scan_scenes`` train step on the 6 rooms in scatter mode (192 bfloat16
    forward and backward launches);
18. holds both conv kernels' standard-geometry (kD = 3: G = F = 1, the
    raw offsets as the 3 pne inputs, no rot6) instantiations against their
    plain versions at the DFaust standard recipe's level-1 and level-4
    block convs (B=32, the synthetic bodies' fill) and at the ScanNet
    level-0 block conv, padded and fully live, and its level-4 block conv,
    in float32 and in bfloat16 (with the control of phase 2), with the
    gates of phases 2 and 6, each timed beside its bound, its plain version
    and ``torch.matmul``; every launch counted at D = 3;
19. builds ``dfaust_I_standard`` with ``build_model_from_config`` (on the
    card by default): a calibration step and eval steps on the 32 bodies,
    21 forward launches per forward, all at kD = 3; card vs CPU logits at
    B=2 (phase 5; phase 4 does not apply: a standard model is not rotation
    invariant); the recipe's ``Training`` section, 21 + 21 launches per
    step at kD = 3, finite losses, moved BN means; card vs CPU parameter
    gradients at B=2 (phase 8's bound); the step time and peak beside
    phase 7's equivariant step;
29. holds both conv kernels with each pne activation, gelu, then relu, sin
    and linear (the TPU kernel's ``_ACTS``), then gelu's kernels timed again,
    against their plain versions at the ScanNet level-0 block conv, fully
    live, in the equivariant geometry (kD = 9) in float32 and bfloat16 and in
    the standard one (kD = 3) in bfloat16, and where phase 31's models run
    them, the DFaust level-0 and level-4 convs in both geometries (G = F =
    2 and 1) in float32 at the bodies' fill, with the gates of phases 2 and
    6, each timed beside its bound, its plain version and ``torch.matmul``;
    the gelu times, taken in turns with the others, show what the run-time
    activation switch costs the recipes' path;
30. holds both kernels' kernel-point instantiation (the P correlation
    weights of each edge computed in the kernel from its float32 offset)
    for gauss, linear and box at P = 13 and P = 55 against their plain
    versions at the DFaust standard model's level-0 shape (B=32, M=N=4096,
    K=32, C=O=32, the bodies' level-0 fill; float32), at its level-4 block
    conv (M=N=128, C=O=256, the level-4 fill; float32) and at the standard
    ScanNet level-0 block conv (bfloat16), with the same gates and times;
31. builds ``dfaust_I_standard`` with both conv factories swapped (as a user
    does with ``get_model_spec(..., conv=..., conv_blocks=...)``) to
    ``kp_gauss`` and ``kp_linear_double``: a calibration step and eval
    steps, card vs CPU logits at B=2, train steps in scatter mode and one in
    sorted mode (its prefix sums counted), 21 forward and 21 backward
    launches per step, all at their (correlation, P); the other four kp
    types, and ``dfaust_I_rot_pca_2F`` and ``dfaust_I_standard`` with
    ``mlp_relu``, ``mlp_sin`` and ``mlp_linear``, one calibration and one
    train step each, then card vs CPU logits at B=2 and the equivariant
    ones' logits unchanged by a global rotation.  These model gates run with
    every BN's running statistics seeded from its own input (at init the
    logits hardly depend on the convs), each beside a control it must fail:
    the first conv's kernel planted with another activation or correlation
    (card vs CPU), the frames left unrotated (rotation); then one conv of
    each plain-path kind (``mlp_softmax``,
    'max', quaternion, matrix: the JAX package's XLA path, which no Pallas
    kernel serves) on the card against the CPU;
21. on 12 synthetic ModelNet40-like shapes of 4096 points (triangle meshes
    of five families sampled by area, in the unit sphere, ones features,
    labels 0..39; the fill per hierarchy level printed) holds both conv
    kernels against their plain versions in float32 (the recipes' dtype)
    at the level-5 block conv (B=12, M=N=256, K=32, G=F=2, C=O=512: product
    depth C*Q = 16,384) at the shapes' fill and fully live, at
    ``down_conv_3`` (N=512, C=256, O=512) and at the standard recipe's
    level-5 block conv (kD = 3), with the gates of phases 2 and 6, each
    timed beside its bound, its plain version and ``torch.matmul``, and
    prints each conv's forward and backward plans (chunks, depth splits,
    ``d_w`` splits, scratch) and the memory one call of each adds;
22. runs ``modelnet40_pca_2F``, ``modelnet40_MC_2F`` and
    ``modelnet40_standard`` as written, each built with
    ``build_model_from_config`` (on the card by default) as a ClassNet with
    the classification ``Trainer``: a calibration step and eval steps at
    ``test_n_frames`` (25 forward launches per forward: 2 patch, 19 block,
    4 down, all at G = F = 2 and kD = 9, or kD = 3), the logits unchanged
    by a global rotation (with the frames left unrotated as the control;
    equivariant recipes), card vs CPU logits at B=2; a fresh model trained
    with the recipe's ``Training`` section (25 + 25 launches per step,
    finite losses, every BN running mean moved; the step times and the
    peak) and card vs CPU parameter gradients at B=2 (phase 8's bound);
9. holds the conv kernels against their plain versions at the ScanNet
   level-0 and level-4 block convs and at a padded level-0 conv (the
   first 22,563 of 131,072 rows live, as the fullest synthetic room), in
   bfloat16 (the recipe's operands, against the plain versions' bfloat16
   rounding, with the control of phase 2) and in float32, the forward
   bitwise equal over two calls, the
   backward in both feature-gradient output modes (atomic scatter; rows at
   their sorted slots) with its parameter gradients bitwise equal across
   modes and calls, each with its device ms per pass, and times
   ``torch.matmul`` in the same dtype for their products over the same
   live rows beside them;
10. holds the prefix-sum kernel against its plain version on the sorted
    buffers of the ScanNet level-0 and level-4 block convs (level 0 in
    bfloat16 too), of the DFaust level-0 conv (B=32) and of the ModelNet40
    level-5 block conv (B=12, 1024 columns), checks that 10
    more calls give the same bits, times ``torch.cumsum`` and a float32
    copy of the same rows beside it with each shape's share of its bound,
    and holds ``sorted_segment_sum`` against ``index_add_`` on the same
    rows (the kernel's device ms per call at these shapes come last, from
    a CUDA graph of 5 calls);
11. holds the grid neighbor searches against brute force on one
    full-capacity synthetic room (same neighbor sets per row, away from
    distance ties) and times both;
12. builds the ScanNet model with ``build_model_from_config`` (on the card
    by default) from the recipe's ``Model`` section as written (bfloat16
    convs), runs a calibration step and eval steps on one room (32
    bfloat16 conv launches per forward, each given its neighborhood's
    live-row table), checks rotation invariance (and that its bound tells
    apart a forward whose frames were left unrotated), and card vs CPU
    logits on a smaller room whose capacities still take the grid (in
    bfloat16 also apart from the CPU logits with float32 convs, the
    control); then the same in float32;
13. trains the recipe as written with ``scan_scenes`` on 6 rooms x 120,000
    points, the two feature-gradient modes in turns (scatter, sorted,
    sorted, scatter, ...), counting 192 bfloat16 forward and 192 bfloat16
    backward launches per step and 192 prefix sums (of bfloat16 rows) in
    sorted mode only, and checking finite losses and moved BN means; then
    one step per mode split on the host clock (with the live rows the 192
    forwards and 192 backwards walked against their capacity rows, each
    given its neighborhood's table) and one under ``torch.profiler`` (device
    ms by kernel and per forward and backward pass);
14. checks that the two modes give the same parameter gradients on one
    room, with the same hierarchy and DropPath keep masks (in bfloat16 also
    apart from the gradients with float32 convs, the control); then 13-14
    in float32, one train step per mode;
20. builds ``scannet20_standard_I`` from its pinned ``Model`` section as
    written (bfloat16 convs): phase 12 on room 0 without the rotation check
    (32 bfloat16 kD = 3 forward launches per forward; card vs CPU logits on
    the smaller room with the float32-conv control), one ``scan_scenes``
    step per feature-gradient mode on the 6 rooms (192 forward and 192
    backward bfloat16 kD = 3 launches, 192 prefix sums in sorted mode
    only), phase 14 on one room, and one scatter step under
    ``torch.profiler`` (device ms per conv forward and backward pass);

23. trains ``configs/dfaust/dfaust_I_rot_pca_2F.yaml`` as written through
    the training CLI (``se3conv3d_tpu_torch.tasks.train.main``, in this
    process) on a DFaust fixture in the loader's format (64 train and 8
    test synthetic bodies of 4096 points): calibration, one epoch of two
    B = 32 steps, validation, a checkpoint, ``config.yaml``; then again with
    ``--resume``, the restored state held bitwise against the checkpoint
    file; finite losses, mIoU in [0, 1], the conv launches counted against
    the steps taken (21 per forward, 21 per backward), the host-clock split
    of each step (load and augment, collate, host-to-device copy,
    ``train_step``), epoch times and the peak;
24. the same for ``configs/modelnet40/modelnet40_pca_2F.yaml`` (B = 12) on
    24 train and 12 test synthetic shapes in the ModelNet40 txt format:
    validation accuracy, the loader's ``.npz`` cache written on the first
    run and read on the second (a resume);
25. the same for ``configs/scannet/scannet20_rot_pca_I.yaml`` as written
    (bf16, ``scan_scenes``, the 750,000-point budget, its augmentation
    modules and ``train_scene_max_pts``) but for one epoch of two batches,
    on 8 train and 2 val synthetic rooms of 120,000 points in the npz
    format; the second train step in sorted mode (its prefix sums
    counted), every conv launch a bfloat16 one, and the native ``pcprep``
    library built and called (elastic distortion, nearest-point crop);
26. evaluates phase 23's run through the segmentation eval CLI
    (``se3conv3d_tpu_torch.tasks.test_seg.main``) under
    ``configs/dfaust/dfaust_test.yaml`` as written (one vote over the 8 test
    bodies) with a 2-checkpoint ensemble (phase 23 saves the resumed state
    as a second checkpoint where the resume found no better mIoU): 21
    forward launches per member per body, no backward, no prefix sum, every
    forward given its live-row table; body 0's accumulated logits equal, to
    float64 rounding, the sum of one ``eval_step`` per checkpoint on its
    batch with its generator seed, and the sum of each checkpoint alone on
    the voter's hierarchy; the ensemble swap's time;
27. evaluates phase 24's run through ``tasks.test_class.main`` under
    ``configs/modelnet40/modelnet40_test_rot.yaml`` (SO(3) test rotations,
    batches of 24) but for two vote epochs (the file: 50): each batch pads
    the 12 test shapes with copies of the last, and the accumulator holds
    exactly the 12 real rows' logits summed over the votes;
28. evaluates phase 25's run under
    ``configs/scannet/scannet20_test_pca_I_SO2.yaml`` (PCA frames about z,
    kNN 16, the 30-angle z sweep) but for two vote epochs, with segment
    smoothing and the benchmark files, on whole val rooms of 120,000,
    400,000 and 1,500,000 points (numpy seeds 260-262, segments the 0.2 m
    voxels): the two larger run at capacity buckets of 409,600 and
    1,507,328 points; 32 bfloat16 forward launches per room and vote, no
    backward, no prefix sum; exactly two bucket trainers; the 400,000-point
    room voted again with the same draws on its real rows, through its
    bucket (bitwise the voter's accumulator, twice) and through a trainer
    one bucket larger (within 1e-4 of max |accum|), and, as the control,
    twice with the grid averages summed by float32 atomics; one label file
    per room with one ScanNet-20 id per raw point; per vote and room the
    host-clock time, its build / forward split, points per second and
    peak, the share of points with a logit, the accumulation time; the
    1.5M-point room's level-0 grid average, summed in a fixed order and by
    atomics, timed; then the forward kernel against its plain version at
    that room's level-0 shape and live fill (bfloat16), with its bound and
    ``torch.matmul``, and the shape's int32 index ranges;

34. (after phase 28) the rest of the model zoo at full widths, with every
    launch count at 0 before each path and read after it:
    ``dfaust_I_rot_pca_2F`` (B = 32) with ``block_layer`` ``resnetb``, with
    ``resconvnext`` and two hidden seg-head layers, and as the plain
    ``SegUNet``: a calibration step, three train steps (the median after the
    first, the peak), an eval step, every conv launching once a pass; then
    on two bodies the rotation gate and card vs CPU logits, each beside its
    control (the frames left unrotated; the first conv's kernel planted
    wrong), the norms seeded where a control does not pass; the same recipe
    with PCA frames over a ball query (radius ``BQ_RADIUS``): the frames card
    vs CPU from the same draws beside the kNN frames as the control, then
    the same train, eval and gates; ``modelnet40_pca_2F`` (B = 12, 512
    channels) with ClassNet's global equivariant feature vector into one
    extra grid level: forward, the backward of a seeded projection, the
    O = 1024 conv's kernels against their plain versions at its shape with
    their plans and peaks, the feature vector's rotation gate and card vs
    CPU, each with its control; both conv kernels at Q = 64 against their
    plain versions at DFaust's level 0 (standard geometry in float32 and
    bfloat16, kernel points at P = 13 and 55, the equivariant geometry at
    G = F = 2), and one train step each of ``dfaust_I_standard`` at
    ``num_basis: 64`` (mlp gelu and ``kp_gauss_double``) and of
    ``dfaust_I_rot_pca_2F`` at ``num_basis: 64``, every launch counted at
    (D, 64); ``MultiHeadAttConv`` and ``LoRAttConv`` on DFaust's level 0 (kNN
    16, 32 channels, 16 basis functions, 4 heads): forward and gradients
    card vs CPU at B = 2, their times at B = 32;

35. (after phase 34) data parallelism on ``dfaust_I_rot_pca_2F`` at full
    width, B = 32 bodies, the last 25% of the points of the first 8 masked
    off, the hierarchy draws and DropPath keep masks recorded once and
    injected at each process's bodies: (a) one process, no group, twice (its
    own repeat spread); (b) a one-rank NCCL group on the card, whose state
    after a calibration pass and one step must equal (a)'s bitwise where (a)
    repeats itself bitwise, else within twice (a)'s spread (that step in
    the deterministic 'sorted' backward mode, in which (a) repeats itself
    bitwise; the timed steps in the default 'scatter' mode); (c) two ranks on
    the card over gloo (``parallel.launch``), 16 bodies each, rank 0's
    holding the masked ones: the loss within 1e-5 relative of (a)'s, every
    parameter's gradient within ``GRAD_RTOL`` of its leaf (the gradient gate
    of phase 8), the BN running statistics and calibration buffers within
    1e-5, the ranks' states bitwise equal; two controls that must fail that
    gate (each rank's own mean loss with DDP's averaged gradients; each
    rank's own BN statistics); the dry-run contract of
    ``__graft_entry__.py`` (three steps of (c) on one batch lower the loss,
    the ranks stay bitwise equal); the validation counts summed by
    ``cross_host_sum`` over (c) equal to (a)'s; the step medians of (a),
    (b) and (c), the all-reduce share of a (c) step, each rank's peak, and
    the conv kernels' launches of every configuration and rank;
36. ``MinkUNet34A`` at the module's defaults (grid (96, 48, 96), cell 0.1,
    20 classes, 3 input features) on two synthetic rooms of 120,000 points:
    the forward and one train step with cuDNN's TF32 on and off, the peak;
    then the card (TF32 off) against the CPU on one room at a grid of (32,
    16, 32) within 2e-4 of max |logits|, beside the control with the
    transposed convs' kernels unflipped;
37. farthest-point sampling, B = 32 bodies x 4096 points -> 1024: ``ids``,
    ``out_mask`` and ``nearest`` on the card equal the CPU's exactly, timed,
    and the same with two bodies left with 300 and 1 valid points (the tied
    picks past the valid count);
38. the ``(data, points)`` mesh (``parallel.mesh`` with ``points=2``): (a)
    one process on one synthetic room of 120,000 points (numpy seed 100) of
    ``scannet20_rot_pca_I`` as written (bf16, full widths and capacities),
    a calibration pass and one train step in the 'sorted' mode, then the
    same in float32, and in float32 at the capacity bucket of 32,768 points
    (``HierarchyConfig.with_capacity``: the room then fills both halves of
    every level, which at the recipe's capacities its second half never
    does); the bf16 gradients of the same step in the 'scatter' mode beside
    it (its own spread); (b) the same over a ``(data=1, points=2)`` group of
    two gloo ranks on the card (``shard_points``: 60,000 raw points a rank),
    each configuration against (a)'s: float32 at phase 35's loss and state
    bounds and gradients within ``POINTS_GRAD_RTOL`` a leaf; bf16 with its
    loss and state within ``BF16_GRAD_RTOL`` and its gradients as far from
    the float32 step's as (a)'s, within ``POINTS_BF16_PARITY`` either way
    (the per-leaf distance from (a) printed, not gated), beside two float32
    controls that must fail (each rank's convs reading only the source rows
    it owns; each rank's own BN statistics) and a bf16 one, the ranks' states
    bitwise equal; the step medians of (a) and (b), each rank's peak beside
    (a)'s, the collectives' share and bytes of a (b) step, the rows and
    valid rows each holds per level, the launches per rank (every conv on a
    rank that holds live rows of its queries); (c) ``__graft_entry__``'s
    dry-run configuration, ``(data=2, points=2)``, four gloo ranks on the
    card, ``dfaust_I_rot_pca_2F`` at full width on four bodies (numpy seed
    38, two a data row): three steps on one batch lower the loss and leave
    the four ranks bitwise equal;

and last, one ``modelnet40_pca_2F`` train step under ``torch.profiler``
(device ms by kernel, per conv pass, in PyTorch's reductions, and the idle
share).

Run from the repository root: ``python3 chip_smoke.py``.  Exits non-zero,
printing no result, without a CUDA device or outside the repository.  The
last line of a passing run is ``{"ok": true, "device": {...}}``, after
the run's total time and the card's line.  Phases
23-28 run after phase 20 and before the last profile, in one temporary
directory, removed at their end.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
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
# the ScanNet phases run the recipe as written (bfloat16), then in float32
# with one train step per backward mode
SCANNET_DTYPES = ("bfloat16", "float32")
# the operand dtypes of the kernel checks of phases 2, 6 and 9
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
SCANNET_F32_MODE_ORDER = ("scatter", "sorted")
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
# the dense bf16 tensor-core peak of the same sheet: the bound of the
# bfloat16 kernels takes every FLOP there
PEAK_BF16_FLOPS = 989e12
# the kernel-point correlation's FLOPs per point and edge (conv_bounds): 3
# differences, 3 squares, 2 sums, the 1/sigma^2 scale, the exp (gauss),
# sqrt (linear) or compare (box) as one, and one more scale, subtract or
# select
KP_FLOPS = 11
# bfloat16 kernels vs their bfloat16 plain versions, each output (as
# tests/test_torch_kernel_cuda.py): both round at the same points and sum in
# float32 in other orders, which can flip a rounding by one bfloat16 ulp
# (2^-8 relative) where a sum lies next to a boundary; such flips are rare,
# so max |d| <= BF16_RTOL * max |plain| and mean |d| <= BF16_MEAN_RTOL *
# max |plain| (readings up to 2.1e-5 on one H100).  The mean bound alone
# cannot tell a kernel that skipped its roundings where most rows are
# padding (its control reads 3.6e-5 on the padded level-0 sorted rows):
# the control gate below does, per output
BF16_RTOL, BF16_MEAN_RTOL = 1e-2, 1e-4
# the control of every bfloat16 gate: the same inputs with no bfloat16
# rounding (a kernel against its plain version on the operands widened to
# float32; a model against the same weights with float32 convs).  The sound
# reading must be at most BF16_SOUND_SHARE of the control's, so a path that
# skipped its bfloat16 roundings fails the gate (as tests/test_torch_bf16.py
# holds the port against JAX bf16 and float32); on one H100 the kernels'
# outputs read at most 0.019 of their controls' mean error, the ScanNet
# card-vs-CPU logits 0.16, its sorted-vs-scatter gradients 0.19 (global
# norm; the per-leaf worst reads 0.21-0.28 and is bounded by BF16_GRAD_RTOL)
BF16_SOUND_SHARE = 0.5
# the ScanNet model in bfloat16: card vs CPU logits and rotated vs unrotated
# logits (max abs over the valid output points, relative to max |logits|):
# the two sides round at the same points but sum in other orders (or from
# re-rounded float32 geometry), and a flipped rounding propagates through 32
# convs; sorted vs scatter parameter gradients, per leaf as GRAD_RTOL: the
# modes' feature-gradient sums differ in float32 order before their bfloat16
# rounding.  Each bound lies between the sound reading and its control's on
# one H100 (PERF.md section 6): card vs CPU 0.9-1.05e-4 against 5.6e-4 with
# float32 convs on the CPU; rotation 5.0-5.6e-4 against 8.7e-2 with the
# frames left unrotated; gradients 1.4-1.8e-3 against 5.1-7.5e-3 with
# float32 convs
BF16_CPU_RTOL, BF16_ROT_RTOL, BF16_GRAD_RTOL = 2.5e-4, 5e-3, 4e-3
# kernel vs plain: max |kernel - plain| <= KERNEL_RTOL * max |plain| (both
# float32; they sum up to 64 edges x 32 basis x 256 channels in other orders,
# the kernel's weight contraction in 3xTF32)
KERNEL_RTOL = 1e-5
# whole-model logits: card vs CPU and rotated vs unrotated, max abs over the
# valid output points (the repo's whole-model bound is 2e-4; rotating the
# positions re-rounds every float32 offset, hence the looser invariance bound)
CPU_ATOL, ROT_ATOL = 2e-4, 1e-3
# a rotation gate's control (the positions rotated, the frames not) must
# read at least this many times ROT_ATOL on the model as it is, else the
# gate runs on a copy with its norms seeded (seed_norms): a control just past
# its bound barely shows that the gate can fail (the global equivariant
# vector's read 1.045e-3, 1.04x, with fresh norms)
ROT_CONTROL_MARGIN = 3.0
# backward kernel vs plain, each of its four outputs: the parameter
# gradients sum over up to 131,072 rows (B*M*G) in other orders
BWD_RTOL = 1e-4
# parameter gradients, card vs CPU, per leaf: max |card - cpu| <=
# GRAD_RTOL * max(max |cpu leaf|, GRAD_FLOOR * global norm).  The floor
# covers leaves whose true gradient is 0 (a bias just before a train-mode
# BN): they hold only rounding noise.
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-2
# the DFaust Monte-Carlo mixed-frame-count recipe
# (configs/dfaust/dfaust_I_rot_MC_mixF.yaml, phase 16): its batch_size of 16
# clouds a micro-batch, two micro-batches an optimizer step (accum_grads),
# and the forced frame count of each micro-batch: every count of its
# mix_n_frames, in pairs of one count and of two (six optimizer steps)
MIXF_BATCH = 16
MIXF_FRAMES = (4, 4, 4, 2, 2, 2, 1, 1, 1, 4, 2, 1)
MIXF_EVAL_STEPS = 2
# phase 15's convs at G = F = 4 (128 pne columns): the mixF recipe's level-0
# and level-4 block convs, name: (B, M, N, K, G, F, Q, C, O, hierarchy level
# whose fill of the synthetic bodies gives the live rows per example)
G4_SHAPES = {
    "mixf_level0_block_conv": ((MIXF_BATCH, 4096, 4096, 32, 4, 4, 32, 32, 32), 0),
    "mixf_level4_block_conv": ((MIXF_BATCH, 128, 128, 32, 4, 4, 32, 256, 256), 4),
}


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


def seeded_model(model_dict, dev, num_in_feats=1, num_classes=CLASSES, kind=None):
    """The model of the ``Model`` section ``model_dict`` from
    ``build_model_from_config`` (on the card by default, which it must
    take) with a seeded init and seeded skip gammas; with ``kind``, a dict
    of ``ConvFactory`` fields, the segmentation model of that section's
    spec with both conv factories of that kind (``ModelSpec`` has copied
    ``conv`` into ``conv_blocks``, so both are replaced), as a user builds
    one with ``get_model_spec(..., conv=..., conv_blocks=...)``."""
    from se3conv3d_tpu_torch.models import FPNSegUNet, presets
    from se3conv3d_tpu_torch.train.config import build_model_from_config

    gen = torch.Generator().manual_seed(0)
    if kind:
        spec = presets.spec_from_model_dict(model_dict)
        spec = dataclasses.replace(spec, conv=dataclasses.replace(spec.conv, **kind),
                                   conv_blocks=dataclasses.replace(spec.conv_blocks, **kind))
        model = FPNSegUNet(spec, num_in_feats=num_in_feats, num_classes=num_classes, generator=gen).to(dev)
    else:
        model = build_model_from_config(model_dict, num_in_feats, num_classes, generator=gen)
    model = seed_gammas(model)
    if next(model.parameters()).device.type != dev.type:
        raise SystemExit(f"build_model_from_config did not put {model_dict['model']} on the card")
    return model


def conv_bounds(shape, idx, mask, dtype=torch.float32, d=9, kp=False) -> dict:
    """Least times of one conv forward and backward on the card: the larger
    of bytes / HBM rate (each input read once, each output written once)
    and FLOPs / peak, counting the valid edges of ``mask`` and its live
    rows (the query rows with a valid edge): a padded row needs no work, so
    its geometry, ``gout`` row and products are not counted, and of the
    features only the source rows that a valid edge gathers (``idx[mask]``,
    each once) are read.

    FLOPs as in ``PERF.md``: per valid edge and frame pair the pne
    (``2*D*Q``, D = 9 pne inputs, or 3 for the standard geometry) and basis
    (``2*Q*C``) products, per live point and out-frame the weight
    contraction (``2*C*Q*O``).  The backward counts, per edge, pne and
    basis once, ``dpne`` and ``d_feats`` (``2*Q*C`` each) and
    ``d_proj``/``d_bias`` (``2*(D+1)*Q``), and per live point the ``d_w``
    and ``dbasis`` products (``2*C*Q*O`` each).  The standard geometry reads
    the offsets and no ``rot6``.  The forward's weight contraction, the
    backward's two products and its per-edge ``dpne`` and ``d_feats``
    products (``edge_kernel``) run on tensor cores in 3xTF32, so the bounds
    take them at that ceiling (``PEAK_TF32_FLOPS / 3``) and the rest (pne,
    the basis sums, ``d_proj``) at the float32 peak; ``bound_f32_ms`` takes
    every FLOP at the float32 peak.  With bfloat16 operands (``dtype``) the
    geometry and the features count 2 bytes a value (the parameters,
    ``gout``, ``d_feats`` and the output stay float32), every FLOP counts at
    the dense bf16 tensor-core peak, and ``bound_f32_ms`` takes the FLOPs
    these kernels run outside the tensor cores (pne and the basis sums;
    ``d_proj``) at the float32 peak and the products (``dpne`` and
    ``d_feats`` too) at the bf16 peak.  ``kp``: the kernel-point geometry, D = P weights per
    edge computed from the float32 offsets (4 bytes a value whatever
    ``dtype``), ``KP_FLOPS`` per point and edge for the correlation (and 3
    for the ``norm_dist`` scale) in the forward and again in the backward,
    which recomputes them.
    """
    b, m, n, k, g, f, q, c, o = shape
    edges = float(mask.sum()) * g * f
    live = float(mask.any(-1).sum())
    point_flops = 2.0 * live * g * c * q * o
    corr_flops = edges * (KP_FLOPS * d + 3) if kp else 0.0
    fwd_flops = 2 * edges * q * (d + c) + point_flops + corr_flops
    bwd_edge_flops = 2 * edges * q * (d + 3 * c + d + 1) + corr_flops
    edge_mma_flops = 4 * edges * q * c  # dpne and d_feats, on tensor cores
    bwd_flops = bwd_edge_flops + 2 * point_flops
    bf16 = dtype == torch.bfloat16
    op = 2.0 if bf16 else 4.0  # bytes of an operand value
    rot = 6 * f if d == 9 and not kp else 0
    # rel (float32 at the kernel points), rot6, idx, mask of the live rows
    geo = live * ((4.0 if kp else op) * k * g * 3 + op * k * g * rot + 9.0 * k)
    params = 4.0 * ((d + 1) * q + c * q * o)
    example = torch.arange(b, device=idx.device).reshape(b, 1, 1) * n
    gathered = float(torch.unique((idx.long() + example)[mask]).numel())  # distinct source rows read
    fwd_bytes = geo + op * gathered * f * c + params + 4.0 * b * m * g * o
    # + gout's live rows, d_feats (every row), d_params
    bwd_bytes = geo + op * gathered * f * c + params + 4.0 * live * g * o + 4.0 * b * n * f * c + params
    if bf16:
        fwd_ops_s, bwd_ops_s = fwd_flops / PEAK_BF16_FLOPS, bwd_flops / PEAK_BF16_FLOPS
        fma_s = {"fwd": (fwd_flops - point_flops) / PEAK_F32_FLOPS + point_flops / PEAK_BF16_FLOPS,
                 "bwd": (bwd_edge_flops - edge_mma_flops) / PEAK_F32_FLOPS
                 + (edge_mma_flops + 2 * point_flops) / PEAK_BF16_FLOPS}
    else:
        tf32x3 = PEAK_TF32_FLOPS / 3
        fwd_ops_s = (fwd_flops - point_flops) / PEAK_F32_FLOPS + point_flops / tf32x3
        bwd_ops_s = (bwd_edge_flops - edge_mma_flops) / PEAK_F32_FLOPS + (edge_mma_flops + 2 * point_flops) / tf32x3
        fma_s = {"fwd": fwd_flops / PEAK_F32_FLOPS, "bwd": bwd_flops / PEAK_F32_FLOPS}
    out = {}
    for name, flops, ops_s, nbytes in (("fwd", fwd_flops, fwd_ops_s, fwd_bytes),
                                       ("bwd", bwd_flops, bwd_ops_s, bwd_bytes)):
        t_ops, t_bytes = ops_s * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                         else "bytes", gflop=flops / 1e9, live_rows=int(live), gathered_rows=int(gathered),
                         bound_f32_ms=max(fma_s[name], nbytes / PEAK_BYTES_PER_S) * 1e3)
    return out


def site_operands(rows: int, conv_weights, seed: int, dtype=torch.float32) -> tuple:
    """Seeded ``(basis [rows, C*Q], gout [rows, O], W [C*Q, O])`` in
    ``dtype`` at a conv's product shapes (the times do not depend on the
    values)."""
    c, q, o = conv_weights.shape
    gen = torch.Generator(device=conv_weights.device).manual_seed(seed)
    basis = torch.randn(rows, c * q, device=conv_weights.device, generator=gen).to(dtype)
    gout = torch.randn(rows, o, device=conv_weights.device, generator=gen).to(dtype)
    return basis, gout, conv_weights.reshape(c * q, o).to(dtype)


def products_matmul_ms(rows: int, conv_weights, seed: int, dtype=torch.float32) -> dict:
    """The yardsticks of the conv backward's two products, each timed
    apart: ``torch.matmul`` in ``dtype`` (float32: full float32, TF32 off,
    set here) for ``d_w = basis^T . gout`` and ``dbasis = gout . W^T`` over
    ``rows`` live rows: ``{"d_w": ms, "dbasis": ms}``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    basis, gout, w2 = site_operands(rows, conv_weights, seed, dtype)
    return {"d_w": cuda_ms(lambda: torch.matmul(basis.t(), gout), 10),
            "dbasis": cuda_ms(lambda: torch.matmul(gout, w2.t()), 10)}


def product_matmul_ms(rows: int, conv_weights, seed: int, dtype=torch.float32) -> float:
    """The yardstick of the conv forward's weight contraction:
    ``torch.matmul`` in ``dtype`` (float32: full float32, TF32 off, set
    here) for ``out = basis . W`` over ``rows`` live rows x out-frames
    (seeded operands of the kernel's shapes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    basis, _, w2 = site_operands(rows, conv_weights, seed, dtype)
    return cuda_ms(lambda: torch.matmul(basis, w2), 10)


# the conv's shared product (wg_product) by call site: its pass name in
# FWD_PASSES / BWD_PASSES, its layout in kernels.product, and the key of its
# torch.matmul yardstick in forward_vs_plain's / backward_vs_plain's result
PRODUCT_SITES = {"fwd": ("product", "fwd", "library_ms"), "d_w": ("d_w product", "dw", "dw_library_ms"),
                 "dbasis": ("dbasis product", "dbasis", "dbasis_library_ms")}


def product_dims(layout: str, rows: int, cq: int, o: int) -> tuple:
    """``(I, J, K)`` of the product at ``layout`` for a conv of ``rows``
    live rows x out-frames, depth ``C*Q`` and ``O`` outputs."""
    return {"fwd": (rows, o, cq), "dw": (cq, o, rows), "dbasis": (rows, cq, o)}[layout]


def product_bound(layout: str, i: int, j: int, k: int, dtype=torch.float32) -> dict:
    """Least time of one product (``kernels.product`` layouts, ``I x J``
    outputs over depth ``K``): the larger of its bytes over the HBM rate
    (each input read once, each output written once: the operands in
    ``dtype``, W float32, the output float32, or in ``dtype`` at dbasis)
    and ``2 I J K`` FLOPs at the bf16 peak or the 3xTF32 ceiling (a third
    of the TF32 peak)."""
    op = 2.0 if dtype == torch.bfloat16 else 4.0
    nbytes = {"fwd": op * i * k + 4.0 * k * j + 4.0 * i * j,
              "dw": op * k * i + op * k * j + 4.0 * i * j,
              "dbasis": op * i * k + 4.0 * j * k + op * i * j}[layout]
    flops = 2.0 * i * j * k
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def edge_bound(shape, idx, mask, dtype=torch.float32, d=9, kp=False, sorted_rows=False) -> dict:
    """Least time of the backward's per-edge pass (``edge_kernel``) alone,
    from :func:`conv_bounds`' counts: the larger of its bytes over the HBM
    rate and its FLOPs over the peaks.  It reads the dbasis rows of the live
    rows (``L*G*C*Q`` operand values), their geometry (``rel``, ``rot6``,
    ``idx``, ``mask``), the distinct feature rows its valid edges gather and
    the projection and bias, and writes ``d_feats`` (float32, every row) or,
    with ``sorted_rows``, each valid edge's row of the sorted buffer (operand
    values), and its ``[D + 1, Q]`` partials.  FLOPs per valid edge and
    frame pair: ``dpne`` and ``d_feats`` (``2*Q*C`` each) on tensor cores, at
    the 3xTF32 ceiling in float32 or the bf16 peak; pne (``2*D*Q``), act' and
    ``d_proj`` / ``d_bias`` (``2*(D+1)*Q``), and the kernel-point weights,
    at the float32 peak."""
    b, m, n, k, g, f, q, c, o = shape
    valid = float(mask.sum())
    edges = valid * g * f
    live = float(mask.any(-1).sum())
    bf16 = dtype == torch.bfloat16
    op = 2.0 if bf16 else 4.0
    rot = 6 * f if d == 9 and not kp else 0
    geo = live * ((4.0 if kp else op) * k * g * 3 + op * k * g * rot + 9.0 * k)
    example = torch.arange(b, device=idx.device).reshape(b, 1, 1) * n
    gathered = float(torch.unique((idx.long() + example)[mask]).numel())
    out = op * valid * f * c if sorted_rows else 4.0 * b * n * f * c
    nbytes = op * live * g * c * q + geo + op * gathered * f * c + 4.0 * (d + 1) * q + out + 4.0 * (d + 1) * q
    mma_flops = 4.0 * edges * q * c
    other_flops = 2.0 * edges * q * (2 * d + 1) + (edges * (KP_FLOPS * d + 3) if kp else 0.0)
    t_ops = mma_flops / (PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3) + other_flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=(mma_flops + other_flops) / 1e9, mbytes=nbytes / 1e6)


def edge_matmul_ms(rows: int, e: int, c: int, gq: int, seed: int, dtype=torch.float32) -> dict:
    """The per-edge pass's yardstick: its two products as ``torch.bmm`` in
    ``dtype`` (float32: full float32, TF32 off, set here) over operands
    gathered beforehand (seeded, of its shapes), ``rows`` live rows of
    ``e`` edges: ``[rows, e, C] @ [rows, C, G*Q]`` for dpne and ``[rows, e,
    G*Q] @ [rows, G*Q, C]`` for d_feats; ``{"dpne": ms, "d_feats": ms,
    "ms": both}``.  No PyTorch call computes the pass."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feat = torch.randn(rows, e, c, device="cuda", generator=gen).to(dtype)
    db = torch.randn(rows, c, gq, device="cuda", generator=gen).to(dtype)
    pne = torch.randn(rows, e, gq, device="cuda", generator=gen).to(dtype)
    dbt = db.transpose(1, 2).contiguous()
    out = {"dpne": cuda_ms(lambda: torch.bmm(feat, db), 10), "d_feats": cuda_ms(lambda: torch.bmm(pne, dbt), 10)}
    del feat, db, pne, dbt
    torch.cuda.empty_cache()
    return dict(out, ms=out["dpne"] + out["d_feats"])


# every instantiation of the per-edge pass, (operand bytes, G, Q, K, kd, P)
# at the recipes' shapes and at the limits: phase 9 holds kernels.fused_equiv's
# plan mirror against the C plan there, and the card's occupancy and spills
EDGE_PLANS = [(e, *s) for e in (4, 2) for s in ((1, 32, 24, 9, 0), (2, 32, 16, 9, 0), (2, 32, 32, 9, 0),
                                                (4, 32, 32, 9, 0), (2, 32, 768, 9, 0), (4, 32, 432, 9, 0),
                                                (1, 64, 32, 3, 0), (1, 64, 32, 0, 55), (1, 64, 768, 0, 64))]
# edge_kernel's instantiations in the backward's library: operand type x
# (pne columns, kd, the activation switch)
EDGE_INSTANCES = 2 * 7


def edge_checks(card) -> dict:
    """9. (before the conv shapes) every ``edge_kernel`` instantiation of the
    backward's library carries HMMA in its SASS (``probe_ab.sass_counts``,
    ``cuobjdump``); the plan mirror (``kernels.fused_equiv.edge_plan``)
    equals the C plan at ``EDGE_PLANS``, where gelu's instantiation keeps
    no local memory (the kernel points' 32 bytes of stack, sinf's slow path)
    and the card holds at least the plan's blocks an SM.  Fails the run
    otherwise."""
    import ctypes

    import probe_ab
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels.build import build_libraries, library

    sass = {k: v for k, v in probe_ab.sass_counts(build_libraries(names=("bwd",))["bwd"], every=True).items()
            if k.startswith("edge_kernel")}
    print(f"edge_checks: SASS HMMA of each edge_kernel instantiation: "
          + ", ".join(f"{k} {v[1]}" for k, v in sorted(sass.items())) + f" [{card}]", flush=True)
    if len(sass) != EDGE_INSTANCES or not all(v[1] > 0 for v in sass.values()):
        raise SystemExit(f"edge_kernel: {len(sass)} instantiations (want {EDGE_INSTANCES}), "
                         f"not every one on tensor cores: {sass}")
    keys = ("warps", "smem_bytes", "stages", "blocks_per_sm", "gq_stride", "geo_rows", "edges_per_round",
            "channels_per_chunk")
    plans = {}
    for plan in EDGE_PLANS:
        out, attrs = (ctypes.c_int * 8)(), (ctypes.c_int * 4)()
        err = library("bwd").se3_fused_edge_plan(*plan, out)
        want = kfe.edge_plan(*plan)
        err = err or library("bwd").se3_fused_edge_attrs(*plan, 0, attrs)
        plans[str(plan)] = dict(c_plan=list(out), registers=attrs[0], local_bytes=attrs[1], blocks_per_sm=attrs[3])
        # gelu's own instantiation (act 0) keeps no local memory; the
        # kernel-point one switches the activation: 32 bytes, sinf's stack
        local_max = 32 if plan[4] == 0 else 0
        if err or list(out) != [want[x] for x in keys] or attrs[1] > local_max or attrs[3] < want["blocks_per_sm"]:
            raise SystemExit(f"edge_kernel plan {plan}: C {list(out)} (error {err}), mirror "
                             f"{[want[x] for x in keys]}, attributes {list(attrs)}")
    print("edge_checks: plan mirror equal to the C plan; (bytes, G, Q, K, kd, P): registers, blocks an SM "
          "(plan) " + "; ".join(f"{k}: {v['registers']}, {v['blocks_per_sm']} ({v['c_plan'][3]})"
                                for k, v in plans.items()) + f" [{card}]", flush=True)
    return dict(sass={k: v[1] for k, v in sass.items()}, plans=plans)


def max_rel_err(got, ref) -> tuple:
    """``(max |got - ref|, max |got - ref| / max |ref|, mean |got - ref| /
    max |ref|)`` (in float32 for bfloat16 tensors)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    scale = max(ref.abs().max().item(), 1e-30)
    err = diff.max().item()
    return err, err / scale, diff.mean().item() / scale


def within(err, dtype, rtol) -> bool:
    """``max_rel_err`` output within the kernel bounds: ``rtol`` for float32
    operands, ``BF16_RTOL`` and ``BF16_MEAN_RTOL`` for bfloat16 ones."""
    if dtype == torch.bfloat16:
        return err[1] <= BF16_RTOL and err[2] <= BF16_MEAN_RTOL
    return err[1] <= rtol


def tells_apart(sound: float, control: float) -> bool:
    """The discrimination gate of the bfloat16 checks: an error against the
    bfloat16 version (``sound``) at most ``BF16_SOUND_SHARE`` of the same
    error against the version with no bfloat16 rounding (``control``)."""
    return sound <= BF16_SOUND_SHARE * control


def control_text(sound: float, control: float) -> str:
    return (f"against no bfloat16 rounding (control) {control:.3e}, sound/control "
            f"{sound / max(control, 1e-30):.3f} (bound {BF16_SOUND_SHARE})")


def bound_text(dtype, rtol) -> str:
    return (f"bounds max {BF16_RTOL}, mean {BF16_MEAN_RTOL}" if dtype == torch.bfloat16
            else f"bound {rtol}")


def as_operands(args, dtype) -> list:
    """A conv's operands with rel, rot6 (None at the standard geometry) and
    feats in ``dtype``."""
    return [x.to(dtype) if i < 3 and x is not None else x for i, x in enumerate(args)]


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
# the conv forward's and backward's passes: (name, alternatives, each a
# tuple of substrings of a kernel's name); both libraries build
# basis_kernel and the shared product wg_product, told apart by their
# template arguments (the product's first names its call site)
FWD_PASSES = (("basis_kernel", (("basis_kernel<", ", false, "),)),
              ("product", (("wg_product<", "SiteFwd"),)),
              ("sum_splits", (("sum_splits",),)))
BWD_PASSES = (("basis_kernel", (("basis_kernel<", ", true, "),)),
              ("d_w product", (("wg_product<", "SiteDw"),)),
              ("dbasis product", (("wg_product<", "SiteDbasis"),)),
              ("edge_kernel", (("edge_kernel",),)), ("sum_partials", (("sum_partials",),)))
# the weights' images for the products (W for the forward, W^T for dbasis):
# one small kernel in each library, so a step's profile cannot tell the
# forward's from the backward's
WEIGHT_COPY_PASSES = (("product_image", (("product_image",),)),)
# the prefix sum's single kernel ('sorted' mode only)
CUMSUM_PASSES = (("scan_kernel", (("scan_kernel<",),)),)
# PyTorch's reduction kernels (BN statistics, masked sums and means)
REDUCTION_PASSES = (("reduce_kernel", (("reduce_kernel",),)),)


def cumsum_cases() -> dict:
    """Phase 10's prefix-sum inputs, ``name: ((B, E, C), payload dtype)``.
    A conv's sorted buffer is ``[B, M*K, F*C]``: the ScanNet level-0 and
    level-4 block convs (level 0 in bfloat16 too, the recipe's compute
    dtype), the DFaust recipe's level-0 conv (capacity x max_neighbors
    edges, in-frames x the level-0 width, B=32) and the ModelNet40 recipes'
    level-5 block conv (B=12, 512 channels x 2 in-frames)."""
    from se3conv3d_tpu_torch.models import presets

    cases = {name.replace("block_conv", "edges"): ((b, m * k, f * c), torch.float32)
             for name, (b, m, _, k, _, f, _, c, _) in SCANNET_SHAPES.items()}
    cases["scannet_level0_edges_bf16"] = (cases["scannet_level0_edges"][0], torch.bfloat16)
    model = presets.DFAUST_I_ROT_PCA_2F_MODEL
    width = presets.spec_from_model_dict(model).num_features[0]
    cases["dfaust_level0_edges"] = ((BATCH, model["capacities"][0] * model["max_neighbors"],
                                     model["RefFrames"]["train_n_frames"] * width), torch.float32)
    model = presets.MODELNET40_PCA_2F_MODEL
    width = presets.spec_from_model_dict(model).num_features[-1]
    cases["modelnet_level5_edges"] = ((MN_BATCH, model["capacities"][-1] * model["max_neighbors"],
                                       model["RefFrames"]["train_n_frames"] * width), torch.float32)
    return cases


def device_rows(prof) -> list:
    """``(device ms, launches, kernel name)`` of a ``torch.profiler`` run,
    largest first.  Read from the profiler's raw events: ``key_averages``
    first builds the tree of every host event, about half a minute for a
    ScanNet step's 80,000 launches, where this takes about two seconds."""
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation():
            ms, n = by_name.get(ev.name(), (0.0, 0))
            by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, n + 1)
    return sorted(((ms, n, key) for key, (ms, n) in by_name.items() if ms > 0), reverse=True)


def pass_ms(rows, passes=BWD_PASSES) -> dict:
    """Device ms of each pass of ``passes`` in ``device_rows`` output."""
    return {name: sum(ms for ms, _, key in rows if any(all(tag in key for tag in alt) for alt in alts))
            for name, alts in passes}


def dfaust_eval(card, dev, batch, model_dict=None, label="slice", kind=None, steps=EVAL_STEPS) -> tuple:
    """3. the DFaust recipe's eval path at full width (``model_dict``, by
    default ``dfaust_I_rot_pca_2F``'s; its convs of ``kind``, as
    :func:`seeded_model` takes it): a seeded model, one calibration step
    and ``steps`` eval steps on ``batch``, counting 21 forward conv
    launches per forward and checking the logits and the calibration;
    ``label`` heads the printed lines.  Returns ``(trainer, {step_s, all_s,
    peak_gib, launches})``."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model_dict = model_dict or presets.DFAUST_I_ROT_PCA_2F_MODEL
    model = seeded_model(model_dict, dev, kind=kind).eval()
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=False),
                      label_smoothing=0.2)
    gen = torch.Generator(device=dev).manual_seed(3)

    h, _, out_pc, _, _ = trainer.build(batch, gen, train=False)
    occupancy = [int(pc.mask.sum(1).max()) for pc in h.levels] + [int(out_pc.mask.sum(1).max())]
    caps = [pc.capacity for pc in h.levels] + [out_pc.capacity]
    print(f"{label}: max valid points per level {occupancy} of capacities {caps}")
    if any(o > c or o == 0 for o, c in zip(occupancy, caps)):
        raise SystemExit("synthetic batch overflows (or empties) a level")
    del h, out_pc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe)
    t0 = time.perf_counter()
    trainer.calibration_step(batch, gen)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    after_calib = kfe.fused_equiv_fwd.launches
    step_s, outs = [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        outs = trainer.eval_step(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = kfe.fused_equiv_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    logits = outs["logits"]
    median_s = statistics.median(step_s)
    print(f"{label}: calibration_step {calib_s:.4f} s, eval_step median {median_s:.4f} s "
          f"(all {[round(s, 4) for s in step_s]}), {BATCH * POINTS / median_s:.1f} input points/s, "
          f"peak memory {peak / 2**30:.3f} GiB, loss {float(outs['loss']):.4f} [{card}]")
    print(f"{label}: kernel launches {launches} = {after_calib} (calibration) + "
          f"{launches - after_calib} ({steps} eval steps) [{card}]")
    if after_calib != CONVS_PER_FORWARD or launches != CONVS_PER_FORWARD * (1 + steps):
        raise SystemExit(f"expected {CONVS_PER_FORWARD} kernel launches per forward")
    if tuple(logits.shape) != (BATCH, POINTS, CLASSES) or not torch.isfinite(logits).all():
        raise SystemExit(f"bad logits: shape {tuple(logits.shape)}")
    if not all(bool(m.initialized) for m in model.modules() if hasattr(m, "initialized")):
        raise SystemExit("a conv was not calibrated")
    return trainer, dict(step_s=median_s, all_s=step_s, peak_gib=peak / 2**30, launches=launches)


def dfaust_train(card, dev, batch, model_dict=None, training=None, kind=None, steps=TRAIN_STEPS) -> tuple:
    """7. the DFaust recipe's training at full width: a fresh seeded model
    (of ``model_dict``, by default the recipe's; its convs of ``kind``) and
    the ``Training`` section ``training`` (by default the recipe's), one
    calibration step, then ``steps`` train
    steps on ``batch``, counting 21 forward and 21 backward conv launches
    per step (all of them bfloat16 ones with bfloat16 convs, none
    otherwise) and checking finite losses and moved BN means.  Returns
    ``(trainer, {step_s, steady_s, all_s, peak_gib, launches,
    bf16_launches})``: ``steady_s`` is the median of the steps after the
    first, which alone carries one-time costs (allocator growth, library
    handles)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model_dict = model_dict or presets.DFAUST_I_ROT_PCA_2F_MODEL
    training = training or presets.DFAUST_I_ROT_PCA_2F_TRAINING
    label = f"train {model_dict['model']} {model_dict.get('compute_dtype', 'float32')}" + (
        f" {kind}" if kind else "")
    model = seeded_model(model_dict, dev, kind=kind)
    opt = schedule.optimizer_from_training(model.parameters(), training, steps)
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=False),
                      label_smoothing=training["label_smoothing"], optimizer=opt)
    gen = torch.Generator(device=dev).manual_seed(7)
    bns = {n: mod for n, mod in model.named_modules() if isinstance(mod, MaskedBatchNorm)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe)
    trainer.calibration_step(batch, gen)
    bn_before = {n: mod.mean.clone() for n, mod in bns.items()}
    train_fwd_calib = kfe.fused_equiv_fwd.launches
    step_s, per_step = [], []
    for step in range(steps):
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
        print(f"{label}: step {step} lr {lr:.6e} loss {loss:.6f} grad_norm {gnorm:.6f} "
              f"launches fwd {fwd_n} bwd {bwd_n} time {step_s[-1]:.4f} s [{card}]", flush=True)
    train_fwd, train_bwd = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    bf16_n = (kfe.fused_equiv_fwd.bf16_launches, kfe.fused_equiv_bwd.bf16_launches)
    train_peak = torch.cuda.max_memory_allocated()
    train_median, steady = statistics.median(step_s), statistics.median(step_s[1:] or step_s)
    print(f"{label}: calibration launches {train_fwd_calib}; train_step median {train_median:.4f} s, "
          f"after the first {steady:.4f} s (all {[round(x, 4) for x in step_s]}), "
          f"{BATCH * POINTS / train_median:.1f} input points/s, "
          f"peak memory {train_peak / 2**30:.3f} GiB; launches fwd {train_fwd} bwd {train_bwd}, "
          f"bfloat16 fwd {bf16_n[0]} bwd {bf16_n[1]} [{card}]", flush=True)
    result = dict(step_s=train_median, steady_s=steady, all_s=step_s, peak_gib=train_peak / 2**30,
                  launches=(train_fwd, train_bwd), bf16_launches=bf16_n)
    if bf16_n != ((train_fwd, train_bwd) if bf16_convs(model) else (0, 0)):
        raise SystemExit(f"{label}: bfloat16 launches {bf16_n} of {(train_fwd, train_bwd)}")
    if not all(np.isfinite(lo) and np.isfinite(gn) for lo, gn, _, _ in per_step):
        raise SystemExit("non-finite loss or gradients in a train step")
    if train_fwd_calib != CONVS_PER_FORWARD or any(
            (f_, b_) != (CONVS_PER_FORWARD, CONVS_PER_FORWARD) for _, _, f_, b_ in per_step):
        raise SystemExit(f"expected {CONVS_PER_FORWARD} forward and backward kernel launches per step")
    still = [n for n, mod in bns.items() if torch.equal(mod.mean, bn_before[n])]
    print(f"{label}: {len(bns) - len(still)} of {len(bns)} BN running means moved")
    if still:
        raise SystemExit(f"BN running mean did not move: {still[:5]}")
    return trainer, result


def dfaust_invariance(card, dev, model, h, f0, out_pc, base, label="") -> float:
    """4. the logits ``base`` of an equivariant ``model`` on ``h`` unchanged
    by a global rotation of the hierarchy (``ROT_ATOL``).  Returns the
    error."""
    from se3conv3d_tpu_torch.core.hierarchy import rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.rotation import random_rotations

    valid = out_pc.mask
    rot = random_rotations(1, generator=torch.Generator().manual_seed(6))[0].to(dev)
    with torch.no_grad():
        rotated = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
    rot_err = (base - rotated).abs()[valid].max().item()
    spread = (base[valid].max() - base[valid].min()).item()
    print(f"{label}invariance: max |logits - logits(rotated)| = {rot_err:.3e} (bound {ROT_ATOL}); "
          f"logits span {spread:.3e} over the valid points [{card}]")
    if not rot_err <= ROT_ATOL:
        raise SystemExit(f"{label}logits change under a global rotation")
    return rot_err


def dfaust_card_vs_cpu(card, dev, trainer, small, label="") -> float:
    """4.-5. on the two clouds of ``small``: with an equivariant model the
    logits unchanged by a global rotation of the hierarchy
    (:func:`dfaust_invariance`; a standard model is not rotation invariant
    and is not checked), then the same model and hierarchy on the CPU
    (plain path) within ``CPU_ATOL`` of the card's logits.  Returns the card
    vs CPU error."""
    model = trainer.model
    h, f0, out_pc, _, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(5), train=False)
    with torch.no_grad():
        base = model(h, f0, out_pc)
        valid = out_pc.mask
        if model.spec.equivariant:
            dfaust_invariance(card, dev, model, h, f0, out_pc, base, label)
        cpu_model = copy.deepcopy(model).cpu()
        cpu_logits = cpu_model(h.to("cpu"), f0.cpu(), out_pc.to("cpu"))
        cpu_err = (base.cpu() - cpu_logits).abs()[valid.cpu()].max().item()
        print(f"{label}card_vs_cpu: max |logits(card) - logits(cpu)| = {cpu_err:.3e} "
              f"(bound {CPU_ATOL}), max |logits| = {base.abs().max().item():.3e} [{card}]")
        if not cpu_err <= CPU_ATOL:
            raise SystemExit(f"{label}card and CPU logits disagree")
    return cpu_err


def dfaust_grads_card_vs_cpu(card, dev, trainer, small, recorded_draws, training, label="") -> float:
    """8. one train-mode forward and backward on the two clouds of
    ``small``: the card's parameter gradients against the same model's on
    the CPU (plain path) with the same hierarchy and DropPath keep masks,
    per leaf within ``GRAD_RTOL`` (``grads_ratio``).  Returns the worst
    ratio."""
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model = trainer.model
    h, f0, out_pc, out_labels, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(8))
    cpu_model = copy.deepcopy(model).cpu()
    draws = recorded_draws(torch.Generator(device=dev).manual_seed(9))
    card_loss = float(trainer.backward(h, f0, out_pc, out_labels, draws))
    cpu_trainer = Trainer(cpu_model, trainer.hcfg, label_smoothing=training["label_smoothing"])
    cpu_loss = float(cpu_trainer.backward(h.to("cpu"), f0.cpu(), out_pc.to("cpu"), out_labels.cpu(),
                                          DropPathDraws(keep_masks=draws.masks)))
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    grads = {n: p.grad for n, p in model.named_parameters()}
    bad = [n for n, g in grads.items() if g is None or cpu_grads[n] is None or not torch.isfinite(g).all()]
    if bad:
        raise SystemExit(f"missing or non-finite gradient for {bad[:5]}")
    norm = float(schedule.global_norm(list(cpu_grads.values())))
    worst, worst_name = grads_ratio({n: g.cpu() for n, g in grads.items()}, cpu_grads, norm)
    print(f"{label}grads_card_vs_cpu: loss card {card_loss:.6f} cpu {cpu_loss:.6f}; {len(cpu_grads)} leaves, "
          f"global norm {norm:.6f}, {len(draws.masks)} DropPath masks; worst max|card - cpu| / "
          f"max(max|cpu leaf|, {GRAD_FLOOR} * norm) = {worst:.3e} at {worst_name} "
          f"(bound {GRAD_RTOL}) [{card}]", flush=True)
    if not (worst <= GRAD_RTOL and abs(card_loss - cpu_loss) <= GRAD_RTOL * abs(cpu_loss)):
        raise SystemExit(f"{label}card and CPU gradients disagree")
    return worst


def scannet_rooms(dev) -> dict:
    """The ``SCENES`` synthetic rooms of ``SCENE_POINTS`` points of the
    ScanNet phases (numpy seeds 100-105), stacked on the card."""
    return to_device(stack_scenes([room_scene(SCENE_POINTS, 100 + i) for i in range(SCENES)]), dev)


def scannet_recipes() -> dict:
    """The ScanNet ``Model`` sections of the ScanNet phases by dtype: the
    recipe as written (``compute_dtype: bfloat16``) and a float32 copy."""
    from se3conv3d_tpu_torch.models import presets

    written = presets.SCANNET20_ROT_PCA_I_MODEL
    if written.get("compute_dtype") != "bfloat16":
        raise SystemExit("the pinned ScanNet recipe no longer computes in bfloat16")
    return {"bfloat16": written, "float32": {**written, "compute_dtype": "float32"}}


def scannet_trainer(dev, room0, model_dict, steps=len(SCANNET_MODE_ORDER), s_training=None):
    """Phase 13's trainer: a fresh seeded model of the ScanNet ``Model``
    section ``model_dict`` from ``build_model_from_config``, the optimizer
    of the ``Training`` section ``s_training`` (by default
    ``scannet20_rot_pca_I``'s) over ``steps`` steps and ``scan_scenes``,
    calibrated on ``room0``."""
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    s_training = s_training or presets.SCANNET20_ROT_PCA_I_TRAINING
    model = seeded_model(model_dict, dev, presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES)
    opt = schedule.optimizer_from_training(model.parameters(), s_training, steps)
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, SCENE_POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, SCENE_POINTS, train=False),
                      label_smoothing=s_training["label_smoothing"],
                      ignore_label=presets.SCANNET20_IGNORE_LABEL, optimizer=opt,
                      scan_scenes=s_training["scan_scenes"])
    trainer.calibration_step(room0, torch.Generator(device=dev).manual_seed(120))
    return trainer


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def product_text(dtype) -> str:
    return ("every FLOP at the dense bf16 tensor-core peak; {:.4f} with the per-edge FLOPs at the "
            "float32 peak" if dtype == torch.bfloat16 else
            "the products at the 3xTF32 tensor-core ceiling; {:.4f} with every FLOP at the float32 peak")


def forward_vs_plain(card, label, shp, args, live, bounds, seed, opts=None) -> dict:
    """The forward kernel on the live rows ``live`` vs its plain version
    (over every row; for bfloat16 operands its bfloat16 rounding, with the
    control of :func:`tells_apart`), two calls bitwise equal, and its time
    beside the plain version's and ``torch.matmul``'s (in the operands'
    dtype) for its weight contraction over the same live rows; fails the run
    on a disagreement.  ``opts``: the activation and kernel-point keywords
    (``act``, ``kp``) of both versions."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    g, dtype = shp[4], args[2].dtype
    bf16 = dtype == torch.bfloat16
    opts = opts or {}
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args, live_rows=live, **opts)
        again = kfe.fused_equiv_fwd(*args, live_rows=live, **opts)
        ref = kfe.fused_equiv_fwd_reference(*args, **opts)
        torch.cuda.synchronize()
        err = max_rel_err(got, ref)
        finite, same = bool(torch.isfinite(got).all()), torch.equal(got, again)
        del again, ref
        control = (max_rel_err(got, kfe.fused_equiv_fwd_reference(*as_operands(args, torch.float32),
                                                                  **opts))[2]
                   if bf16 else None)
        del got
        ms = cuda_ms(lambda: kfe.fused_equiv_fwd(*args, live_rows=live, **opts), 20)
        plain_ms = cuda_ms(lambda: kfe.fused_equiv_fwd_reference(*args, **opts), 3)
    lib_ms = product_matmul_ms(live.numel() * g, args[7], seed, dtype)
    print(f"{label} {dtype_name(dtype)} B,M,N,K,G,F,Q,C,O={shp}: {live.numel()} live of "
          f"{shp[0] * shp[1]} rows; max_abs_err={err[0]:.3e} max_rel_err={err[1]:.3e} mean_rel_err="
          f"{err[2]:.3e} ({bound_text(dtype, KERNEL_RTOL)}"
          + (f"; mean_rel_err {control_text(err[2], control)}" if bf16 else "")
          + f"); two calls bitwise equal: {same}; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bounds['bound_ms']:.4f} "
          f"({bounds['bound_by']}, {bounds['gflop']:.2f} GFLOP, "
          + product_text(dtype).format(bounds["bound_f32_ms"])
          + f"); torch.matmul {dtype_name(dtype)} for basis . W over the same live rows {lib_ms:.4f} ms "
          f"[{card}]", flush=True)
    if not (finite and same and within(err, dtype, KERNEL_RTOL)
            and (not bf16 or tells_apart(err[2], control))):
        raise SystemExit(f"forward kernel disagrees with its plain version at {label} ({dtype})")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err[0], max_rel_err=err[1],
                mean_rel_err=err[2], control_mean_rel_err=control, library_ms=lib_ms, **bounds)


def backward_vs_plain(card, label, shp, args, gout, live, bounds, seed, opts=None) -> dict:
    """The backward kernel on the live rows ``live`` vs its plain version
    (over every row; for bfloat16 operands its bfloat16 rounding, with the
    control of :func:`tells_apart`) in both feature-gradient output modes
    (atomic scatter; rows at their sorted slots, summed by
    ``sorted_segment_sum``), its parameter gradients bitwise equal across
    modes and calls, and its time beside the plain version's and
    ``torch.matmul``'s (in the operands' dtype) for its two products over
    the same live rows; fails the run on a disagreement.  ``opts`` as in
    :func:`forward_vs_plain`."""
    from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.ops.pne_conv import backward_sort_tables

    names = ("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights")
    b, m, n, k, g, f, q, c, o = shp
    dtype = args[2].dtype
    dname, bf16 = dtype_name(dtype), dtype == torch.bfloat16
    opts = opts or {}
    tabs = backward_sort_tables(Neighborhood(args[3], args[4], args[4].any(-1)), n)
    got = kfe.fused_equiv_bwd(*args, gout, live_rows=live, **opts)
    ref = kfe.fused_equiv_bwd_reference(*args, gout, **opts)
    got_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live, **opts)
    ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot, **opts)
    summed = segsum.sorted_segment_sum(got_s[0], tabs.bwd_run_start, tabs.bwd_run_end)
    prefix_scale = float(segsum.blocked_cumsum(got_s[0]).abs().max())
    torch.cuda.synchronize()
    errs = {w: max_rel_err(x, y) for w, x, y in zip(names, got, ref)}
    errs_s = {w: max_rel_err(x, y) for w, x, y in zip(("d_sorted_rows",) + names[1:], got_s, ref_s)}
    # the segment sums against the plain scatter (float32), or against the
    # kernel's own scatter of the same bfloat16-rounded rows (bfloat16: a
    # plain row may round the other way): prefix differences, so the bound
    # is SEGSUM_EPS_FACTOR * eps * max |prefix|, not relative
    seg_ref = got[0] if bf16 else ref[0]
    seg_err = float((summed.reshape(seg_ref.shape) - seg_ref).abs().max())
    seg_limit = SEGSUM_EPS_FACTOR * torch.finfo(torch.float32).eps * prefix_scale
    del ref, ref_s, seg_ref, summed
    control = {}
    if bf16:  # the plain version on the widened operands: no bfloat16 rounding
        wide = as_operands(args, torch.float32)
        control = {w: max_rel_err(x, y)[2] for w, x, y in
                   zip(names, got, kfe.fused_equiv_bwd_reference(*wide, gout, **opts))}
        control["d_sorted_rows"] = max_rel_err(
            got_s[0], kfe.fused_equiv_bwd_reference(*wide, gout, sorted_slot=tabs.bwd_slot, **opts)[0])[2]
        del wide
    finite = all(bool(torch.isfinite(x.float()).all()) for x in (*got, *got_s))
    sorted_dtype = got_s[0].dtype
    again = kfe.fused_equiv_bwd(*args, gout, live_rows=live, **opts)
    same_params = all(torch.equal(x, y) and torch.equal(x, z)
                      for x, y, z in zip(got[1:], got_s[1:], again[1:]))
    del got, got_s, again
    ms = cuda_ms(lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live, **opts), 10)
    sorted_ms = cuda_ms(lambda: kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live,
                                                    **opts), 10)
    # one timed call of the plain version: 0.7-2 s each at the ScanNet level 0
    plain_ms = cuda_ms(lambda: kfe.fused_equiv_bwd_reference(*args, gout, **opts), 1)
    lib = products_matmul_ms(live.numel() * g, args[7], seed, dtype)
    lib_ms = lib["d_w"] + lib["dbasis"]
    for mode, e in (("scatter", errs), ("sorted", errs_s)):
        print(f"{label} {dname} mode {mode}: "
              + " ".join(f"{w}: max_abs_err={v[0]:.3e} max_rel_err={v[1]:.3e} mean_rel_err={v[2]:.3e}"
                         + (f" ({control_text(v[2], control[w])})" if w in control and (
                             mode == "scatter" or w == "d_sorted_rows") else "")
                         for w, v in e.items())
              + f" ({bound_text(dtype, BWD_RTOL)}) [{card}]", flush=True)
    print(f"{label} {dname} mode sorted: rows in {dtype_name(sorted_dtype)}; d_feats by segment sums "
          f"of the rows vs the {'kernel' if bf16 else 'plain'} scatter: max_abs_err={seg_err:.3e} (bound "
          f"{seg_limit:.3e} = {SEGSUM_EPS_FACTOR} eps x max|prefix| {prefix_scale:.3e}) [{card}]", flush=True)
    print(f"{label} {dname} B,M,N,K,G,F,Q,C,O={shp}: {live.numel()} live of {b * m} rows; kernel_ms "
          f"scatter {ms:.4f} sorted-rows {sorted_ms:.4f} plain_ms {plain_ms:.4f} "
          f"bound_ms={bounds['bound_ms']:.4f} ({bounds['bound_by']}, {bounds['gflop']:.2f} GFLOP, "
          + product_text(dtype).format(bounds["bound_f32_ms"])
          + f"); torch.matmul {dname} over the same live rows for d_w {lib['d_w']:.4f} ms and dbasis "
          f"{lib['dbasis']:.4f} ms ({lib_ms:.4f} together); "
          f"parameter gradients equal across modes and calls: {same_params} [{card}]", flush=True)
    told_apart = all(tells_apart(errs_s[w][2] if w == "d_sorted_rows" else errs[w][2], v)
                     for w, v in control.items())
    if not (finite and same_params and seg_err <= seg_limit and sorted_dtype == dtype and told_apart
            and all(within(v, dtype, BWD_RTOL) for e in (errs, errs_s) for v in e.values())):
        raise SystemExit(f"backward kernel disagrees with its plain version at {label} ({dname})")
    return dict(ms=ms, ms_sorted_rows=sorted_ms, plain_ms=plain_ms,
                max_abs_err=max(v[0] for e in (errs, errs_s) for v in e.values()),
                max_rel_err=max(v[1] for e in (errs, errs_s) for v in e.values()),
                control_mean_rel_err=control or None, segment_sum_max_abs_err=seg_err,
                products_library_ms=lib_ms, dw_library_ms=lib["d_w"], dbasis_library_ms=lib["dbasis"],
                **bounds)


def scannet_conv_kernels(card, dev, dtype=torch.float32) -> dict:
    """9. conv forward and backward kernels vs plain at the ScanNet shapes,
    with ``dtype`` operands, given the live-row table as the main path gives
    it (:func:`forward_vs_plain`, :func:`backward_vs_plain`).  (Their passes'
    device ms come last, in :func:`scannet_conv_passes`: a
    ``torch.profiler`` run slows the kernel launches that follow it, and the
    train steps are timed in between.)"""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    out = {}
    for i, (name, (shp, n_live)) in enumerate(scannet_conv_cases().items()):
        args, gout = padded_conv_args(i, shp, n_live, dev, dtype)
        live = kfe.live_row_table(args[4])
        bounds = conv_bounds(shp, args[3], args[4], dtype)
        out[name] = dict(
            fwd=forward_vs_plain(card, f"scannet_fwd_kernel_vs_plain {name}", shp, args, live,
                                 bounds["fwd"], 57 + i),
            bwd=backward_vs_plain(card, f"scannet_bwd_kernel_vs_plain {name}", shp, args, gout, live,
                                  bounds["bwd"], 55 + i),
        )
        del args, gout, live
        torch.cuda.empty_cache()
    return out


def scannet_conv_cases() -> dict:
    """Phase 9's convs: ``name: (shape, live rows per example or None)``."""
    cases = {name: (shp, None) for name, shp in SCANNET_SHAPES.items()}
    cases.update({name: (SCANNET_SHAPES[base], live) for name, (base, live) in SCANNET_PADDED.items()})
    return cases


def padded_conv_args(i, shp, n_live, dev, dtype=torch.float32) -> tuple:
    """The seeded operands (rel, rot6 and feats in ``dtype``) and ``gout`` of
    the conv of seed index ``i`` (phase 9: ``i`` < 10; 15: 10-11; 18: 20-24;
    21: 30-33); rows past ``n_live`` (if given) of each example are
    padding, with no valid edge."""
    b, m, n, k, g, f, q, c, o = shp
    args = as_operands(conv_inputs(*shp, seed=40 + i, dev=dev), dtype)
    if n_live is not None:
        args[4][:, n_live:] = False
    args[3] = torch.where(args[4], args[3], torch.zeros_like(args[3]))  # invalid slots hold 0
    gout = torch.randn(b, m, g, o, device=dev, generator=torch.Generator(device=dev).manual_seed(50 + i))
    return args, gout


def scannet_conv_passes(card, dev, conv: dict, dtype=torch.float32) -> None:
    """Device ms of each conv forward and backward pass at phase 9's shapes
    with ``dtype`` operands (:func:`conv_passes`)."""
    cases = {name: (i, shp, n_live) for i, (name, (shp, n_live)) in enumerate(scannet_conv_cases().items())}
    conv_passes(card, dev, conv, cases, dtype, "scannet")


def modelnet_conv_passes(card, dev, conv: dict) -> None:
    """Device ms of each conv pass at phase 21's fully live level-5 block
    conv (float32, the recipes' dtype; :func:`conv_passes`)."""
    names = list(MN_SHAPES)
    name = "modelnet_level5_block_conv_live"
    conv_passes(card, dev, conv, {name: (30 + names.index(name), MN_SHAPES[name][0], None)}, torch.float32,
                "modelnet")


def conv_passes(card, dev, conv: dict, cases: dict, dtype, label: str) -> None:
    """Device ms of each conv forward and backward pass (``torch.profiler``
    over 3 calls each) at ``cases`` (``name: (seed index of
    padded_conv_args, shape, live rows per example or None)``) with
    ``dtype`` operands, into ``conv[name]["fwd"]`` / ``["bwd"]``; each
    call site of the shared product beside its bound
    (:func:`product_bound`) and ``torch.matmul`` in the same dtype, into
    ``conv[name]["products"]``; and the backward's per-edge pass beside
    :func:`edge_bound` and its two-``bmm`` yardstick
    (:func:`edge_matmul_ms`), into ``conv[name]["edge"]``."""
    from torch.profiler import ProfilerActivity, profile

    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    for name, (i, shp, n_live) in cases.items():
        args, gout = padded_conv_args(i, shp, n_live, dev, dtype)
        live = kfe.live_row_table(args[4])
        with torch.no_grad():
            runs = {"fwd": (lambda: kfe.fused_equiv_fwd(*args, live_rows=live), FWD_PASSES + WEIGHT_COPY_PASSES),
                    "bwd": (lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live), BWD_PASSES + WEIGHT_COPY_PASSES)}
            for what, (fn, passes) in runs.items():
                fn()
                torch.cuda.synchronize()
                # both activities, as scannet_profile.  The ModelNet40
                # forward's profile, the last of the run, still read a third
                # of its kernels (a third of the CUDA-event time; chip_ab.py's
                # fresh processes read them whole)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                conv[name][what]["passes_ms"] = {p: ms / 3 for p, ms in
                                                 pass_ms(device_rows(prof), passes).items()}
        fwd, bwd = conv[name]["fwd"], conv[name]["bwd"]
        print(f"{label}_fwd_passes {name} {dtype_name(dtype)}: device ms per call "
              + ", ".join(f"{p} {ms:.4f}" for p, ms in fwd["passes_ms"].items())
              + f" (torch.matmul for the product {fwd['library_ms']:.4f}) [{card}]", flush=True)
        print(f"{label}_bwd_passes {name} {dtype_name(dtype)}: device ms per call "
              + ", ".join(f"{p} {ms:.4f}" for p, ms in bwd["passes_ms"].items())
              + f" (products: {bwd['passes_ms']['d_w product'] + bwd['passes_ms']['dbasis product']:.4f}; "
              f"torch.matmul {bwd['products_library_ms']:.4f}) [{card}]", flush=True)
        _, _, _, _, g, _, q, c, o = shp
        products = {}
        for site, (pass_name, layout, lib_key) in PRODUCT_SITES.items():
            x = fwd if site == "fwd" else bwd
            bound = product_bound(layout, *product_dims(layout, live.numel() * g, c * q, o), dtype)
            products[site] = dict(ms=x["passes_ms"][pass_name], library_ms=x[lib_key], **bound)
        conv[name]["products"] = products
        print(f"{label}_products {name} {dtype_name(dtype)}, {live.numel() * g} rows: "
              + "; ".join(f"{site} {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ({v['bound_by']}, "
                          f"{v['bound_ms'] / max(v['ms'], 1e-9):.0%} of it), torch.matmul {v['library_ms']:.4f}"
                          for site, v in products.items()) + f" [{card}]", flush=True)
        edge = edge_bound(shp, args[3], args[4], dtype)
        yard = edge_matmul_ms(live.numel(), shp[3] * shp[5], c, g * q, 140 + i, dtype)
        edge.update(ms=bwd["passes_ms"]["edge_kernel"], yardstick_ms=yard["ms"], yardstick=yard)
        conv[name]["edge"] = edge
        print(f"{label}_edge_pass {name} {dtype_name(dtype)}: edge_kernel {edge['ms']:.4f} ms, bound "
              f"{edge['bound_ms']:.4f} ({edge['bound_by']}, {edge['gflop']:.2f} GFLOP, {edge['mbytes']:.1f} MB; "
              f"{edge['bound_ms'] / max(edge['ms'], 1e-9):.0%} of it), yardstick two torch.bmm "
              f"{dtype_name(dtype)} over gathered operands {yard['ms']:.4f} (dpne {yard['dpne']:.4f}, "
              f"d_feats {yard['d_feats']:.4f}) [{card}]", flush=True)
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
        print(f"cumsum_kernel_vs_plain {name} {list(shape)} {dtype_name(dtype)}: max_abs_err={err[0]:.3e} "
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


def bf16_convs(model) -> bool:
    """Whether ``model``'s convs compute in bfloat16 (all or none do here)."""
    return any(getattr(mod, "compute_dtype", None) == torch.bfloat16 for mod in model.modules())


@contextlib.contextmanager
def computing_in(model, dtype):
    """``model`` with its convs, and the spec that its neighborhoods' cached
    geometry follows, computing in ``dtype`` for the ``with`` block: the
    same weights and buffers with no bfloat16 rounding for ``float32`` (the
    control of the model-level bfloat16 gates)."""
    from se3conv3d_tpu_torch.nn.conv import PNEConv

    spec, convs = model.spec, [mod for mod in model.modules() if isinstance(mod, PNEConv)]
    kept = [conv.compute_dtype for conv in convs]
    model.spec = dataclasses.replace(spec, conv=dataclasses.replace(spec.conv, compute_dtype=dtype),
                                     conv_blocks=dataclasses.replace(spec.conv_blocks, compute_dtype=dtype))
    for conv in convs:
        conv.compute_dtype = dtype
    try:
        yield model
    finally:
        model.spec = spec
        for conv, cdt in zip(convs, kept):
            conv.compute_dtype = cdt


def reset_launches(kfe, segsum=None) -> None:
    """Every kernel launch count to 0 (all, those with bfloat16 operands,
    and those by out-frame count G, by pne input width D, by activation, by
    kernel-point kind and by (D, Q) where the package counts them)."""
    for fn in (kfe.fused_equiv_fwd, kfe.fused_equiv_bwd):
        fn.launches = fn.bf16_launches = 0
        fn.launches_by_g, fn.launches_by_d = {}, {}
        if hasattr(fn, "launches_by_act"):
            fn.launches_by_act, fn.launches_by_kp = {}, {}
        if hasattr(fn, "launches_by_q"):
            fn.launches_by_q = {}
        if hasattr(fn, "product_launches"):
            fn.product_launches = 0
        if hasattr(fn, "edge_launches"):
            fn.edge_launches = 0
    if segsum is not None:
        segsum.blocked_cumsum.launches = 0


def scannet_invariance(card, dev, model, trainer, scene, rot, name, bf16) -> tuple:
    """Phase 12's rotation check of an equivariant model: the logits on one
    room and on the room rotated by ``rot`` (by default a seeded uniform
    rotation), at the bound of the model's dtype, with the frames left
    unrotated as the control; returns ``(error, control)``."""
    from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.core.rotation import random_rotations

    dname = "bfloat16" if bf16 else "float32"
    h, f0, out_pc, _, _ = trainer.build(scene, torch.Generator(device=dev).manual_seed(71), train=False)
    if rot is None:
        rot = random_rotations(1, generator=torch.Generator().manual_seed(72))[0].to(dev)
    searches = SharedSearches()
    with torch.no_grad(), searches.recording():
        base = model(h, f0, out_pc)
    with torch.no_grad(), searches.watching():
        rotated = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
    with torch.no_grad(), searches.replaying():
        rotated_shared = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
    with torch.no_grad(), searches.replaying():
        # the control: the positions rotated but every frame left as it was,
        # which no equivariant model is blind to
        unframed = model(Hierarchy(tuple(PointCloud(pc.positions @ rot.T, pc.mask, pc.frames)
                                         for pc in h.levels), h.maps, h.levels_radii),
                         f0, PointCloud(out_pc.positions @ rot.T, out_pc.mask, out_pc.frames))
    valid = out_pc.mask
    own = (base - rotated).abs()[valid].amax(-1)
    rot_err = (base - rotated_shared).abs()[valid].max().item()
    unframed_err = (base - unframed).abs()[valid].max().item()
    scale = base[valid].abs().max().item()
    rot_bound = BF16_ROT_RTOL * scale if bf16 else ROT_ATOL
    print(f"{name}_invariance {dname}: max |logits - logits(rotated)| = {rot_err:.3e} (bound "
          f"{rot_bound:.3e}{f' = {BF16_ROT_RTOL} x max|logits|' if bf16 else ''}; max |logits| "
          f"{scale:.3e}) over {int(valid.sum())} valid output points, the rotated forward reusing "
          f"the unrotated forward's neighbor tables (its geometry recomputed); with its own searches "
          f"{own.max().item():.3e}, {int((own > 1e-5).sum())} points above 1e-5, "
          f"{searches.rows_that_differ()} neighbor rows that flipped at the radius or the cap under "
          f"float32 rounding of the rotated positions; control, the positions rotated and the frames "
          f"not: {unframed_err:.3e} [{card}]", flush=True)
    if not (rot_err <= rot_bound < unframed_err):
        raise SystemExit(f"ScanNet logits change under a global rotation ({dname}), or the bound "
                         "does not tell a model that ignores the frames' rotation")
    return rot_err, unframed_err


def scannet_eval(card, dev, model, trainer, scene, kfe, num_classes, rot=None, name="scannet") -> dict:
    """12. calibration and eval steps on one room, invariance under the
    global rotation ``rot`` (by default a seeded uniform one; equivariant
    models only), and card vs CPU logits on a smaller room, in the dtype of
    the model's convs (bfloat16: every forward launch is a bfloat16 one,
    and the logits are held at the bfloat16 bounds); ``name`` heads the
    printed lines.  The result's ``launches_by_d`` are the calibration's
    and eval steps' forward launches by pne input width."""
    bf16 = bf16_convs(model)
    dname = "bfloat16" if bf16 else "float32"
    gen = torch.Generator(device=dev).manual_seed(70)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe)
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
    launches, bf16_launches = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_fwd.bf16_launches
    by_d = dict(kfe.fused_equiv_fwd.launches_by_d)
    check_live_rows(card, f"{dname} calibration and eval, conv forwards", seen,
                    SCANNET_CONVS * (1 + SCANNET_EVAL_STEPS))
    peak = torch.cuda.max_memory_allocated()
    median_s = statistics.median(step_s)
    logits = outs["logits"]
    print(f"{name}_eval {dname}: calibration_step {calib_s:.4f} s, eval_step median {median_s:.4f} s (all "
          f"{[round(s, 4) for s in step_s]}), {SCENE_POINTS / median_s:.1f} input points/s, peak "
          f"memory {peak / 2**30:.3f} GiB, loss {float(outs['loss']):.4f}; fwd kernel launches "
          f"{launches} = {calib_launches} + {launches - calib_launches}, {bf16_launches} of them "
          f"bfloat16 [{card}]", flush=True)
    if calib_launches != SCANNET_CONVS or launches != SCANNET_CONVS * (1 + SCANNET_EVAL_STEPS):
        raise SystemExit(f"expected {SCANNET_CONVS} forward kernel launches per ScanNet forward")
    if bf16_launches != (launches if bf16 else 0):
        raise SystemExit(f"ScanNet eval in {dname}: {bf16_launches} of {launches} forward launches bfloat16")
    if tuple(logits.shape) != (1, trainer.eval_hcfg.out_capacity, num_classes) \
            or not torch.isfinite(logits).all():
        raise SystemExit(f"bad ScanNet logits: shape {tuple(logits.shape)}")

    rot_err = unframed_err = None  # a standard model is not rotation invariant
    if model.spec.equivariant:
        rot_err, unframed_err = scannet_invariance(card, dev, model, trainer, scene, rot, name, bf16)
    else:
        print(f"{name}_invariance {dname}: not checked, the model is not equivariant [{card}]", flush=True)

    small_cfg = dataclasses.replace(trainer.eval_hcfg, capacities=tuple(SMALL_CAPS),
                                    out_capacity=SMALL_CAPS[0])
    room = to_device({k: v[None] for k, v in room_scene(SMALL_ROOM_POINTS, 73, (4.0, 4.0, 2.5)).items()}, dev)
    h, f0, out_pc, _, _ = type(trainer)(model, small_cfg).build(
        room, torch.Generator(device=dev).manual_seed(74), train=False)
    print(f"{name}_card_vs_cpu room: {occupancy_line(h, out_pc)}")
    valid = out_pc.mask.cpu()
    cpu_model, cpu_h, cpu_f0, cpu_out = copy.deepcopy(model).cpu(), h.to("cpu"), f0.cpu(), out_pc.to("cpu")
    with torch.no_grad():
        card_logits = model(h, f0, out_pc).cpu()
        t0 = time.perf_counter()
        cpu_logits = cpu_model(cpu_h, cpu_f0, cpu_out)
        cpu_s = time.perf_counter() - t0
        control = None
        if bf16:  # the same weights on the CPU with no bfloat16 rounding
            with computing_in(cpu_model, torch.float32):
                control = (card_logits - cpu_model(cpu_h, cpu_f0, cpu_out)).abs()[valid].max().item()
    diff = (card_logits - cpu_logits).abs()[valid]
    cpu_err, scale = diff.max().item(), cpu_logits[valid].abs().max().item()
    cpu_bound = BF16_CPU_RTOL * scale if bf16 else CPU_ATOL
    print(f"{name}_card_vs_cpu {dname}: max |logits(card) - logits(cpu)| = {cpu_err:.3e} (bound "
          f"{cpu_bound:.3e}{f' = {BF16_CPU_RTOL} x max|logits|' if bf16 else ''}"
          + (f"; {control_text(cpu_err, control)}" if bf16 else "")
          + f"), mean {diff.mean().item():.3e}, max |logits| {scale:.3e}; CPU forward {cpu_s:.1f} s "
          f"[{card}]", flush=True)
    if not (cpu_err <= cpu_bound and (not bf16 or tells_apart(cpu_err, control))):
        raise SystemExit(f"ScanNet card and CPU logits disagree ({dname})")
    gate = {}
    if not bf16:  # float32: the control is the first conv's kernel planted wrong
        gate = card_vs_cpu_with_control(card, f"{name}_{dname}", model, (h, f0, out_pc), out_pc.mask, cpu_logits)
        control = gate["card_vs_cpu_control"]
    return dict(launches=launches, bf16_launches=bf16_launches, launches_by_d=by_d, eval_s=median_s,
                peak_gib=peak / 2**30, card_vs_cpu_max_abs_err=cpu_err, card_vs_cpu_control=control, rotation_max_abs_err=rot_err,
                rotation_control=unframed_err, card_vs_cpu_gate=gate)


def scannet_train(card, dev, trainer, batch, kfe, segsum, ops, order=SCANNET_MODE_ORDER,
                  name="scannet_train") -> dict:
    """13. scan_scenes train steps, the backward modes in turns (``order``),
    in the dtype of the model's convs: with bfloat16 convs every conv launch
    is a bfloat16 one and every prefix sum reads bfloat16 rows; ``name``
    heads the printed lines."""
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm

    model = trainer.model
    bf16 = bf16_convs(model)
    dname = "bfloat16" if bf16 else "float32"
    gen = torch.Generator(device=dev).manual_seed(80)
    bns = {n: mod for n, mod in model.named_modules() if isinstance(mod, MaskedBatchNorm)}
    bn_before = {n: mod.mean.clone() for n, mod in bns.items()}
    counts = {mode: [0, 0, 0] for mode in ("scatter", "sorted")}
    prod_counts = {mode: [0, 0] for mode in counts}
    edge_counts = {mode: 0 for mode in counts}
    times = {mode: [] for mode in counts}
    peaks = {mode: 0 for mode in counts}
    want_fwd = SCANNET_CONVS * SCENES
    for step, mode in enumerate(order):
        ops.BWD_SCATTER_MODE = mode
        lr = trainer.optimizer.lr
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kfe, segsum)
        with watching_payloads(kfe) as payloads:
            t0 = time.perf_counter()
            out = trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        n = (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches, segsum.blocked_cumsum.launches)
        n_bf16 = (getattr(kfe.fused_equiv_fwd, "bf16_launches", 0), getattr(kfe.fused_equiv_bwd, "bf16_launches", 0))
        # the shared product's launches inside the convs (a package without the count: None)
        n_prod = tuple(getattr(fn, "product_launches", None) for fn in (kfe.fused_equiv_fwd, kfe.fused_equiv_bwd))
        # the per-edge pass's launches inside the backwards (None: a package without the count)
        n_edge = getattr(kfe.fused_equiv_bwd, "edge_launches", None)
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        peak = torch.cuda.max_memory_allocated()
        print(f"{name} {dname}: step {step} mode {mode} lr {lr:.6e} loss {loss:.6f} grad_norm "
              f"{gnorm:.6f} launches fwd {n[0]} bwd {n[1]} cumsum {n[2]} (bfloat16: fwd {n_bf16[0]} bwd "
              f"{n_bf16[1]}; prefix-sum payloads {sorted(set(payloads))}; the product inside them: fwd "
              f"{n_prod[0]} bwd {n_prod[1]}; edge_kernel {n_edge}) time {dt:.4f} s peak "
              f"{peak / 2**30:.3f} GiB [{card}]", flush=True)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise SystemExit("non-finite loss or gradients in a ScanNet train step")
        want = (want_fwd, want_fwd, want_fwd if mode == "sorted" else 0)
        if n != want:
            raise SystemExit(f"ScanNet train step in mode {mode}: launches {n}, expected {want}")
        if n_bf16 != ((n[0], n[1]) if bf16 else (0, 0)) or set(payloads) - {dname}:
            raise SystemExit(f"ScanNet {dname} train step in mode {mode}: bfloat16 launches {n_bf16} "
                             f"of {n[:2]}, prefix-sum payloads {sorted(set(payloads))}")
        if n_prod[0] is not None and (n_prod[0] < n[0] or n_prod[1] != 2 * n[1]):
            raise SystemExit(f"ScanNet train step in mode {mode}: the product launched {n_prod} times in "
                             f"{n[:2]} conv launches (at least one a forward, two a backward)")
        if n_edge is not None and n_edge != n[1]:
            raise SystemExit(f"ScanNet train step in mode {mode}: edge_kernel launched {n_edge} times in "
                             f"{n[1]} backward launches (one a backward)")
        prod_counts[mode] = [a + (b or 0) for a, b in zip(prod_counts[mode], n_prod)]
        edge_counts[mode] += n_edge or 0
        times[mode].append(dt)
        peaks[mode] = max(peaks[mode], peak)
        for j in range(3):
            counts[mode][j] += n[j]
    ops.BWD_SCATTER_MODE = "scatter"
    result = {}
    for mode in counts:
        if not times[mode]:
            continue
        med = statistics.median(times[mode])
        print(f"{name} {dname}: mode {mode}: step median {med:.4f} s (all "
              f"{[round(x, 4) for x in times[mode]]}), {SCENES * SCENE_POINTS / med:.1f} input points/s, "
              f"peak memory {peaks[mode] / 2**30:.3f} GiB [{card}]", flush=True)
        result[mode] = dict(step_s=med, all_s=times[mode], peak_gib=peaks[mode] / 2**30,
                            launches=counts[mode], product_launches=prod_counts[mode],
                            edge_launches=edge_counts[mode])
    still = [n for n, mod in bns.items() if torch.equal(mod.mean, bn_before[n])]
    print(f"{name} {dname}: {len(bns) - len(still)} of {len(bns)} BN running means moved")
    if still:
        raise SystemExit(f"BN running mean did not move: {still[:5]}")
    return result


@contextlib.contextmanager
def watching_payloads(kfe):
    """Within: the dtype name of every sorted buffer the conv backward hands
    the prefix sum (``kfe.sorted_segment_sum``), in call order."""
    real, seen = kfe.sorted_segment_sum, []

    def watched(data, *args):
        seen.append(dtype_name(data.dtype))
        return real(data, *args)

    kfe.sorted_segment_sum = watched
    try:
        yield seen
    finally:
        kfe.sorted_segment_sum = real


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
    # here that is `watched`, which carries the counts and hands them back
    counts = [a for a in vars(real) if a.endswith("launches") or a.startswith("launches_by_")]
    for attr in counts:
        setattr(watched, attr, getattr(real, attr))
    setattr(kfe, name, watched)
    try:
        yield seen
    finally:
        setattr(kfe, name, real)
        for attr in counts:
            setattr(real, attr, getattr(watched, attr))


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
    dname = "bfloat16" if bf16_convs(model) else "float32"
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
        print(f"scannet_split {dname}: mode {mode}, ms per step of {batch['mask'].shape[0]} rooms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in out[mode].items()) + f" [{card}]", flush=True)
        check_live_rows(card, f"{dname} train mode {mode}, conv forwards", fwd_seen, SCANNET_CONVS * SCENES)
        live, cap = check_live_rows(card, f"{dname} train mode {mode}, conv backwards", seen,
                                    SCANNET_CONVS * SCENES)
        out[mode]["live_rows"], out[mode]["capacity_rows"] = live, cap
    ops.BWD_SCATTER_MODE = "scatter"
    return out


def scannet_profile(card, trainer, batch, ops, modes=("scatter", "sorted"), name="scannet_profile") -> dict:
    """Device time by kernel over one scan_scenes train step per backward
    mode of ``modes`` (``torch.profiler``): the busy total, the idle share
    of the step's wall time, the kernels that take the most, and the conv
    forward's and backward's passes; ``name`` heads the printed lines."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=batch["mask"].device).manual_seed(87)
    dname = "bfloat16" if bf16_convs(trainer.model) else "float32"
    out = {}
    for mode in modes:
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
        print(f"{name} {dname}: mode {mode}: step {wall_ms:.1f} ms under the profiler, device busy "
              f"{busy:.1f} ms ({100 * (1 - busy / wall_ms):.1f}% idle), {sum(r[1] for r in rows)} kernel "
              f"launches [{card}]", flush=True)
        for ms, n, key in rows[:14]:
            print(f"{name}:   {ms:9.2f} ms {n:6d}x {key[:110]}")
        cumsum = pass_ms(rows, CUMSUM_PASSES)
        copies = pass_ms(rows, WEIGHT_COPY_PASSES)
        reductions = pass_ms(rows, REDUCTION_PASSES)
        for what, ps in (("forward", fwd_passes), ("backward", passes), ("prefix sum", cumsum),
                         ("weights' images", copies), ("PyTorch reductions", reductions)):
            print(f"{name} {dname}: mode {mode}: conv {what} {sum(ps.values()):.2f} ms: "
                  + ", ".join(f"{p} {ms:.2f}" for p, ms in ps.items()) + f" [{card}]", flush=True)
        out[mode] = dict(wall_ms=wall_ms, busy_ms=busy, fwd_passes_ms=fwd_passes, bwd_passes_ms=passes,
                         cumsum_ms=cumsum, weight_copy_ms=copies, reductions_ms=reductions,
                         top=[(k[:110], ms, n) for ms, n, k in rows[:14]])
    ops.BWD_SCATTER_MODE = "scatter"
    return out


def grads_ratio(grads: dict, ref: dict, norm: float) -> tuple:
    """The worst leaf of ``max |grad - ref| / max(max |ref leaf|, GRAD_FLOOR
    * norm)`` over the parameter gradients ``grads`` and ``ref``: ``(ratio,
    leaf name)``."""
    worst, worst_name = 0.0, None
    for n, g in grads.items():
        ratio = (g - ref[n]).abs().max().item() / max(ref[n].abs().max().item(), GRAD_FLOOR * norm)
        if ratio > worst:
            worst, worst_name = ratio, n
    return worst, worst_name


def grads_norm_ratio(grads: dict, ref: dict) -> float:
    """``|grads - ref| / |ref|`` over every leaf at once (global norms)."""
    diff = sum(float((g - ref[n]).double().square().sum()) for n, g in grads.items())
    return (diff / sum(float(r.double().square().sum()) for r in ref.values())) ** 0.5


def scannet_mode_grads(card, dev, trainer, scene, ops, recorded_draws, drop_path_draws) -> float:
    """14. one room's parameter gradients, sorted vs scatter mode, with the
    same hierarchy and DropPath keep masks (bound ``GRAD_RTOL``, or
    ``BF16_GRAD_RTOL`` with bfloat16 convs, which must also tell the
    gradients of the same weights with no bfloat16 rounding apart:
    :func:`tells_apart`)."""
    from se3conv3d_tpu_torch.train import schedule

    model = trainer.model
    bf16 = bf16_convs(model)
    rtol = BF16_GRAD_RTOL if bf16 else GRAD_RTOL
    h, f0, out_pc, out_labels, _ = trainer.build(scene, torch.Generator(device=dev).manual_seed(90))
    draws = recorded_draws(torch.Generator(device=dev).manual_seed(91))

    def grads(mode, keep_masks=None):
        ops.BWD_SCATTER_MODE = mode
        try:
            loss = float(trainer.backward(h, f0, out_pc, out_labels,
                                          draws if keep_masks is None else drop_path_draws(keep_masks=keep_masks)))
        finally:
            ops.BWD_SCATTER_MODE = "scatter"
        got = {n: p.grad.clone() if p.grad is not None else None for n, p in model.named_parameters()}
        bad = [n for n, g in got.items() if g is None or not torch.isfinite(g).all()]
        if bad:
            raise SystemExit(f"missing or non-finite {mode}-mode gradient for {bad[:5]}")
        return loss, got

    scatter_loss, scatter = grads("scatter")
    sorted_loss, sorted_ = grads("sorted", draws.masks)
    norm = float(schedule.global_norm(list(scatter.values())))
    worst, worst_name = grads_ratio(sorted_, scatter, norm)
    whole = grads_norm_ratio(sorted_, scatter)
    control = whole_control = None
    if bf16:  # scatter mode with the same weights and no bfloat16 rounding
        with computing_in(model, torch.float32):
            _, wide = grads("scatter", draws.masks)
        control = grads_ratio(scatter, wide, float(schedule.global_norm(list(wide.values()))))[0]
        whole_control = grads_norm_ratio(scatter, wide)
    print(f"scannet_grads_sorted_vs_scatter {'bfloat16' if bf16 else 'float32'}: loss {sorted_loss:.6f} "
          f"vs {scatter_loss:.6f}; {len(scatter)} leaves, global norm {norm:.6f}, {len(draws.masks)} "
          f"DropPath masks; worst max|sorted - scatter| / max(max|leaf|, {GRAD_FLOOR} * norm) = "
          f"{worst:.3e} at {worst_name} (bound {rtol}"
          + (f"; scatter {control_text(worst, control)}" if bf16 else "")
          + f"); |sorted - scatter| / |scatter| over every leaf {whole:.3e}"
          + (f" ({control_text(whole, whole_control)})" if bf16 else "") + f" [{card}]", flush=True)
    if not (worst <= rtol and abs(sorted_loss - scatter_loss) <= rtol * abs(scatter_loss)
            and (not bf16 or tells_apart(whole, whole_control))):
        raise SystemExit("sorted and scatter gradients disagree")
    return worst


def run_scannet(card, dev, recorded_draws, drop_path_draws) -> dict:
    """Phases 9-14 (the ScanNet slice), in bfloat16 (the recipe as written)
    and in float32; returns their measurements by dtype."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.ops import pne_conv as ops
    from se3conv3d_tpu_torch.train.trainer import Trainer

    # 9.-10. the per-edge pass's SASS and plans, the ScanNet conv shapes, the
    # prefix sum and the segment sums
    edge = edge_checks(card)
    scan_conv = {dt: scannet_conv_kernels(card, dev, getattr(torch, dt)) for dt in SCANNET_DTYPES}
    scan_cumsum = scannet_cumsum(card, dev)
    torch.cuda.empty_cache()

    # 11.-12. the ScanNet model on synthetic rooms: grid searches, eval path
    recipes = scannet_recipes()
    s_training = presets.SCANNET20_ROT_PCA_I_TRAINING
    s_hcfg = presets.hierarchy_config_from_model_dict(recipes["bfloat16"], SCENE_POINTS, train=True)
    s_eval_hcfg = presets.hierarchy_config_from_model_dict(recipes["bfloat16"], SCENE_POINTS, train=False)
    feats, classes = presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES
    rooms = scannet_rooms(dev)
    room0 = {k: v[:1] for k, v in rooms.items()}
    scan_eval, grid = {}, None
    for dt in SCANNET_DTYPES:
        model = seeded_model(recipes[dt], dev, feats, classes)
        if bf16_convs(model) != (dt == "bfloat16"):
            raise SystemExit(f"build_model_from_config did not build {dt} convs from the {dt} recipe")
        trainer = Trainer(model, s_hcfg, s_eval_hcfg, label_smoothing=s_training["label_smoothing"],
                          ignore_label=presets.SCANNET20_IGNORE_LABEL)
        if grid is None:
            for i in range(SCENES):
                h, _, out_pc, _, _ = trainer.build({k: v[i : i + 1] for k, v in rooms.items()},
                                                   torch.Generator(device=dev).manual_seed(110 + i),
                                                   train=False)
                print(f"scannet room {i}: {occupancy_line(h, out_pc)}", flush=True)
            h, _, out_pc, _, _ = trainer.build(room0, torch.Generator(device=dev).manual_seed(110),
                                               train=False)
            grid = scannet_grid_vs_brute(card, h, out_pc, s_hcfg.init_cell_size)
            del h, out_pc
        scan_eval[dt] = scannet_eval(card, dev, model, trainer, room0, kfe, classes)
        del model, trainer
        torch.cuda.empty_cache()

    # 13.-14. scan_scenes training, the two backward modes in turns
    scan_train = {}
    for dt in SCANNET_DTYPES:
        order = SCANNET_MODE_ORDER if dt == "bfloat16" else SCANNET_F32_MODE_ORDER
        trainer = scannet_trainer(dev, room0, recipes[dt], len(order))
        train = scannet_train(card, dev, trainer, rooms, kfe, segsum, ops, order)
        train["split_ms"] = scannet_split(card, dev, trainer, rooms, ops, drop_path_draws, kfe)
        train["profile"] = scannet_profile(card, trainer, rooms, ops)
        train["grads_sorted_vs_scatter"] = scannet_mode_grads(card, dev, trainer, room0, ops,
                                                              recorded_draws, drop_path_draws)
        scan_train[dt] = train
        del trainer
        torch.cuda.empty_cache()
    del rooms
    for dt in SCANNET_DTYPES:
        scannet_conv_passes(card, dev, scan_conv[dt], getattr(torch, dt))
    cumsum_device_ms(card, dev, scan_cumsum)

    return dict(conv=scan_conv, cumsum=scan_cumsum, grid=grid, eval=scan_eval, train=scan_train, edge=edge)


def mixf_fill(dev, batch, model_dict=None) -> list:
    """Max valid points per hierarchy level of ``batch`` under the DFaust
    recipe ``model_dict`` (by default the mixF one; the positions do not
    depend on the frames): the live rows per example of phase 15's and
    phase 18's DFaust convs."""
    from se3conv3d_tpu_torch.core.hierarchy import build_hierarchy
    from se3conv3d_tpu_torch.models import presets

    model_dict = model_dict or presets.DFAUST_I_ROT_MC_MIXF_MODEL
    hcfg = presets.hierarchy_config_from_model_dict(model_dict, POINTS)
    h = build_hierarchy(batch["positions"], batch["mask"], batch["features"], hcfg,
                        generator=torch.Generator(device=dev).manual_seed(13))[0]
    return [int(pc.mask.sum(1).max()) for pc in h.levels]


def g4_conv_kernels(card, dev, fill) -> dict:
    """15. both conv kernels at G = F = 4 (their 128-column instantiations)
    vs their plain versions at the mixF recipe's level-0 and level-4 block
    convs, ``fill[level]`` live rows per example (the synthetic bodies'
    fill; the rows past it are padding), in float32 and in bfloat16 (with
    the control of phase 2): the forward bitwise equal over two calls, the
    backward in both output modes with its parameter gradients bitwise
    equal across modes and calls, each timed beside its bound, its plain
    version and ``torch.matmul`` in the same dtype for its products
    (:func:`forward_vs_plain`, :func:`backward_vs_plain`)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    out = {dtype_name(dt): {} for dt in KERNEL_DTYPES}
    for dt in KERNEL_DTYPES:
        for i, (name, (shp, level)) in enumerate(G4_SHAPES.items()):
            args, gout = padded_conv_args(10 + i, shp, fill[level], dev, dt)
            live = kfe.live_row_table(args[4])
            bounds = conv_bounds(shp, args[3], args[4], dt)
            out[dtype_name(dt)][name] = dict(
                fwd=forward_vs_plain(card, f"g4_fwd_kernel_vs_plain {name}", shp, args, live,
                                     bounds["fwd"], 66 + i),
                bwd=backward_vs_plain(card, f"g4_bwd_kernel_vs_plain {name}", shp, args, gout, live,
                                      bounds["bwd"], 68 + i),
            )
            del args, gout, live
            torch.cuda.empty_cache()
    return out


def dfaust_mixf(card, dev, batch, small, recorded_draws) -> dict:
    """16. ``configs/dfaust/dfaust_I_rot_MC_mixF.yaml`` as written: the model
    from ``build_model_from_config`` (on the card by default) with random
    SO(3) frames, one calibration step at ``train_n_frames`` and eval steps
    at ``test_n_frames``, then the recipe's ``Training`` section (B = 16,
    ``accum_grads: 2``) over the micro-batches of ``MIXF_FRAMES``, each at
    its frame count: per micro-batch 21 forward and 21 backward launches,
    all at G = F; after each first micro-batch of a step the parameters are
    bitwise unchanged and the schedule stays, after each second they have
    all moved and the schedule advanced once; every BN running mean moves.
    Then at F = 4 on the two clouds of ``small``: rotation invariance of the
    logits (with the frames left unrotated as the control), card vs CPU
    logits and card vs CPU parameter gradients, at the bounds of phases 4,
    5 and 8."""
    from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.core.rotation import random_rotations
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer, draw_n_frames

    model_dict, training = presets.DFAUST_I_ROT_MC_MIXF_MODEL, presets.DFAUST_I_ROT_MC_MIXF_TRAINING
    mix, accum = presets.mix_n_frames(model_dict), int(training["accum_grads"])
    rf = model_dict["RefFrames"]
    if (set(MIXF_FRAMES) != set(mix) or len(MIXF_FRAMES) % accum or rf["pca"]
            or batch["mask"].shape[0] != training["batch_size"]):
        raise SystemExit("phase 16 does not drive the mixF recipe as written")
    rng = np.random.default_rng(0)
    drawn = [draw_n_frames(mix, rng) for _ in range(24)]
    print(f"mixf: {model_dict['model']}, RefFrames {rf}; batch_size {training['batch_size']}, "
          f"accum_grads {accum}; draw_n_frames from numpy seed 0: {drawn}; the run forces "
          f"{list(MIXF_FRAMES)} [{card}]", flush=True)
    model = seeded_model(model_dict, dev)
    opt = schedule.optimizer_from_training(model.parameters(), training, len(MIXF_FRAMES))
    hcfg = presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True)
    trainer = Trainer(model, hcfg, presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=False),
                      label_smoothing=training["label_smoothing"], optimizer=opt)
    gen = torch.Generator(device=dev).manual_seed(14)

    # calibration at train_n_frames, eval at test_n_frames
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe)
    trainer.calibration_step(batch, gen)
    calib_by_g = dict(kfe.fused_equiv_fwd.launches_by_g)
    eval_s, outs = [], None
    for _ in range(MIXF_EVAL_STEPS):
        t0 = time.perf_counter()
        outs = trainer.eval_step(batch, gen)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    eval_by_g = {g: n - calib_by_g.get(g, 0) for g, n in kfe.fused_equiv_fwd.launches_by_g.items()}
    eval_peak = torch.cuda.max_memory_allocated()
    logits = outs["logits"]
    print(f"mixf: calibration launches by G {calib_by_g}, {MIXF_EVAL_STEPS} eval steps' launches by G "
          f"{eval_by_g}; eval_step {[round(x, 4) for x in eval_s]} s, peak {eval_peak / 2**30:.3f} GiB, "
          f"loss {float(outs['loss']):.4f} [{card}]", flush=True)
    if calib_by_g != {rf["train_n_frames"]: CONVS_PER_FORWARD} or eval_by_g != {
            rf["test_n_frames"]: CONVS_PER_FORWARD * MIXF_EVAL_STEPS}:
        raise SystemExit("mixF calibration or eval did not run its convs at train_n_frames / test_n_frames")
    if tuple(logits.shape) != (training["batch_size"], POINTS, CLASSES) or not torch.isfinite(logits).all():
        raise SystemExit(f"bad mixF logits: shape {tuple(logits.shape)}")
    if not all(bool(m.initialized) for m in model.modules() if hasattr(m, "initialized")):
        raise SystemExit("a mixF conv was not calibrated")

    # training: one micro-batch per frame count of MIXF_FRAMES
    params = [p for p in model.parameters() if p.requires_grad]
    bns = {n: mod for n, mod in model.named_modules() if isinstance(mod, MaskedBatchNorm)}
    bn_before = {n: mod.mean.clone() for n, mod in bns.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, by_g = {f: [] for f in sorted(set(MIXF_FRAMES))}, ({}, {})
    for i, f in enumerate(MIXF_FRAMES):
        before = [p.detach().clone() for p in params]
        updates, lr = opt.scheduler.last_epoch, opt.lr
        reset_launches(kfe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch, gen, n_frames=f)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fwd, bwd = dict(kfe.fused_equiv_fwd.launches_by_g), dict(kfe.fused_equiv_bwd.launches_by_g)
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        moved = sum(not torch.equal(p, q) for p, q in zip(params, before))
        advanced = opt.scheduler.last_epoch - updates
        update = (i + 1) % accum == 0
        print(f"mixf_train: micro-batch {i} F={f} lr {lr:.6e} loss {loss:.6f} grad_norm {gnorm:.6f} "
              f"launches by G fwd {fwd} bwd {bwd}; {'update' if update else 'accumulate'}: {moved} of "
              f"{len(params)} parameter leaves moved, schedule advanced {advanced} time {dt:.4f} s "
              f"[{card}]", flush=True)
        if fwd != {f: CONVS_PER_FORWARD} or bwd != {f: CONVS_PER_FORWARD}:
            raise SystemExit(f"mixF micro-batch {i}: launches by G fwd {fwd} bwd {bwd}, expected "
                             f"{CONVS_PER_FORWARD} each at G={f}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise SystemExit("non-finite loss or gradients in a mixF micro-batch")
        if (moved, advanced) != ((len(params), 1) if update else (0, 0)):
            raise SystemExit(f"mixF micro-batch {i}: {moved} leaves moved, schedule advanced {advanced}; "
                             f"expected {'every leaf and once' if update else 'none and not'}")
        times[f].append(dt)
        for total, step in zip(by_g, (fwd, bwd)):
            for g, n in step.items():
                total[g] = total.get(g, 0) + n
    peak = torch.cuda.max_memory_allocated()
    still = [n for n, mod in bns.items() if torch.equal(mod.mean, bn_before[n])]
    steady = {f: statistics.median(ts[1:]) for f, ts in times.items()}
    print(f"mixf_train: micro-batch time by F after the first of each F "
          + ", ".join(f"F={f} {steady[f]:.4f} s (all {[round(x, 4) for x in ts]})" for f, ts in times.items())
          + f"; {training['batch_size'] * POINTS / steady[4]:.1f} input points/s at F=4; peak memory "
          f"{peak / 2**30:.3f} GiB; {len(bns) - len(still)} of {len(bns)} BN running means moved "
          f"[{card}]", flush=True)
    if still:
        raise SystemExit(f"mixF: BN running mean did not move: {still[:5]}")

    # F = 4 on two clouds: invariance, card vs CPU logits and gradients
    h, f0, out_pc, _, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(15), train=False,
                                        n_frames=4)
    if h.levels[0].frames.shape[2] != 4:
        raise SystemExit("the F = 4 checks did not build 4 frames")
    model.eval()
    with torch.no_grad():
        base = model(h, f0, out_pc)
        rot = random_rotations(1, generator=torch.Generator().manual_seed(16))[0].to(dev)
        rotated = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
        unframed = model(Hierarchy(tuple(PointCloud(pc.positions @ rot.T, pc.mask, pc.frames)
                                         for pc in h.levels), h.maps, h.levels_radii),
                         f0, PointCloud(out_pc.positions @ rot.T, out_pc.mask, out_pc.frames))
        valid = out_pc.mask
        rot_err = (base - rotated).abs()[valid].max().item()
        unframed_err = (base - unframed).abs()[valid].max().item()
        cpu_model = copy.deepcopy(model).cpu()
        cpu_logits = cpu_model(h.to("cpu"), f0.cpu(), out_pc.to("cpu"))
    print(f"mixf_invariance F=4: max |logits - logits(rotated)| = {rot_err:.3e} (bound {ROT_ATOL}); "
          f"control, the positions rotated and the frames not: {unframed_err:.3e} [{card}]", flush=True)
    if not rot_err <= ROT_ATOL < unframed_err:
        raise SystemExit("mixF logits change under a global rotation at F = 4, or the bound does not "
                         "tell a model that ignores the frames' rotation")
    cpu_gate = card_vs_cpu_with_control(card, "mixf F=4", model, (h, f0, out_pc), valid, cpu_logits)
    del base, rotated, unframed, cpu_logits, h, f0, out_pc

    h, f0, out_pc, out_labels, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(17),
                                                 n_frames=4)
    draws = recorded_draws(torch.Generator(device=dev).manual_seed(18))
    card_loss = float(trainer.backward(h, f0, out_pc, out_labels, draws))
    cpu_trainer = Trainer(cpu_model, hcfg, label_smoothing=training["label_smoothing"])
    cpu_loss = float(cpu_trainer.backward(h.to("cpu"), f0.cpu(), out_pc.to("cpu"), out_labels.cpu(),
                                          DropPathDraws(keep_masks=draws.masks)))
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
    if set(grads) != set(cpu_grads) or not all(torch.isfinite(g).all() for g in grads.values()):
        raise SystemExit("missing or non-finite mixF gradients at F = 4")
    norm = float(schedule.global_norm(list(cpu_grads.values())))
    worst, worst_name = grads_ratio(grads, cpu_grads, norm)
    print(f"mixf_grads_card_vs_cpu F=4: loss card {card_loss:.6f} cpu {cpu_loss:.6f}; {len(cpu_grads)} "
          f"leaves, global norm {norm:.6f}, {len(draws.masks)} DropPath masks; worst max|card - cpu| / "
          f"max(max|cpu leaf|, {GRAD_FLOOR} * norm) = {worst:.3e} at {worst_name} (bound {GRAD_RTOL}) "
          f"[{card}]", flush=True)
    if not (worst <= GRAD_RTOL and abs(card_loss - cpu_loss) <= GRAD_RTOL * abs(cpu_loss)):
        raise SystemExit("mixF card and CPU gradients disagree at F = 4")
    return dict(eval_s=eval_s, eval_peak_gib=eval_peak / 2**30, step_s_by_f=steady, all_s_by_f=times,
                peak_gib=peak / 2**30, eval_launches=sum(calib_by_g.values()) + sum(eval_by_g.values()),
                train_launches=tuple(sum(x.values()) for x in by_g), train_launches_by_g=by_g,
                rotation_max_abs_err=rot_err, rotation_control=unframed_err, card_vs_cpu=cpu_gate,
                card_vs_cpu_max_abs_err=cpu_gate["card_vs_cpu_max_abs_err"], grads_card_vs_cpu=worst)


def scannet_rot_i(card, dev) -> dict:
    """17. ``configs/scannet/scannet20_rot_I.yaml`` as written (bfloat16
    convs, one random planar frame about z per point): calibration and eval
    on one room, invariance under a rotation about z (with the frames left
    unrotated as the control) and card vs CPU logits on the small room of
    phase 12 (:func:`scannet_eval`), then one ``scan_scenes`` train step on
    the 6 rooms in scatter mode, 192 bfloat16 forward and backward launches
    (:func:`scannet_train`)."""
    from se3conv3d_tpu_torch.core.rotation import planar_rotations
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.ops import pne_conv as ops
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model_dict, training = presets.SCANNET20_ROT_I_MODEL, presets.SCANNET20_ROT_I_TRAINING
    frames = presets.frame_config_from_dict(model_dict["RefFrames"])
    if frames.pca or frames.fixed_axis != 2 or frames.n_frames != 1 or model_dict["compute_dtype"] != "bfloat16":
        raise SystemExit("the pinned scannet20_rot_I recipe is not bfloat16 with one random frame about z")
    rooms = scannet_rooms(dev)
    room0 = {k: v[:1] for k, v in rooms.items()}
    feats, classes = presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES
    model = seeded_model(model_dict, dev, feats, classes)
    if not bf16_convs(model):
        raise SystemExit("build_model_from_config did not build the bfloat16 scannet20_rot_I model on the card")
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, SCENE_POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, SCENE_POINTS, train=False),
                      label_smoothing=training["label_smoothing"], ignore_label=presets.SCANNET20_IGNORE_LABEL)
    h = trainer.build(room0, torch.Generator(device=dev).manual_seed(76), train=False)[0]
    up = h.levels[0].frames[..., :, 2]
    if not (up == torch.tensor([0.0, 0.0, 1.0], device=dev)).all():
        raise SystemExit("a scannet20_rot_I frame does not keep the z axis")
    del h, up
    rot = planar_rotations(1, 2, generator=torch.Generator().manual_seed(75))[0].to(dev)
    ev = scannet_eval(card, dev, model, trainer, room0, kfe, classes, rot=rot, name="scannet20_rot_I")
    del model, trainer
    torch.cuda.empty_cache()
    trainer = scannet_trainer(dev, room0, model_dict, 1, training)
    train = scannet_train(card, dev, trainer, rooms, kfe, segsum, ops, ("scatter",), "scannet20_rot_I_train")
    del trainer, rooms
    torch.cuda.empty_cache()
    return dict(eval=ev, train=train)


# phase 18's convs at the standard geometry (kD = 3: G = F = 1, the raw
# offsets, no rot6), name: ((B, M, N, K, G, F, Q, C, O), live rows per
# example): the DFaust standard recipe's level-1 and level-4 block convs at
# the synthetic bodies' fill (("fill", hierarchy level)), and the ScanNet
# standard recipe's level-0 block conv padded (the fullest synthetic room)
# and fully live, and its level-4 block conv
STD_SHAPES = {
    "dfaust_std_level1_block_conv": ((BATCH, 2048, 2048, 32, 1, 1, 32, 32, 32), ("fill", 1)),
    "dfaust_std_level4_block_conv": ((BATCH, 128, 128, 32, 1, 1, 32, 256, 256), ("fill", 4)),
    "scannet_std_level0_padded_block_conv": (SCANNET_SHAPES["scannet_level0_block_conv"], 22_563),
    "scannet_std_level0_block_conv": (SCANNET_SHAPES["scannet_level0_block_conv"], None),
    "scannet_std_level4_block_conv": (SCANNET_SHAPES["scannet_level4_block_conv"], None),
}


def std_conv_args(i, shp, n_live, dev, dtype) -> tuple:
    """Phase 18's seeded operands of the ``i``-th standard conv (rel and
    feats in ``dtype``, ``rot6`` None, ``proj_axes [3, Q]``) and ``gout``;
    rows past ``n_live`` of each example are padding."""
    args, gout = padded_conv_args(20 + i, shp, n_live, dev, dtype)
    args[1], args[5] = None, args[5][:3].contiguous()
    return args, gout


def std_conv_kernels(card, dev, fill) -> dict:
    """18. both conv kernels' standard-geometry (kD = 3) instantiations vs
    their plain versions at ``STD_SHAPES`` (the DFaust ones at
    ``fill[level]`` live rows per example), in float32 and in bfloat16
    (with the control of phase 2): the forward bitwise equal over two
    calls, the backward in both output modes with its parameter gradients
    bitwise equal across modes and calls, each timed beside its bound, its
    plain version and ``torch.matmul`` in the same dtype for its products
    (:func:`forward_vs_plain`, :func:`backward_vs_plain`)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    out = {dtype_name(dt): {} for dt in KERNEL_DTYPES}
    for dt in KERNEL_DTYPES:
        for i, (name, (shp, live_rows)) in enumerate(STD_SHAPES.items()):
            n_live = fill[live_rows[1]] if isinstance(live_rows, tuple) else live_rows
            args, gout = std_conv_args(i, shp, n_live, dev, dt)
            live = kfe.live_row_table(args[4])
            bounds = conv_bounds(shp, args[3], args[4], dt, d=3)
            before = dict(kfe.fused_equiv_fwd.launches_by_d), dict(kfe.fused_equiv_bwd.launches_by_d)
            out[dtype_name(dt)][name] = dict(
                fwd=forward_vs_plain(card, f"std_fwd_kernel_vs_plain {name}", shp, args, live,
                                     bounds["fwd"], 90 + i),
                bwd=backward_vs_plain(card, f"std_bwd_kernel_vs_plain {name}", shp, args, gout, live,
                                      bounds["bwd"], 95 + i),
            )
            grew = [{d: n - b.get(d, 0) for d, n in fn.launches_by_d.items() if n != b.get(d, 0)}
                    for fn, b in zip((kfe.fused_equiv_fwd, kfe.fused_equiv_bwd), before)]
            if any(set(x) != {3} for x in grew):
                raise SystemExit(f"phase 18 at {name}: launches by D {grew}, expected kD = 3 only")
            del args, gout, live
            torch.cuda.empty_cache()
    return out


def read_launches(kfe) -> tuple:
    """The ``(forward, backward)`` conv kernel launches since the last
    reset."""
    return kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches


def check_by_d(label, kfe, fwd, bwd=0, d=3, g=1, act="gelu", kp=None) -> None:
    """Fails the run unless the launches since the last reset were ``fwd``
    forward and ``bwd`` backward ones, all at pne input width ``d``, ``g``
    out-frames and activation ``act`` (by default the standard geometry's
    gelu), and, given ``kp`` (``(corr, P)``), all of that kernel-point
    kind."""
    attrs = ("launches_by_d", "launches_by_g", "launches_by_act", "launches_by_kp")
    got = tuple(dict(getattr(fn, attr)) for fn in (kfe.fused_equiv_fwd, kfe.fused_equiv_bwd)
                for attr in attrs)
    want = tuple({key: n} if n and key is not None else {} for n in (fwd, bwd) for key in (d, g, act, kp))
    if got != want:
        raise SystemExit(f"{label}: launches by D, G, act and kp (fwd x4, bwd x4) {got}, expected {want}")


def dfaust_standard(card, dev, batch, small, recorded_draws, equivariant) -> dict:
    """19. ``configs/dfaust/dfaust_I_standard.yaml``: the model from
    ``build_model_from_config`` (on the card by default); a calibration step
    and eval steps on the 32 bodies, 21 forward launches per forward, all at
    kD = 3 (phase 3); card vs CPU logits at B=2 (phase 5; a standard model
    is not rotation invariant, so phase 4 does not apply), also with the
    norms seeded beside a planted kernel (:func:`dfaust_model_gates`); training with the
    recipe's ``Training`` section, 21 + 21 launches per step at kD = 3,
    finite losses and moved BN means (phase 7); card vs CPU parameter
    gradients at B=2 (phase 8).  Prints the step time and the peak beside
    the equivariant B=32 step of phase 7 (``equivariant``)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets

    model_dict, training = presets.DFAUST_I_STANDARD_MODEL, presets.DFAUST_I_STANDARD_TRAINING
    if "RefFrames" in model_dict or model_dict["model"] != "FPNSegUNetMLPGeluFAUST":
        raise SystemExit("the pinned dfaust_I_standard recipe is not the standard model")
    trainer, ev = dfaust_eval(card, dev, batch, model_dict, "dfaust_std")
    check_by_d("dfaust_std eval", kfe, CONVS_PER_FORWARD * (1 + EVAL_STEPS))
    if trainer.model.spec.equivariant:
        raise SystemExit("build_model_from_config built an equivariant model from dfaust_I_standard")
    cpu_err = dfaust_card_vs_cpu(card, dev, trainer, small, "dfaust_std_")
    seeded = dfaust_model_gates(card, dev, trainer, small, "dfaust_std")
    del trainer
    torch.cuda.empty_cache()
    trainer, steps = dfaust_train(card, dev, batch, model_dict, training)
    check_by_d("dfaust_std train", kfe, CONVS_PER_FORWARD * (1 + TRAIN_STEPS), CONVS_PER_FORWARD * TRAIN_STEPS)
    print(f"dfaust_std_train: steps after the first, median {steps['steady_s']:.4f} s (range "
          f"{min(steps['all_s'][1:]):.4f}-{max(steps['all_s'][1:]):.4f}), peak {steps['peak_gib']:.3f} GiB; "
          f"the equivariant dfaust_I_rot_pca_2F step of phase 7 {equivariant['steady_s']:.4f} s (range "
          f"{min(equivariant['all_s'][1:]):.4f}-{max(equivariant['all_s'][1:]):.4f}), peak "
          f"{equivariant['peak_gib']:.3f} GiB [{card}]", flush=True)
    grads = dfaust_grads_card_vs_cpu(card, dev, trainer, small, recorded_draws, training, "dfaust_std_")
    del trainer
    torch.cuda.empty_cache()
    return dict(eval=ev, train=steps, eval_launches=ev["launches"], train_launches=steps["launches"],
                card_vs_cpu_max_abs_err=cpu_err, seeded_gates=seeded, grads_card_vs_cpu=grads)


def scannet_standard(card, dev, recorded_draws, drop_path_draws) -> dict:
    """20. ``configs/scannet/scannet20_standard_I.yaml`` as written
    (bfloat16 convs, no frames), from its pinned ``Model`` section: eval on
    room 0, 32 bfloat16 kD = 3 forward launches per forward, and card vs
    CPU logits on phase 12's smaller room at the bfloat16 bound with the
    float32-conv control (:func:`scannet_eval`; no rotation check); one
    ``scan_scenes`` step per feature-gradient mode on the 6 rooms, 192
    forward and 192 backward bfloat16 kD = 3 launches each, 192 prefix sums
    in sorted mode only (:func:`scannet_train`); the two modes' gradients on
    one room at phase 14's bound (:func:`scannet_mode_grads`); one scatter
    step under ``torch.profiler`` (device ms per conv forward and backward
    pass, :func:`scannet_profile`)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.ops import pne_conv as ops
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model_dict, training = presets.SCANNET20_STANDARD_I_MODEL, presets.SCANNET20_STANDARD_I_TRAINING
    if "RefFrames" in model_dict or model_dict.get("compute_dtype") != "bfloat16":
        raise SystemExit("the pinned scannet20_standard_I recipe is not the bfloat16 standard model")
    feats, classes = presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES
    rooms = scannet_rooms(dev)
    room0 = {k: v[:1] for k, v in rooms.items()}
    model = seeded_model(model_dict, dev, feats, classes)
    if not bf16_convs(model) or model.spec.equivariant:
        raise SystemExit("build_model_from_config did not build the bfloat16 standard ScanNet model")
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, SCENE_POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, SCENE_POINTS, train=False),
                      label_smoothing=training["label_smoothing"], ignore_label=presets.SCANNET20_IGNORE_LABEL)
    ev = scannet_eval(card, dev, model, trainer, room0, kfe, classes, name="scannet_std")
    if ev["launches_by_d"] != {3: ev["launches"]}:
        raise SystemExit(f"scannet_std eval: launches by D {ev['launches_by_d']}, expected kD = 3 only")
    del model, trainer
    torch.cuda.empty_cache()
    trainer = scannet_trainer(dev, room0, model_dict, len(SCANNET_F32_MODE_ORDER), training)
    train = {}
    for mode in SCANNET_F32_MODE_ORDER:
        train.update(scannet_train(card, dev, trainer, rooms, kfe, segsum, ops, (mode,), "scannet_std_train"))
        check_by_d(f"scannet_std train {mode}", kfe, SCANNET_CONVS * SCENES, SCANNET_CONVS * SCENES)
    train["grads_sorted_vs_scatter"] = scannet_mode_grads(card, dev, trainer, room0, ops, recorded_draws,
                                                          drop_path_draws)
    train["profile"] = scannet_profile(card, trainer, rooms, ops, ("scatter",), "scannet_std_profile")
    del trainer, rooms
    torch.cuda.empty_cache()
    return dict(eval=ev, train=train)


# --- ModelNet40 classification (phases 21-22) -------------------------------------

# the three ModelNet40 recipes; models.presets pins each as NAME_MODEL and
# NAME_TRAINING, NAME the recipe's name in upper case
MN_RECIPES = ("modelnet40_pca_2F", "modelnet40_MC_2F", "modelnet40_standard")
# the recipes' batch_size of synthetic shapes and their classes; 25 convs per
# forward (2 patch, 19 block, 4 down); eval steps and train steps per recipe
MN_BATCH, MN_CLASSES, MN_CONVS = 12, 40, 25
MN_EVAL_STEPS, MN_TRAIN_STEPS = 3, 4
# phase 21's convs, name: ((B, M, N, K, G, F, Q, C, O), live rows per example:
# "fill" (the synthetic shapes' fill of the queried level 5) or None (every row
# live)): the level-5 block conv (512 -> 512 channels, product depth C*Q =
# 16,384), the same fully live, down_conv_3 (256 -> 512, level 4 -> 5) and the
# standard recipe's level-5 block conv (kD = 3)
MN_SHAPES = {
    "modelnet_level5_block_conv": ((MN_BATCH, 256, 256, 32, 2, 2, 32, 512, 512), "fill", 9),
    "modelnet_level5_block_conv_live": ((MN_BATCH, 256, 256, 32, 2, 2, 32, 512, 512), None, 9),
    "modelnet_down_conv_3": ((MN_BATCH, 256, 512, 32, 2, 2, 32, 256, 512), "fill", 9),
    "modelnet_std_level5_block_conv": ((MN_BATCH, 256, 256, 32, 1, 1, 32, 512, 512), "fill", 3),
}


def _grid_faces(nu, nv, wrap_u=False, wrap_v=False):
    """Triangles of an ``nu x nv`` vertex lattice (two per quad)."""
    faces = []
    for i in range(nu if wrap_u else nu - 1):
        for j in range(nv if wrap_v else nv - 1):
            a, b = i * nv + j, ((i + 1) % nu) * nv + j
            c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
            faces += [(a, b, c), (a, c, d)]
    return np.asarray(faces, np.int64)


def _ellipsoid(a, b, c, n=12):
    th, ph = np.meshgrid(np.linspace(0, np.pi, n), np.linspace(0, 2 * np.pi, 2 * n, endpoint=False),
                         indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1).reshape(-1, 3)
    return v * np.asarray((a, b, c)), _grid_faces(n, 2 * n, wrap_v=True)


def _box(w, h, d):
    v = np.array([(sx * w, sy * h, sz * d) for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)])
    f = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
                  (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)], np.int64)
    return v, f


def _cylinder(r, h, cone=False, n=24):
    """Lateral surface and caps (a cone: apex at the top, bottom cap only)."""
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    lo = np.stack([r * np.cos(ph), r * np.sin(ph), np.full(n, -h / 2)], -1)
    hi = np.tile([[0.0, 0.0, h / 2]], (n, 1)) if cone else lo + [0, 0, h]
    v = np.concatenate([lo, hi, [[0, 0, -h / 2]], [[0, 0, h / 2]]])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [(i, j, n + i), (j, i, 2 * n)]
        if not cone:
            faces += [(j, n + j, n + i), (n + i, n + j, 2 * n + 1)]
    return v, np.asarray(faces, np.int64)


def _torus(ring_r, tube_r, n=24, m=12):
    th, ph = np.meshgrid(np.linspace(0, 2 * np.pi, n, endpoint=False),
                         np.linspace(0, 2 * np.pi, m, endpoint=False), indexing="ij")
    r = ring_r + tube_r * np.cos(ph)
    v = np.stack([r * np.cos(th), r * np.sin(th), tube_r * np.sin(ph)], -1).reshape(-1, 3)
    return v, _grid_faces(n, m, wrap_u=True, wrap_v=True)


# five mesh families; a shape parameter s in [0, 1) sets the variant
SHAPE_FAMILIES = (
    lambda s: _ellipsoid(1.0, 0.4 + 0.6 * s, 0.3 + 0.3 * s),
    lambda s: _box(1.0, 0.3 + 0.7 * s, 0.15 + 0.5 * s),
    lambda s: _cylinder(0.2 + 0.4 * s, 1.2 - 0.6 * s),
    lambda s: _cylinder(0.3 + 0.4 * s, 1.1 - 0.5 * s, cone=True),
    lambda s: _torus(0.45, 0.08 + 0.12 * s),
)


def shape_batch(b: int, n: int, seed: int) -> dict:
    """Synthetic ModelNet40-format batch: ``b`` triangle meshes of the
    families above (label ``l``: family ``l % 5``, variant ``l // 5`` of 8,
    each parameter jittered by U(0.9, 1.1)), ``n`` points each sampled
    uniformly by triangle area (the sampler of ``experiments/
    synthetic_shapes.py``), centred and scaled into the unit sphere as the
    ModelNet40 files are; the loader's ones features, labels 0..39."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(b) * 7 + 3) % MN_CLASSES
    pts = np.empty((b, n, 3), np.float32)
    for i, label in enumerate(labels):
        verts, faces = SHAPE_FAMILIES[label % len(SHAPE_FAMILIES)](label // len(SHAPE_FAMILIES) / 8.0)
        verts = verts * rng.uniform(0.9, 1.1, size=3)
        tri = verts[faces]
        e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        pick = rng.choice(len(faces), n, p=area / area.sum())
        u, v = rng.uniform(size=(2, n))
        flip = u + v > 1
        u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
        p = tri[pick, 0] + u[:, None] * e1[pick] + v[:, None] * e2[pick]
        p -= p.mean(0)
        pts[i] = p / np.linalg.norm(p, axis=1).max()
    return {
        "positions": torch.from_numpy(pts),
        "mask": torch.ones(b, n, dtype=torch.bool),
        "features": torch.ones(b, n, 1),
        "labels": torch.from_numpy(labels.astype(np.int64)),
    }


def modelnet_recipe(name: str) -> tuple:
    """The pinned ``(Model, Training)`` sections of ModelNet40 recipe ``name``."""
    from se3conv3d_tpu_torch.models import presets

    return getattr(presets, f"{name.upper()}_MODEL"), getattr(presets, f"{name.upper()}_TRAINING")


def conv_plan(shp, n_live, elem_bytes=4) -> dict:
    """The forward's and backward's work plans of a conv of shape ``shp``
    with ``n_live`` live rows (``se3_fused_equiv_fwd_plan`` /
    ``se3_fused_equiv_bwd_plan``): rows per chunk, chunks, depth splits and
    scratch bytes of the forward; scratch bytes, ``d_w`` row splits (and
    their partials' bytes) and ``d_proj`` blocks of the backward."""
    import ctypes

    from se3conv3d_tpu_torch.kernels.build import library
    from se3conv3d_tpu_torch.kernels.fused_equiv import FWD_SCRATCH_BYTES

    _, _, _, _, g, _, q, c, o = shp
    chunk, splits, fwd_scratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    library("fwd").se3_fused_equiv_fwd_plan(n_live, g, q, c, o, FWD_SCRATCH_BYTES, elem_bytes,
                                            ctypes.byref(chunk), ctypes.byref(splits),
                                            ctypes.byref(fwd_scratch))
    bwd_scratch, w_splits, p_blocks = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    library("bwd").se3_fused_equiv_bwd_plan(n_live, g, q, c, o, elem_bytes, ctypes.byref(bwd_scratch),
                                            ctypes.byref(w_splits), ctypes.byref(p_blocks))
    return dict(chunk=chunk.value, chunks=-(-n_live // chunk.value), splits=splits.value,
                fwd_scratch_mib=fwd_scratch.value / 2**20, bwd_scratch_mib=bwd_scratch.value / 2**20,
                w_splits=w_splits.value,
                w_partials_mib=w_splits.value * c * q * o * 4 / 2**20 if w_splits.value > 1 else 0.0,
                p_blocks=p_blocks.value)


def call_peak_mib(fn) -> float:
    """Device memory that one call of ``fn`` adds at its peak, MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 2**20


def modelnet_conv_kernels(card, dev, fill) -> dict:
    """21. both conv kernels vs their plain versions at ``MN_SHAPES``
    (float32, the recipes' dtype; the live rows ``fill[5]`` per example or
    all), with the gates of phases 2 and 6: the forward bitwise equal over
    two calls, the backward in both output modes with its parameter
    gradients bitwise equal across modes and calls, each timed beside its
    bound, its plain version and ``torch.matmul`` for its products
    (:func:`forward_vs_plain`, :func:`backward_vs_plain`); each conv's
    forward and backward plans and the memory one call of each adds."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    out = {}
    for i, (name, (shp, rows, d)) in enumerate(MN_SHAPES.items()):
        n_live = fill[5] if rows == "fill" else None
        args, gout = padded_conv_args(30 + i, shp, n_live, dev)
        if d == 3:
            args[1], args[5] = None, args[5][:3].contiguous()
        live = kfe.live_row_table(args[4])
        plan = conv_plan(shp, live.numel())
        with torch.no_grad():
            plan["fwd_peak_mib"] = call_peak_mib(lambda: kfe.fused_equiv_fwd(*args, live_rows=live))
        plan["bwd_peak_mib"] = call_peak_mib(lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live))
        print(f"modelnet_conv_plan {name} B,M,N,K,G,F,Q,C,O={shp} kD={d}: {live.numel()} live rows; forward "
              f"{plan['chunks']} chunk(s) of <= {plan['chunk']} rows, {plan['splits']} depth split(s) of "
              f"C*Q = {shp[7] * shp[6]}, scratch {plan['fwd_scratch_mib']:.1f} MiB, one call's peak "
              f"{plan['fwd_peak_mib']:.1f} MiB; backward scratch {plan['bwd_scratch_mib']:.1f} MiB, "
              f"w_splits {plan['w_splits']} ({plan['w_partials_mib']:.1f} MiB of d_w partials), p_blocks "
              f"{plan['p_blocks']}, one call's peak {plan['bwd_peak_mib']:.1f} MiB [{card}]", flush=True)
        bounds = conv_bounds(shp, args[3], args[4], torch.float32, d=d)
        reset_launches(kfe)
        out[name] = dict(
            plan=plan,
            fwd=forward_vs_plain(card, f"modelnet_fwd_kernel_vs_plain {name}", shp, args, live,
                                 bounds["fwd"], 100 + i),
            bwd=backward_vs_plain(card, f"modelnet_bwd_kernel_vs_plain {name}", shp, args, gout, live,
                                  bounds["bwd"], 105 + i),
        )
        by_d = [fn.launches_by_d for fn in (kfe.fused_equiv_fwd, kfe.fused_equiv_bwd)]
        if any(set(x) != {d} for x in by_d):
            raise SystemExit(f"phase 21 at {name}: launches by D {by_d}, expected kD = {d} only")
        del args, gout, live
        torch.cuda.empty_cache()
    return out


def modelnet_trainer(dev, model_dict, training, optimizer_steps=0):
    """A classification ``Trainer`` of a fresh seeded model of ``model_dict``
    (``build_model_from_config``, on the card by default) on the recipe's
    hierarchy without an output subsample, with the optimizer of
    ``training`` over ``optimizer_steps`` steps (none at 0)."""
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    model = seeded_model(model_dict, dev, presets.MODELNET40_NUM_FEATURES, presets.MODELNET40_NUM_CLASSES)
    hcfg = [presets.hierarchy_config_from_model_dict(model_dict, presets.MODELNET40_NUM_POINTS, train=t)
            for t in (True, False)]
    opt = (schedule.optimizer_from_training(model.parameters(), training, optimizer_steps)
           if optimizer_steps else None)
    return Trainer(model, *hcfg, label_smoothing=training["label_smoothing"], optimizer=opt)


def seed_class_norm(trainer, batch, gen) -> None:
    """``class_norm``'s running statistics from the pooled rows of one eval
    forward on ``batch``, so the head sees unit-variance rows: at init
    (mean 0, var 1) the pooled vectors, averages over hundreds of points and
    frames, reach the head much smaller than the per-point features, and so
    do the logits, too small for the rotation gate's control to show (a
    degenerate init, as the skip gammas' of :func:`seed_gammas`)."""
    rows = []
    norm = trainer.model.class_norm
    hook = norm.register_forward_hook(lambda mod, args, out: rows.append(args[0][:, 0].detach()))
    try:
        trainer.eval_step(batch, gen)
    finally:
        hook.remove()
    with torch.no_grad():
        norm.mean.copy_(rows[0].mean(0))
        norm.var.copy_(rows[0].var(0))


def modelnet_invariance_and_cpu(card, dev, trainer, small, label) -> dict:
    """Phases 4-5 for a classification model on the two clouds of ``small``:
    an equivariant model's logits unchanged by a global rotation of the
    hierarchy (``ROT_ATOL``), and changed past it when the positions are
    rotated and the frames are not (the control); the same model and
    hierarchy on the CPU (plain path) within ``CPU_ATOL`` of the card, the
    first conv's kernel planted wrong past it
    (:func:`card_vs_cpu_with_control`)."""
    from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, rotate_hierarchy
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.core.rotation import random_rotations

    model = trainer.model.eval()
    h, f0, _, _, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(110), train=False)
    out = {}
    with torch.no_grad():
        base = model(h, f0)
        if model.spec.equivariant:
            rot = random_rotations(1, generator=torch.Generator().manual_seed(111))[0].to(dev)
            rotated = model(rotate_hierarchy(h, rot), f0)
            unframed = model(Hierarchy(tuple(PointCloud(pc.positions @ rot.T, pc.mask, pc.frames)
                                             for pc in h.levels), h.maps, h.levels_radii), f0)
            out["rotation_max_abs_err"] = rot_err = (base - rotated).abs().max().item()
            out["rotation_control"] = control = (base - unframed).abs().max().item()
            print(f"{label}_invariance: max |logits - logits(rotated)| = {rot_err:.3e} (bound {ROT_ATOL}); "
                  f"control, the positions rotated and the frames not: {control:.3e}; max |logits| "
                  f"{base.abs().max().item():.3e} [{card}]", flush=True)
            if not rot_err <= ROT_ATOL < control:
                raise SystemExit(f"{label}: logits change under a global rotation, or the bound does not "
                                 "tell a model that ignores the frames' rotation")
    if tuple(base.shape) != (2, MN_CLASSES):
        raise SystemExit(f"{label}: logits of shape {tuple(base.shape)}")
    out.update(card_vs_cpu_with_control(card, label, model, (h, f0)))
    return out


def modelnet_run(card, dev, name, batch, small, recorded_draws) -> dict:
    """22. ModelNet40 recipe ``name`` as written, on ``batch`` (the recipe's
    batch_size of synthetic shapes): a calibration step, ``class_norm``
    seeded (:func:`seed_class_norm`, one more forward) and eval steps at
    ``test_n_frames`` (25 forward launches each, all at G = F and kD = 9,
    or kD = 3 for the standard model), the logits' rotation invariance with
    its control (equivariant recipes) and card vs CPU logits at B = 2; then
    a fresh model trained with the recipe's ``Training`` section, 25 + 25
    launches per step, finite losses, every BN running mean moved; card vs
    CPU parameter gradients at B = 2 (phase 8's bound).  Returns the eval
    and train-step times, peaks and gate readings, and the launches read
    from the counters: ``eval_launches`` the forward ones of the two
    calibration steps, the seed forward and the eval steps,
    ``train_launches`` the train steps' ``(forward, backward)``."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm

    model_dict, training = modelnet_recipe(name)
    frames = model_dict.get("RefFrames")
    d, g = (9, frames["test_n_frames"]) if frames else (3, 1)
    g_train = frames["train_n_frames"] if frames else 1
    if training["batch_size"] != batch["mask"].shape[0]:
        raise SystemExit(f"{name}: the batch is not the recipe's batch_size")
    points = MN_BATCH * batch["mask"].shape[1]
    trainer = modelnet_trainer(dev, model_dict, training)
    model = trainer.model
    print(f"{name}: {model_dict['model']}, RefFrames {frames}, max_drop_path {model_dict['max_drop_path']}; "
          f"{sum(p.numel() for p in model.parameters())} parameters [{card}]", flush=True)
    gen = torch.Generator(device=dev).manual_seed(112)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe)
    t0 = time.perf_counter()
    trainer.calibration_step(batch, gen)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    check_by_d(f"{name} calibration", kfe, MN_CONVS, 0, d, g_train)
    forward_launches = [read_launches(kfe)]
    reset_launches(kfe)
    seed_class_norm(trainer, batch, gen)
    check_by_d(f"{name} class_norm seed forward", kfe, MN_CONVS, 0, d, g)
    forward_launches.append(read_launches(kfe))
    reset_launches(kfe)
    eval_s, outs = [], None
    for _ in range(MN_EVAL_STEPS):
        t0 = time.perf_counter()
        outs = trainer.eval_step(batch, gen)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    check_by_d(f"{name} eval", kfe, MN_CONVS * MN_EVAL_STEPS, 0, d, g)
    forward_launches.append(read_launches(kfe))
    logits = outs["logits"]
    print(f"{name}_eval: calibration_step {calib_s:.4f} s, eval_step {[round(x, 4) for x in eval_s]} s "
          f"(median {statistics.median(eval_s):.4f} s, {points / statistics.median(eval_s):.1f} input "
          f"points/s), peak {eval_peak:.3f} GiB, loss {float(outs['loss']):.4f}; (forward, backward) launches of the "
          f"calibration, the seed forward and the eval steps {forward_launches}, at kD = {d}, G = {g} "
          f"[{card}]", flush=True)
    if tuple(logits.shape) != (MN_BATCH, MN_CLASSES) or not torch.isfinite(logits).all():
        raise SystemExit(f"{name}: bad logits, shape {tuple(logits.shape)}")
    if not all(bool(m.initialized) for m in model.modules() if hasattr(m, "initialized")):
        raise SystemExit(f"{name}: a conv was not calibrated")
    checks = modelnet_invariance_and_cpu(card, dev, trainer, small, name)
    del trainer, model, outs, logits
    torch.cuda.empty_cache()

    trainer = modelnet_trainer(dev, model_dict, training, MN_TRAIN_STEPS)
    opt = trainer.optimizer
    print(f"{name}_train: Training max_lr {training['max_lr']} div_factor {training['div_factor']} "
          f"final_div_factor {training['final_div_factor']} pct_start {training['pct_start']} clip_grads "
          f"{opt.clip_grad_norm} label_smoothing {trainer.label_smoothing} weight_decay "
          f"{opt.adamw.defaults['weight_decay']} [{card}]", flush=True)
    bns = {n: mod for n, mod in trainer.model.named_modules() if isinstance(mod, MaskedBatchNorm)}
    reset_launches(kfe)
    trainer.calibration_step(batch, gen)
    check_by_d(f"{name} train calibration", kfe, MN_CONVS, 0, d, g_train)
    forward_launches.append(read_launches(kfe))
    bn_before = {n: mod.mean.clone() for n, mod in bns.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, train_launches = [], []
    for step in range(MN_TRAIN_STEPS):
        lr = opt.lr
        reset_launches(kfe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loss, gnorm = float(res["loss"]), float(res["grad_norm"])
        print(f"{name}_train: step {step} lr {lr:.6e} loss {loss:.6f} grad_norm {gnorm:.6f} time "
              f"{step_s[-1]:.4f} s [{card}]", flush=True)
        check_by_d(f"{name} train step {step}", kfe, MN_CONVS, MN_CONVS, d, g_train)
        train_launches.append(read_launches(kfe))
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise SystemExit(f"{name}: non-finite loss or gradients in a train step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    still = [n for n, mod in bns.items() if torch.equal(mod.mean, bn_before[n])]
    steady = statistics.median(step_s[1:])
    print(f"{name}_train: train_step after the first, median {steady:.4f} s (all "
          f"{[round(x, 4) for x in step_s]}), {points / steady:.1f} input points/s, peak {peak:.3f} GiB; "
          f"(forward, backward) launches by step {train_launches} at kD = {d}, G = {g_train}; "
          f"{len(bns) - len(still)} of "
          f"{len(bns)} BN running means moved [{card}]", flush=True)
    if still:
        raise SystemExit(f"{name}: BN running mean did not move: {still[:5]}")
    grads = dfaust_grads_card_vs_cpu(card, dev, trainer, small, recorded_draws, training, f"{name}_")
    del trainer
    torch.cuda.empty_cache()
    return dict(eval_s=eval_s, eval_peak_gib=eval_peak, calib_s=calib_s, train_s=step_s, steady_s=steady,
                peak_gib=peak, d=d, eval_launches=sum(f for f, _ in forward_launches),
                train_launches=tuple(map(sum, zip(*train_launches))),
                grads_card_vs_cpu=grads, **checks)


def modelnet_profile(card, dev, batch) -> dict:
    """One ``torch.profiler`` train step of ``modelnet40_pca_2F`` (a fresh
    model, calibrated, after one unprofiled step): device ms by kernel, the
    conv passes, the PyTorch reductions and the idle share
    (:func:`scannet_profile`).  It runs last: a profiled run slows the
    launches after it."""
    from se3conv3d_tpu_torch.ops import pne_conv as ops

    model_dict, training = modelnet_recipe("modelnet40_pca_2F")
    trainer = modelnet_trainer(dev, model_dict, training, 2)
    gen = torch.Generator(device=dev).manual_seed(113)
    trainer.calibration_step(batch, gen)
    trainer.train_step(batch, gen)
    out = scannet_profile(card, trainer, batch, ops, ("scatter",), "modelnet_profile")
    del trainer
    torch.cuda.empty_cache()
    return out


def run_modelnet(card, dev, recorded_draws) -> tuple:
    """21.-22.: the shapes, their fill, the kernels at ModelNet's shapes and
    the three recipes; returns ``(conv, runs, batch)``."""
    from se3conv3d_tpu_torch.models import presets

    if (presets.MODELNET40_NUM_CLASSES, presets.MODELNET40_NUM_POINTS) != (MN_CLASSES, POINTS):
        raise SystemExit("the ModelNet40 phases do not run the recipes' classes and points")
    batch = to_device(shape_batch(MN_BATCH, POINTS, seed=114), dev)
    small = to_device(shape_batch(2, POINTS, seed=115), dev)
    fill = mixf_fill(dev, batch, modelnet_recipe("modelnet40_pca_2F")[0])
    print(f"modelnet: {MN_BATCH} synthetic shapes of {POINTS} points, labels "
          f"{batch['labels'].tolist()}; max valid points per level {fill} of capacities "
          f"{modelnet_recipe('modelnet40_pca_2F')[0]['capacities']} [{card}]", flush=True)
    conv = modelnet_conv_kernels(card, dev, fill)
    runs = {name: modelnet_run(card, dev, name, batch, small, recorded_draws) for name in MN_RECIPES}
    return conv, runs, batch


# the CLI phases (23-25): the recipes through ``python -m
# se3conv3d_tpu_torch.tasks.train``'s ``main``, on fixtures in each loader's
# format: DFaust bodies (train, test), ModelNet40 shapes (train, test) and
# ScanNet rooms (train, val), with the numpy seed of each fixture
CLI_DFAUST = ("configs/dfaust/dfaust_I_rot_pca_2F.yaml", 64, 8, 23)
CLI_MODELNET = ("configs/modelnet40/modelnet40_pca_2F.yaml", 24, 12, 24)
CLI_SCANNET = ("configs/scannet/scannet20_rot_pca_I.yaml", 8, 2, 250)
# the ScanNet recipe's two cuts of scale for the phase: one epoch of two batches
CLI_SCANNET_CUTS = {"num_epochs": 1, "num_batches": 2}


def write_dfaust_fixture(root: Path, n_train: int, n_test: int, seed: int) -> None:
    """Synthetic bodies (:func:`body_batch`) as DFaust ``model_{i}_pc.pt`` /
    ``model_{i}_labels.pt``; the 20 height bands are stored as the raw
    labels the loader shifts (those above 9 plus 2)."""
    for split, n, s in (("train", n_train, seed), ("test", n_test, seed + 1)):
        d = root / split
        d.mkdir(parents=True)
        batch = body_batch(n, POINTS, s)
        for i in range(n):
            band = batch["labels"][i]
            torch.save(batch["positions"][i].clone(), d / f"model_{i}_pc.pt")
            torch.save(torch.where(band > 9, band + 2, band), d / f"model_{i}_labels.pt")


def write_modelnet_fixture(root: Path, n_train: int, n_test: int, seed: int) -> None:
    """Synthetic shapes (:func:`shape_batch`) in the ModelNet40 txt format:
    ``modelnet40_shape_names.txt`` (40 classes), the split lists and one
    ``x,y,z,nx,ny,nz`` file per shape (the normals, which the recipes'
    ones features never read, set to the unit position vectors)."""
    root.mkdir(parents=True)
    names = [f"shape{c:02d}" for c in range(MN_CLASSES)]
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    k = 0
    for split, n, s in (("train", n_train, seed), ("test", n_test, seed + 1)):
        batch = shape_batch(n, POINTS, s)
        listed = []
        for i in range(n):
            cls = names[int(batch["labels"][i])]
            k += 1
            name = f"{cls}_{k:04d}"
            (root / cls).mkdir(exist_ok=True)
            p = batch["positions"][i].numpy().astype(np.float64)
            nrm = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-9)
            np.savetxt(root / cls / f"{name}.txt", np.concatenate([p, nrm], 1), fmt="%.6f", delimiter=",")
            listed.append(name)
        (root / f"modelnet40_{split}.txt").write_text("\n".join(listed) + "\n")


def write_room(path: Path, room: dict) -> None:
    """One room of :func:`room_scene` in the ScanNet npz format (``points``,
    ``normals``, ``colors``, ``labels_20``)."""
    feats = room["features"].numpy()
    np.savez(path, points=room["positions"].numpy(), normals=feats[:, :3], colors=feats[:, 3:],
             labels_20=room["labels"].numpy().astype(np.int32))


def write_scannet_fixture(root: Path, n_train: int, n_val: int, seed: int) -> None:
    """Synthetic rooms (:func:`room_scene`, ``SCENE_POINTS`` each) in the
    ScanNet npz format, with the split lists and ``color_stats.txt``."""
    root.mkdir(parents=True)
    (root / "color_stats.txt").write_text("0.5,0.5,0.5\n0.29,0.29,0.29\n")
    k = 0
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split).mkdir()
        names = []
        for _ in range(n):
            name = f"scene{k:04d}_00"
            write_room(root / split / f"{name}.npz", room_scene(SCENE_POINTS, seed + k))
            k += 1
            names.append(name)
        (root / f"scannet_{split}.txt").write_text("\n".join(names) + "\n")


@contextlib.contextmanager
def counting_steps(modes=None):
    """Records each ``Trainer`` step the CLI takes as ``(kind, clouds)``;
    with ``modes``, train step i runs in feature-gradient mode ``modes[i]``."""
    from se3conv3d_tpu_torch.ops import pne_conv as ops
    from se3conv3d_tpu_torch.train.trainer import Trainer

    seen = []
    originals = {k: getattr(Trainer, k) for k in ("calibration_step", "train_step", "eval_step")}

    def wrap(kind):
        def step(self, batch, *args, **kwargs):
            clouds = int(batch["mask"].shape[0])
            if kind == "train_step" and modes is not None:
                ops.BWD_SCATTER_MODE = modes[sum(k == kind for k, _ in seen)]
            seen.append((kind, clouds))
            return originals[kind](self, batch, *args, **kwargs)
        return step

    try:
        for k in originals:
            setattr(Trainer, k, wrap(k))
        yield seen
    finally:
        for k, fn in originals.items():
            setattr(Trainer, k, fn)
        ops.BWD_SCATTER_MODE = "scatter"


@contextlib.contextmanager
def checking_restore(checked):
    """Holds the state each ``Experiment.restore`` loads against the
    checkpoint file it read, bitwise (every parameter, buffer and AdamW
    moment, the schedule's and the trainer's steps); appends the step."""
    from se3conv3d_tpu_torch.train import run as trun

    original = trun.Experiment.restore

    def restore(self, step=None):
        meta = original(self, step)
        saved = self.ckpt.load(step, map_location=self.device)["state"]
        now = self.state_payload()
        bad = [k for k, v in saved["model"].items() if not torch.equal(now["model"][k], v)]
        for i, s in saved["optimizer"]["adamw"]["state"].items():
            bad += [f"adamw {i} {k}" for k in ("step", "exp_avg", "exp_avg_sq")
                    if not torch.equal(now["optimizer"]["adamw"]["state"][i][k], s[k])]
        if (now["optimizer"]["scheduler"] != saved["optimizer"]["scheduler"]
                or now["trainer_step"] != saved["trainer_step"]
                or now["model"].keys() != saved["model"].keys()):
            bad.append("schedule, trainer step or keys")
        if bad:
            raise SystemExit(f"resume: restored state differs from the checkpoint: {bad[:5]}")
        checked.append((self.ckpt.latest_step() if step is None else step,
                        len(saved["model"]), len(saved["optimizer"]["adamw"]["state"])))
        return meta

    trun.Experiment.restore = restore
    try:
        yield checked
    finally:
        trun.Experiment.restore = original


def cli_run(card, label, argv, convs, modes=None) -> dict:
    """One ``main(argv)`` on the card: the Experiment, the steps it took,
    its conv launches (read from the counters, reset just before), the
    prefix sums, the native library's calls, its wall time and peak."""
    from se3conv3d_tpu_torch import native
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.tasks.train import main as train_main

    native_before = dict(native.calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe, segsum)
    t0 = time.perf_counter()
    with counting_steps(modes) as steps:
        exp = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kfe)
    bf16 = (kfe.fused_equiv_fwd.bf16_launches, kfe.fused_equiv_bwd.bf16_launches)
    cumsum = segsum.blocked_cumsum.launches
    if next(exp.model.parameters()).device.type != "cuda":
        raise SystemExit(f"{label}: the CLI did not train on the card")
    losses = [x for h in exp.history for x in h["losses"]]
    if not losses or not all(np.isfinite(losses)):
        raise SystemExit(f"{label}: non-finite or missing losses {losses}")
    # each forward launches every conv once; scan_scenes steps run their clouds one by one
    per_train = [n if exp.trainer.scan_scenes else 1 for k, n in steps if k == "train_step"]
    want_fwd = convs * (sum(k != "train_step" for k, _ in steps) + sum(per_train))
    if launches != (want_fwd, convs * sum(per_train)):
        raise SystemExit(f"{label}: conv launches {launches}, expected {(want_fwd, convs * sum(per_train))} "
                         f"from the steps {steps}")
    split = {k: statistics.median(v) for k, v in exp.host_split.items()}
    host = split["load"] + split["collate"] + split["copy"]
    result = dict(steps=steps, launches=launches, bf16_launches=bf16, cumsum_launches=cumsum,
                  wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30, losses=losses,
                  history=[{k: v for k, v in h.items() if k != "val"} for h in exp.history],
                  val={k: v for k, v in exp.history[-1].get("val", {}).items()
                       if k not in ("iou_per_class", "acc_per_class")},
                  host_split_s=exp.host_split, host_split_median_s=split,
                  host_share=host / (host + split["step"]),
                  native_calls={k: native.calls[k] - native_before[k] for k in native.calls})
    print(f"{label}: steps {steps}; conv launches (fwd, bwd) {launches}, bf16 {bf16}, prefix sums {cumsum}; "
          f"losses {[round(x, 4) for x in losses]}; epochs {[(h['epoch'], round(h['epoch_time_s'], 3)) for h in exp.history]} s; "
          f"validation {result['val']}; wall {wall:.2f} s; peak {result['peak_gib']:.3f} GiB [{card}]", flush=True)
    print(f"{label}: host clock per train batch, median s: load+augment {split['load']:.4f}, collate "
          f"{split['collate']:.4f}, host-to-device copy {split['copy']:.4f}, train_step {split['step']:.4f} "
          f"(host share {result['host_share']:.3f}); all {exp.host_split}; native calls "
          f"{result['native_calls']} [{card}]", flush=True)
    return exp, result


def run_cli(card, dev, tmp: Path) -> dict:
    """23.-25. The training CLI on the card (see the module docstring), its
    fixtures and log folders under ``tmp``, which phases 26-28 evaluate."""
    from se3conv3d_tpu_torch import native
    from se3conv3d_tpu_torch.train.config import dump_yaml_config, load_yaml_config

    out = {}
    # 23. DFaust: the recipe as written, B = 32, then a resume
    conf, n_train, n_test, seed = CLI_DFAUST
    t0 = time.perf_counter()
    write_dfaust_fixture(tmp / "dfaust", n_train, n_test, seed)
    print(f"cli_dfaust: fixture {n_train} train and {n_test} test bodies of {POINTS} points "
          f"(numpy seeds {seed}, {seed + 1}) in {time.perf_counter() - t0:.2f} s", flush=True)
    argv = ["--conf_file", conf, "--data_folder", str(tmp / "dfaust"), "--log_folder", str(tmp / "dfaust_log")]
    exp, first = cli_run(card, "cli_dfaust", argv + ["--max_epochs", "1"], CONVS_PER_FORWARD)
    saved = exp.ckpt.all_steps()
    miou = first["val"].get("miou", float("nan"))
    if saved != [0] or not 0.0 <= miou <= 1.0:
        raise SystemExit(f"cli_dfaust: checkpoints {saved}, mIoU {miou}")
    if load_yaml_config(str(tmp / "dfaust_log" / "config.yaml")) != exp.cfg:
        raise SystemExit("cli_dfaust: config.yaml does not read back")
    del exp
    checked = []
    with checking_restore(checked):
        exp, resumed = cli_run(card, "cli_dfaust_resume", argv + ["--resume", "--max_epochs", "1"],
                               CONVS_PER_FORWARD)
    if len(checked) != 1 or [h["epoch"] for h in exp.history] != [1]:
        raise SystemExit(f"cli_dfaust_resume: restored {checked}, epochs {exp.history}")
    if exp.ckpt.all_steps() == [0]:  # no better mIoU: phase 26 ensembles two checkpoints
        exp.save(1, float(resumed["val"].get("miou", float("nan"))))
    print(f"cli_dfaust_resume: checkpoint {checked[0][0]} restored bitwise ({checked[0][1]} tensors of "
          f"the model, {checked[0][2]} AdamW states); schedule at step "
          f"{exp.optimizer.scheduler.last_epoch} [{card}]", flush=True)
    out["dfaust"], out["dfaust_resume"] = first, resumed
    del exp
    torch.cuda.empty_cache()

    # 24. ModelNet40: the recipe as written, B = 12; the npz cache written, then read
    conf, n_train, n_test, seed = CLI_MODELNET
    t0 = time.perf_counter()
    write_modelnet_fixture(tmp / "modelnet", n_train, n_test, seed)
    print(f"cli_modelnet40: fixture {n_train} train and {n_test} test shapes of {POINTS} points "
          f"(numpy seeds {seed}, {seed + 1}) in {time.perf_counter() - t0:.2f} s", flush=True)
    argv = ["--conf_file", conf, "--data_folder", str(tmp / "modelnet"), "--log_folder",
            str(tmp / "modelnet_log"), "--max_epochs", "1"]
    exp, mn = cli_run(card, "cli_modelnet40", argv, MN_CONVS)
    acc = mn["val"].get("accuracy", float("nan"))
    caches = sorted(p.name for p in (tmp / "modelnet").glob("tmp_*"))
    if exp.train_ds.from_cache or caches != [f"tmp_test_{POINTS}.npz", f"tmp_train_{POINTS}.npz"] or not 0 <= acc <= 1:
        raise SystemExit(f"cli_modelnet40: caches {caches}, accuracy {acc}")
    del exp
    exp, mn_again = cli_run(card, "cli_modelnet40_cached", argv + ["--resume"], MN_CONVS)
    if not (exp.train_ds.from_cache and exp.val_ds.from_cache):
        raise SystemExit("cli_modelnet40_cached: the npz cache was not read")
    out["modelnet40"], out["modelnet40_cached"] = mn, mn_again
    del exp
    torch.cuda.empty_cache()

    # 25. ScanNet-20: the recipe as written (bf16, scan_scenes, 750,000-point
    # budget) but for its two cuts; train step 2 in sorted mode
    conf, n_train, n_val, seed = CLI_SCANNET
    t0 = time.perf_counter()
    write_scannet_fixture(tmp / "scannet", n_train, n_val, seed)
    cfg = load_yaml_config(conf)
    cfg["Training"].update(CLI_SCANNET_CUTS)
    dump_yaml_config(cfg, str(tmp / "scannet20_rot_pca_I.yaml"))
    print(f"cli_scannet20: fixture {n_train} train and {n_val} val rooms of {SCENE_POINTS} points "
          f"(numpy seeds {seed}-{seed + n_train + n_val - 1}) in {time.perf_counter() - t0:.2f} s; "
          f"{conf} as written but for Training {CLI_SCANNET_CUTS} [{card}]", flush=True)
    argv = ["--conf_file", str(tmp / "scannet20_rot_pca_I.yaml"), "--data_folder", str(tmp / "scannet"),
            "--log_folder", str(tmp / "scannet_log")]
    exp, scan = cli_run(card, "cli_scannet20", argv, SCANNET_CONVS, modes=("scatter", "sorted"))
    train_clouds = [n for k, n in scan["steps"] if k == "train_step"]
    if scan["bf16_launches"] != scan["launches"] or scan["cumsum_launches"] != SCANNET_CONVS * train_clouds[1]:
        raise SystemExit(f"cli_scannet20: bf16 launches {scan['bf16_launches']} of {scan['launches']}, "
                         f"prefix sums {scan['cumsum_launches']} for {train_clouds}")
    calls = scan["native_calls"]
    if native.load_library() is None or not native.library_path().exists() or min(
            calls["elastic_distortion"], calls["select_nearest"]) < 1:
        raise SystemExit(f"cli_scannet20: the native library was not built or not used: {calls}")
    if not exp.trainer.scan_scenes or not 0.0 <= scan["val"].get("miou", -1.0) <= 1.0:
        raise SystemExit(f"cli_scannet20: scan_scenes {exp.trainer.scan_scenes}, val {scan['val']}")
    scan["cuts"] = CLI_SCANNET_CUTS
    out["scannet20"] = scan
    del exp
    torch.cuda.empty_cache()
    return out


# the eval phases (26-28): the test CLIs (``python -m
# se3conv3d_tpu_torch.tasks.test_seg`` / ``.test_class``, their ``main``) on
# the log folders of phases 23-25, each recipe's test regime from
# ``configs/``: DFaust as written with a 2-checkpoint ensemble; ModelNet40
# and ScanNet with their vote epochs cut (the files: 50 and 30)
EVAL_DFAUST = ("configs/dfaust/dfaust_test.yaml", 2)  # conf, checkpoints
EVAL_MODELNET = ("configs/modelnet40/modelnet40_test_rot.yaml", 2)  # conf, vote epochs
EVAL_SCANNET = ("configs/scannet/scannet20_test_pca_I_SO2.yaml", 2)  # conf, vote epochs
# phase 28's whole val rooms (points, numpy seed): one within the recipe's
# capacity of 131,072, two above it (buckets of 409,600 and 1,507,328); their
# segments are the voxels of SEGMENT_VOXEL m they fall in
EVAL_ROOMS = ((120_000, 260), (400_000, 261), (1_500_000, 262))
SEGMENT_VOXEL = 0.2
# the bucket-consistency check: the 400,000-point room voted again through
# its bucket (bitwise the voter's) and through a trainer one bucket larger,
# within BUCKET_RTOL of max |accum| (two readings, 0 and 1.423e-5, on
# NVIDIA H100 80GB HBM3 at 700 W)
BUCKET_ROOM = 1
BUCKET_RTOL = 1e-4


@contextlib.contextmanager
def watching_evals(keep=lambda index, n_raw: False):
    """Within: each ``Trainer.eval_ensemble`` call records its clouds,
    members, generator seed, raw points, capacity, host-clock seconds in
    all, in the hierarchy build and in ``live_row_table`` (its host
    synchronisations), the peak device memory of the call (reset before
    it), its logits on the host, and its batch and the hierarchy its build
    gave (``built``) where ``keep(call index, n_raw)``; each
    ``Trainer.load_member`` (an ensemble swap) and each
    ``SegmentationVoter._accumulate`` records its seconds.  Every boundary
    synchronises the card."""
    from se3conv3d_tpu_torch.models import spec as spec_mod
    from se3conv3d_tpu_torch.train.evaluate import SegmentationVoter
    from se3conv3d_tpu_torch.train.trainer import Trainer

    seen = {"calls": [], "swap_s": [], "accumulate_s": []}
    originals = dict(build=Trainer.build, eval_ensemble=Trainer.eval_ensemble, load_member=Trainer.load_member,
                     accumulate=SegmentationVoter._accumulate, live=spec_mod.live_row_table)
    current, built = {}, {}

    def build(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals["build"](self, *args, **kwargs)
        torch.cuda.synchronize()
        current["build_s"] = current.get("build_s", 0.0) + time.perf_counter() - t0
        built["last"] = out
        return out

    def live(mask):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals["live"](mask)
        current["live_rows_s"] = current.get("live_rows_s", 0.0) + time.perf_counter() - t0
        current["live_rows_calls"] = current.get("live_rows_calls", 0) + 1
        return out

    def eval_ensemble(self, batch, members, generator=None, draws=None):
        current.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = originals["eval_ensemble"](self, batch, members, generator, draws)
        torch.cuda.synchronize()
        n_raw = int(batch["mask"].sum())
        rec = dict(clouds=int(batch["mask"].shape[0]), members=len(members), seed=generator.initial_seed(),
                   n_raw=n_raw, capacity=int(batch["mask"].shape[1]), wall_s=time.perf_counter() - t0,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   logits=[o["logits"].float().cpu() for o in outs], **current)
        rec["forward_s"] = rec["wall_s"] - rec.get("build_s", 0.0)
        if keep(len(seen["calls"]), n_raw):
            rec["batch"] = {k: v.clone() for k, v in batch.items()}
            rec["built"] = built["last"]
        built.clear()
        seen["calls"].append(rec)
        return outs

    def load_member(self, state_dict):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        originals["load_member"](self, state_dict)
        torch.cuda.synchronize()
        seen["swap_s"].append(time.perf_counter() - t0)

    def accumulate(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        originals["accumulate"](self, *args, **kwargs)
        torch.cuda.synchronize()
        seen["accumulate_s"].append(time.perf_counter() - t0)

    try:
        Trainer.build, Trainer.eval_ensemble, Trainer.load_member = build, eval_ensemble, load_member
        SegmentationVoter._accumulate = accumulate
        spec_mod.live_row_table = live
        yield seen
    finally:
        Trainer.build, Trainer.eval_ensemble = originals["build"], originals["eval_ensemble"]
        Trainer.load_member, SegmentationVoter._accumulate = originals["load_member"], originals["accumulate"]
        spec_mod.live_row_table = originals["live"]


def eval_run(card, label, cli, argv, convs, keep=lambda index, n_raw: False) -> tuple:
    """One evaluation CLI ``main(argv)`` on the card, watched
    (:func:`watching_evals`, the forwards' live-row tables): its voter and
    summary, the launches (read from the counters, reset just before; every
    forward is one eval step of one member), the records, wall time and
    peak.  Fails the run on a backward or prefix-sum launch, on a forward
    count other than ``convs`` per member per eval step, or on a forward
    without its live-row table."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe, segsum)
    t0 = time.perf_counter()
    with watching_evals(keep) as seen, \
            watching_live_rows(kfe, "fused_equiv_fwd") as live:
        voter, summary = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kfe)
    bf16 = kfe.fused_equiv_fwd.bf16_launches
    forwards = sum(c["members"] for c in seen["calls"])
    if next(voter.trainer.model.parameters()).device.type != "cuda":
        raise SystemExit(f"{label}: the CLI did not evaluate on the card")
    if launches != (convs * forwards, 0) or segsum.blocked_cumsum.launches:
        raise SystemExit(f"{label}: conv launches {launches}, prefix sums {segsum.blocked_cumsum.launches}; "
                         f"expected ({convs * forwards}, 0) and none for {forwards} forwards")
    check_live_rows(card, label, live, convs * forwards)
    calls = seen["calls"]
    print(f"{label}: {len(calls)} eval steps x members {[c['members'] for c in calls][:1]}, {forwards} forwards; "
          f"conv launches (fwd, bwd) {launches}, bf16 {bf16}, prefix sums 0; wall {wall:.2f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ensemble swaps {len(seen['swap_s'])} "
          f"({1e3 * statistics.median(seen['swap_s']) if seen['swap_s'] else 0.0:.3f} ms median); "
          f"live_row_table {sum(c.get('live_rows_calls', 0) for c in calls)} calls, "
          f"{sum(c.get('live_rows_s', 0.0) for c in calls):.4f} s [{card}]", flush=True)
    return voter, summary, dict(launches=launches, bf16_launches=bf16, forwards=forwards, wall_s=wall,
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30, seen=seen, live=live)


def accumulate_direct(acc, out, n_raw) -> None:
    """One eval output of one cloud (batch row 0) into ``acc`` as the voter
    adds it: each valid output row's logits at its raw point."""
    rows = torch.nonzero(out["mask"][0]).reshape(-1)
    idx = out["out_idx"][0][rows]
    ok = idx < n_raw
    acc.index_add_(0, idx[ok].long(), out["logits"][0][rows[ok]].double())


def write_eval_rooms(root: Path, train_from: Path) -> list:
    """Phase 28's data folder: phase 25's train rooms (linked), and the
    whole val rooms of ``EVAL_ROOMS`` with their segment files; returns the
    val rooms' point counts."""
    root.mkdir()
    (root / "train").symlink_to(train_from / "train", target_is_directory=True)
    for f in ("scannet_train.txt", "color_stats.txt"):
        (root / f).write_text((train_from / f).read_text())
    (root / "val").mkdir()
    (root / "segments").mkdir()
    names = []
    for k, (n, seed) in enumerate(EVAL_ROOMS):
        room = room_scene(n, seed)
        name = f"scene{100 + k:04d}_00"
        write_room(root / "val" / f"{name}.npz", room)
        voxel = np.floor(room["positions"].numpy() / SEGMENT_VOXEL).astype(np.int64)
        segments = np.unique(voxel, axis=0, return_inverse=True)[1].reshape(-1)
        np.savez(root / "segments" / f"{name}_seg.npz", segments=segments)
        names.append(name)
    (root / "scannet_val.txt").write_text("\n".join(names) + "\n")
    return [n for n, _ in EVAL_ROOMS]


def pad_rows(x: torch.Tensor, rows: int, dim: int = 1) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to ``rows``."""
    pad = list(x.shape)
    pad[dim] = rows - x.shape[dim]
    return torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)], dim)


def atomic_sums(vm, s, mask, out_shape):
    """The grid average's cell sums by ``scatter_add_`` on the card: float32
    atomics, in no fixed order (the control of ``grid._cell_sums``)."""
    from se3conv3d_tpu_torch.core import grid

    return vm.new_zeros(out_shape).scatter_add_(1, grid._seg_index(s, vm), vm)


@contextlib.contextmanager
def atomic_cell_sums():
    """Within: every grid average of the build sums its cells by
    :func:`atomic_sums`."""
    from se3conv3d_tpu_torch.core import grid

    ordered = grid._cell_sums
    grid._cell_sums = atomic_sums
    try:
        yield
    finally:
        grid._cell_sums = ordered


def bucket_consistency(card, dev, voter, seen) -> dict:
    """The 400,000-point room voted again with the voter's batches and
    random draws (its generator seeds; the draws padded to the larger
    capacities), as the CLI runs: twice through its own bucket, each the
    voter's accumulator bitwise, and once through a trainer one bucket
    larger, within ``BUCKET_RTOL`` of max |accum|.  Beside them, the
    control: two votes through its bucket with the grid averages summed by
    float32 atomics (:func:`atomic_cell_sums`), and how far apart they
    land."""
    from se3conv3d_tpu_torch.core.hierarchy import HierarchyDraws, draw_hierarchy
    from se3conv3d_tpu_torch.train.evaluate import CAPACITY_BUCKET

    n_raw, _ = EVAL_ROOMS[BUCKET_ROOM]
    small_cap = -(-n_raw // CAPACITY_BUCKET) * CAPACITY_BUCKET
    big_cap = small_cap + CAPACITY_BUCKET
    small, big = voter.bucket_trainers[small_cap], voter.trainer_factory(big_cap)
    recs = [c for c in seen["calls"] if c["n_raw"] == n_raw]

    def vote(trainer, cap):
        acc = torch.zeros_like(voter.accum[BUCKET_ROOM])
        caps = trainer.eval_hcfg.resolve_capacities(cap)
        out_cap = trainer.eval_hcfg.out_capacity
        for rec in recs:
            gen = torch.Generator(device=dev).manual_seed(rec["seed"])
            d = draw_hierarchy(small.eval_hcfg, 1, small_cap, gen, dev)
            draws = HierarchyDraws(level_frames=[pad_rows(x, c) for x, c in zip(d.level_frames, caps)],
                                   out_uniforms=pad_rows(d.out_uniforms, out_cap),
                                   out_frames=pad_rows(d.out_frames, out_cap))
            batch = {k: pad_rows(v, cap) for k, v in rec["batch"].items()}
            accumulate_direct(acc, trainer.eval_ensemble(batch, [None], draws=draws)[0], n_raw)
        return acc

    ref, again, acc = vote(small, small_cap), vote(small, small_cap), vote(big, big_cap)
    with atomic_cell_sums():
        atomic = [vote(small, small_cap) for _ in range(2)]
    err, rel, _ = max_rel_err(acc, ref)
    repeats, voters = torch.equal(ref, again), torch.equal(voter.accum[BUCKET_ROOM], ref)
    atomic_rel = max_rel_err(atomic[1], atomic[0])[1]
    print(f"eval_scannet20: the {n_raw}-point room voted again ({len(recs)} votes, the same draws): through "
          f"bucket {small_cap} twice, bitwise the voter's accumulator: {voters}, a vote repeats bitwise: "
          f"{repeats}; through bucket {big_cap}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (bound "
          f"{BUCKET_RTOL:.0e} of max |accum| {ref.abs().max().item():.4f}); control, the grid averages summed "
          f"by float32 atomics: two votes {atomic_rel:.3e} of max apart, bitwise equal: "
          f"{torch.equal(atomic[0], atomic[1])} [{card}]", flush=True)
    if len(recs) != EVAL_SCANNET[1] or not (repeats and voters) or not rel <= BUCKET_RTOL:
        raise SystemExit(f"eval_scannet20: a vote does not repeat ({repeats}, {voters}) or bucket {big_cap} "
                         f"disagrees with bucket {small_cap} ({rel})")
    return dict(buckets=[small_cap, big_cap], max_abs_err=err, max_rel_err=rel, repeats_bitwise=repeats,
                voter_bitwise=voters, atomic_max_rel_err=atomic_rel)


def grid_average_cost(card, dev, hcfg, cap) -> dict:
    """Device ms of the 1.5M-point room's grid averages at its bucket
    ``cap``: its raw positions into the level-0 cells, and the level-0
    cloud (capacity rows, most of them padding) into the level-1 cells;
    each with the cells summed in a fixed order (``grid._cell_sums``, what
    the build runs) and by float32 atomics (:func:`atomic_sums`), and
    whether each gives the same bits twice."""
    from se3conv3d_tpu_torch.core import grid
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud

    n, seed = EVAL_ROOMS[-1]
    caps = hcfg.resolve_capacities(cap)
    pos = pad_rows(room_scene(n, seed)["positions"].to(dev, torch.float32)[None], cap)
    pc = PointCloud(positions=pos, mask=torch.arange(cap, device=dev)[None] < n)
    out = {}
    for level, cell in enumerate((hcfg.init_cell_size, hcfg.cell_sizes[0])):
        smap = grid.build_grid_subsample(pc, cell, capacity=caps[level])
        vm, mask = pc.positions * pc.mask[..., None], pc.mask
        s = torch.where(mask, smap.cell_id, torch.zeros_like(smap.cell_id))
        shape = (1, smap.capacity, 3)
        for name, fn in (("ordered", grid._cell_sums), ("atomic", atomic_sums)):
            first, second = fn(vm, s, mask, shape), fn(vm, s, mask, shape)
            out[f"level{level}_{name}"] = dict(ms=cuda_ms(lambda: fn(vm, s, mask, shape), 20),
                                               repeats_bitwise=torch.equal(first, second))
        ordered, atomic = out[f"level{level}_ordered"], out[f"level{level}_atomic"]
        print(f"eval_scannet20: the {n}-point room's level-{level} grid average ({int(mask.sum())} points of "
              f"{mask.shape[1]} rows into {int(smap.n_cells[0])} cells of {smap.capacity}): cells summed in a "
              f"fixed order {ordered['ms']:.4f} ms, repeats bitwise {ordered['repeats_bitwise']}; by float32 "
              f"atomics {atomic['ms']:.4f} ms, repeats bitwise {atomic['repeats_bitwise']} [{card}]", flush=True)
        if not ordered["repeats_bitwise"]:
            raise SystemExit(f"eval_scannet20: the level-{level} grid average does not repeat bitwise")
        pc = PointCloud(positions=smap.subsample(pc.positions), mask=smap.out_mask)
    return out


def whole_scene_forward(card, dev, live_seen) -> dict:
    """The forward kernel at the whole 1.5M-point room's level-0 block conv
    (bucket capacity, bfloat16 as the recipe computes) at that room's live
    fill, each valid edge's source among the live rows, against its plain
    version, with its bound and ``torch.matmul``
    (:func:`forward_vs_plain`); the int32 index ranges of the shape."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.train.evaluate import CAPACITY_BUCKET

    cap = -(-EVAL_ROOMS[-1][0] // CAPACITY_BUCKET) * CAPACITY_BUCKET
    n_live = max(live for live, rows in live_seen if rows == cap)
    shp = (1, cap, cap, 24, 1, 1, 32, 64, 64)
    b, m, n, k, g, f, q, c, o = shp
    ranges = {"B*M*K": b * m * k, "B*N*F*C": b * n * f * c, "B*M*G*O": b * m * g * o}
    args, gout = padded_conv_args(40, shp, n_live, dev, torch.bfloat16)
    del gout
    # as in the room, where the level-0 cloud is both the query and the
    # source: a live point's neighbours are live points
    args[3] = torch.where(args[4], args[3] % n_live, torch.zeros_like(args[3]))
    live = kfe.live_row_table(args[4])
    res = forward_vs_plain(card, "whole_scene_fwd_kernel_vs_plain scannet_1.5M_level0_block_conv", shp, args,
                           live, conv_bounds(shp, args[3], args[4], torch.bfloat16)["fwd"], 70)
    print(f"whole_scene: level-0 live rows {n_live} of {cap}; index ranges {ranges} (int32 limit "
          f"{2**31 - 1}) [{card}]", flush=True)
    if max(ranges.values()) >= 2**31:
        raise SystemExit(f"whole_scene: an index range reaches 2**31: {ranges}")
    del args, live
    torch.cuda.empty_cache()
    return dict(res, shape=shp, live_rows=n_live, index_ranges=ranges)


def run_eval(card, dev, tmp: Path) -> dict:
    """26.-28. The evaluation CLIs on the runs of phases 23-25 (see the
    module docstring)."""
    from se3conv3d_tpu_torch.tasks import test_class, test_seg
    from se3conv3d_tpu_torch.train.checkpoint import CheckpointManager
    from se3conv3d_tpu_torch.train.evaluate import CAPACITY_BUCKET
    from se3conv3d_tpu_torch.utils.scannet_io import SCANNET_CLASS_IDS_20

    out = {}
    # 26. DFaust: the test regime as written (one vote over the 8 test
    # bodies), a 2-checkpoint ensemble
    conf, n_ckpt = EVAL_DFAUST
    log = tmp / "dfaust_log"
    argv = ["--conf_file", str(REPO / conf), "--data_folder", str(tmp / "dfaust"), "--log_folder", str(log),
            "--checkpoints", str(n_ckpt)]
    voter, summary, run = eval_run(card, "eval_dfaust", test_seg, argv, CONVS_PER_FORWARD,
                                   keep=lambda index, n_raw: index == 0)
    calls = run["seen"]["calls"]
    steps = CheckpointManager(str(log / "ckpt")).all_steps()
    if len(steps) < n_ckpt or [c["members"] for c in calls] != [n_ckpt] * len(voter.dataset):
        raise SystemExit(f"eval_dfaust: checkpoints {steps}, members per step {[c['members'] for c in calls]}")
    # the ensemble is the sum of its members: one eval_step per checkpoint
    # (a build of its own, with the voter's seed), and each member alone on
    # the voter's hierarchy of body 0
    first = calls[0]
    members = [CheckpointManager(str(log / "ckpt")).load(s, map_location=dev)["state"]["model"]
               for s in steps[-n_ckpt:][::-1]]
    h, f0, out_pc, _, raw_to_out = first["built"]
    acc, rebuilt = torch.zeros_like(voter.accum[0]), torch.zeros_like(voter.accum[0])
    with torch.no_grad():
        for sd in members:
            voter.trainer.load_member(sd)
            accumulate_direct(acc, {"logits": voter.trainer._forward(h, f0, out_pc), "mask": out_pc.mask,
                                    "out_idx": raw_to_out.chosen_idx}, first["n_raw"])
            gen = torch.Generator(device=dev).manual_seed(0 * 100003 + 0)
            accumulate_direct(rebuilt, voter.trainer.eval_step(first["batch"], gen), first["n_raw"])
    # in float64: the sums of two float32 logits per point
    scale = max(voter.accum[0].abs().max().item(), 1e-30)
    build_err = (voter.accum[0] - rebuilt).abs().max().item() / scale
    rel = (voter.accum[0] - acc).abs().max().item() / scale
    print(f"eval_dfaust: {conf} as written, checkpoints {steps[-n_ckpt:][::-1]} (newest first): mIoU "
          f"{summary['miou']:.4f}; body 0's accumulator (seed {first['seed']}) against the sum of one "
          f"eval_step per checkpoint, each with a build of its own: max_rel_err={build_err:.3e}; against each "
          f"checkpoint alone on its hierarchy: max_rel_err={rel:.3e} (bound 1e-12 each) [{card}]", flush=True)
    if first["seed"] != 0 or not max(rel, build_err) <= 1e-12 or not 0.0 <= summary["miou"] <= 1.0:
        raise SystemExit(f"eval_dfaust: the ensemble is not the sum of its members ({build_err}, {rel}) "
                         f"or mIoU {summary['miou']}")
    out["dfaust"] = dict(summary={k: summary[k] for k in ("miou", "macc", "overall_acc")}, checkpoints=steps,
                         ensemble_max_rel_err=rel, rebuilt_max_rel_err=build_err, **eval_summary(run))
    del voter, members, first, h, f0, out_pc, raw_to_out
    torch.cuda.empty_cache()

    # 27. ModelNet40: SO(3) test rotations, batches of 24 (12 real shapes and
    # 12 copies of the last), two vote epochs in place of the file's 50
    conf, votes = EVAL_MODELNET
    argv = ["--conf_file", str(REPO / conf), "--data_folder", str(tmp / "modelnet"), "--log_folder", str(tmp / "modelnet_log"),
            "--vote_epochs", str(votes)]
    voter, summary, run = eval_run(card, "eval_modelnet40", test_class, argv, MN_CONVS)
    calls = run["seen"]["calls"]
    n_real = len(voter.dataset)
    want = sum(c["logits"][0][:n_real].double() for c in calls).numpy()
    if ([c["clouds"] for c in calls] != [voter.batch_size] * votes or voter.accum.shape != (n_real, MN_CLASSES)
            or not np.array_equal(voter.accum, want) or not 0.0 <= summary["accuracy"] <= 1.0):
        raise SystemExit(f"eval_modelnet40: batches {[c['clouds'] for c in calls]}, accum {voter.accum.shape}, "
                         f"accumulated only the real shapes: {np.array_equal(voter.accum, want)}")
    print(f"eval_modelnet40: {conf} but --vote_epochs {votes} (the file: 50), batch_size {voter.batch_size} "
          f"from the file: {votes} batches of {voter.batch_size} clouds, {n_real} real shapes accumulated; "
          f"accuracy {summary['accuracy']:.4f}, class accuracy {summary['class_accuracy']:.4f} [{card}]", flush=True)
    out["modelnet40"] = dict(summary=summary, cut={"vote_epochs": votes}, **eval_summary(run))
    del voter
    torch.cuda.empty_cache()

    # 28. ScanNet-20: whole rooms of 120,000, 400,000 and 1,500,000 points,
    # PCA frames about z, two vote epochs in place of the file's 30, segment
    # smoothing, the benchmark files
    conf, votes = EVAL_SCANNET
    t0 = time.perf_counter()
    sizes = write_eval_rooms(tmp / "scannet_eval", tmp / "scannet")
    print(f"eval_scannet20: val rooms of {sizes} points (numpy seeds {[s for _, s in EVAL_ROOMS]}) with "
          f"{SEGMENT_VOXEL} m voxel segments written in {time.perf_counter() - t0:.2f} s; {conf} but "
          f"--vote_epochs {votes} (the file: 30) [{card}]", flush=True)
    preds = tmp / "scannet_preds"
    argv = ["--conf_file", str(REPO / conf), "--data_folder", str(tmp / "scannet_eval"), "--log_folder", str(tmp / "scannet_log"),
            "--vote_epochs", str(votes), "--smooth_segments", "--save_output", str(preds)]
    voter, summary, run = eval_run(card, "eval_scannet20", test_seg, argv, SCANNET_CONVS,
                                   keep=lambda index, n_raw: n_raw == EVAL_ROOMS[BUCKET_ROOM][0])
    buckets = sorted(voter.bucket_trainers)
    want_buckets = [-(-n // CAPACITY_BUCKET) * CAPACITY_BUCKET for n, _ in EVAL_ROOMS[1:]]
    if run["bf16_launches"] != run["launches"][0] or buckets != want_buckets:
        raise SystemExit(f"eval_scannet20: bf16 launches {run['bf16_launches']} of {run['launches']}, buckets {buckets}")
    if voter.trainer.eval_hcfg.frames.fixed_axis != 2 or voter.trainer.eval_hcfg.frames.neigh_k != 16:
        raise SystemExit(f"eval_scannet20: frames {voter.trainer.eval_hcfg.frames} are not the test regime's")
    files = []
    for name, n in zip(voter.dataset.file_list, sizes):
        ids = np.loadtxt(preds / f"{name}.txt", dtype=np.int64)
        files.append(int(ids.shape[0]))
        if ids.shape != (n,) or not np.isin(ids, SCANNET_CLASS_IDS_20).all():
            raise SystemExit(f"eval_scannet20: {name}.txt holds {ids.shape} ids, not one ScanNet-20 id per point")
        if not (preds / f"{name}_colored.txt").exists():
            raise SystemExit(f"eval_scannet20: no {name}_colored.txt")
    if not 0.0 <= summary["miou"] <= 1.0:
        raise SystemExit(f"eval_scannet20: mIoU {summary['miou']}")
    seen_share = [float((a.sum(-1) != 0).double().mean()) for a in voter.accum]
    for rec in run["seen"]["calls"]:
        print(f"eval_scannet20: vote seed {rec['seed']} room of {rec['n_raw']} points at capacity {rec['capacity']}: "
              f"{rec['wall_s']:.4f} s (build {rec['build_s']:.4f}, forward {rec['forward_s']:.4f}; "
              f"live_row_table {rec.get('live_rows_calls', 0)} calls {rec.get('live_rows_s', 0.0):.4f} s), "
              f"{rec['n_raw'] / rec['wall_s']:.1f} points/s, peak {rec['peak_gib']:.3f} GiB [{card}]", flush=True)
    acc_s = run["seen"]["accumulate_s"]
    print(f"eval_scannet20: buckets {buckets}; mIoU {summary['miou']:.4f} (segment-smoothed); share of raw points "
          f"with a logit per room {[round(x, 4) for x in seen_share]}; accumulation {[round(x, 4) for x in acc_s]} s; "
          f"label files of {files} lines [{card}]", flush=True)
    consistency = bucket_consistency(card, dev, voter, run["seen"])
    grid_avg = grid_average_cost(card, dev, voter.bucket_trainers[buckets[-1]].eval_hcfg, buckets[-1])
    out["scannet20"] = dict(summary={k: summary[k] for k in ("miou", "macc", "overall_acc")}, buckets=buckets,
                            cut={"vote_epochs": votes}, seen_share=seen_share, accumulate_s=acc_s,
                            bucket_consistency=consistency, grid_average=grid_avg, **eval_summary(run))
    live = run["live"]
    del voter, run
    torch.cuda.empty_cache()
    out["whole_scene_fwd"] = whole_scene_forward(card, dev, live)
    return out


def eval_summary(run) -> dict:
    """What the ``kernels`` line keeps of an eval run: launches, steps,
    times and peaks (no logits, no batches)."""
    calls = [{k: v for k, v in c.items() if k not in ("logits", "batch", "built")} for c in run["seen"]["calls"]]
    return dict(launches=run["launches"], bf16_launches=run["bf16_launches"], forwards=run["forwards"],
                wall_s=run["wall_s"], peak_gib=run["peak_gib"], steps=calls, swap_s=run["seen"]["swap_s"])


# --- the other conv kinds (phases 29-31) -------------------------------------------

# the mlp activations of the kernels other than gelu (phases 29, 31)
MODE_ACTS = ("relu", "sin", "linear")
# phase 29's shapes: name: ((B, M, N, K, G, F, Q, C, O), operand dtypes, pne
# inputs D, hierarchy level whose fill of the DFaust bodies gives the live
# rows per example (None: every row live)): the ScanNet level-0 block conv
# in the equivariant geometry (kD = 9, one frame) and in the standard one
# (kD = 3), fully live; the shapes and the dtype at which phase 31's models
# run the activations: the DFaust level-0 and level-4 convs in the
# equivariant geometry (G = F = 2) and in the standard one, float32, at the
# bodies' fill
ACT_SHAPES = {
    "scannet_level0_block_conv": (SCANNET_SHAPES["scannet_level0_block_conv"], KERNEL_DTYPES, 9, None),
    "scannet_std_level0_block_conv": (SCANNET_SHAPES["scannet_level0_block_conv"], (torch.bfloat16,), 3, None),
    "dfaust_level0_conv": ((BATCH, 4096, 4096, 32, 2, 2, 32, 32, 32), (torch.float32,), 9, 0),
    "dfaust_level4_block_conv": ((BATCH, 128, 128, 32, 2, 2, 32, 256, 256), (torch.float32,), 9, 4),
    "dfaust_std_level0_conv": ((BATCH, 4096, 4096, 32, 1, 1, 32, 32, 32), (torch.float32,), 3, 0),
    "dfaust_std_level4_block_conv": ((BATCH, 128, 128, 32, 1, 1, 32, 256, 256), (torch.float32,), 3, 4),
}
# the kernel-point types: each correlation at P = 13 and (_double) P = 55
KP_TYPES = ("kp_gauss", "kp_linear", "kp_box", "kp_gauss_double", "kp_linear_double", "kp_box_double")
# phase 30's shapes: name: ((B, M, N, K, G, F, Q, C, O), hierarchy level
# whose fill of the DFaust bodies gives the live rows per example (None:
# every row live), operand dtype): the DFaust standard model's level-0 and
# level-4 block shapes in float32 (its recipe's dtype) and the standard
# ScanNet level-0 block conv in bfloat16 (its recipe's)
KP_SHAPES = {
    "dfaust_std_level0_conv": ((BATCH, 4096, 4096, 32, 1, 1, 32, 32, 32), 0, torch.float32),
    "scannet_std_level0_block_conv": (SCANNET_SHAPES["scannet_level0_block_conv"], None, torch.bfloat16),
    "dfaust_std_level4_block_conv": ((BATCH, 128, 128, 32, 1, 1, 32, 256, 256), 4, torch.float32),
}
# the norm_dist of phase 30's kernel points (its offsets are N(0, 0.25))
KP_NORM_DIST = 1.3
# phase 31: the kp types run in full (eval steps, scatter train steps, one
# sorted step, card vs CPU logits), the others for one calibration and one
# train step each
KP_MODEL_TYPES = ("kp_gauss", "kp_linear_double")
KP_EVAL_STEPS, KP_TRAIN_STEPS = 3, 3
# phase 31's plain-path convs on the card against the CPU: name: ConvFactory
# fields (the JAX package runs them in XLA: no Pallas kernel serves them)
PLAIN_KINDS = {
    "mlp_softmax": dict(pne_type="mlp_softmax", equivariant=False),
    "max": dict(aggregation="max", equivariant=False),
    "quaternion": dict(rel_rot_type="quaternion", equivariant=True),
    "matrix": dict(rel_rot_type="matrix", equivariant=True),
}


def conv_kernel_points(pne_type, dev, norm_dist=KP_NORM_DIST):
    """The ``KernelPoints`` of a ``pne_type`` conv on ``dev`` (the points
    and sigma ``PNEConv`` gives it) with the scalar ``norm_dist``."""
    from se3conv3d_tpu_torch.kernels.fused_equiv import KernelPoints
    from se3conv3d_tpu_torch.nn.conv import PNEConv

    conv = PNEConv(1, 1, 1, pne_type, equivariant=False)
    return KernelPoints(conv.kernel_points.to(dev), conv.sigma, conv.corr,
                        torch.tensor(norm_dist, device=dev))


def launches_grew(kfe, before) -> list:
    """The launches by activation and by kernel-point kind (forward,
    backward) since ``before`` (:func:`launch_tables`)."""
    return [{k: n - b.get(k, 0) for k, n in now.items() if n != b.get(k, 0)}
            for now, b in zip(launch_tables(kfe), before)]


def launch_tables(kfe) -> tuple:
    return tuple(dict(getattr(fn, attr)) for attr in ("launches_by_act", "launches_by_kp")
                 for fn in (kfe.fused_equiv_fwd, kfe.fused_equiv_bwd))


def act_conv_kernels(card, dev, fill) -> dict:
    """29. both conv kernels with each activation (gelu, then relu, sin and
    linear, then gelu's kernels timed again) against their plain versions at
    ``ACT_SHAPES`` (ScanNet's in float32 and bfloat16 or bfloat16 alone,
    the DFaust ones, at ``fill[level]`` live rows per example, in float32),
    with the gates and times of phases 2 and 6 (:func:`forward_vs_plain`,
    :func:`backward_vs_plain`); every launch counted at its activation.
    gelu's times, taken in turns with the new ones in this call, are the
    check that the run-time switch cost the recipes' path nothing."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    out = {}
    for i, (name, (shp, dtypes, d, level)) in enumerate(ACT_SHAPES.items()):
        for dt in dtypes:
            args, gout = padded_conv_args(60 + i, shp, None if level is None else fill[level], dev, dt)
            if d == 3:
                args[1], args[5] = None, args[5][:3].contiguous()
            live = kfe.live_row_table(args[4])
            bounds = conv_bounds(shp, args[3], args[4], dt, d=d)
            cases = {}
            for j, act in enumerate(("gelu",) + MODE_ACTS):
                before = launch_tables(kfe)
                opts = dict(act=act)
                cases[act] = dict(
                    fwd=forward_vs_plain(card, f"act_fwd_kernel_vs_plain {name} {act}", shp, args, live,
                                         bounds["fwd"], 100 + j, opts),
                    bwd=backward_vs_plain(card, f"act_bwd_kernel_vs_plain {name} {act}", shp, args, gout,
                                          live, bounds["bwd"], 105 + j, opts))
                grew = launches_grew(kfe, before)
                if grew[0].keys() != {act} or grew[1].keys() != {act} or grew[2] or grew[3]:
                    raise SystemExit(f"phase 29 at {name} {act}: launches by act and kp grew by {grew}")
            with torch.no_grad():
                again_fwd = cuda_ms(lambda: kfe.fused_equiv_fwd(*args, live_rows=live), 20)
            again_bwd = cuda_ms(lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live), 10)
            cases["gelu"].update(fwd_again_ms=again_fwd, bwd_again_ms=again_bwd)
            print(f"act_kernels {name} {dtype_name(dt)}: kernel ms forward / backward (scatter), in turns: "
                  + ", ".join(f"{act} {cases[act]['fwd']['ms']:.4f} / {cases[act]['bwd']['ms']:.4f}"
                              for act in ("gelu",) + MODE_ACTS)
                  + f", gelu again {again_fwd:.4f} / {again_bwd:.4f} [{card}]", flush=True)
            out.setdefault(name, {})[dtype_name(dt)] = cases
            del args, gout, live
            torch.cuda.empty_cache()
    return out


def kp_conv_kernels(card, dev, fill) -> dict:
    """30. both conv kernels' kernel-point instantiation (``kD = kKP``)
    against their plain versions for each of ``KP_TYPES`` at ``KP_SHAPES``
    (the DFaust one at ``fill[level]`` live rows per example), with the
    gates and times of phases 2 and 6: float32 raw offsets, ``proj_axes
    [P, Q]``, the features in the shape's dtype; every launch counted at
    its correlation and P."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    out = {}
    for i, (name, (shp, level, dt)) in enumerate(KP_SHAPES.items()):
        b, m, n, k, g, f, q, c, o = shp
        base, gout = padded_conv_args(70 + i, shp, None if level is None else fill[level], dev, torch.float32)
        for j, pne_type in enumerate(KP_TYPES):
            kp = conv_kernel_points(pne_type, dev)
            p = kp.points.shape[0]
            gen = torch.Generator(device=dev).manual_seed(110 + j)
            args = [base[0], None, base[2].to(dt), base[3], base[4],
                    torch.randn(p, q, device=dev, generator=gen) * 0.3, base[6], base[7]]
            live = kfe.live_row_table(args[4])
            bounds = conv_bounds(shp, args[3], args[4], dt, d=p, kp=True)
            before = launch_tables(kfe)
            opts = dict(act="linear", kp=kp)
            out.setdefault(name, {})[pne_type] = dict(
                fwd=forward_vs_plain(card, f"kp_fwd_kernel_vs_plain {name} {pne_type}", shp, args, live,
                                     bounds["fwd"], 115 + j, opts),
                bwd=backward_vs_plain(card, f"kp_bwd_kernel_vs_plain {name} {pne_type}", shp, args, gout,
                                      live, bounds["bwd"], 125 + j, opts))
            grew = launches_grew(kfe, before)
            if grew[2].keys() != {(kp.corr, p)} or grew[3].keys() != {(kp.corr, p)}:
                raise SystemExit(f"phase 30 at {name} {pne_type}: launches by kp grew by {grew}")
            del args, live
        del base, gout
        torch.cuda.empty_cache()
    return out


def kp_models(card, dev, batch, small) -> dict:
    """31a. ``dfaust_I_standard`` with both conv factories of each kernel-point
    type (B = 32 x 4096, full widths): for ``KP_MODEL_TYPES`` a calibration
    step and ``KP_EVAL_STEPS`` eval steps (21 forward launches per forward),
    card vs CPU logits at B = 2 with their control (:func:`dfaust_model_gates`,
    phase 5's bound), ``KP_TRAIN_STEPS`` train
    steps in scatter mode (21 + 21 launches per step, finite losses, moved BN
    means) and one in sorted mode, whose prefix sums are counted; for the
    other types one calibration and one train step.  Every launch counted at
    its (correlation, P), D = P, the identity activation."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.ops import pne_conv as ops

    model_dict, training = presets.DFAUST_I_STANDARD_MODEL, presets.DFAUST_I_STANDARD_TRAINING
    out = {}
    for pne_type in KP_TYPES:
        kp = conv_kernel_points(pne_type, dev)
        key, p = (kp.corr, kp.points.shape[0]), kp.points.shape[0]
        kind, label, full = dict(pne_type=pne_type), f"dfaust_std_{pne_type}", pne_type in KP_MODEL_TYPES
        run = {}
        if full:
            trainer, run["eval"] = dfaust_eval(card, dev, batch, model_dict, label, kind, KP_EVAL_STEPS)
            check_by_d(f"{label} eval", kfe, CONVS_PER_FORWARD * (1 + KP_EVAL_STEPS), 0, p, 1, "linear", key)
            run["gates"] = dfaust_model_gates(card, dev, trainer, small, label)
            del trainer
            torch.cuda.empty_cache()
        steps = KP_TRAIN_STEPS if full else 1
        trainer, run["train"] = dfaust_train(card, dev, batch, model_dict, training, kind, steps)
        check_by_d(f"{label} train", kfe, CONVS_PER_FORWARD * (1 + steps), CONVS_PER_FORWARD * steps, p, 1,
                   "linear", key)
        run["launches"] = (read_launches(kfe)[0] + (run["eval"]["launches"] if full else 0),
                           read_launches(kfe)[1])
        if full:  # one step in sorted mode: the prefix sum on this path
            reset_launches(kfe, segsum)
            saved = ops.BWD_SCATTER_MODE
            ops.BWD_SCATTER_MODE = "sorted"
            try:
                t0 = time.perf_counter()
                res = trainer.train_step(batch, torch.Generator(device=dev).manual_seed(8))
                torch.cuda.synchronize()
                sorted_s = time.perf_counter() - t0
            finally:
                ops.BWD_SCATTER_MODE = saved
            cums = segsum.blocked_cumsum.launches
            check_by_d(f"{label} sorted step", kfe, CONVS_PER_FORWARD, CONVS_PER_FORWARD, p, 1, "linear", key)
            print(f"{label}: one train step in sorted mode: loss {float(res['loss']):.6f} grad_norm "
                  f"{float(res['grad_norm']):.6f}, {cums} prefix sums, {sorted_s:.4f} s [{card}]", flush=True)
            if not (cums > 0 and np.isfinite(float(res["loss"])) and np.isfinite(float(res["grad_norm"]))):
                raise SystemExit(f"{label}: the sorted step ran no prefix sum or was not finite")
            run["sorted"] = dict(cumsum_launches=cums, step_s=sorted_s,
                                 launches=(CONVS_PER_FORWARD, CONVS_PER_FORWARD))
            run["launches"] = tuple(x + CONVS_PER_FORWARD for x in run["launches"])
        out[pne_type] = run
        del trainer
        torch.cuda.empty_cache()
    return out


def act_models(card, dev, batch, small) -> dict:
    """31b. ``dfaust_I_rot_pca_2F`` (equivariant, G = F = 2, float32) and
    ``dfaust_I_standard`` with both conv factories of each of ``MODE_ACTS``:
    one calibration and one train step each (21 + 21 launches, all at that
    activation, D = 9 or 3), finite, moved BN means; then the trained
    model's gates with their controls (:func:`dfaust_model_gates`): card vs
    CPU logits on two clouds, and the equivariant model's unchanged by a
    global rotation (phase 4's and 5's bounds)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets

    out = {}
    for act in MODE_ACTS:
        kind = dict(pne_type=f"mlp_{act}")
        run = {}
        for geometry, model_dict, training, d, g in (
                ("equivariant", presets.DFAUST_I_ROT_PCA_2F_MODEL, presets.DFAUST_I_ROT_PCA_2F_TRAINING, 9, 2),
                ("standard", presets.DFAUST_I_STANDARD_MODEL, presets.DFAUST_I_STANDARD_TRAINING, 3, 1)):
            trainer, steps = dfaust_train(card, dev, batch, model_dict, training, kind, 1)
            check_by_d(f"mlp_{act} {geometry} train", kfe, 2 * CONVS_PER_FORWARD, CONVS_PER_FORWARD, d, g, act)
            run[geometry] = dict(train=steps, launches=read_launches(kfe),
                                 gates=dfaust_model_gates(card, dev, trainer, small, f"mlp_{act} {geometry}"))
            del trainer
            torch.cuda.empty_cache()
        out[act] = run
    return out


def seed_norms(model, h, f0, out_pc=None) -> None:
    """Every ``MaskedBatchNorm``'s running statistics from its own input (the
    valid rows) in one eval forward of ``model``, each set just before it
    normalises, so the later ones see the earlier ones seeded.  At init
    (mean 0, var 1) each block's conv path reaches the next block far
    smaller than its skip path: the fresh DFaust models' logits vary by
    ~1e-5 over the points, and zeroing a conv moves them by less than the
    card-vs-CPU bound (``PERF.md`` §6).  A degenerate init, as the
    skip gammas' of :func:`seed_gammas` and ``class_norm``'s of
    :func:`seed_class_norm`.  ``out_pc`` None: a model called as
    ``model(h, f0)`` (a ``ClassNet``)."""
    from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm

    def seed(norm, args):
        x, mask = args
        rows = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).expand(*x.shape[:-1], 1).to(x.dtype)
        dims = tuple(range(x.ndim - 1))
        mean = (x * rows).sum(dims) / rows.sum()
        norm.mean.copy_(mean)
        norm.var.copy_((rows * (x - mean) ** 2).sum(dims) / rows.sum())

    hooks = [m.register_forward_pre_hook(seed) for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    try:
        with torch.no_grad():
            model(h, f0) if out_pc is None else model(h, f0, out_pc)
    finally:
        for hook in hooks:
            hook.remove()


@contextlib.contextmanager
def planted_first_conv(model):
    """``model`` with the kernel of its first conv (the farthest from the
    logits) planted wrong while the block runs: another activation (gelu,
    or relu for gelu) or, for kernel points, another correlation.  Yields
    a description of the plant."""
    from se3conv3d_tpu_torch.nn.conv import PNEConv

    conv = next(m for m in model.modules() if isinstance(m, PNEConv))
    attr, wrong = (("corr", "linear" if conv.corr == "gauss" else "gauss") if hasattr(conv, "corr")
                   else ("pne_type", "mlp_relu" if conv.pne_type == "mlp_gelu" else "mlp_gelu"))
    right = getattr(conv, attr)
    setattr(conv, attr, wrong)
    try:
        yield f"the first conv's kernel with {attr} {wrong} for {right}"
    finally:
        setattr(conv, attr, right)


def card_vs_cpu_with_control(card, label, model, inputs, valid=None, cpu_logits=None) -> dict:
    """Card-vs-CPU logits (``CPU_ATOL``) beside a control they must fail:
    the card's logits with the first conv's kernel planted wrong
    (:func:`planted_first_conv`) past the bound from the CPU's.  ``inputs``
    are the card's ``(h, f0[, out_pc])``; ``valid`` the rows compared (all
    where None); ``cpu_logits`` the CPU's logits of ``model`` where already
    computed.  Where the plant does not get past the bound on the model as
    it is (its norms shrink the conv path, as :func:`seed_norms` says), it prints
    that unseeded reading, then gates a copy with every norm seeded from its
    own input (:func:`seed_norms`).  Returns the readings."""
    def readings(m, cpu):
        with torch.no_grad():
            if cpu is None:
                cpu = copy.deepcopy(m).cpu()(*(x.to("cpu") for x in inputs))
            keep = (lambda x: x) if valid is None else (lambda x: x[valid.cpu()])
            base = m(*inputs)
            err = keep((base.cpu() - cpu).abs()).max().item()
            with planted_first_conv(m) as what:
                control = keep((m(*inputs).cpu() - cpu).abs()).max().item()
        return err, control, what, base.abs().max().item()

    err, control, what, scale = readings(model, cpu_logits)
    out = dict(card_vs_cpu_max_abs_err=err, card_vs_cpu_control=control, norms_seeded=False)
    print(f"{label} card_vs_cpu: max |logits(card) - logits(cpu)| = {err:.3e} (bound {CPU_ATOL}); control, {what}: "
          f"{control:.3e}; max |logits| {scale:.3e} [{card}]", flush=True)
    if err <= CPU_ATOL and control <= CPU_ATOL:
        model = copy.deepcopy(model)
        seed_norms(model, *inputs)
        out.update(unseeded_max_abs_err=err, unseeded_control=control, norms_seeded=True)
        err, control, what, scale = readings(model, None)
        out.update(card_vs_cpu_max_abs_err=err, card_vs_cpu_control=control)
        print(f"{label} card_vs_cpu (norms seeded, the control above does not pass the bound): max |logits(card) - "
              f"logits(cpu)| = {err:.3e} (bound {CPU_ATOL}); control, {what}: {control:.3e}; max |logits| "
              f"{scale:.3e} [{card}]", flush=True)
    if not err <= CPU_ATOL < control:
        raise SystemExit(f"{label}: card and CPU logits disagree, or the bound does not tell a wrong kernel")
    return out


def dfaust_model_gates(card, dev, trainer, small, label) -> dict:
    """31d. phase 31's model gates, each with a control that a wrong result
    fails, on a copy of ``trainer``'s model with its norms seeded
    (:func:`seed_norms`) on the two clouds of ``small``: an equivariant
    model's logits unchanged by a global rotation of the hierarchy
    (``ROT_ATOL``), and changed past it when the positions are rotated and
    the frames are not; the card's logits within ``CPU_ATOL`` of the CPU's
    (plain path), and the card's with the kernel of the first conv (the
    farthest from the logits) planted wrong, another activation (gelu, or
    relu for gelu) or correlation, past it.  Before the norms are seeded it prints how far
    that planted kernel moves the logits of the model as it is (the
    reading that calls for the seeding).  Returns the readings."""
    from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.core.rotation import random_rotations

    model = copy.deepcopy(trainer.model).eval()
    h, f0, out_pc, _, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(5), train=False)
    valid, out = out_pc.mask, {}

    @torch.no_grad()
    def planted():
        with planted_first_conv(model) as what:
            return model(h, f0, out_pc), what

    with torch.no_grad():  # the norms as the model has them: what the control moves there
        base = model(h, f0, out_pc)
        out["unseeded_logits_std_over_points"] = (base[valid].std(0).mean().item())
        wrong, what = planted()
        out["unseeded_control"] = (wrong - base).abs()[valid].max().item()
    print(f"{label} norms as trained: logits std over the points {out['unseeded_logits_std_over_points']:.3e}; "
          f"{what} moves them by {out['unseeded_control']:.3e} [{card}]", flush=True)
    seed_norms(model, h, f0, out_pc)
    with torch.no_grad():
        base = model(h, f0, out_pc)
        out["logits_std_over_points"] = spread = base[valid].std(0).mean().item()
        if model.spec.equivariant:
            rot = random_rotations(1, generator=torch.Generator().manual_seed(6))[0].to(dev)
            rotated = model(rotate_hierarchy(h, rot), f0, rotate_cloud(out_pc, rot))
            unframed = model(Hierarchy(tuple(PointCloud(pc.positions @ rot.T, pc.mask, pc.frames)
                                             for pc in h.levels), h.maps, h.levels_radii), f0,
                             PointCloud(out_pc.positions @ rot.T, out_pc.mask, out_pc.frames))
            out["rotation_max_abs_err"] = rot_err = (base - rotated).abs()[valid].max().item()
            out["rotation_control"] = rot_control = (base - unframed).abs()[valid].max().item()
            print(f"{label} invariance (norms seeded): max |logits - logits(rotated)| = {rot_err:.3e} (bound "
                  f"{ROT_ATOL}); control, the positions rotated and the frames not: {rot_control:.3e} [{card}]",
                  flush=True)
            if not rot_err <= ROT_ATOL < rot_control:
                raise SystemExit(f"{label}: logits change under a global rotation, or the bound does not tell "
                                 "a model that ignores the frames' rotation")
        cpu_logits = copy.deepcopy(model).cpu()(h.to("cpu"), f0.cpu(), out_pc.to("cpu"))
        out["card_vs_cpu_max_abs_err"] = err = (base.cpu() - cpu_logits).abs()[valid.cpu()].max().item()
        out["card_vs_cpu_control"] = control = (planted()[0].cpu() - cpu_logits).abs()[valid.cpu()].max().item()
    print(f"{label} card_vs_cpu (norms seeded): max |logits(card) - logits(cpu)| = {err:.3e} (bound {CPU_ATOL}); "
          f"control, {what}: {control:.3e}; max |logits| "
          f"{base.abs().max().item():.3e}, std over the points {spread:.3e} [{card}]", flush=True)
    if not err <= CPU_ATOL < control:
        raise SystemExit(f"{label}: card and CPU logits disagree, or the bound does not tell a wrong kernel")
    return out


def plain_kinds_card_vs_cpu(card, dev) -> dict:
    """31c. one conv of each of ``PLAIN_KINDS`` (the JAX package's XLA path:
    ``mlp_softmax``, 'max' aggregation, quaternion and matrix rotations; no
    Pallas kernel serves them, and the port runs them in PyTorch ops, not as
    a fallback) on the card against the same conv on the CPU: 2 clouds of
    2,048 sources and 1,024 queries (two random frames per point where
    equivariant), kNN 16, C = O = 32, Q = 32; a calibration pass, the
    forward within ``KERNEL_RTOL`` of its largest value (float32 sums in
    other orders) and the parameter gradients within ``GRAD_RTOL`` per leaf;
    no conv kernel launched."""
    from se3conv3d_tpu_torch.core.neighborhoods import knn_neighborhood
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.core.rotation import random_rotations
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.nn.conv import ConvFactory
    from se3conv3d_tpu_torch.train import schedule

    gen = torch.Generator().manual_seed(140)
    out = {}
    for name, kind in PLAIN_KINDS.items():
        f = 2 if kind["equivariant"] else 0

        def cloud(n):
            frames = random_rotations(2 * n * f, generator=gen).reshape(2, n, f, 3, 3) if f else None
            return PointCloud(torch.rand(2, n, 3, generator=gen) * 2.0, torch.ones(2, n, dtype=torch.bool),
                              frames)

        pc_in, pc_out = cloud(2048), cloud(1024)
        feats = torch.randn((2, 2048, f, 32) if f else (2, 2048, 32), generator=gen)
        conv = ConvFactory(**kind).make(32, 32)
        conv.reset_parameters(gen)
        sides = {}
        before = read_launches(kfe)
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            c = copy.deepcopy(conv).to(d)
            src, dst = pc_in.to(d), pc_out.to(d)
            neigh = knn_neighborhood(src, dst, 16)
            x = feats.to(d).requires_grad_()
            with torch.no_grad():
                c(src, dst, x, neigh, calibrate=True)
            y = c(src, dst, x, neigh)
            (y * torch.cos(y)).sum().backward()
            sides[where] = (y.detach().cpu(), {n: q.grad.cpu() for n, q in c.named_parameters()})
        if conv.fused or read_launches(kfe) != before:
            raise SystemExit(f"plain kind {name}: took the kernel path")
        err = max_rel_err(sides["card"][0], sides["cpu"][0])
        norm = float(schedule.global_norm(list(sides["cpu"][1].values())))
        worst, worst_name = grads_ratio(sides["card"][1], sides["cpu"][1], norm)
        print(f"plain_kind {name}: max |out(card) - out(cpu)| = {err[0]:.3e}, relative {err[1]:.3e} (bound "
              f"{KERNEL_RTOL}); parameter gradients worst {worst:.3e} at {worst_name} (bound {GRAD_RTOL}) "
              f"[{card}]", flush=True)
        if not (err[1] <= KERNEL_RTOL and worst <= GRAD_RTOL):
            raise SystemExit(f"plain kind {name}: card and CPU disagree")
        out[name] = dict(max_abs_err=err[0], max_rel_err=err[1], grads_ratio=worst)
    return out


def run_modes(card, dev, batch, small, fill) -> dict:
    """29.-31. the other conv kinds: their kernels, then their models;
    ``fill``: the live rows per level of ``batch`` (the DFaust standard and
    equivariant recipes subsample alike)."""
    return dict(act_conv=act_conv_kernels(card, dev, fill), kp_conv=kp_conv_kernels(card, dev, fill),
                kp_models=kp_models(card, dev, batch, small), act_models=act_models(card, dev, batch, small),
                plain_kinds=plain_kinds_card_vs_cpu(card, dev))


def mode_entries(modes: dict) -> list:
    """The ``{"kernels": [...]}`` entries of the activations and of the
    kernel-point geometry (phases 29-31): per kernel, activation and
    correlation, its launches on phase 31's model paths and its times at
    the first of its shapes (float32), the others under ``"by_case"``."""
    ack, kpk, acm, kpm = modes["act_conv"], modes["kp_conv"], modes["act_models"], modes["kp_models"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    src = {kind: f"se3conv3d_tpu_torch/kernels/csrc/fused_equiv_{kind}.cu" for kind in ("fwd", "bwd")}
    tpu = {"fwd": "se3conv3d_tpu/ops/pallas/fused_equiv.py:196", "bwd": "se3conv3d_tpu/ops/pallas/fused_equiv.py:227"}
    lib = {"fwd": "library_ms", "bwd": "products_library_ms"}
    lvl0 = SCANNET_SHAPES["scannet_level0_block_conv"]
    entries = []
    for kind, which in (("fwd", 0), ("bwd", 1)):
        for act in MODE_ACTS:
            cases = {f"{name} {dt}": c[act][kind] for name, by_dt in ack.items() for dt, c in by_dt.items()}
            gelu = {f"{name} {dt}": {k: c["gelu"][kind][k] for k in ("ms", "plain_ms")}
                    | {"again_ms": c["gelu"][f"{kind}_again_ms"]} for name, by_dt in ack.items()
                    for dt, c in by_dt.items()}
            every = {f"dfaust_{g}_mlp_{act}_train": acm[act][g]["launches"][which]
                     for g in ("equivariant", "standard")}
            top = cases["scannet_level0_block_conv float32"]
            entries.append({
                "name": f"fused_equiv_{kind}[act={act}]", "route": "cuda", "source": src[kind],
                "replaces": tpu[kind], "launches": sum(every.values()), "launches_by_path": every,
                **{k: top[k] for k in keys}, "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                "library_ms": top[lib[kind]], "at": f"scannet level-0 block conv B,M,N,K,G,F,Q,C,O={lvl0}, "
                "kD = 9, float32", "by_case": cases, "gelu_same_call": gelu})
        for corr in ("gauss", "linear", "box"):
            types = (f"kp_{corr}", f"kp_{corr}_double")
            cases = {f"{name} {t}": by_t[t][kind] for name, by_t in kpk.items() for t in types}
            every = {f"dfaust_std_{t}": kpm[t]["launches"][which] for t in types}
            top = cases[f"dfaust_std_level0_conv kp_{corr}"]
            entries.append({
                "name": f"fused_equiv_{kind}[kp={corr}]", "route": "cuda", "source": src[kind],
                "replaces": tpu[kind], "launches": sum(every.values()), "launches_by_path": every,
                **{k: top[k] for k in keys}, "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                "library_ms": top[lib[kind]], "at": f"dfaust standard level-0 shape "
                f"B,M,N,K,G,F,Q,C,O={KP_SHAPES['dfaust_std_level0_conv'][0]} at the bodies' fill, P = 13, "
                "float32", "by_case": cases})
    return entries


# phase 32: the probe kernels of experiments/chip_stage_time.py,
# bisect_fused.py and chip_stream.py.  The staged forward's scalars against
# its plain version, relative to the sum of their terms' magnitudes (a sum
# of ~1e8 values that cancel): float32 sums in other orders; bfloat16 may
# flip a rounding by one ulp (with the control of tells_apart).  The stage
# tensors and b1-b5 at bisect_fused.RTOL of max |plain|, and the whole
# forward's [G, M, O] output of tile-sum mode at M = 65,536 value by value
# as the conv kernels' (KERNEL_RTOL; bfloat16 at BF16_RTOL, BF16_MEAN_RTOL
# and tells_apart); the column sums per column against a float64 sum,
# relative to the column's sum of |x|
PROBE_SCALAR_RTOL = {torch.float32: 1e-6, torch.bfloat16: 1e-5}
STREAM_RTOL = 1e-6
PROBE_SRC = "se3conv3d_tpu_torch/kernels/csrc/probe_{}.cu"
# the JAX scripts' default sizes: chip_stage_time's M and TM, chip_stream's M
PROBE_M, PROBE_TM = 65536, 64


def probe_bound(work: dict, dtype=torch.float32, tensor_cores: bool = False) -> dict:
    """Least time of a probe kernel: the larger of bytes / HBM rate and
    FLOPs / peak (float32: ``product_flops`` at the 3xTF32 ceiling, a third
    of the TF32 peak, and ``fma_flops`` at the float32 peak, or at the
    3xTF32 ceiling too where ``tensor_cores``: the tile-sum forward runs its
    pne and aggregation products there; bfloat16: every FLOP at the dense
    bf16 peak, as :func:`conv_bounds`)."""
    fma, prod = work.get("fma_flops", 0.0), work.get("product_flops", 0.0)
    if dtype == torch.bfloat16:
        t_ops = (fma + prod) / PEAK_BF16_FLOPS
    elif tensor_cores:
        t_ops = (fma + prod) / (PEAK_TF32_FLOPS / 3)
    else:
        t_ops = fma / PEAK_F32_FLOPS + prod / (PEAK_TF32_FLOPS / 3)
    t_bytes = work["bytes"] / PEAK_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes")


def mosaic_fma_bound_ms(work: dict) -> float:
    """A Mosaic product probe's bound as an FMA kernel would have it: its
    product FLOPs at the float32 FMA peak, or its bytes, whichever is
    larger (printed beside the tensor-core bound of :func:`probe_bound`)."""
    return max(work.get("product_flops", 0.0) / PEAK_F32_FLOPS, work["bytes"] / PEAK_BYTES_PER_S) * 1e3


def probe_main_path(card) -> dict:
    """32a. the three probe entry points as a user runs them, every launch
    counter at 0 before and read after: ``chip_stage_time`` for each stage
    in float32 and in bfloat16 (``CDT=bf16``) at its default M and TM,
    ``bisect_fused`` with every probe, ``chip_stream``.  Fails if a probe
    failed or a kernel of the path was not launched."""
    from se3conv3d_tpu_torch.experiments import bisect_fused, chip_stage_time, chip_stream
    from se3conv3d_tpu_torch.kernels import probes

    counters = (probes.stage_sum, probes.stage_forward, probes.gelu_jvp, probes.expand_groups,
                probes.batched_contract, probes.rank3_accum, probes.merge_back, probes.column_sums)
    for fn in counters:
        fn.launches = 0
        if hasattr(fn, "launches_by"):
            fn.launches_by.clear()
    split = {}
    for dt, env in (("float32", {}), ("bfloat16", {"CDT": "bf16"})):
        split[dt] = {stage: chip_stage_time.main([stage], env=env) for stage in chip_stage_time.STAGES}
    failed = bisect_fused.main([])
    rates = chip_stream.main()
    launches = {fn.__name__: fn.launches for fn in counters}
    by = {fn.__name__: {str(k): v for k, v in fn.launches_by.items()} for fn in counters
          if hasattr(fn, "launches_by")}
    want_by = {"stage_sum": [f"('{s}', '{dt}')" for s in ("pne", "agg", "swap", "reduce")
                             for dt in ("float32", "bfloat16")],
               "stage_forward": ["pne", "agg", "swap", "wcontract", "reduce", "reduce[batch]"],
               "column_sums": ["64", "19", "128"]}
    missing = [k for k, v in launches.items() if v == 0]
    missing += [f"{name}[{k}]" for name, keys in want_by.items() for k in keys if not by[name].get(k)]
    print(f"probes main path: launches {launches}, by {by}; bisect_fused failures {failed} [{card}]", flush=True)
    if failed or missing:
        raise SystemExit(f"phase 32: bisect_fused failures {failed}, kernels not launched {missing}")
    return dict(split=split, rates=rates, launches=launches, launches_by=by)


def probe_stage_cases(card, dev) -> dict:
    """32b. the staged forward in tile-sum mode at ``chip_stage_time``'s
    size, every stage, float32 and bfloat16: kernel vs plain (bfloat16 with
    its no-rounding control), the whole forward's ``[G, M, O]`` output also
    value by value (``KERNEL_RTOL``; bfloat16 at the kernels' bounds and
    under half its control's mean error), two calls bitwise equal, times beside the
    bound (every product on tensor cores) and, for the whole forward,
    ``torch.matmul`` for its weight contraction, the instantiation's
    registers, spills, shared memory and blocks an SM, and the bytes of W it
    reads from L2 (:func:`probes.stage_w_l2_bytes`, from the tiling).
    Kernel times are device ms per call from a CUDA graph
    (:func:`graph_ms`), the one-call CUDA-event time with its host time
    beside them (``call_ms``)."""
    from se3conv3d_tpu_torch.experiments import chip_stage_time as cst
    from se3conv3d_tpu_torch.kernels import probes

    args = cst.make_inputs(PROBE_M, 32, dev)
    side = torch.cuda.Stream(dev)
    cases = {}
    for dtype in KERNEL_DTYPES:
        dt = dtype_name(dtype)
        cases[dt] = {}
        for stage, kstage in cst.STAGES.items():
            with torch.no_grad():
                fwd = (torch.empty(cst.G, PROBE_M, cst.O, device=dev) if kstage == "reduce" else None)
                got = probes.stage_sum(*args, stage=kstage, cdt=dtype, out=fwd)
                again = probes.stage_sum(*args, stage=kstage, cdt=dtype)
                ref_t = probes.stage_forward_reference(*args[:3], args[3], None, kstage, dtype)
                terms = float(ref_t.double().abs().sum())
                ref = ref_t.sum()
                ref_f32 = (probes.stage_forward_reference(*args[:3], args[3], None, kstage)
                           if dtype == torch.bfloat16 else ref_t)
                err = abs(float(got) - float(ref))
                control = (abs(float(got) - float(ref_f32.sum())) / terms if dtype == torch.bfloat16 else None)
                fwd_err = fwd_control = None
                if fwd is not None:  # the [G, M, O] output, each value
                    fwd_err = max_rel_err(fwd, ref_t)
                    fwd_control = max_rel_err(fwd, ref_f32)[2] if dtype == torch.bfloat16 else None
                del ref_t, ref_f32, fwd
                same = torch.equal(got, again)
                ms = graph_ms(lambda: probes.stage_sum(*args, stage=kstage, cdt=dtype), side)
                call_ms = cuda_ms(lambda: probes.stage_sum(*args, stage=kstage, cdt=dtype), 10)
                plain_ms = cuda_ms(lambda: probes.stage_sum_reference(*args, stage=kstage, cdt=dtype), 3)
            lib_ms = None
            if stage == "full":  # torch.matmul for out[g] = basis_b[g] [M, Q*C] . W[g] [Q*C, O]
                gen = torch.Generator(device=dev).manual_seed(33)
                basis = torch.randn(cst.G, PROBE_M, cst.Q * cst.C, device=dev, generator=gen).to(dtype)
                w2 = args[3].reshape(cst.G, cst.Q * cst.C, cst.O).to(dtype)
                lib_ms = cuda_ms(lambda: torch.matmul(basis, w2), 10)
                del basis, w2
            bound = probe_bound(cst.stage_work(stage, PROBE_M), dtype, tensor_cores=True)
            attrs = probes.stage_kernel_attributes(kstage, True, dtype)
            w_l2 = probes.stage_w_l2_bytes(1, PROBE_M, dtype) if kstage == "reduce" else 0
            rel = err / terms
            print(f"probe_stage_fwd tile-sum {stage} {dt} M={PROBE_M}: |kernel - plain| = {err:.4e} "
                  f"({rel:.3e} of sum |terms| {terms:.4e}, bound {PROBE_SCALAR_RTOL[dtype]:g}"
                  + (f"; {control_text(rel, control)}" if control is not None else "")
                  + ")" + (f"; the [G, M, O] output: max_abs_err={fwd_err[0]:.3e} max_rel_err={fwd_err[1]:.3e} "
                           f"mean_rel_err={fwd_err[2]:.3e} ({bound_text(dtype, KERNEL_RTOL)}"
                           + (f"; mean_rel_err {control_text(fwd_err[2], fwd_control)}" if fwd_control is not None else "")
                           + ")" if fwd_err else "")
                  + f"; two calls bitwise equal: {same}; kernel_ms={ms:.4f} (device, one call with its host "
                  f"time {call_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']})"
                  + (f"; torch.matmul {dt} for the weight contraction {lib_ms:.4f} ms" if lib_ms else "")
                  + f"; {attrs['registers']} registers, {attrs['local_bytes']} local bytes, "
                  f"{attrs['dynamic_smem']} bytes of shared memory, {attrs['blocks_per_sm']} block(s) an SM"
                  + (f"; W read from L2 {w_l2 / 2**30:.3f} GiB" if w_l2 else "") + f" [{card}]", flush=True)
            fwd_ok = fwd_err is None or (within(fwd_err, dtype, KERNEL_RTOL)
                                         and (fwd_control is None or tells_apart(fwd_err[2], fwd_control)))
            if not (bool(torch.isfinite(got)) and same and rel <= PROBE_SCALAR_RTOL[dtype]
                    and (control is None or tells_apart(rel, control)) and fwd_ok):
                raise SystemExit(f"phase 32: the staged forward disagrees with its plain version at {stage} {dt}")
            cases[dt][stage] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err, rel_err=rel, terms=terms,
                                    control_rel_err=control, library_ms=lib_ms, attributes=attrs,
                                    w_l2_bytes=w_l2, **bound)
            if fwd_err is not None:
                cases[dt][stage].update(out_max_abs_err=fwd_err[0], out_max_rel_err=fwd_err[1],
                                        out_mean_rel_err=fwd_err[2], out_control_mean_rel_err=fwd_control)
    del args
    torch.cuda.empty_cache()
    return cases


# bisect_fused's probes with no single PyTorch call for the same function,
# and why (printed where the library time would stand)
BISECT_NO_LIBRARY = {
    "s1_pne": "pne = gelu(geo . proj + bias) takes a product, the bias and a GELU: no one call",
    "s2_agg": "the aggregation needs pne first (a product and a GELU), then a batched product: no one call",
    "s3_swap": "pne, the aggregation and the relayout to [GQ, M, C]: no one call",
    "b1_jvp_gelu": "gelu(a) + gelu'(a): no PyTorch call gives a GELU and its derivative together; "
                   "F.gelu(a, approximate='tanh'), the same bytes with one tanh an element, timed as yardstick_ms",
    "b4_rank3_accum": "column sums broadcast to [GQ, C, O]: torch.sum, then a copy of the broadcast "
                      "(the two calls timed as yardstick_ms)",
}
# b4's two-call yardstick: the column sums, then a copy of their broadcast;
# b1's: the GELU alone (the floor a fused b1 can reach)
BISECT_YARDSTICK = {
    "b4_rank3_accum": lambda a, gq, c, o: torch.sum(a, 0)[None, :, None].expand(gq, c, o).contiguous(),
    "b1_jvp_gelu": lambda a, *shape: torch.nn.functional.gelu(a, approximate="tanh"),
}
# b1's per-element bound over gelu_jvp_sweep: |kernel - ref| <=
# GELU_JVP_SWEEP_RTOL (1 + |ref|), ref the float64 gelu + gelu'
GELU_JVP_SWEEP_RTOL = 1e-6


def gelu_jvp_sweep(device) -> torch.Tensor:
    """float32 points that b1's kernel is held to one by one: [-20, 20] in
    400,000 steps, +-1e4 and signed zeros (400,004 values, a multiple of 4)."""
    x = torch.linspace(-20.0, 20.0, 400_000, dtype=torch.float64)
    return torch.cat([x, torch.tensor([1e4, -1e4, 0.0, -0.0], dtype=torch.float64)]).float().to(device)


def gelu_jvp_sweep_error(got: torch.Tensor, x: torch.Tensor) -> float:
    """max |got - ref| / (1 + |ref|) over ``x``, ref ``gelu(x) + gelu'(x)``
    (tanh form) in float64 numpy on the host; inf where ``got`` is not
    finite."""
    k, c = math.sqrt(2.0 / math.pi), 0.044715
    xd = x.detach().double().cpu().numpy()
    t = np.tanh(k * (xd + c * xd ** 3))
    ref = 0.5 * (1.0 + t) * (xd + 1.0) + xd * 0.5 * (1.0 - t * t) * k * (1.0 + 3.0 * c * xd * xd)
    g = got.detach().double().cpu().numpy()
    return float((np.abs(g - ref) / (1.0 + np.abs(ref))).max()) if np.isfinite(g).all() else float("inf")
# the stages that end in the weight contraction: their library time is the
# contraction alone (torch.bmm of a [GQ, MP, C] basis with W)
BISECT_PRODUCT_ALONE = ("s4_wcontract", "s5_reduce", "s6_vmap")


def bisect_stage_bounds(stage: str, mp: int, gd: int, written: int) -> dict:
    """A ``bisect_fused`` stage's bound in whole-tensor mode: its inputs
    read once (the bias too), its tensor written once, every product FLOP
    (pne, the aggregation, the weight contraction) at the 3xTF32 ceiling,
    where the kernel runs them (``bound_ms``); ``bound_fma_ms`` beside it is
    the bound of a design that runs pne and the aggregation on the float32
    FMA units, at their peak."""
    from se3conv3d_tpu_torch.kernels import probes

    work = probes.stage_work(stage, mp, gd, written)
    work["bytes"] += 4.0 * probes.STAGE_GQ
    return dict(**probe_bound(work, tensor_cores=True), bound_fma_ms=probe_bound(work)["bound_ms"])


def probe_bisect_cases(card, dev) -> dict:
    """32c. ``bisect_fused``'s stage tensors at MP = 1024 (s1-s6) and the
    backward blocks b1-b5 at its shapes: kernel vs plain, two calls
    bitwise equal (b4: the block partials added in a fixed order), times
    beside the bound (the stages on tensor cores, :func:`bisect_stage_bounds`,
    with the FMA bound beside it) and the one PyTorch call that computes
    the same function where there is one (s4-s6: the weight contraction
    alone as ``torch.bmm``), or why there is none
    (:data:`BISECT_NO_LIBRARY`; b4 and b1 with their yardsticks,
    :data:`BISECT_YARDSTICK`); b1 also value by value over
    :func:`gelu_jvp_sweep` against float64 (:data:`GELU_JVP_SWEEP_RTOL`)."""
    from se3conv3d_tpu_torch.experiments import bisect_fused as bf
    from se3conv3d_tpu_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(39)
    basis = torch.randn(bf.GQ, bf.MP, bf.C, device=dev, generator=gen)
    library = {"b2_gexp": lambda a: a.repeat_interleave(bf.Q, 0),
               "b3_dw2_contract11": lambda a, b: torch.bmm(a.transpose(1, 2), b),
               "b5_merge_back": lambda a: torch.mul(a, 2.0),
               **{name: (lambda *xs: torch.bmm(basis, xs[4])) for name in BISECT_PRODUCT_ALONE}}
    kstage = {"s1_pne": "pne", "s2_agg": "agg", "s3_swap": "swap", "s4_wcontract": "wcontract",
              "s5_reduce": "reduce", "s6_vmap": "reduce"}
    side = torch.cuda.Stream(dev)
    cases = {}
    for i, name in enumerate(bf.STAGES):
        inputs = bf.draw(name, 40 + i, dev)
        fn, plain = bf.STAGES[name], bf.REFERENCES[name]
        with torch.no_grad():
            got, again = fn(*inputs), fn(*inputs)
            ref = plain(*inputs)
            torch.cuda.synchronize()
            try:
                rel = bf.check(got, ref)
            except ValueError as e:
                raise SystemExit(f"phase 32: {name} disagrees with its plain version: {e}")
            err, same = float((got - ref).abs().max()), torch.equal(got, again)
            ms, call_ms = graph_ms(lambda: fn(*inputs), side), cuda_ms(lambda: fn(*inputs), 20)
            plain_ms = cuda_ms(lambda: plain(*inputs), 5)
            lib_ms = graph_ms(lambda: library[name](*inputs), side) if name in library else None
            yard_ms = (graph_ms(lambda: BISECT_YARDSTICK[name](*inputs, *got.shape), side)
                       if name in BISECT_YARDSTICK else None)
        nin = sum(x.numel() for x in inputs)
        fma_ms = None
        if name in kstage:  # the stage's inputs read once (bias too), its tensor written once
            bound = bisect_stage_bounds(kstage[name], bf.MP, bf.GD, got.numel())
            fma_ms = bound.pop("bound_fma_ms")
        elif name == "b3_dw2_contract11":  # on tensor cores, 3xTF32
            gq, r, c = inputs[0].shape
            bound = probe_bound({"product_flops": 2.0 * gq * r * c * inputs[1].shape[2],
                                 "bytes": 4.0 * (nin + got.numel())})
        else:  # elementwise and copies: bytes
            bound = probe_bound({"bytes": 4.0 * (nin + got.numel())})
        if lib_ms is not None:
            lib_text = (f"; the weight contraction alone (torch.bmm, the product alone) {lib_ms:.4f} ms"
                        if name in BISECT_PRODUCT_ALONE else f"; one PyTorch call {lib_ms:.4f} ms")
        else:
            lib_text = f"; no single PyTorch call: {BISECT_NO_LIBRARY[name]}"
        if yard_ms is not None:
            lib_text += f"; yardstick_ms {yard_ms:.4f}"
        if name == "b1_jvp_gelu":  # each value of the sweep against float64
            sweep = gelu_jvp_sweep(dev)
            sweep_err = gelu_jvp_sweep_error(fn(sweep), sweep)
            lib_text += (f"; over {sweep.numel()} points of [-20, 20] and +-1e4 {sweep_err:.3e} of 1 + |float64| "
                         f"(bound {GELU_JVP_SWEEP_RTOL:g})")
            if sweep_err > GELU_JVP_SWEEP_RTOL:
                raise SystemExit(f"phase 32: b1 is {sweep_err:.3e} of 1 + |ref| off float64 over the sweep")
        print(f"probe {name}: shape {tuple(got.shape)} max_abs_err={err:.3e} max_rel_err={rel:.3e} (bound "
              f"{bf.RTOL:g}); two calls bitwise equal: {same}; kernel_ms={ms:.4f} (device, one call with its host "
              f"time {call_ms:.4f}) plain_ms={plain_ms:.4f} "
              f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']}"
              + (f", tensor cores; FMA bound {fma_ms:.4f}, {100 * bound['bound_ms'] / ms:.1f}% of the bound reached"
                 if fma_ms is not None else "") + ")"
              + lib_text + f" [{card}]", flush=True)
        if not same:
            raise SystemExit(f"phase 32: {name} gave other bits on a second call")
        cases[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err, max_rel_err=rel,
                           library_ms=lib_ms, **bound)
        if fma_ms is not None:
            cases[name]["bound_fma_ms"] = fma_ms
        if lib_ms is None:
            cases[name]["no_library"] = BISECT_NO_LIBRARY[name]
        if yard_ms is not None:
            cases[name]["yardstick_ms"] = yard_ms
    del basis
    torch.cuda.empty_cache()
    return cases


def probe_stream_cases(card, dev) -> dict:
    """32d. the column sums of ``chip_stream``'s three arrays (feat as
    ``[M*E, 64]``, the ``[M*E, 19]`` and ``[M*E, 128]`` tables): each column
    against a float64 sum, the total, two calls bitwise equal, the read rate
    and its share of the nominal 3.35 TB/s beside ``torch.sum`` over the
    rows (the same column sums, one PyTorch call); and ``sum_feat`` against
    ``C * sum(x[..., C-1])``, what the JAX ``pallas_sum_feat`` returns."""
    from se3conv3d_tpu_torch.experiments import chip_stream
    from se3conv3d_tpu_torch.kernels import probes

    feat, geo, geo128 = chip_stream.make_inputs(chip_stream.M, 50, dev)
    side = torch.cuda.Stream(dev)
    cases = {}
    for name, x in (("feat", feat.reshape(-1, chip_stream.C)), ("geo19", geo), ("geo128", geo128)):
        width = x.shape[1]
        got, again = probes.column_sums(x), probes.column_sums(x)
        ref, terms = x.double().sum(0), x.double().abs().sum(0)
        col_err = float(((got[:width].double() - ref).abs() / terms).max())
        tot_err = abs(float(got[width]) - float(ref.sum())) / float(terms.sum())
        same = torch.equal(got, again)
        ms, call_ms = graph_ms(lambda: probes.column_sums(x), side), cuda_ms(lambda: probes.column_sums(x), 20)
        plain_ms = cuda_ms(lambda: probes.column_sums_reference(x), 5)
        lib_ms = graph_ms(lambda: torch.sum(x, 0), side)
        nbytes = 4.0 * x.numel()
        bound = probe_bound({"bytes": nbytes})
        rate, lib_rate = nbytes / ms / 1e6, nbytes / lib_ms / 1e6
        print(f"probe column_sums {name} [{x.shape[0]}, {width}]: max column error {col_err:.3e} of its sum "
              f"|x|, total {tot_err:.3e} (bound {STREAM_RTOL:g}); two calls bitwise equal: {same}; "
              f"kernel_ms={ms:.4f} (device; {rate:.1f} GB/s, {rate * 1e9 / PEAK_BYTES_PER_S:.1%} of 3.35 TB/s; "
              f"one call with its host time {call_ms:.4f}) "
              f"plain_ms={plain_ms:.4f} bound_ms={bound['bound_ms']:.4f}; torch.sum over the rows "
              f"{lib_ms:.4f} ms ({lib_rate:.1f} GB/s, {lib_rate * 1e9 / PEAK_BYTES_PER_S:.1%}) [{card}]", flush=True)
        if not (same and col_err <= STREAM_RTOL and tot_err <= STREAM_RTOL):
            raise SystemExit(f"phase 32: the column sums of {name} disagree with float64 or repeat other bits")
        cases[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           max_abs_err=float((got[:width].double() - ref).abs().max()),
                           max_rel_err=col_err, library_ms=lib_ms, gb_s=rate, library_gb_s=lib_rate, **bound)
    c = chip_stream.C
    last = feat[..., -1].double()
    got = float(chip_stream.sum_feat(feat))
    err = abs(got - c * float(last.sum())) / (c * float(last.abs().sum()))
    print(f"probe sum_feat: C * sum(x[..., C-1]) within {err:.3e} of its terms (bound {STREAM_RTOL:g}) [{card}]",
          flush=True)
    if err > STREAM_RTOL:
        raise SystemExit("phase 32: sum_feat is not C * sum(x[..., C-1])")
    del feat, geo, geo128
    torch.cuda.empty_cache()
    return cases


def probe_registers(card) -> dict:
    """32e. registers, local (stack and spill) bytes and shared memory of
    every instantiation of the staged forward (``cudaFuncGetAttributes``,
    the counterpart of ``-Xptxas -v``, which phase 1 prints), and the
    whole-tensor mode's grid at ``bisect_fused``'s MP."""
    from se3conv3d_tpu_torch.experiments import bisect_fused
    from se3conv3d_tpu_torch.kernels import probes

    regs = {}
    for stage in probes.STAGES:
        regs[f"{stage} tensor float32"] = probes.stage_kernel_attributes(stage, False)
        if stage != "wcontract":
            for dtype in KERNEL_DTYPES:
                regs[f"{stage} tile-sum {dtype_name(dtype)}"] = probes.stage_kernel_attributes(stage, True, dtype)
    for key, a in regs.items():
        grid = (f", {probes.stage_tensor_grid(key.split()[0], 1, bisect_fused.MP)['blocks']} blocks at MP = "
                f"{bisect_fused.MP}" if " tensor " in key else "")
        print(f"probe_stage_fwd {key}: {a['registers']} registers, {a['local_bytes']} local bytes, "
              f"{a['dynamic_smem']} bytes of dynamic shared memory, {a['blocks_per_sm']} block(s) an SM{grid} "
              f"[{card}]", flush=True)
    return regs


def run_probes(card, dev) -> dict:
    """32. the probe kernels: the main path, then each kernel against its
    plain version, the stage split, the read rates and the registers."""
    main_path = probe_main_path(card)
    stage = probe_stage_cases(card, dev)
    split = {dt: {s: (stage[dt][s]["ms"], stage[dt][s]["bound_ms"]) for s in stage[dt]} for dt in stage}
    print(f"probe stage split ((kernel ms, bound ms); each stage's time minus the one before is its cost): "
          f"{split} [{card}]", flush=True)
    return dict(main=main_path, stage=stage, bisect=probe_bisect_cases(card, dev),
                stream=probe_stream_cases(card, dev), registers=probe_registers(card))


def probe_entries(pr: dict) -> list:
    """The ``{"kernels": [...]}`` entries of phase 32: one per ported
    ``pl.pallas_call`` site, its launches on the probes' main path (32a)
    and its times at the JAX script's default size."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main, launches = pr["main"]["launches"], pr["main"]["launches_by"]
    st, bis, stream = pr["stage"], pr["bisect"], pr["stream"]

    def entry(name, source, replaces, n, case, at, **extra):
        return {"name": name, "route": "cuda", "source": PROBE_SRC.format(source), "replaces": replaces,
                "launches": n, **{k: case[k] for k in keys}, "at": at, **extra}

    fwd_by = launches["stage_forward"]
    s_names = ("s1_pne", "s2_agg", "s3_swap", "s4_wcontract", "s5_reduce")
    b_rows = (("gelu_jvp", "b1_jvp_gelu", 218), ("expand_groups", "b2_gexp", 232),
              ("batched_contract", "b3_dw2_contract11", 249), ("rank3_accum", "b4_rank3_accum", 265),
              ("merge_back", "b5_merge_back", 283))
    width = launches["column_sums"]
    return [
        entry("probe_stage_fwd[tile_sum]", "stage_fwd", "experiments/chip_stage_time.py:17", main["stage_sum"],
              {**st["float32"]["full"], "max_abs_err": max(c["max_abs_err"] for c in st["float32"].values())},
              f"chip_stage_time full stage M={PROBE_M}, float32 (torch.matmul: the weight contraction alone)",
              by_stage=st, launches_by_stage=launches["stage_sum"], main_path_ms=pr["main"]["split"]),
        entry("probe_stage_fwd[tensor]", "stage_fwd", "experiments/bisect_fused.py:46",
              sum(fwd_by.get(k, 0) for k in ("pne", "agg", "swap", "wcontract", "reduce")),
              {**bis["s5_reduce"], "max_abs_err": max(bis[k]["max_abs_err"] for k in s_names)},
              "bisect_fused s5_reduce MP=1024 (bound on tensor cores; library: the weight contraction alone, "
              "torch.bmm)", bound_fma_ms=bis["s5_reduce"]["bound_fma_ms"], by_stage={k: bis[k] for k in s_names},
              launches_by_stage=fwd_by),
        entry("probe_stage_fwd[tensor,batch]", "stage_fwd", "experiments/bisect_fused.py:193",
              fwd_by.get("reduce[batch]", 0), bis["s6_vmap"], "bisect_fused s6_vmap MP=1024, batch 1 (library: the "
              "weight contraction alone, torch.bmm)", bound_fma_ms=bis["s6_vmap"]["bound_fma_ms"]),
        *(entry(f"probe_{fn}", "bwd_ops", f"experiments/bisect_fused.py:{line}", main[fn], bis[name],
                f"bisect_fused {name}", **({"yardstick_ms": bis[name]["yardstick_ms"]}
                                           if "yardstick_ms" in bis[name] else {}))
          for fn, name, line in b_rows),
        entry("probe_column_sums[feat]", "stream", "experiments/chip_stream.py:37", width.get("64", 0),
              stream["feat"], f"chip_stream feat [{PROBE_M * 32}, 64] (torch.sum over the rows)",
              gb_s=stream["feat"]["gb_s"], library_gb_s=stream["feat"]["library_gb_s"]),
        entry("probe_column_sums[geo]", "stream", "experiments/chip_stream.py:45",
              width.get("19", 0) + width.get("128", 0), stream["geo19"],
              f"chip_stream geo [{PROBE_M * 32}, 19] (torch.sum over the rows)",
              by_shape={k: stream[k] for k in ("geo19", "geo128")}),
    ]


# phase 33: the Mosaic probe sites of experiments/bisect_accum.py,
# bisect_accum2.py, probe_cellconv.py and probe_mosaic.py, held by the
# CLIs' own checks: gathers, copies, 2a and the r-ordered sums bitwise; the
# accumulators' totals within 1e-9 of sum |a| of the float64 total (a
# bound that passes the plain version's total and rejects planted wrong
# ones, accum_controls), the column sums within 1e-6 of each column's sum
# |a| (float32 sums in other orders); products within 1e-5 of
# max |plain| (TF32 off; p10's bfloat16 products are exact in float32);
# p3's pne bitwise, so no mask disagreement; every fixed-order sum two
# calls bitwise equal
SITE_SRC = "se3conv3d_tpu_torch/kernels/csrc/probe_{}.cu"


def site_counters() -> dict:
    """Every launch counter of phase 33's kernels, by name: the two
    accumulators, the three cell-conv kernels and the 16 Mosaic probes'
    wrappers (p11 counts on ``grid_column_accum``)."""
    from se3conv3d_tpu_torch.kernels import cellconv_probes as cc, mosaic_probes as mp, probes

    return {"block_total_accum": probes.block_total_accum, "grid_column_accum": probes.grid_column_accum,
            "gather_blocks": cc.gather_blocks, "gather_sum_blocks": cc.gather_sum_blocks,
            "masked_dist_product": cc.masked_dist_product,
            **{name: fn for name, fn in mp.PROBES.items() if name != "p11_grid_accum"}}


def mosaic_sites_main_path(card) -> dict:
    """33a. the four CLIs as a user runs them, every counter at 0 before
    and read after each: ``bisect_accum`` (six trials), ``bisect_accum2``
    (seven combinations), ``probe_cellconv`` once per part, ``probe_mosaic``
    (17 probes).  Fails if a probe failed, or a kernel, an accumulator
    combination or a part's kernel was not launched."""
    from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2, probe_cellconv, probe_mosaic
    from se3conv3d_tpu_torch.kernels import probes

    counters = site_counters()
    for fn in counters.values():
        fn.launches = 0
    probes.block_total_accum.launches_by.clear()
    read = lambda: {k: fn.launches for k, fn in counters.items()}  # noqa: E731
    failed, by_cli = {}, {}
    t0 = time.perf_counter()
    for name, run in (("bisect_accum", lambda: bisect_accum.main([])),
                      ("bisect_accum2", lambda: bisect_accum2.main([])),
                      *((f"probe_cellconv {p}", lambda p=p: probe_cellconv.main(["--part", p], env={}))
                        for p in probe_cellconv.PARTS),
                      ("probe_mosaic", lambda: probe_mosaic.main([]))):
        before = read()
        failed[name] = run()
        by_cli[name] = {k: v - before[k] for k, v in read().items() if v != before[k]}
    seconds = time.perf_counter() - t0
    launches, accum_by = read(), dict(probes.block_total_accum.launches_by)
    want_tags = {probes.accum_tag(bisect_accum.SHAPES[:n], d) for _, n, d in bisect_accum.TRIALS.values()}
    want_tags |= {probes.accum_tag([bisect_accum2.SHAPES[n] for n in names], d)
                  for names, d in bisect_accum2.COMBINATIONS}
    part_kernel = {"p1": "gather_blocks", "p2": "gather_sum_blocks", "p3": "masked_dist_product",
                   "p4": "gather_sum_blocks"}
    missing = [k for k, v in launches.items() if v == 0]
    missing += [f"block_total_accum[{t}]" for t in sorted(want_tags) if not accum_by.get(t)]
    missing += [f"probe_cellconv {p}: {k}" for p, k in part_kernel.items()
                if not by_cli[f"probe_cellconv {p}"].get(k)]
    print(f"mosaic sites main path: {seconds:.2f} s; launches {launches}; block_total_accum by outputs "
          f"{accum_by}; by CLI {by_cli}; failures {failed} [{card}]", flush=True)
    if any(failed.values()) or missing:
        raise SystemExit(f"phase 33: failures {failed}, kernels not launched {missing}")
    return dict(launches=launches, accum_by=accum_by, by_cli=by_cli, seconds=seconds)


def site_case(card, label, fn, plain, check, work, side, library=None, dtype=torch.float32) -> dict:
    """33b-c for one kernel call ``fn()``: its result held by ``check(got)``
    (which raises ``ValueError``; returns the relative error it reads, 0
    for a bitwise check), ``max |kernel - plain|`` over every output, two
    calls bitwise equal, device ms from a CUDA graph beside the one-call
    CUDA-event time, the plain version's and the library call's times, the
    bound."""
    with torch.no_grad():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        try:
            rel = check(got)
        except ValueError as e:
            raise SystemExit(f"phase 33: {label} disagrees with its plain version: {e}")
        pairs = list(zip(got, again)) if isinstance(got, list) else [(got, again)]
        same = all(torch.equal(x, y) for x, y in pairs)
        ref = plain()
        err = max(float((x.float() - r.float()).abs().max()) if x.numel() else 0.0
                  for x, r in zip([x for x, _ in pairs], ref if isinstance(ref, list) else [ref]))
        ms, call_ms = graph_ms(fn, side), cuda_ms(fn, 20)
        plain_ms = cuda_ms(plain, 5)
        lib_ms = graph_ms(library, side) if library is not None else None
    bound = probe_bound(work, dtype)
    print(f"site {label}: max_abs_err={err:.3e} max_rel_err={rel:.3e}; two calls bitwise equal: {same}; "
          f"kernel_ms={ms:.4f} (device, one call with "
          f"its host time {call_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms={bound['bound_ms']:.4f} "
          f"({bound['bound_by']})" + (f"; one PyTorch call {lib_ms:.4f} ms" if lib_ms is not None else "")
          + f" [{card}]", flush=True)
    if not same:
        raise SystemExit(f"phase 33: {label} gave other bits on a second call")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err, max_rel_err=rel, library_ms=lib_ms,
                **bound)


def accum_controls(label, a) -> dict:
    """33b's controls of a total's bound: the plain version's total and
    :func:`bisect_accum.planted_totals`' wrong ones, each read as
    ``|total - float64 total| / sum |a|``; ``check_accum`` must pass the
    first and reject the others."""
    from se3conv3d_tpu_torch.experiments import bisect_accum
    from se3conv3d_tpu_torch.kernels import probes

    exact, terms = float(a.double().sum()), float(a.double().abs().sum())
    totals = {"plain": probes.block_total_accum_reference(a, [(1,)], False)[0], **bisect_accum.planted_totals(a)}
    readings, passed = {}, {}
    for k, v in totals.items():
        readings[k] = abs(float(v.reshape(())) - exact) / terms
        try:
            bisect_accum.check_accum(a, [v.reshape(1)], [(1,)], False)
            passed[k] = True
        except ValueError:
            passed[k] = False
    print(f"site {label} controls: |total - float64 total| / sum |a| {readings} (bound {bisect_accum.SUM_RTOL:g}); "
          f"passed {passed}", flush=True)
    if not passed["plain"] or passed["bf16_partials"] or passed["dropped_chunk"]:
        raise SystemExit(f"phase 33: {label}: the total's bound does not tell the controls apart: {passed}")
    return readings


def accum_site_cases(card, dev, side) -> dict:
    """33b-c. ``block_total_accum`` at each of ``bisect_accum``'s trials and
    ``bisect_accum2``'s combinations (library: ``a * 2`` where dfeat is
    written and ``torch.sum(a)``), and ``grid_column_accum`` at p11's
    ``[1024, 32]``, also held bit for bit to its stated order
    (``probes.grid_column_in_kernel_order``; library: ``torch.sum(a, 0)``)."""
    from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2, probe_mosaic
    from se3conv3d_tpu_torch.kernels import probes

    def accum(label, a, shapes, with_dfeat):
        n_out = sum(math.prod(s) for s in shapes)
        work = {"bytes": 4.0 * (a.numel() * (2 if with_dfeat else 1) + n_out)}
        check = lambda got: bisect_accum.check_accum(a, got, shapes, with_dfeat)  # noqa: E731
        lib = (lambda: (a * 2.0, torch.sum(a))) if with_dfeat else (lambda: torch.sum(a))
        case = site_case(card, label, lambda: probes.block_total_accum(a, shapes, with_dfeat),
                         lambda: probes.block_total_accum_reference(a, shapes, with_dfeat), check, work, side, lib)
        case["controls"] = accum_controls(label, a)
        return case

    out = {"bisect_accum": {}, "bisect_accum2": {}}
    for i, (name, (grid_n, n_accum, with_dfeat)) in enumerate(bisect_accum.TRIALS.items()):
        a = bisect_accum.draw(grid_n, 400 + i, dev)
        out["bisect_accum"][name] = accum(f"bisect_accum {name}", a, bisect_accum.SHAPES[:n_accum], with_dfeat)
        del a
    for i, (names, with_dfeat) in enumerate(bisect_accum2.COMBINATIONS):
        a = bisect_accum.draw(bisect_accum2.GRID, 420 + i, dev)
        tag = bisect_accum2.tag(names, with_dfeat)
        out["bisect_accum2"][tag] = accum(f"bisect_accum2 {tag}", a, [bisect_accum2.SHAPES[n] for n in names],
                                          with_dfeat)
        del a
    (a,) = probe_mosaic.draw("p11_grid_accum", 440, dev)

    def column_check(got):
        rel = probe_mosaic.check("p11_grid_accum", [a], got)
        if not torch.equal(got, probes.grid_column_in_kernel_order(a)):
            raise ValueError("the column sums are not the kernel's stated order's bit for bit")
        return rel

    out["p11_grid_accum"] = site_case(
        card, "p11_grid_accum (grid_column_accum)", lambda: probes.grid_column_accum(a),
        lambda: probes.grid_column_accum_reference(a), column_check,
        {"bytes": 4.0 * (a.numel() + a.shape[1])}, side, lambda: torch.sum(a, 0))
    torch.cuda.empty_cache()
    return out


def cellconv_work(part: str, x: dict) -> dict:
    """A cell-conv part's work for :func:`probe_bound`: the bytes of its
    inputs and output, each once (p1, p2, p4: the table blocks its ids name),
    and p3's product as ``product_flops`` (on tensor cores, charged at the
    3xTF32 ceiling; :func:`mosaic_fma_bound_ms` gives its bound at the float32
    FMA peak)."""
    from se3conv3d_tpu_torch.experiments import probe_cellconv as pc

    if part == "p3":
        nq, c = x["qp"].shape[0], x["cf"].shape[1]
        return {"product_flops": 2.0 * nq * x["cp"].shape[0] * c,
                "bytes": 4.0 * (x["qp"].numel() + x["cp"].numel() + x["cf"].numel() + nq * c)}
    blocks = int(torch.unique(x["ids"]).numel())
    return {"bytes": 4.0 * (x["ids"].numel() + (blocks + x["ids"].shape[0]) * pc.P * pc.C)}


def cellconv_site_cases(card, dev, side) -> dict:
    """33b-c. the four cell-conv parts at the JAX script's sizes: p1, p2
    and p4 bitwise, p3's pne bitwise and its product within
    ``probe_cellconv.P3_RTOL``; bounds from :func:`cellconv_work` (p3 on
    tensor cores, its FMA bound beside it as ``bound_fma_ms``); libraries:
    the indexed copy times 2, the indexed sum over r, and
    ``torch.matmul(pne, cf)`` for p3's product alone; beside each gather a
    ``clone`` of its output (``clone_ms``: the same bytes written, half of
    p1's and fewer of p2's and p4's read)."""
    from se3conv3d_tpu_torch.experiments import probe_cellconv as pc

    out = {}
    for i, part in enumerate(pc.PARTS):
        x = pc.draw(part, 460 + i, dev)
        if part == "p3":
            pne = torch.empty(pc.QB3 * pc.Q3, pc.CAND, device=dev)
            pc.check(part, x, pc.run(part, x, pne), pne)  # no mask disagreement, pne bitwise
            lib = lambda pne=pne, x=x: torch.matmul(pne, x["cf"])  # noqa: E731
        else:
            t3 = (x["tab"] if "tab" in x else x["g"]).view(-1, pc.P, pc.C)
            lib = ((lambda t3=t3, x=x: t3[x["ids"].long()] * 2.0) if part == "p1"
                   else (lambda t3=t3, x=x: t3[x["ids"].long()].sum(1)))
        work = cellconv_work(part, x)
        out[part] = site_case(card, f"probe_cellconv {part}", lambda x=x, part=part: pc.run(part, x),
                              lambda x=x, part=part: pc.reference(part, x),
                              lambda got, x=x, part=part: pc.check(part, x, got), work, side, lib)
        if part != "p3":
            got = pc.run(part, x)
            out[part]["clone_ms"] = graph_ms(lambda got=got: got.clone(), side)
            print(f"site probe_cellconv {part}: block_gather {out[part]['ms']:.4f} ms, a clone of its "
                  f"{got.numel() * 4 // 1024} KB output {out[part]['clone_ms']:.4f} ms [{card}]", flush=True)
            del got
        if part == "p3":
            out[part]["bound_fma_ms"] = mosaic_fma_bound_ms(work)
            print(f"site probe_cellconv p3: {work['product_flops'] / 1e6:.1f} MFLOP on tensor cores (3xTF32), "
                  f"bound {out[part]['bound_ms']:.4f} ms; the FMA bound (every product FLOP at the float32 FMA "
                  f"peak) {out[part]['bound_fma_ms']:.4f} ms [{card}]", flush=True)
        del x
    torch.cuda.empty_cache()
    return out


def mosaic_library(device) -> dict:
    """The one PyTorch call per Mosaic probe, its constants made here, out
    of the timed graph: p9's block diagonal as an ``einsum`` with ``eye(2)``,
    p14's ``a * q`` for q < 4 as one broadcast product."""
    from se3conv3d_tpu_torch.kernels import mosaic_probes as mp

    eye2 = torch.eye(2, device=device)
    qs = torch.arange(4.0, device=device).view(1, 4, 1)
    p, c, e = mp.TM // 2, mp.C, mp.E  # p9: [TM, C, E] as TM / 2 pairs of [C, E]
    return {
        "p1_plain_2d": lambda a, b: torch.matmul(a, b),
        "p2_leading_batch": lambda a, b: torch.einsum("mec,meq->mcq", a, b),
        "p3_multi_contract": lambda a, b: torch.tensordot(a, b, dims=([1, 2], [0, 1])),
        "p4_free_dims_rhs": lambda a, b: torch.einsum("mec,megq->mcgq", a, b),
        "p5_lane_merge": lambda a: a.reshape(mp.TM, mp.E, mp.G * mp.Q).clone(),
        "p6_sublane_split": lambda a: a.reshape(mp.TM, mp.E * mp.G, mp.Q).clone(),
        "p7_mid_slice": lambda a: a[:, :, 1, :].contiguous(),
        "p8_blockdiag_batched": lambda a, b: torch.bmm(a, b),
        "p9_concat_blockdiag_build": lambda a: torch.einsum("phce,hk->phcke", a.view(p, 2, c, e),
                                                            eye2).reshape(p, 2 * c, 2 * e),
        "p10_bf16_batched": lambda a, b: torch.einsum("mec,meq->mcq", a, b),
        "p12_transpose_last2": lambda a: a.transpose(1, 2).contiguous(),
        "p13_nt_contract": lambda a, b: torch.einsum("pec,pmc->pem", a, b),
        "p14_mid_write": lambda a: a[:, None, :] * qs,
        "p15_dim0_contract": lambda a, b: torch.matmul(a.t(), b),
        "p16_leading_split_rank2": lambda a: a.reshape(mp.TM, mp.E, 2 * mp.Q).clone(),
        "p17_outer_swap": lambda a: a.transpose(0, 1).contiguous(),
    }


def mosaic_site_cases(card, dev, side) -> dict:
    """33b-c. the 16 probes of ``run_kernel`` at the JAX script's shapes:
    copies bitwise (each with the path of its collapsed view,
    ``mosaic_probes.copy_plan``), products within ``probe_mosaic.PRODUCT_RTOL`` of max |plain|;
    bounds from each probe's bytes and FLOPs (the products on tensor cores:
    float32 at the 3xTF32 ceiling, p10 at the bfloat16 peak; the FMA
    bound, every product FLOP at the float32 FMA peak, beside it as
    ``bound_fma_ms``);
    libraries (:func:`mosaic_library`): ``torch.matmul`` / ``einsum`` /
    ``bmm`` / ``tensordot`` (p10 in bfloat16 with a bfloat16 result),
    ``.contiguous()`` / ``.clone()``, p9's ``einsum`` with ``eye(2)`` and
    p14's broadcast product."""
    from se3conv3d_tpu_torch.experiments import probe_mosaic
    from se3conv3d_tpu_torch.kernels import mosaic_probes as mp

    out = {}
    for i, (name, lib) in enumerate(mosaic_library(dev).items()):
        xs = probe_mosaic.draw(name, 480 + i, dev)
        fn = mp.PROBES[name]
        work = mp.probe_work(name, xs, fn(*xs))
        out[name] = site_case(card, f"probe_mosaic {name}", lambda fn=fn, xs=xs: fn(*xs),
                              lambda name=name, xs=xs: mp.REFERENCES[name](*xs),
                              lambda got, name=name, xs=xs: probe_mosaic.check(name, xs, got), work, side,
                              lambda lib=lib, xs=xs: lib(*xs), xs[0].dtype)
        if mp.KIND[name] == "product":
            out[name]["bound_fma_ms"] = mosaic_fma_bound_ms(work)
            print(f"site probe_mosaic {name}: plan {mp.product_plans()[name]}; the FMA bound (every product FLOP "
                  f"at the float32 FMA peak) {out[name]['bound_fma_ms']:.4f} ms [{card}]", flush=True)
        elif name in mp.COPY_VIEWS:  # strided_copy: the path of the collapsed view
            view = mp.COPY_VIEWS[name](xs[0])
            plan = mp.copy_plan(view.shape, view.stride(), mp._align(view.data_ptr()))
            out[name]["copy_path"] = plan["path"]
            print(f"site probe_mosaic {name}: view {tuple(view.shape)} strides {view.stride()} collapsed to "
                  f"{plan['dims']} strides {plan['strides']}, the {plan['path']} path; {out[name]['ms']:.4f} ms "
                  f"against the library's {out[name]['library_ms']:.4f} [{card}]", flush=True)
        del xs
    torch.cuda.empty_cache()
    return out


def mosaic_sites_registers(card) -> dict:
    """33d. registers, local bytes and shared memory of every kernel of the
    three sources (``cudaFuncGetAttributes``)."""
    from se3conv3d_tpu_torch.kernels import cellconv_probes as cc, mosaic_probes as mp, probes

    regs = {"accum": probes.accum_kernel_attributes(), "cellconv": cc.cellconv_kernel_attributes(),
            "mosaic": mp.mosaic_kernel_attributes()}
    # grid_column_accum's dynamic shared memory is the call's: p11's S * C block sums
    regs["accum"]["grid_column_accum"]["dynamic_smem"] = probes.column_partials_bytes(
        mp.SHAPES["p11_grid_accum"][0][0])
    for src, kernels in regs.items():
        print(f"probe_{src}.cu: " + "; ".join(f"{k} {a['registers']} registers, {a['local_bytes']} local bytes, "
                                              f"{a['static_smem']} + {a['dynamic_smem']} bytes of static + "
                                              f"dynamic shared memory" for k, a in kernels.items())
              + f" [{card}]", flush=True)
    return regs


def run_mosaic_sites(card, dev) -> dict:
    """33. the last eight Mosaic probe sites: the CLIs as the main path,
    then each kernel against its plain version with its times, and the
    registers."""
    t0 = time.perf_counter()
    main_path = mosaic_sites_main_path(card)
    side = torch.cuda.Stream(dev)
    out = dict(main=main_path, accum=accum_site_cases(card, dev, side), cellconv=cellconv_site_cases(card, dev, side),
               mosaic=mosaic_site_cases(card, dev, side), registers=mosaic_sites_registers(card))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 33: {out['seconds']:.2f} s [{card}]", flush=True)
    return out


def mosaic_site_entries(ms: dict) -> list:
    """The ``{"kernels": [...]}`` entries of phase 33: one per ported
    ``pl.pallas_call`` site, its launches on the CLIs' run (33a) and its
    times at the JAX script's sizes.  ``max_abs_err`` is ``max |kernel -
    plain|``; ``max_rel_err`` what the site's check reads: a total's error
    against the float64 total over ``sum |a|``, a column sum's over its
    column's ``sum |a|``, a product's over ``max |plain|``, 0 where the check
    is bitwise."""
    keys = ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_cli = ms["main"]["by_cli"]
    cell = {p: by_cli[f"probe_cellconv {p}"] for p in ("p1", "p2", "p3", "p4")}

    def entry(name, source, replaces, n, case, at, **extra):
        return {"name": name, "route": "cuda", "source": SITE_SRC.format(source), "replaces": replaces,
                "launches": n, **{k: case[k] for k in keys}, "at": at, **extra}

    mosaic = ms["mosaic"]
    return [
        entry("probe_block_total_accum[bisect_accum]", "accum", "experiments/bisect_accum.py:46",
              by_cli["bisect_accum"]["block_total_accum"], ms["accum"]["bisect_accum"]["grid64_accum3_dfeat"],
              "bisect_accum grid64_accum3_dfeat, a [8192, 32, 64] (library: a * 2 and torch.sum(a))",
              by_trial=ms["accum"]["bisect_accum"]),
        entry("probe_block_total_accum[bisect_accum2]", "accum", "experiments/bisect_accum2.py:40",
              by_cli["bisect_accum2"]["block_total_accum"], ms["accum"]["bisect_accum2"]["dproj+dbias+dw2"],
              "bisect_accum2 dproj+dbias+dw2, a [4096, 32, 64] (library: torch.sum(a))",
              by_combination=ms["accum"]["bisect_accum2"], launches_by_outputs=ms["main"]["accum_by"]),
        entry("probe_block_gather[p1]", "cellconv", "experiments/probe_cellconv.py:47", cell["p1"]["gather_blocks"],
              ms["cellconv"]["p1"], "probe_cellconv p1 (library: tab[ids] * 2)",
              clone_ms=ms["cellconv"]["p1"]["clone_ms"]),
        entry("probe_block_gather[p2]", "cellconv", "experiments/probe_cellconv.py:82",
              cell["p2"]["gather_sum_blocks"], ms["cellconv"]["p2"], "probe_cellconv p2 (library: tab[ids].sum(1))",
              clone_ms=ms["cellconv"]["p2"]["clone_ms"]),
        entry("probe_masked_dist_product", "cellconv", "experiments/probe_cellconv.py:120",
              cell["p3"]["masked_dist_product"], ms["cellconv"]["p3"],
              "probe_cellconv p3 (library: torch.matmul(pne, cf), the product alone)",
              bound_fma_ms=ms["cellconv"]["p3"]["bound_fma_ms"]),
        entry("probe_block_gather[p4]", "cellconv", "experiments/probe_cellconv.py:160",
              cell["p4"]["gather_sum_blocks"], ms["cellconv"]["p4"], "probe_cellconv p4 (library: g[ids].sum(1))",
              clone_ms=ms["cellconv"]["p4"]["clone_ms"]),
        entry("probe_strided_product[run_kernel]", "mosaic", "experiments/probe_mosaic.py:53",
              sum(by_cli["probe_mosaic"].get(k, 0) for k in mosaic), mosaic["p8_blockdiag_batched"],
              "probe_mosaic p8_blockdiag_batched (every probe under by_probe)", by_probe=mosaic,
              launches_by_probe={k: by_cli["probe_mosaic"].get(k, 0) for k in mosaic}),
        entry("probe_grid_column_accum", "accum", "experiments/probe_mosaic.py:218",
              by_cli["probe_mosaic"].get("grid_column_accum", 0), ms["accum"]["p11_grid_accum"],
              "probe_mosaic p11_grid_accum, [1024, 32] (library: torch.sum(a, 0))"),
    ]


# phase 34: the rest of the model zoo at full widths: the other residual
# blocks, the hidden seg-head layers and the plain SegUNet, ball-query PCA
# frames, ClassNet's global equivariant feature vector, 64 basis functions
# in every geometry, and the attention convs
ZOO_TRAIN_STEPS = 3
# dfaust_I_rot_pca_2F's variants: label: (ModelSpec fields, net)
ZOO_VARIANTS = {
    "dfaust_resnetb": (dict(block_layer="resnetb"), "FPNSegUNet"),
    "dfaust_resconvnext_hidden2": (dict(block_layer="resconvnext", num_hidden_seg_head=2), "FPNSegUNet"),
    "dfaust_segunet": ({}, "SegUNet"),
}
# ball-query PCA frames on the bodies (level 0 at 0.04 m cells, about 625
# points a square meter of surface): a ball of 0.09 m holds about
# neigh_k = 16 of them.  The radius is the same on every level, as the
# recipe key is: on the coarser levels the balls hold a few points
BQ_RADIUS, BQ_NEIGH_K = 0.09, 16
# frames card vs CPU where the neighborhood's PCA axes are determined
# (eigenvalues apart by at least BQ_EIG_GAP of their span; elsewhere the
# axes are not fixed by the data): float32 sums in other orders move an
# axis by about eps over the gap
BQ_EIG_GAP, FRAMES_ATOL = 5e-2, 1e-4
# ClassNet's global feature vector: one extra grid level past
# modelnet40_pca_2F's trunk (cells of 0.8 on the unit-sphere shapes)
MN_EXTRA_CELL, MN_EXTRA_CAP = 0.8, 64
# Q = 64: name: ((B, M, N, K, G, F, Q, C, O), pne type, operand dtypes):
# DFaust's level-0 conv in the standard and kernel-point geometries
# (G = F = 1, one pne row of 64 columns, the wide basis tile) and in the
# equivariant one at G = F = 2 (G*Q = 128: the 128-column instantiations),
# at the bodies' level-0 fill
Q64_SHAPES = {
    "dfaust_std_level0_conv_q64": ((BATCH, 4096, 4096, 32, 1, 1, 64, 32, 32), "mlp_gelu", KERNEL_DTYPES),
    "dfaust_std_level0_conv_q64_kp_gauss": ((BATCH, 4096, 4096, 32, 1, 1, 64, 32, 32), "kp_gauss",
                                            (torch.float32,)),
    "dfaust_std_level0_conv_q64_kp_gauss_double": ((BATCH, 4096, 4096, 32, 1, 1, 64, 32, 32), "kp_gauss_double",
                                                   (torch.float32,)),
    "dfaust_level0_conv_q64_g2": ((BATCH, 4096, 4096, 32, 2, 2, 64, 32, 32), "mlp_gelu", (torch.float32,)),
}
# the Q = 64 models, one train step each: label: (recipe, ConvFactory
# fields, pne inputs D)
Q64_MODELS = {
    "dfaust_std_q64": ("DFAUST_I_STANDARD", dict(num_basis=64), 3),
    "dfaust_std_kp_gauss_double_q64": ("DFAUST_I_STANDARD", dict(pne_type="kp_gauss_double", num_basis=64), 55),
    "dfaust_rot_pca_2F_q64": ("DFAUST_I_ROT_PCA_2F", dict(num_basis=64), 9),
}
# the attention convs on DFaust's level 0: kNN, channels in = out, basis
# functions, heads
ATT_K, ATT_C, ATT_Q, ATT_HEADS = 16, 32, 16, 4


def fused_convs(model) -> int:
    """The convs of ``model`` that launch the conv kernels (one forward and
    one backward launch each per pass)."""
    from se3conv3d_tpu_torch.nn.conv import PNEConv

    return sum(1 for m in model.modules() if isinstance(m, PNEConv) and m.fused)


def zoo_model(spec, net, dev, num_in_feats=1, num_classes=CLASSES):
    """A ``net`` (``FPNSegUNet``, ``SegUNet`` or ``ClassNet``) of ``spec`` on
    ``dev`` with a seeded init and seeded skip gammas, as a user builds one
    with ``get_model_spec`` and ``dataclasses.replace``."""
    from se3conv3d_tpu_torch import models

    model = getattr(models, net)(spec, num_in_feats, num_classes, generator=torch.Generator().manual_seed(0))
    return seed_gammas(model.to(dev))


def by_q(kfe) -> tuple:
    """The launches by (D, Q) since the last reset, forward and backward."""
    return tuple(dict(getattr(fn, "launches_by_q", {})) for fn in (kfe.fused_equiv_fwd, kfe.fused_equiv_bwd))


def rotation_with_control(card, label, model, h, f0, out_pc=None, valid=None) -> dict:
    """Phase 4's gate beside its control: the output of an equivariant
    ``model`` (logits, or ``ClassNet``'s feature vector in its frames, where
    ``out_pc`` is None) unchanged by a global rotation of the hierarchy
    (``ROT_ATOL``), and changed past it when the positions are rotated and
    the frames are not.  Where that control does not get past
    ``ROT_CONTROL_MARGIN`` times the bound on the model as it is (its norms
    shrink the conv path), a copy with every norm seeded from its own input
    (:func:`seed_norms`) is gated, its reading printed beside the first.  ``valid``:
    the rows compared (all where None).  Returns the readings, each key
    prefixed ``rotation_`` (the card-vs-CPU gate's share a dict with them)."""
    from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, rotate_cloud, rotate_hierarchy
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.core.rotation import random_rotations

    rot = random_rotations(1, generator=torch.Generator().manual_seed(6))[0].to(f0.device)

    def unframed(pc):
        return PointCloud(pc.positions @ rot.T, pc.mask, pc.frames)

    def readings(m):
        def call(hh, oo):
            return m(hh, f0) if out_pc is None else m(hh, f0, oo)

        keep = (lambda x: x) if valid is None else (lambda x: x[valid])
        with torch.no_grad():
            base = call(h, out_pc)
            rotated = call(rotate_hierarchy(h, rot), None if out_pc is None else rotate_cloud(out_pc, rot))
            control = call(Hierarchy(tuple(unframed(pc) for pc in h.levels), h.maps, h.levels_radii),
                           None if out_pc is None else unframed(out_pc))
        return (keep((base - rotated).abs()).max().item(), keep((base - control).abs()).max().item(),
                base.abs().max().item())

    err, control, scale = readings(model)
    out = dict(rotation_max_abs_err=err, rotation_control=control, rotation_norms_seeded=False)
    print(f"{label} invariance: max |out - out(rotated)| = {err:.3e} (bound {ROT_ATOL}); control, the positions "
          f"rotated and the frames not: {control:.3e}; max |out| {scale:.3e} [{card}]", flush=True)
    if control <= ROT_CONTROL_MARGIN * ROT_ATOL:
        model = copy.deepcopy(model)
        seed_norms(model, h, f0, out_pc)
        out.update(rotation_unseeded_max_abs_err=err, rotation_unseeded_control=control,
                   rotation_norms_seeded=True)
        err, control, scale = readings(model)
        out.update(rotation_max_abs_err=err, rotation_control=control)
        print(f"{label} invariance (norms seeded, the control above reads {out['rotation_unseeded_control']:.3e}, "
              f"{out['rotation_unseeded_control'] / ROT_ATOL:.2f}x the bound, under {ROT_CONTROL_MARGIN:g}x): max |out - "
              f"out(rotated)| = {err:.3e} (bound {ROT_ATOL}); control {control:.3e} ({control / ROT_ATOL:.2f}x); "
              f"max |out| {scale:.3e} [{card}]", flush=True)
    if not err <= ROT_ATOL < control:
        raise SystemExit(f"{label}: the output changes under a global rotation, or the bound does not tell a "
                         "model that ignores the frames' rotation")
    return out


def zoo_dfaust_run(card, dev, label, model, model_dict, batch, small, steps=ZOO_TRAIN_STEPS) -> dict:
    """34a-b. one segmentation model on ``batch`` at full width with the
    hierarchy of the ``Model`` section ``model_dict`` and the DFaust
    recipe's ``Training`` section: with every launch count at 0, a
    calibration step, ``steps`` train steps (the median after the first,
    the peak) and one eval step, each forward and backward launching every
    conv's kernel once, all at (D, Q) = (9, 32); finite losses, the logits'
    shape.  Then on the two clouds of ``small`` the rotation gate
    (:func:`rotation_with_control`) and card vs CPU logits
    (:func:`card_vs_cpu_with_control`), each beside its control."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    training = presets.DFAUST_I_ROT_PCA_2F_TRAINING
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=True),
                      presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=False),
                      label_smoothing=training["label_smoothing"],
                      optimizer=schedule.optimizer_from_training(model.parameters(), training, steps))
    n = fused_convs(model)
    gen = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe)
    trainer.calibration_step(batch, gen)
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        res = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append((float(res["loss"]), float(res["grad_norm"])))
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    ev = trainer.eval_step(batch, gen)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches, q_launches = read_launches(kfe), by_q(kfe)
    steady = statistics.median(step_s[1:])
    print(f"{label}: {type(model).__name__} block {model.spec.block_layer}, hidden seg-head layers "
          f"{model.spec.num_hidden_seg_head}, {n} convs; train steps {[round(s, 4) for s in step_s]} s, median "
          f"after the first {steady:.4f} s, peak {peak:.3f} GiB; eval step {eval_s:.4f} s; losses "
          f"{[round(lo, 4) for lo, _ in losses]}; launches fwd {launches[0]} bwd {launches[1]}, by (D, Q) "
          f"{q_launches} [{card}]", flush=True)
    want = (n * (steps + 2), n * steps)
    if launches != want or q_launches != ({(9, 32): want[0]}, {(9, 32): want[1]}):
        raise SystemExit(f"{label}: launches {launches} by (D, Q) {q_launches}, expected {want} at (9, 32)")
    if not (all(np.isfinite(x) for pair in losses for x in pair) and torch.isfinite(ev["logits"]).all()
            and tuple(ev["logits"].shape) == (BATCH, model_dict["out_capacity"], CLASSES)):
        raise SystemExit(f"{label}: non-finite losses or bad logits")
    model.eval()
    h, f0, out_pc, _, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(5), train=False)
    gates = rotation_with_control(card, label, model, h, f0, out_pc, out_pc.mask)
    gates.update(card_vs_cpu_with_control(card, label, model, (h, f0, out_pc), out_pc.mask))
    return dict(step_s=step_s, steady_s=steady, peak_gib=peak, eval_s=eval_s, launches=launches, convs=n,
                gates=gates)


def well_posed_frames(pc, cfg) -> tuple:
    """The points of ``pc`` whose frame neighborhood (``cfg``'s ball query,
    invalid neighbors filled with the center as the solver fills them) has
    PCA eigenvalues apart by at least ``BQ_EIG_GAP`` of their span, and
    each valid point's neighbor count."""
    from se3conv3d_tpu_torch.core.neighborhoods import ball_query_neighborhood

    nb = ball_query_neighborhood(pc, pc, cfg.bq_radius, cfg.neigh_k)
    pos = pc.positions.double()
    x = pos[torch.arange(pos.shape[0], device=pos.device)[:, None, None], nb.idx]
    x = torch.where(nb.mask[..., None], x, pos[:, :, None, :])
    c = x - x.mean(2, keepdim=True)
    w = torch.linalg.eigvalsh(torch.einsum("bnki,bnkj->bnij", c, c))
    span = (w[..., 2] - w[..., 0]).clamp(min=1e-30)
    gap = torch.diff(w, dim=-1).min(-1).values / span
    return (gap >= BQ_EIG_GAP) & pc.mask, nb.mask.sum(-1)[pc.mask]


def bq_frames_card_vs_cpu(card, dev, hcfg, small) -> dict:
    """34b. the hierarchy of the two clouds of ``small`` with PCA frames over
    a ball query (``hcfg``), built on the card and on the CPU from the same
    draws: every level's and the output cloud's frames within
    ``FRAMES_ATOL`` where the neighborhood fixes the axes
    (:func:`well_posed_frames`), beside the control: the card's frames over
    the kNN neighborhood of the same ``neigh_k``, past it.  Prints the
    balls' mean valid count on level 0."""
    from se3conv3d_tpu_torch.core.hierarchy import HierarchyDraws, build_hierarchy, draw_hierarchy

    draws = draw_hierarchy(hcfg, 2, POINTS, torch.Generator().manual_seed(21))

    def build(cfg, where):
        d = HierarchyDraws([x.to(where) for x in draws.level_frames], draws.out_uniforms.to(where),
                           draws.out_frames.to(where))
        b = {k: v.to(where) for k, v in small.items()}
        h, _, out_pc, _, _ = build_hierarchy(b["positions"], b["mask"], b["features"], cfg, draws=d)
        return list(h.levels) + [out_pc]

    card_pcs, cpu_pcs = build(hcfg, dev), build(hcfg, torch.device("cpu"))
    knn_pcs = build(dataclasses.replace(hcfg, frames=dataclasses.replace(hcfg.frames, neigh_method="knn")), dev)
    levels = []
    for i, (a, b, k) in enumerate(zip(card_pcs, cpu_pcs, knn_pcs)):
        ok, count = well_posed_frames(b, hcfg.frames)
        err = (a.frames.cpu() - b.frames).abs()[ok].max().item() if ok.any() else 0.0
        control = (k.frames.cpu() - b.frames).abs()[ok].max().item() if ok.any() else 0.0
        levels.append(dict(max_abs_err=err, control=control, well_posed=int(ok.sum()), valid=int(b.mask.sum()),
                           mean_valid_count=float(count.float().mean()) if count.numel() else 0.0))
    err, control = max(x["max_abs_err"] for x in levels), max(x["control"] for x in levels)
    share = levels[0]["well_posed"] / levels[0]["valid"]
    print(f"ball_query_frames: radius {hcfg.frames.bq_radius}, neigh_k {hcfg.frames.neigh_k}; mean valid count on "
          f"level 0 {levels[0]['mean_valid_count']:.2f}, per level "
          f"{[round(x['mean_valid_count'], 2) for x in levels]}; well-posed points per level "
          f"{[(x['well_posed'], x['valid']) for x in levels]}; max |frames(card) - frames(cpu)| there = {err:.3e} "
          f"(bound {FRAMES_ATOL}); control, the kNN frames: {control:.3e} [{card}]", flush=True)
    if not (err <= FRAMES_ATOL < control and share >= 0.5):
        raise SystemExit("ball_query_frames: card and CPU frames disagree, the control passes, or level 0 has too "
                         "few well-posed points")
    return dict(levels=levels, max_abs_err=err, control=control, level0_well_posed_share=share)


def modelnet_global(card, dev, batch) -> dict:
    """34c. ``modelnet40_pca_2F`` at full widths with
    ``global_equiv_featurevector`` and one extra grid level (``MN_EXTRA_CELL``,
    capacity ``MN_EXTRA_CAP``): with every count at 0, a calibration pass,
    the forward on ``batch`` (``[B, M_extra, F, 2C]``, 2C = 1024) and the
    backward of a seeded random projection of it, timed (host clock,
    synchronised) with their peak, every conv launching once a pass at
    (D, Q) = (9, 32); the O = 1024 conv's forward and backward kernels at
    its shape and live rows against their plain versions, with their plans
    and the memory one call adds; then on two shapes the rotation gate of
    the feature vector and card vs CPU, each beside its control."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.train.trainer import Trainer

    base = presets.MODELNET40_PCA_2F_MODEL
    model_dict = {**base, "grid_subsamples": base["grid_subsamples"] + [MN_EXTRA_CELL],
                  "capacities": base["capacities"] + [MN_EXTRA_CAP]}
    spec = dataclasses.replace(presets.spec_from_model_dict(model_dict), global_equiv_featurevector=True)
    model = zoo_model(spec, "ClassNet", dev, presets.MODELNET40_NUM_FEATURES, presets.MODELNET40_NUM_CLASSES)
    trainer = Trainer(model, *(presets.hierarchy_config_from_model_dict(model_dict, POINTS, train=t)
                               for t in (True, False)))
    h, f0, _, _, _ = trainer.build(batch, torch.Generator(device=dev).manual_seed(116), train=False)
    trunk, extra = h.levels[-2], h.levels[-1]
    fill = [int(pc.mask.sum(1).max()) for pc in h.levels]
    c = spec.num_features[-1]
    n = fused_convs(model)
    model.eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kfe)
    with torch.no_grad():
        model(h, f0, calibrate=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(h, f0)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    proj = torch.randn(out.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(117))
    t0 = time.perf_counter()
    (out * proj).sum().backward()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, q_launches = read_launches(kfe), by_q(kfe)
    grad = model.global_conv_down.conv_weights.grad
    print(f"modelnet_global: {n} convs, levels' max valid points {fill} of capacities "
          f"{[pc.capacity for pc in h.levels]}; output {tuple(out.shape)}; forward {fwd_s:.4f} s, backward of a "
          f"seeded projection {bwd_s:.4f} s, peak {peak:.3f} GiB; launches fwd {launches[0]} bwd {launches[1]}, "
          f"by (D, Q) {q_launches} [{card}]", flush=True)
    want = (2 * n, n)
    if (tuple(out.shape) != (MN_BATCH, MN_EXTRA_CAP, 2, 2 * c) or not torch.isfinite(out).all()
            or launches != want or q_launches != ({(9, 32): want[0]}, {(9, 32): want[1]})
            or not (torch.isfinite(grad).all() and grad.abs().max() > 0)
            or any(p.grad is None for p in model.parameters())):
        raise SystemExit(f"modelnet_global: output {tuple(out.shape)}, launches {launches} {q_launches}, or a "
                         "missing or non-finite gradient")
    del out, proj
    model.zero_grad(set_to_none=True)
    # the O = 1024 conv at its shape and live rows
    shp = (MN_BATCH, MN_EXTRA_CAP, trunk.capacity, trunk.capacity, 2, 2, spec.conv.num_basis, c, 2 * c)
    args, gout = padded_conv_args(140, shp, fill[-1], dev)
    live = kfe.live_row_table(args[4])
    plan = conv_plan(shp, live.numel())
    with torch.no_grad():
        plan["fwd_peak_mib"] = call_peak_mib(lambda: kfe.fused_equiv_fwd(*args, live_rows=live))
    plan["bwd_peak_mib"] = call_peak_mib(lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live))
    print(f"modelnet_global_conv_plan B,M,N,K,G,F,Q,C,O={shp}: {live.numel()} live rows; forward {plan['chunks']} "
          f"chunk(s), {plan['splits']} depth split(s), scratch {plan['fwd_scratch_mib']:.1f} MiB, one call's peak "
          f"{plan['fwd_peak_mib']:.1f} MiB; backward scratch {plan['bwd_scratch_mib']:.1f} MiB, w_splits "
          f"{plan['w_splits']} ({plan['w_partials_mib']:.1f} MiB of d_w partials), one call's peak "
          f"{plan['bwd_peak_mib']:.1f} MiB [{card}]", flush=True)
    bounds = conv_bounds(shp, args[3], args[4])
    conv = dict(shape=shp, plan=plan,
                fwd=forward_vs_plain(card, "modelnet_global_conv_fwd_kernel_vs_plain", shp, args, live,
                                     bounds["fwd"], 141),
                bwd=backward_vs_plain(card, "modelnet_global_conv_bwd_kernel_vs_plain", shp, args, gout, live,
                                      bounds["bwd"], 142))
    del args, gout, live
    torch.cuda.empty_cache()
    small = to_device(shape_batch(2, POINTS, seed=115), dev)
    h2, f2, _, _, _ = trainer.build(small, torch.Generator(device=dev).manual_seed(118), train=False)
    valid = h2.levels[-1].mask
    gates = rotation_with_control(card, "modelnet_global", model, h2, f2, None, valid)
    gates.update(card_vs_cpu_with_control(card, "modelnet_global", model, (h2, f2), valid))
    return dict(forward_s=fwd_s, backward_s=bwd_s, peak_gib=peak, launches=launches, convs=n, fill=fill,
                conv=conv, gates=gates)


def q64_kernels(card, dev, fill) -> dict:
    """34d. both conv kernels at Q = 64 (``Q64_SHAPES``, DFaust's level 0 at
    the bodies' fill ``fill[0]``) against their plain versions with the
    gates and times of phases 2 and 6: the standard geometry in float32
    and bfloat16, kernel points (gauss at P = 13 and 55, float32 offsets),
    the equivariant geometry at G = F = 2; every launch counted at (D, 64)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

    out = {}
    for i, (name, (shp, pne_type, dtypes)) in enumerate(Q64_SHAPES.items()):
        b, m, n, k, g, f, q, c, o = shp
        for dt in dtypes:
            kp = conv_kernel_points(pne_type, dev) if pne_type.startswith("kp") else None
            args, gout = padded_conv_args(150 + i, shp, fill[0], dev, torch.float32 if kp else dt)
            d = 9 if g > 1 else 3
            if kp is not None:
                d = kp.points.shape[0]
                gen = torch.Generator(device=dev).manual_seed(160 + i)
                args = [args[0], None, args[2].to(dt), args[3], args[4],
                        torch.randn(d, q, device=dev, generator=gen) * 0.3, args[6], args[7]]
            elif d == 3:
                args[1], args[5] = None, args[5][:3].contiguous()
            live = kfe.live_row_table(args[4])
            bounds = conv_bounds(shp, args[3], args[4], dt, d=d, kp=kp is not None)
            opts = dict(act="linear", kp=kp) if kp is not None else {}
            reset_launches(kfe)
            out.setdefault(name, {})[dtype_name(dt)] = dict(
                fwd=forward_vs_plain(card, f"q64_fwd_kernel_vs_plain {name}", shp, args, live, bounds["fwd"],
                                     165 + i, opts),
                bwd=backward_vs_plain(card, f"q64_bwd_kernel_vs_plain {name}", shp, args, gout, live,
                                      bounds["bwd"], 170 + i, opts))
            if any(set(x) != {(d, 64)} for x in by_q(kfe)):
                raise SystemExit(f"phase 34 at {name}: launches by (D, Q) {by_q(kfe)}, expected ({d}, 64) only")
            del args, gout, live
            torch.cuda.empty_cache()
    return out


def q64_models(card, dev, batch) -> dict:
    """34d. the DFaust recipes with 64 basis functions (``Q64_MODELS``): one
    calibration and one train step each (:func:`dfaust_train`: 21 forward
    and 21 backward launches a step), every launch at (D, 64) and none on
    the plain path."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import presets

    out = {}
    for label, (recipe, kind, d) in Q64_MODELS.items():
        model_dict, training = (getattr(presets, f"{recipe}_{part}") for part in ("MODEL", "TRAINING"))
        trainer, steps = dfaust_train(card, dev, batch, model_dict, training, kind, 1)
        launches, q_launches = read_launches(kfe), by_q(kfe)
        print(f"{label}: launches fwd {launches[0]} bwd {launches[1]}, by (D, Q) {q_launches} [{card}]", flush=True)
        if q_launches != ({(d, 64): launches[0]}, {(d, 64): launches[1]}):
            raise SystemExit(f"{label}: launches by (D, Q) {q_launches}, expected every one at ({d}, 64)")
        out[label] = dict(train=steps, launches=launches, d=d)
        del trainer
        torch.cuda.empty_cache()
    return out


def attention_layers(card, dev, batch) -> dict:
    """34e. ``MultiHeadAttConv`` and ``LoRAttConv`` (PyTorch ops, as the JAX
    layers' XLA einsums) on DFaust's level 0 (``batch``'s bodies, kNN
    ``ATT_K``, ``ATT_C`` -> ``ATT_C`` channels, ``ATT_Q`` basis functions,
    ``ATT_HEADS`` heads), calibrated on the card: the forward and the
    gradients of a seeded projection (every parameter and the features) on
    the card against the CPU at B = 2 (``KERNEL_RTOL`` of max |out|,
    ``GRAD_RTOL`` per leaf), then the forward and forward + backward times
    at the full batch and the peak; no conv kernel launched."""
    from se3conv3d_tpu_torch.core.hierarchy import build_hierarchy
    from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood, knn_neighborhood
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.models import init_parameters, presets
    from se3conv3d_tpu_torch.nn import LoRAttConv, MultiHeadAttConv
    from se3conv3d_tpu_torch.train import schedule

    hcfg = presets.hierarchy_config_from_model_dict(presets.DFAUST_I_STANDARD_MODEL, POINTS)
    h = build_hierarchy(batch["positions"], batch["mask"], batch["features"], hcfg,
                        generator=torch.Generator(device=dev).manual_seed(13))[0]
    pc = h.levels[0]
    neigh = knn_neighborhood(pc, pc, ATT_K)
    gen = torch.Generator(device=dev).manual_seed(162)
    x = torch.randn(*pc.mask.shape, ATT_C, device=dev, generator=gen)
    proj = torch.randn(*pc.mask.shape, ATT_C, device=dev, generator=gen)
    pc2 = PointCloud(pc.positions[:2].contiguous(), pc.mask[:2].contiguous())
    nb2 = knn_neighborhood(pc2, pc2, ATT_K)
    out = {}
    for name, cls in (("MultiHeadAttConv", MultiHeadAttConv), ("LoRAttConv", LoRAttConv)):
        layer = cls(ATT_C, ATT_C, num_basis=ATT_Q, num_heads=ATT_HEADS)
        init_gen = torch.Generator().manual_seed(163)
        layer.reset_parameters(init_gen)
        init_parameters(layer, init_gen)
        layer = layer.to(dev)
        before = read_launches(kfe)
        with torch.no_grad():
            layer(pc, pc, x, neigh, calibrate=True)
        sides = {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            lyr = copy.deepcopy(layer).to(where)
            src = pc2.to(where)
            nb = Neighborhood(nb2.idx.to(where), nb2.mask.to(where), nb2.query_mask.to(where), nb2.method,
                              nb2.radius)
            xs = x[:2].to(where).requires_grad_()
            y = lyr(src, src, xs, nb)
            (y * proj[:2].to(where)).sum().backward()
            grads = {n: p.grad.cpu() for n, p in lyr.named_parameters()}
            grads["features"] = xs.grad.cpu()
            sides[side] = (y.detach().cpu(), grads)
        err = max_rel_err(sides["card"][0], sides["cpu"][0])
        norm = float(schedule.global_norm(list(sides["cpu"][1].values())))
        worst, worst_name = grads_ratio(sides["card"][1], sides["cpu"][1], norm)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: layer(pc, pc, x, neigh), 10)
        xg = x.clone().requires_grad_()

        def step():
            y = layer(pc, pc, xg, neigh)
            (y * proj).sum().backward()

        step_ms = cuda_ms(step, 5)
        peak_mib = call_peak_mib(step)
        layer.zero_grad(set_to_none=True)
        kernels = [a - b for a, b in zip(read_launches(kfe), before)]
        print(f"attention {name}: B,N,K,C,Q,heads = {tuple(pc.mask.shape) + (ATT_K, ATT_C, ATT_Q, ATT_HEADS)}; "
              f"card vs cpu at B = 2: max |out| diff {err[0]:.3e}, relative {err[1]:.3e} (bound {KERNEL_RTOL}); "
              f"gradients worst {worst:.3e} at {worst_name} (bound {GRAD_RTOL}); forward {fwd_ms:.4f} ms, forward "
              f"+ backward {step_ms:.4f} ms, its peak {peak_mib:.1f} MiB; conv kernel launches {kernels} "
              f"[{card}]", flush=True)
        if not (err[1] <= KERNEL_RTOL and worst <= GRAD_RTOL and kernels == [0, 0]):
            raise SystemExit(f"attention {name}: card and CPU disagree, or a conv kernel ran")
        out[name] = dict(max_abs_err=err[0], max_rel_err=err[1], grads_ratio=worst, forward_ms=fwd_ms,
                         forward_backward_ms=step_ms, peak_mib=peak_mib)
    return out


def run_zoo(card, dev, mn_batch) -> dict:
    """34. the rest of the model zoo at full widths: the DFaust variants
    (``ZOO_VARIANTS``), PCA frames over a ball query, ClassNet's global
    feature vector on ``mn_batch``, 64 basis functions and the attention
    convs."""
    from se3conv3d_tpu_torch.models import presets

    t0 = time.perf_counter()
    batch = to_device(body_batch(BATCH, POINTS, seed=2), dev)
    small = to_device(body_batch(2, POINTS, seed=4), dev)
    model_dict = presets.DFAUST_I_ROT_PCA_2F_MODEL
    spec = presets.spec_from_model_dict(model_dict)
    out = {"variants": {}}
    for label, (fields, net) in ZOO_VARIANTS.items():
        model = zoo_model(dataclasses.replace(spec, **fields), net, dev)
        out["variants"][label] = zoo_dfaust_run(card, dev, label, model, model_dict, batch, small)
        del model
        torch.cuda.empty_cache()
    bq_dict = {**model_dict, "RefFrames": {**model_dict["RefFrames"], "neigh_method": "ball_query",
                                           "neigh_kwargs": {"neigh_k": BQ_NEIGH_K, "bq_radius": BQ_RADIUS}}}
    frames = bq_frames_card_vs_cpu(card, dev, presets.hierarchy_config_from_model_dict(bq_dict, POINTS), small)
    out["ball_query"] = dict(frames=frames, run=zoo_dfaust_run(
        card, dev, "dfaust_ball_query_frames", zoo_model(spec, "FPNSegUNet", dev), bq_dict, batch, small))
    torch.cuda.empty_cache()
    out["modelnet_global"] = modelnet_global(card, dev, mn_batch)
    torch.cuda.empty_cache()
    out["q64_conv"] = q64_kernels(card, dev, mixf_fill(dev, batch, presets.DFAUST_I_STANDARD_MODEL))
    out["q64_models"] = q64_models(card, dev, batch)
    out["attention"] = attention_layers(card, dev, batch)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 34: {out['seconds']:.2f} s [{card}]", flush=True)
    return out


def zoo_entries(zoo: dict) -> list:
    """The ``{"kernels": [...]}`` entries of phase 34: the conv kernels'
    instantiations at Q = 64 (the standard geometry with the wide basis
    tile, its bfloat16 under ``"bf16"``; the kernel points, P = 55 at the
    top and P = 13 under ``"by_case"``; the equivariant geometry at G = F =
    2), each with its launches on the Q = 64 model paths; and the O = 1024
    conv of ClassNet's global feature vector (the kD = 9 instantiation at
    G*Q = 64) with the launches of that path."""
    qc, qm, mg = zoo["q64_conv"], zoo["q64_models"], zoo["modelnet_global"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    src = {kind: f"se3conv3d_tpu_torch/kernels/csrc/fused_equiv_{kind}.cu" for kind in ("fwd", "bwd")}
    tpu = {"fwd": "se3conv3d_tpu/ops/pallas/fused_equiv.py:196", "bwd": "se3conv3d_tpu/ops/pallas/fused_equiv.py:227"}
    lib = {"fwd": "library_ms", "bwd": "products_library_ms"}
    tops = {"kD=3,Q=64": ("dfaust_std_level0_conv_q64", "dfaust_std_q64"),
            "kp,Q=64": ("dfaust_std_level0_conv_q64_kp_gauss_double", "dfaust_std_kp_gauss_double_q64"),
            "kD=9,G=2,Q=64": ("dfaust_level0_conv_q64_g2", "dfaust_rot_pca_2F_q64")}
    entries = []
    for kind, which in (("fwd", 0), ("bwd", 1)):
        for tag, (shape, path) in tops.items():
            top = qc[shape]["float32"][kind]
            entry = {"name": f"fused_equiv_{kind}[{tag}]", "route": "cuda", "source": src[kind],
                     "replaces": tpu[kind], "launches": qm[path]["launches"][which],
                     "launches_by_path": {f"{path}_train": qm[path]["launches"][which]},
                     **{k: top[k] for k in keys}, "library_ms": top[lib[kind]],
                     "at": f"{shape} B,M,N,K,G,F,Q,C,O={Q64_SHAPES[shape][0]} at the bodies' level-0 fill, float32"}
            if tag == "kD=3,Q=64":
                b0 = qc[shape]["bfloat16"][kind]
                entry["bf16"] = {**{k: b0[k] for k in keys}, "library_ms": b0[lib[kind]]}
            if tag == "kp,Q=64":
                entry["by_case"] = {s: qc[s]["float32"][kind] for s in Q64_SHAPES if "_kp_" in s}
            entries.append(entry)
        top = mg["conv"][kind]
        entries.append({"name": f"fused_equiv_{kind}[modelnet_global,O=1024]", "route": "cuda", "source": src[kind],
                        "replaces": tpu[kind], "launches": mg["launches"][which],
                        "launches_by_path": {"modelnet_global": mg["launches"][which]},
                        **{k: top[k] for k in keys}, "library_ms": top[lib[kind]], "plan": mg["conv"]["plan"],
                        "at": f"global_conv_down B,M,N,K,G,F,Q,C,O={mg['conv']['shape']} at the extra level's "
                              "fill, float32"})
    return entries


# phase 35: data parallelism on the DFaust recipe at full width, in three
# configurations: (a) one process, no group; (b) a one-rank NCCL group on the
# card; (c) two ranks on the card over gloo, 16 bodies each.  The first
# DDP_MASKED bodies lose their last 25% of points, so rank 0's half holds
# fewer valid points than rank 1's.
DDP_BATCH, DDP_MASKED, DDP_TIMED_STEPS, DDP_DRYRUN_STEPS = 32, 8, 3, 3
DDP_LOSS_RTOL, DDP_STATE_RTOL = 1e-5, 1e-5
# the BN statistics and calibration buffers a state comparison reads
STAT_NAMES = ("mean", "var", "norm_neigh_dist", "norm_num_neighs", "trunc_frac")


def ddp_batch() -> dict:
    """Phase 35's global batch (on the CPU): ``body_batch`` with the last
    25% of the points of the first ``DDP_MASKED`` bodies masked off."""
    batch = body_batch(DDP_BATCH, POINTS, seed=35)
    batch["mask"][:DDP_MASKED, POINTS * 3 // 4:] = False
    return batch


def ddp_draws(dev, batch) -> dict:
    """The global batch's random numbers, recorded once on the CPU: the
    hierarchy draws of the calibration pass, of the train step and of the
    eval pass, and the train step's DropPath keep masks (from a train-mode
    forward of a seeded model)."""
    from se3conv3d_tpu_torch.core.hierarchy import draw_hierarchy
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws

    class Keeping(DropPathDraws):
        def __init__(self, generator):
            super().__init__(generator)
            self.masks = []

        def keep_mask(self, b, keep, like):
            mask = super().keep_mask(b, keep, like)
            self.masks.append(mask.cpu())
            return mask

    trainer = ddp_trainer(dev)
    gen = torch.Generator().manual_seed(350)
    b, n = batch["mask"].shape
    out = {k: draw_hierarchy(cfg, b, n, gen) for k, cfg in
           (("calib", trainer.hcfg), ("step", trainer.hcfg), ("eval", trainer.eval_hcfg))}
    keeping = Keeping(torch.Generator(device=dev).manual_seed(351))
    h, f0, out_pc, out_labels, _ = trainer.build(to_device(batch, dev), draws=draws_at(out["step"], range(b), dev))
    with torch.no_grad():
        trainer.model.train()
        trainer._forward(h, f0, out_pc, drops=keeping)
    out["masks"] = keeping.masks
    return out


def draws_at(draws, idx, dev):
    """Hierarchy draws at examples ``idx``, on ``dev``."""
    from se3conv3d_tpu_torch.core.hierarchy import HierarchyDraws

    idx = list(idx)
    pick = (lambda x: None if x is None else x[idx].to(dev))
    return HierarchyDraws([pick(x) for x in draws.level_frames], pick(draws.out_uniforms), pick(draws.out_frames))


def ddp_trainer(dev, per_rank_mean=False):
    """A seeded ``dfaust_I_rot_pca_2F`` model and its trainer, the recipe's
    optimizer over ``1 + DDP_TIMED_STEPS`` steps (its peak rate from the
    first step on); ``per_rank_mean``: the control whose loss is each rank's
    own mean, its gradients averaged over the ranks (DDP's rule)."""
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.parallel import mesh
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    class PerRankMean(Trainer):
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

    md, training = presets.DFAUST_I_ROT_PCA_2F_MODEL, presets.DFAUST_I_ROT_PCA_2F_TRAINING
    model = seeded_model(md, dev)
    opt = schedule.optimizer_from_training(model.parameters(), training, 1 + DDP_TIMED_STEPS)
    cls = PerRankMean if per_rank_mean else Trainer
    return cls(model, presets.hierarchy_config_from_model_dict(md, POINTS, train=True),
               presets.hierarchy_config_from_model_dict(md, POINTS, train=False),
               label_smoothing=training["label_smoothing"], optimizer=opt)


@contextlib.contextmanager
def per_rank_bn():
    """The control whose BN layers take their own rank's rows only."""
    from se3conv3d_tpu_torch.nn import norm

    saved = norm.rank_sum
    norm.rank_sum = lambda x, dims, *extras: (x.sum(dims),) + extras
    try:
        yield
    finally:
        norm.rank_sum = saved


def cpu_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def ddp_val_counts(dev, batch, draws, halves) -> object:
    """The validation counts (``SemSegMetrics``) of a fresh seeded model,
    before calibration, so that every process holds it bit for bit: one
    eval pass per half of the global batch in ``halves`` (16 bodies each,
    with the recorded eval draws), summed over them and over the ranks
    (``cross_host_sum``)."""
    from se3conv3d_tpu_torch.parallel.multihost import cross_host_sum
    from se3conv3d_tpu_torch.train.metrics import SemSegMetrics

    trainer = ddp_trainer(dev)
    counts = SemSegMetrics.empty(CLASSES)
    for idx in halves:
        local = to_device({k: v[list(idx)] for k, v in batch.items()}, dev)
        ev = trainer.eval_step(local, draws=draws_at(draws["eval"], idx, dev))
        counts = counts.update(ev["logits"].argmax(-1), ev["labels"], ev["mask"])
    return cross_host_sum(counts)


def ddp_step(dev, batch, draws, idx, variant="sound", timed_steps=0, mode="scatter") -> dict:
    """One calibration pass and one train step of a fresh seeded trainer on
    the examples ``idx`` of the global batch, with the recorded draws at
    those examples; ``variant``: "sound", "per_rank_mean" or "per_rank_bn"
    (a control); ``mode``: the conv backward's mode for that step ('sorted'
    is deterministic).  Returns the loss, the gradients (after the sum over
    the ranks), the state after the step, the launches of the conv kernels,
    and with ``timed_steps`` the host-clock seconds of that many more steps
    (generator draws, the default 'scatter' mode) and the peak."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.ops import pne_conv as ops

    trainer = ddp_trainer(dev, per_rank_mean=variant == "per_rank_mean")
    local = to_device({k: v[list(idx)] for k, v in batch.items()}, dev)
    out = {}
    with per_rank_bn() if variant == "per_rank_bn" else contextlib.nullcontext():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kfe)
        trainer.calibration_step(local, draws=draws_at(draws["calib"], idx, dev))
        ops.BWD_SCATTER_MODE = mode
        try:
            res = trainer.train_step(local, draws=draws_at(draws["step"], idx, dev),
                                     drop_masks=[m[list(idx)] for m in draws["masks"]])
        finally:
            ops.BWD_SCATTER_MODE = "scatter"
        out["loss"], out["grad_norm"] = float(res["loss"]), float(res["grad_norm"])
        out["launches"] = (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches)
        out["grads"] = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        out["state"] = cpu_state(trainer.model)
        gen = torch.Generator(device=dev).manual_seed(352)
        times = []
        for _ in range(timed_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(local, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["step_s"], out["peak_gib"] = times, torch.cuda.max_memory_allocated() / 2**30
    return out


def ddp_dryrun(dev, batch, draws, idx) -> dict:
    """``__graft_entry__._dryrun_impl``'s contract on this rank: three steps
    on one batch (the same draws each step): the losses and the final
    state."""
    trainer = ddp_trainer(dev)
    local = to_device({k: v[list(idx)] for k, v in batch.items()}, dev)
    trainer.calibration_step(local, draws=draws_at(draws["calib"], idx, dev))
    losses = [float(trainer.train_step(local, draws=draws_at(draws["step"], idx, dev),
                                       drop_masks=[m[list(idx)] for m in draws["masks"]])["loss"])
              for _ in range(DDP_DRYRUN_STEPS)]
    return {"losses": losses, "state": cpu_state(trainer.model)}


@contextlib.contextmanager
def timing_collectives(calls: list):
    """Every ``torch.distributed.all_gather`` and ``all_reduce`` timed on
    the host clock between two device syncs, with the bytes it moved (an
    all-gather: the bytes it received), into ``calls`` as ``(kind, seconds,
    bytes)``."""
    import torch.distributed as dist

    plain = {"all_gather": dist.all_gather, "all_reduce": dist.all_reduce}

    def timed(kind):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain[kind](*args, **kwargs)
            torch.cuda.synchronize()
            moved = (sum(t.numel() * t.element_size() for t in args[0]) if kind == "all_gather"
                     else args[0].numel() * args[0].element_size())
            calls.append((kind, time.perf_counter() - t0, moved))
            return out
        return call

    dist.all_gather, dist.all_reduce = timed("all_gather"), timed("all_reduce")
    try:
        yield
    finally:
        dist.all_gather, dist.all_reduce = plain["all_gather"], plain["all_reduce"]


def ddp_rank(rank: int, batch: dict, draws: dict) -> dict:
    """Phase 35 (c), one rank of two on the card: the sound step (timed),
    the two controls, the all-reduce share of one more step, the dry-run's
    three steps, and its half's validation counts summed over the ranks."""
    from se3conv3d_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.rank_device()
    idx = range(rank * DDP_BATCH // 2, (rank + 1) * DDP_BATCH // 2)
    out = {"sound": ddp_step(dev, batch, draws, idx, timed_steps=DDP_TIMED_STEPS),
           "val_counts": ddp_val_counts(dev, batch, draws, [idx])}
    for variant in ("per_rank_mean", "per_rank_bn"):
        out[variant] = ddp_step(dev, batch, draws, idx, variant)
    calls = []
    trainer = ddp_trainer(dev)
    local = to_device({k: v[list(idx)] for k, v in batch.items()}, dev)
    trainer.calibration_step(local, draws=draws_at(draws["calib"], idx, dev))
    gen = torch.Generator(device=dev).manual_seed(353)
    trainer.train_step(local, gen)
    with timing_collectives(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(local, gen)
        torch.cuda.synchronize()
        reduce_s = [c[1] for c in calls if c[0] == "all_reduce"]
        out["reduce"] = {"step_s": time.perf_counter() - t0, "all_reduce_s": sum(reduce_s),
                         "calls": len(reduce_s)}
    del trainer
    out["dryrun"] = ddp_dryrun(dev, batch, draws, idx)
    return out


def stat_errors(state: dict, ref: dict) -> tuple:
    """The worst error of the BN running statistics and calibration
    buffers over each leaf's scale (a running mean's: the larger of its max
    |value| and the root of its variance's max): ``(error, leaf)``."""
    worst = (0.0, "")
    for k, x in ref.items():
        name = k.rpartition(".")[2]
        if name not in STAT_NAMES:
            continue
        x = x.double()
        scale = max(x.abs().max().item(), 1e-30)
        if name == "mean":
            scale = max(scale, ref[k[:-4] + "var"].double().max().item() ** 0.5)
        worst = max(worst, ((state[k].double() - x).abs().max().item() / scale, k))
    return worst


def ddp_gate(card, label, got: dict, ref: dict, phase: int = 35, grad_rtol: float = GRAD_RTOL) -> dict:
    """(c)'s gate against (a): the loss within ``DDP_LOSS_RTOL`` relative,
    every parameter's gradient within ``grad_rtol`` of its leaf
    (``grads_ratio``), the BN statistics and calibration buffers within
    ``DDP_STATE_RTOL`` (``stat_errors``)."""
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    norm = float(torch.sqrt(sum(g.double().square().sum() for g in ref["grads"].values())))
    grad_err, grad_leaf = grads_ratio(got["grads"], ref["grads"], norm)
    stat_err, stat_leaf = stat_errors(got["state"], ref["state"])
    ok = loss_err <= DDP_LOSS_RTOL and grad_err <= grad_rtol and stat_err <= DDP_STATE_RTOL
    print(f"phase {phase} {label}: loss {got['loss']:.7f} vs (a) {ref['loss']:.7f}, rel {loss_err:.3e} (bound "
          f"{DDP_LOSS_RTOL}); gradients worst {grad_err:.3e} at {grad_leaf} (bound {grad_rtol}, floor "
          f"{GRAD_FLOOR} * norm {norm:.4f}); BN statistics and calibration buffers worst {stat_err:.3e} at "
          f"{stat_leaf} (bound {DDP_STATE_RTOL}): {'within' if ok else 'outside'} the gate [{card}]", flush=True)
    return dict(loss_rel=loss_err, grad_ratio=grad_err, grad_leaf=grad_leaf, stat_err=stat_err,
                stat_leaf=stat_leaf, ok=ok)


def repeat_gate(card, b: dict, a1: dict, a2: dict) -> dict:
    """(b) against (a): bitwise where (a) repeats itself bitwise, else within
    twice (a)'s own repeat spread, leaf by leaf (parameters, BN statistics,
    calibration buffers after the step)."""
    worst, bitwise_leaves, spread_leaves = (0.0, ""), 0, 0
    for k, x in a1["state"].items():
        spread = (a2["state"][k].double() - x.double()).abs().max().item() if x.numel() else 0.0
        err = (b["state"][k].double() - x.double()).abs().max().item() if x.numel() else 0.0
        if spread == 0.0:
            bitwise_leaves += 1
            if not torch.equal(b["state"][k], x):
                grad = (b["grads"][k] - a1["grads"][k]).abs().max().item() if k in a1["grads"] else None
                raise SystemExit(f"phase 35 (b): {k} differs from (a), which repeats it bitwise: max "
                                 f"|b - a| {err:.3e}, its gradient's {grad}; loss (a) {a1['loss']!r} (b) "
                                 f"{b['loss']!r}")
        else:
            spread_leaves += 1
            worst = max(worst, (err / spread, k))
    loss_same = b["loss"] == a1["loss"]
    print(f"phase 35 (b) one-rank NCCL group vs (a): {bitwise_leaves} leaves bitwise (as (a) repeats them), "
          f"{spread_leaves} within twice (a)'s repeat spread, worst {worst[0]:.3f} x the spread at {worst[1]} "
          f"(bound 2); loss {'bitwise' if loss_same else 'differs'} [{card}]", flush=True)
    if worst[0] > 2.0:
        raise SystemExit("phase 35: the one-rank group's step is not the one-process step")
    return dict(bitwise_leaves=bitwise_leaves, spread_leaves=spread_leaves, worst_spread_ratio=worst[0],
                loss_bitwise=loss_same)


def rank_card() -> torch.device:
    """The card phase 35's groups put their ranks on: this process's."""
    return torch.device("cuda", torch.cuda.current_device())


def run_ddp(card, dev) -> dict:
    """35. data parallelism: ``dfaust_I_rot_pca_2F`` at full width, B = 32,
    in configurations (a), (b) and (c) (module note); the gates and
    controls of ``ddp_gate`` / ``repeat_gate``, the dry-run contract, the
    validation counts; step medians, the all-reduce share of (c), peaks."""
    from se3conv3d_tpu_torch.parallel import launch, make_group
    from se3conv3d_tpu_torch.parallel.mesh import joined

    t0 = time.perf_counter()
    batch = ddp_batch()
    draws = ddp_draws(dev, batch)
    every = range(DDP_BATCH)
    # (a) and (b) take their gated step in the deterministic 'sorted' mode,
    # so that (a) repeats itself bitwise; (c) in the default 'scatter' mode
    a1 = ddp_step(dev, batch, draws, every, timed_steps=DDP_TIMED_STEPS, mode="sorted")
    a2 = ddp_step(dev, batch, draws, every, mode="sorted")
    card0 = rank_card()
    with joined(make_group(1, devices=[card0])):
        b = ddp_step(dev, batch, draws, every, timed_steps=DDP_TIMED_STEPS, mode="sorted")
    out = {"b_vs_a": repeat_gate(card, b, a1, a2)}
    group = make_group(2, devices=[card0, card0], backend="gloo")
    t1 = time.perf_counter()
    ranks = launch(group, ddp_rank, batch, draws)
    print(f"phase 35 (c): two ranks on {card0} over gloo in {time.perf_counter() - t1:.2f} s [{card}]", flush=True)
    c = ranks[0]
    for name, x in c["sound"]["state"].items():
        if not torch.equal(x, ranks[1]["sound"]["state"][name]):
            raise SystemExit(f"phase 35 (c): the ranks' {name} differ after the step")
    out["c_vs_a"] = ddp_gate(card, "(c) two ranks vs (a)", c["sound"], a1)
    if not out["c_vs_a"]["ok"]:
        raise SystemExit("phase 35: the two-rank step is not the one-process step")
    for variant in ("per_rank_mean", "per_rank_bn"):
        ctl = ddp_gate(card, f"control {variant} (must fail)", ranks[0][variant], a1)
        out[f"control_{variant}"] = ctl
        if ctl["ok"]:
            raise SystemExit(f"phase 35: the control {variant} passes the gate")
    dry = [r["dryrun"] for r in ranks]
    same = all(torch.equal(x, dry[1]["state"][k]) for k, x in dry[0]["state"].items())
    print(f"phase 35 dry-run: losses over {DDP_DRYRUN_STEPS} steps on one batch {dry[0]['losses']} (rank 1 "
          f"{dry[1]['losses']}); ranks' parameters and statistics bitwise equal: {same} [{card}]", flush=True)
    if not (same and dry[0]["losses"][-1] < dry[0]["losses"][0]):
        raise SystemExit("phase 35: the dry-run contract fails")
    counts = [r["val_counts"] for r in ranks]
    half = DDP_BATCH // 2
    ref = ddp_val_counts(dev, batch, draws, [range(half), range(half, DDP_BATCH)])
    equal = all(np.array_equal(getattr(c_, f), getattr(ref, f)) for c_ in counts
                for f in ("intersection", "union", "gt_count", "pred_count"))
    sums = {name: [int(getattr(x, f).sum()) for f in ("intersection", "union", "gt_count", "pred_count")]
            for name, x in (("(c)", counts[0]), ("(a)", ref))}
    print(f"phase 35 validation counts (intersection, union, ground truth, predicted) summed over the "
          f"classes: cross_host_sum over (c) {sums['(c)']}, (a) {sums['(a)']}; equal class by class: "
          f"{equal} [{card}]", flush=True)
    if not equal:
        raise SystemExit("phase 35: the summed validation counts are not the one-process ones")
    med = {k: statistics.median(v["step_s"]) for k, v in (("a", a1), ("b", b), ("c_rank0", c["sound"]),
                                                            ("c_rank1", ranks[1]["sound"]))}
    share = [r["reduce"]["all_reduce_s"] / r["reduce"]["step_s"] for r in ranks]
    print(f"phase 35 step medians (host clock, {DDP_TIMED_STEPS} steps): (a) {med['a']:.4f} s at B = 32, (b) "
          f"{med['b']:.4f} s (NCCL world 1, {100 * (med['b'] / med['a'] - 1):+.1f}% against (a)), (c) rank 0 "
          f"{med['c_rank0']:.4f} s / rank 1 {med['c_rank1']:.4f} s at 16 bodies each, both ranks on one card; "
          f"all-reduce share of a (c) step {100 * share[0]:.1f}% / {100 * share[1]:.1f}% "
          f"({ranks[0]['reduce']['calls']} calls, {ranks[0]['reduce']['all_reduce_s']:.4f} s of "
          f"{ranks[0]['reduce']['step_s']:.4f} s, with a device sync around each); peaks (a) "
          f"{a1['peak_gib']:.3f} GiB, (b) {b['peak_gib']:.3f} GiB, (c) {c['sound']['peak_gib']:.3f} / "
          f"{ranks[1]['sound']['peak_gib']:.3f} GiB [{card}]", flush=True)
    launches = {"ddp_a_train": a1["launches"], "ddp_b_train_nccl_world1": b["launches"],
                "ddp_c_train_rank0": c["sound"]["launches"], "ddp_c_train_rank1": ranks[1]["sound"]["launches"]}
    for name, (fwd, bwd) in launches.items():
        if fwd != 2 * CONVS_PER_FORWARD or bwd != CONVS_PER_FORWARD:
            raise SystemExit(f"phase 35 {name}: launches fwd {fwd} bwd {bwd}, expected "
                             f"{2 * CONVS_PER_FORWARD} / {CONVS_PER_FORWARD} (calibration and one step)")
    out.update(launches=launches, step_median_s=med, all_reduce_share=share,
               all_reduce_calls=ranks[0]["reduce"]["calls"],
               peak_gib={"a": a1["peak_gib"], "b": b["peak_gib"], "c_rank0": c["sound"]["peak_gib"],
                         "c_rank1": ranks[1]["sound"]["peak_gib"]},
               dryrun_losses=dry[0]["losses"], seconds=time.perf_counter() - t0)
    print(f"phase 35: {out['seconds']:.2f} s [{card}]", flush=True)
    return out


# phase 36: the dense-voxel MinkUNet34A at its defaults on two synthetic
# rooms, and card vs CPU on one room at MINK_SMALL_GRID
MINK_ROOMS, MINK_ROOM_POINTS, MINK_SMALL_GRID, MINK_RTOL = (100, 101), 120_000, (32, 16, 32), 2e-4


def mink_room(seed: int) -> dict:
    """A ``room_scene`` on the grid's axes: its height on the 48-voxel axis,
    its colors as the 3 input features, labels taken modulo 20."""
    room = room_scene(MINK_ROOM_POINTS, seed)
    return {"positions": room["positions"][:, [0, 2, 1]].contiguous(), "mask": room["mask"],
            "features": room["features"][:, 3:].contiguous(), "labels": room["labels"] % CLASSES}


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def mink_times(model, batch, tf32: bool) -> dict:
    """The forward (eval) and one AdamW train step, host clock, median of
    3 after one warm-up each, and the step's peak."""
    with cudnn_tf32(tf32):
        model.eval()
        with torch.no_grad():
            fwd = cuda_ms(lambda: model(batch["positions"], batch["mask"], batch["features"]), 3)
        model.train()
        opt = torch.optim.AdamW(model.parameters(), 1e-3)

        def step():
            logits = model(batch["positions"], batch["mask"], batch["features"])
            loss = torch.nn.functional.cross_entropy(logits[batch["mask"]], batch["labels"][batch["mask"]])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train = cuda_ms(step, 3)
        loss = float(step())
    return {"fwd_ms": fwd, "step_ms": train, "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loss": loss}


def run_minkunet(card, dev) -> dict:
    """36. ``MinkUNet34A`` at the module's defaults (grid (96, 48, 96), cell
    0.1, 20 classes, 3 input features) on two rooms of 120,000 points: the
    forward and one train step, cuDNN's TF32 on and off; then card (TF32
    off) vs CPU logits on one room at ``MINK_SMALL_GRID``, beside the
    control with the transposed convs' kernels unflipped."""
    from se3conv3d_tpu_torch.models.minkunet import MinkUNet34A

    t0 = time.perf_counter()
    rooms = [mink_room(s) for s in MINK_ROOMS]
    batch = to_device(stack_scenes(rooms), dev)
    model = MinkUNet34A(CLASSES, 3, generator=torch.Generator().manual_seed(36)).to(dev)
    times = {f"tf32_{on}": mink_times(model, batch, on) for on in (True, False)}
    for k, v in times.items():
        if not np.isfinite(v["loss"]):
            raise SystemExit(f"phase 36: non-finite MinkUNet loss with {k}")
    print(f"phase 36 MinkUNet34A grid (96, 48, 96), 2 rooms x {MINK_ROOM_POINTS} points: forward "
          f"{times['tf32_True']['fwd_ms']:.2f} ms (cuDNN TF32 on) / {times['tf32_False']['fwd_ms']:.2f} ms (off); "
          f"train step {times['tf32_True']['step_ms']:.2f} / {times['tf32_False']['step_ms']:.2f} ms; peak "
          f"{times['tf32_True']['peak_gib']:.3f} / {times['tf32_False']['peak_gib']:.3f} GiB; "
          f"{sum(p.numel() for p in model.parameters())} parameters [{card}]", flush=True)
    del model, batch
    torch.cuda.empty_cache()

    small = MinkUNet34A(CLASSES, 3, grid_dims=MINK_SMALL_GRID, generator=torch.Generator().manual_seed(37))
    room = stack_scenes(rooms[:1])
    with torch.no_grad():
        cpu_logits = small.eval()(room["positions"], room["mask"], room["features"])
        card_model = copy.deepcopy(small).to(dev).eval()
        with cudnn_tf32(False):
            on_card = card_model(*(room[k].to(dev) for k in ("positions", "mask", "features"))).cpu()
            for conv, _ in card_model.ups:
                conv.weight.copy_(conv.weight.flip(2, 3, 4))
            control = card_model(*(room[k].to(dev) for k in ("positions", "mask", "features"))).cpu()
        with cudnn_tf32(True):
            for conv, _ in card_model.ups:
                conv.weight.copy_(conv.weight.flip(2, 3, 4))
            tf32 = card_model(*(room[k].to(dev) for k in ("positions", "mask", "features"))).cpu()
    span = cpu_logits.abs().max().item()
    err, ctl_err, tf32_err = ((x - cpu_logits).abs().max().item() / span for x in (on_card, control, tf32))
    print(f"phase 36 card vs CPU, one room at grid {MINK_SMALL_GRID}: max |card - cpu| / max |cpu| = "
          f"{err:.3e} (bound {MINK_RTOL}, cuDNN allow_tf32 False); control, the ups' kernels unflipped: "
          f"{ctl_err:.3e} (must exceed the bound); with allow_tf32 True: {tf32_err:.3e} [{card}]", flush=True)
    if not (err <= MINK_RTOL < ctl_err):
        raise SystemExit("phase 36: MinkUNet34A card vs CPU gate failed, or its control passed")
    out = dict(times=times, card_vs_cpu=err, control=ctl_err, tf32_vs_cpu=tf32_err, seconds=time.perf_counter() - t0)
    print(f"phase 36: {out['seconds']:.2f} s [{card}]", flush=True)
    return out


# phase 37: farthest-point sampling at the DFaust shape
FPS_SAMPLES, FPS_TIE_VALID = 1024, (300, 1)


def run_fps(card, dev) -> dict:
    """37. ``fps_subsample`` of B = 32 bodies x 4096 points -> 1024 on the
    card: ``ids`` and ``nearest`` equal the CPU's exactly, timed; then the
    ties: two bodies left with ``FPS_TIE_VALID`` valid points, so every
    later pick is the first valid point again."""
    from se3conv3d_tpu_torch.core.fps import fps_subsample
    from se3conv3d_tpu_torch.core.pointcloud import PointCloud

    t0 = time.perf_counter()
    batch = body_batch(BATCH, POINTS, seed=37)
    out = {}
    for case in ("bodies", "ties"):
        mask = batch["mask"].clone()
        if case == "ties":
            for i, v in enumerate(FPS_TIE_VALID):
                mask[i, v:] = False
        pc = PointCloud(batch["positions"], mask)
        on_card = PointCloud(pc.positions.to(dev), pc.mask.to(dev))
        ms = cuda_ms(lambda: fps_subsample(on_card, FPS_SAMPLES), 3)
        got = fps_subsample(on_card, FPS_SAMPLES)
        t1 = time.perf_counter()
        ref = fps_subsample(pc, FPS_SAMPLES)
        cpu_s = time.perf_counter() - t1
        same = all(torch.equal(getattr(got, k).cpu(), getattr(ref, k)) for k in ("ids", "out_mask", "nearest"))
        if case == "ties":
            same = same and all(bool((got.ids[i, v:] == 0).all()) for i, v in enumerate(FPS_TIE_VALID))
        print(f"phase 37 fps {case}: B = {BATCH} x {POINTS} -> {FPS_SAMPLES}: card {ms:.2f} ms, CPU {cpu_s:.2f} s; "
              f"ids, out_mask and nearest equal the CPU's: {same} [{card}]", flush=True)
        if not same:
            raise SystemExit(f"phase 37: FPS on the card differs from the CPU ({case})")
        out[case] = {"ms": ms, "cpu_s": cpu_s}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 37: {out['seconds']:.2f} s [{card}]", flush=True)
    return out


# phase 38: the (data, points) mesh on the card.  (a) one process, no group,
# on one synthetic room of SCENE_POINTS points (numpy seed 100) of the ScanNet
# recipe as written (bfloat16) and in float32; (b) the same room over a
# (data=1, points=2) group of two gloo ranks on the card, each holding half
# of the raw points, the gated step of each dtype against (a)'s beside two
# controls (each rank's convs reading only the source rows it owns; each
# rank's own BN statistics); (c) the dry-run configuration of
# __graft_entry__.py, (data=2, points=2), four gloo ranks on the card on the
# DFaust recipe at full width, POINTS_BODIES bodies (numpy seed 38).  Every
# gated step runs in the deterministic 'sorted' mode.  A level's valid rows
# come first (the grid subsample's order), and the room fills about a sixth
# of the recipe's capacities, so at those capacities the second rank of (b)
# holds padding rows only; (a) and (b) therefore also run the float32 step at
# the capacity bucket POINTS_BUCKET (``HierarchyConfig.with_capacity``, the
# eval CLI's rescaling of every level), where both ranks hold valid rows.
POINTS_ROOM_SEED, POINTS_TIMED_STEPS, POINTS_BODIES, POINTS_DRYRUN_STEPS = 100, 1, 4, 3
POINTS_BUCKET = 32768
# the float32 gate of (b): every parameter's gradient within this much of
# max(max |leaf|, GRAD_FLOOR * global norm) of (a)'s (grads_ratio); the
# sound step reads 3.60e-6 at the recipe's capacities and 7.81e-6 at the
# bucket (NVIDIA H100 80GB HBM3, 700 W), the own-rows control 0.4-0.53
POINTS_GRAD_RTOL = 5e-5
# the bfloat16 gate of (b): its gradients' distance from the float32 step's
# over every leaf, over (a)'s, within this factor either way (points_gate)
POINTS_BF16_PARITY = 1.25
# the configurations of (a) and (b): name: (dtype, at POINTS_BUCKET)
POINTS_CONFIGS = {"bfloat16": ("bfloat16", False), "float32": ("float32", False),
                  "bfloat16_bucket": ("bfloat16", True), "float32_bucket": ("float32", True)}
# (b)'s controls, which must fail the gate of their configuration: (variant,
# configuration); at the recipe's capacities the first rank holds every
# valid row, so neither control would change a thing there
POINTS_CONTROLS = (("own_rows_only", "float32_bucket"), ("per_rank_bn", "float32_bucket"),
                   ("own_rows_only", "bfloat16_bucket"))


def points_room() -> dict:
    """Phase 38's room (on the CPU), ``[1, SCENE_POINTS, ...]``."""
    return stack_scenes([room_scene(SCENE_POINTS, POINTS_ROOM_SEED)])


def points_room_draws(dev, room) -> dict:
    """The room's random numbers, recorded once on the CPU, at the recipe's
    capacities (``"full"``) and at ``POINTS_BUCKET`` (``"bucket"``): the
    hierarchy draws of the calibration pass and of the step, and the step's
    DropPath keep masks (from a train-mode forward of a seeded model)."""
    from se3conv3d_tpu_torch.core.hierarchy import draw_hierarchy
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws

    class Keeping(DropPathDraws):
        def __init__(self, generator):
            super().__init__(generator)
            self.masks = []

        def keep_mask(self, b, keep, like):
            mask = super().keep_mask(b, keep, like)
            self.masks.append(mask.cpu())
            return mask

    out = {}
    for key, bucket in (("full", None), ("bucket", POINTS_BUCKET)):
        trainer = points_trainer(dev, "bfloat16", bucket)
        gen = torch.Generator().manual_seed(380)
        draws = {k: draw_hierarchy(trainer.hcfg, 1, SCENE_POINTS, gen) for k in ("calib", "step")}
        keeping = Keeping(torch.Generator(device=dev).manual_seed(381))
        h, f0, out_pc, _, _ = trainer.build(to_device(room, dev), draws=draws_at(draws["step"], [0], dev))
        with torch.no_grad():
            trainer.model.train()
            trainer._forward(h, f0, out_pc, drops=keeping)
        out[key] = dict(draws, masks=keeping.masks)
        del trainer, h, f0, out_pc
    return out


def points_trainer(dev, dt: str, bucket=None):
    """A seeded ``scannet20_rot_pca_I`` model in ``dt`` (the recipe as
    written is bfloat16) and its trainer, the recipe's optimizer over
    ``1 + POINTS_TIMED_STEPS`` steps; ``bucket``: every level's capacity
    rescaled for that many points (``HierarchyConfig.with_capacity``)."""
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.train import schedule
    from se3conv3d_tpu_torch.train.trainer import Trainer

    md, training = scannet_recipes()[dt], presets.SCANNET20_ROT_PCA_I_TRAINING
    model = seeded_model(md, dev, presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES)
    opt = schedule.optimizer_from_training(model.parameters(), training, 1 + POINTS_TIMED_STEPS)
    hcfg = presets.hierarchy_config_from_model_dict(md, SCENE_POINTS, train=True)
    with warnings.catch_warnings():  # scan_scenes is ignored in a group, with a warning
        warnings.simplefilter("ignore", RuntimeWarning)
        return Trainer(model, hcfg if bucket is None else hcfg.with_capacity(bucket),
                       label_smoothing=training["label_smoothing"], ignore_label=presets.SCANNET20_IGNORE_LABEL,
                       optimizer=opt, scan_scenes=training["scan_scenes"])


@contextlib.contextmanager
def own_rows_only():
    """The control whose conv layers read only the source rows their rank
    owns (the other ranks' rows of each gathered level are zeros)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.parallel import mesh

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


def points_step(dev, room, all_draws, config: str, variant: str = "sound", timed_steps: int = 0,
                spread: bool = False) -> dict:
    """One calibration pass and one train step in the 'sorted' mode of a
    fresh seeded trainer of ``POINTS_CONFIGS[config]`` on this process's
    share of the room (all of it outside a points group, its rows in one:
    ``shard_points``), with the recorded draws; ``variant`` "sound",
    "own_rows_only" or "per_rank_bn" (a control); ``spread``: first, on a
    trainer of its own, the gradients of the same calibration pass and step
    in the 'scatter' mode, for the spread of two orders of summation.
    Returns the loss, the gradients (summed over the group),
    the state, the launches of the conv kernels and of the prefix sum (all,
    and the bfloat16 ones), each level's valid rows that this process holds,
    its peak, and with ``timed_steps`` the host-clock seconds of that many
    more steps (generator draws, the same on every rank of a points row)."""
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws
    from se3conv3d_tpu_torch.ops import pne_conv as ops
    from se3conv3d_tpu_torch.parallel import mesh
    from se3conv3d_tpu_torch.parallel.multihost import shard_points

    dt, bucket = POINTS_CONFIGS[config]
    draws = all_draws["bucket" if bucket else "full"]
    trainer = points_trainer(dev, dt, POINTS_BUCKET if bucket else None)
    local = to_device(shard_points(room), dev)
    control = {"own_rows_only": own_rows_only, "per_rank_bn": per_rank_bn}.get(variant, contextlib.nullcontext)
    out = {}
    if spread:
        other = points_trainer(dev, dt, POINTS_BUCKET if bucket else None)
        other.calibration_step(local, draws=draws_at(draws["calib"], [0], dev))
        h, f0, out_pc, out_labels, _ = other.build(local, draws=draws_at(draws["step"], [0], dev))
        other.backward(h, f0, out_pc, out_labels, DropPathDraws(keep_masks=draws["masks"]))
        out["scatter_grads"] = {n: p.grad.detach().float().cpu().clone() for n, p in other.model.named_parameters()}
        del other, h, f0, out_pc, out_labels
        torch.cuda.empty_cache()
    with control():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kfe, segsum)
        trainer.calibration_step(local, draws=draws_at(draws["calib"], [0], dev))
        if dt == "float32" and variant == "sound":  # the rows this process holds, by level
            h, _, out_pc, _, _ = trainer.build(local, draws=draws_at(draws["step"], [0], dev))
            out["valid_rows"] = [int(pc.mask.sum()) for pc in h.levels] + [int(out_pc.mask.sum())]
            out["rows"] = [pc.capacity for pc in h.levels] + [out_pc.capacity]
            del h, out_pc
        ops.BWD_SCATTER_MODE = "sorted"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = trainer.train_step(local, draws=draws_at(draws["step"], [0], dev), drop_masks=draws["masks"])
            torch.cuda.synchronize()
            out["step_s"] = [time.perf_counter() - t0]
            out["loss"] = float(res["loss"])
            out["launches"] = (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches,
                               segsum.blocked_cumsum.launches)
            out["bf16_launches"] = (kfe.fused_equiv_fwd.bf16_launches, kfe.fused_equiv_bwd.bf16_launches)
            out["grads"] = {n: p.grad.detach().float().cpu().clone() for n, p in trainer.model.named_parameters()}
            out["state"] = cpu_state(trainer.model)
            gen = torch.Generator(device=dev).manual_seed(382)
            for _ in range(timed_steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(local, gen)
                torch.cuda.synchronize()
                out["step_s"].append(time.perf_counter() - t0)
        finally:
            ops.BWD_SCATTER_MODE = "scatter"
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if timed_steps and mesh.points_size() > 1:  # the collectives' share of one more step
        calls = []
        with timing_collectives(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(local, gen)
            torch.cuda.synchronize()
            out["collectives"] = {"step_s": time.perf_counter() - t0, "calls": len(calls)}
        for kind in ("all_gather", "all_reduce"):
            picked = [c for c in calls if c[0] == kind]
            out["collectives"][kind] = {"calls": len(picked), "s": sum(c[1] for c in picked),
                                        "bytes": sum(c[2] for c in picked)}
    return out


def points_group_rank(rank: int, room: dict, draws: dict) -> dict:
    """Phase 38 (b), one rank of a (data=1, points=2) group on the card: the
    sound step of each configuration (bfloat16 timed, with the collectives'
    share of one more step), then the controls ``POINTS_CONTROLS``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from se3conv3d_tpu_torch.parallel import mesh

    dev = mesh.rank_device()
    out = {c: points_step(dev, room, draws, c, timed_steps=POINTS_TIMED_STEPS if c == "bfloat16" else 0)
           for c in POINTS_CONFIGS}
    for variant, config in POINTS_CONTROLS:
        out[f"{variant}_{config}"] = points_step(dev, room, draws, config, variant)
    return out


def points_dryrun_rank(rank: int, batch: dict, draws: dict) -> dict:
    """Phase 38 (c), one rank of a (data=2, points=2) group on the card:
    ``__graft_entry__``'s dry-run contract, three steps on one batch (the
    same draws each step) of the DFaust recipe at full width on its data
    row's bodies (``process_slice``) and its rows of them (``shard_points``):
    the losses, the final state and the launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.parallel import mesh
    from se3conv3d_tpu_torch.parallel.multihost import process_slice, shard_points

    dev = mesh.rank_device()
    idx = process_slice(list(range(POINTS_BODIES)))
    trainer = ddp_trainer(dev)
    local = to_device(shard_points({k: v[idx] for k, v in batch.items()}), dev)
    reset_launches(kfe)
    trainer.calibration_step(local, draws=draws_at(draws["calib"], idx, dev))
    losses = [float(trainer.train_step(local, draws=draws_at(draws["step"], idx, dev),
                                       drop_masks=[m[idx] for m in draws["masks"]])["loss"])
              for _ in range(POINTS_DRYRUN_STEPS)]
    return {"losses": losses, "state": cpu_state(trainer.model), "coords": (mesh.data_rank(), mesh.points_rank()),
            "launches": (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches)}


def points_gate(card, label, got: dict, ref: dict, control=None) -> dict:
    """(b)'s gate against (a): float32 by ``ddp_gate`` (loss
    ``DDP_LOSS_RTOL``, gradients ``POINTS_GRAD_RTOL`` a leaf, BN statistics
    and calibration buffers ``DDP_STATE_RTOL``).  bfloat16, given ``control``
    ((a)'s float32 step of the same weights): the loss, BN statistics and
    calibration buffers within ``BF16_GRAD_RTOL``, and the gradients as far
    from the float32 step's as (a)'s are, over every leaf, within a factor
    ``POINTS_BF16_PARITY`` either way: a path that skipped a bfloat16
    rounding comes closer, a wrong one goes farther.  (A bfloat16 step
    diverges from itself under any change in the order of its float32 sums,
    which flips roundings: (a)'s own 'scatter' and 'sorted' gradients differ
    by twice ``BF16_GRAD_RTOL`` a leaf, so that per-leaf bound is printed
    beside the gate, not gated.)"""
    if control is None:
        return ddp_gate(card, label, got, ref, phase=38, grad_rtol=POINTS_GRAD_RTOL)
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    norm = float(torch.sqrt(sum(g.double().square().sum() for g in ref["grads"].values())))
    grad_err, grad_leaf = grads_ratio(got["grads"], ref["grads"], norm)
    stat_err, stat_leaf = stat_errors(got["state"], ref["state"])
    whole = grads_norm_ratio(got["grads"], ref["grads"])
    off_b, off_a = grads_norm_ratio(got["grads"], control), grads_norm_ratio(ref["grads"], control)
    parity = off_b / off_a
    ok = (max(loss_err, stat_err) <= BF16_GRAD_RTOL
          and 1.0 / POINTS_BF16_PARITY <= parity <= POINTS_BF16_PARITY)
    print(f"phase 38 {label}: loss {got['loss']:.7f} vs (a) {ref['loss']:.7f}, rel {loss_err:.3e}; BN statistics "
          f"and calibration buffers worst {stat_err:.3e} at {stat_leaf} (bound {BF16_GRAD_RTOL} each); gradients "
          f"against the float32 step over every leaf: (b) {off_b:.3e}, (a) {off_a:.3e}, ratio {parity:.3f} (bound "
          f"{POINTS_BF16_PARITY} either way); (b) vs (a) worst {grad_err:.3e} a leaf at {grad_leaf} ({BF16_GRAD_RTOL}"
          f" printed, not gated), {whole:.3e} over every leaf: {'within' if ok else 'outside'} the gate "
          f"[{card}]", flush=True)
    return dict(loss_rel=loss_err, grad_ratio=grad_err, grad_leaf=grad_leaf, stat_err=stat_err,
                stat_leaf=stat_leaf, whole=whole, off_float32=off_b, a_off_float32=off_a, parity=parity, ok=ok)


def run_points(card, dev) -> dict:
    """38. the (data, points) mesh: (a) one process, (b) a (1, 2) group and
    (c) a (2, 2) group on the card (module note); the gates and controls,
    the step medians, each rank's peak beside (a)'s, the collectives' share
    and bytes, the valid rows per rank and level, the launches."""
    from se3conv3d_tpu_torch.parallel import launch, make_group

    t0 = time.perf_counter()
    room = points_room()
    draws = points_room_draws(dev, room)
    a = {c: points_step(dev, room, draws, c, timed_steps=POINTS_TIMED_STEPS if c == "bfloat16" else 0,
                        spread=c == "bfloat16") for c in POINTS_CONFIGS}
    ab = a["bfloat16"]
    norm = float(torch.sqrt(sum(g.double().square().sum() for g in ab["grads"].values())))
    spread = grads_ratio(ab["scatter_grads"], ab["grads"], norm)
    out = {"a_bf16_scatter_vs_sorted": {"grad_ratio": spread[0], "grad_leaf": spread[1],
                                        "whole": grads_norm_ratio(ab["scatter_grads"], ab["grads"])}}
    print(f"phase 38 (a) bfloat16, the same step's gradients in the 'scatter' mode against the 'sorted' one (its "
          f"own spread over two orders of summation): worst {spread[0]:.3e} at {spread[1]}, over every leaf "
          f"{out['a_bf16_scatter_vs_sorted']['whole']:.3e} [{card}]", flush=True)
    torch.cuda.empty_cache()
    card0 = rank_card()
    t1 = time.perf_counter()
    ranks = launch(make_group(2, devices=[card0, card0], backend="gloo", points=2), points_group_rank, room,
                   draws)
    print(f"phase 38 (b): a (data=1, points=2) group of two gloo ranks on {card0} in "
          f"{time.perf_counter() - t1:.2f} s [{card}]", flush=True)
    for c, (dt, _) in POINTS_CONFIGS.items():
        for name, x in ranks[0][c]["state"].items():
            if not torch.equal(x, ranks[1][c]["state"][name]):
                raise SystemExit(f"phase 38 (b): the ranks' {name} differ after the {c} step")
        gate = points_gate(card, f"(b) points=2 vs (a), {c}", ranks[0][c], a[c],
                           a[c.replace("bfloat16", "float32")]["grads"] if dt == "bfloat16" else None)
        out[f"b_vs_a_{c}"] = gate
        if not gate["ok"]:
            raise SystemExit(f"phase 38: the (1, 2) group's {c} step is not the one-process step")
        if dt == "bfloat16":
            for who, run in [("(a)", a[c])] + [(f"(b) rank {r}", ranks[r][c]) for r in range(2)]:
                if run["bf16_launches"] != run["launches"][:2]:
                    raise SystemExit(f"phase 38 {who}: {run['bf16_launches']} of {run['launches'][:2]} conv "
                                     "launches took bfloat16 operands")
    for variant, c in POINTS_CONTROLS:
        bf16 = POINTS_CONFIGS[c][0] == "bfloat16"
        ctl = points_gate(card, f"control {variant}, {c} (must fail)", ranks[0][f"{variant}_{c}"], a[c],
                          a[c.replace("bfloat16", "float32")]["grads"] if bf16 else None)
        out[f"control_{variant}_{c}"] = ctl
        if ctl["ok"]:
            raise SystemExit(f"phase 38: the control {variant} passes the {c} gate")
    rows = {c: {"(a)": (a[c]["rows"], a[c]["valid_rows"]),
                **{f"(b) rank {r}": (ranks[r][c]["rows"], ranks[r][c]["valid_rows"]) for r in range(2)}}
            for c in ("float32", "float32_bucket")}
    for c, by in rows.items():
        print(f"phase 38 rows per level, {c} (levels 0-4, then the output cloud): held {by['(a)'][0]} / "
              f"{by['(b) rank 0'][0]} / {by['(b) rank 1'][0]}, valid {by['(a)'][1]} / {by['(b) rank 0'][1]} / "
              f"{by['(b) rank 1'][1]} ((a) / (b) rank 0 / rank 1) [{card}]", flush=True)
    bf = "bfloat16"
    med = {"a": statistics.median(a[bf]["step_s"][1:]),
           **{f"b_rank{r}": statistics.median(ranks[r][bf]["step_s"][1:]) for r in range(2)}}
    coll = [ranks[r][bf]["collectives"] for r in range(2)]
    share = [(c["all_gather"]["s"] + c["all_reduce"]["s"]) / c["step_s"] for c in coll]
    peaks = {"a": {c: a[c]["peak_gib"] for c in POINTS_CONFIGS},
             **{f"b_rank{r}": {c: ranks[r][c]["peak_gib"] for c in POINTS_CONFIGS} for r in range(2)}}
    bucket_s = {"a": a["float32_bucket"]["step_s"][0],
                **{f"b_rank{r}": ranks[r]["float32_bucket"]["step_s"][0] for r in range(2)}}
    print(f"phase 38 step medians (host clock, bfloat16, 'sorted', the {POINTS_TIMED_STEPS} timed step(s) after "
          f"the gated one): (a) {med['a']:.4f} s, (b) rank 0 {med['b_rank0']:.4f} s / rank 1 {med['b_rank1']:.4f} s "
          f"(both ranks on one card); collectives' share of a (b) step {100 * share[0]:.1f}% / "
          f"{100 * share[1]:.1f}% (all-gather {coll[0]['all_gather']['calls']} calls "
          f"{coll[0]['all_gather']['s']:.4f} s {coll[0]['all_gather']['bytes'] / 2**20:.1f} MiB received, "
          f"all-reduce {coll[0]['all_reduce']['calls']} calls {coll[0]['all_reduce']['s']:.4f} s "
          f"{coll[0]['all_reduce']['bytes'] / 2**20:.1f} MiB, of {coll[0]['step_s']:.4f} s, a device sync "
          f"around each); the gated float32 step at the bucket: (a) {bucket_s['a']:.4f} s, (b) "
          f"{bucket_s['b_rank0']:.4f} / {bucket_s['b_rank1']:.4f} s; peaks (GiB, {list(POINTS_CONFIGS)}): "
          f"{ {k: [round(v[c], 3) for c in POINTS_CONFIGS] for k, v in peaks.items()} } [{card}]", flush=True)
    launches = {f"points_a_train_{c}": a[c]["launches"] for c in POINTS_CONFIGS}
    launches.update({f"points_b_train_{c}_rank{r}": ranks[r][c]["launches"]
                     for c in POINTS_CONFIGS for r in range(2)})
    print(f"phase 38 launches (conv forward, backward, prefix sum) of the calibration pass and the gated step: "
          f"{launches} [{card}]", flush=True)
    # a conv launches on each process that holds a live row of its queries:
    # every conv on (a) and on (b)'s first rank (which holds every level's
    # first rows), some on the second at the bucket
    full = (2 * SCANNET_CONVS, SCANNET_CONVS)
    must = [f"points_a_train_{c}" for c in POINTS_CONFIGS] + [f"points_b_train_{c}_rank0" for c in POINTS_CONFIGS]
    for name in must:
        if launches[name][:2] != full or launches[name][2] == 0:
            raise SystemExit(f"phase 38 {name}: launches {launches[name]}, expected {full} and some prefix sums")
    for c in ("bfloat16_bucket", "float32_bucket"):
        if min(launches[f"points_b_train_{c}_rank1"]) == 0:
            raise SystemExit(f"phase 38: (b)'s second rank launched no conv at the bucket ({c}), where it holds "
                             "live rows")
    del ranks
    torch.cuda.empty_cache()
    # (c) the dry run's (data=2, points=2) configuration
    bodies = body_batch(POINTS_BODIES, POINTS, seed=38)
    dd = ddp_draws(dev, bodies)
    t1 = time.perf_counter()
    dry = launch(make_group(4, devices=[card0] * 4, backend="gloo", points=2), points_dryrun_rank, bodies, dd)
    same = all(torch.equal(x, r["state"][k]) for r in dry[1:] for k, x in dry[0]["state"].items())
    print(f"phase 38 (c): (data=2, points=2), four gloo ranks on {card0} in {time.perf_counter() - t1:.2f} s; "
          f"coordinates {[r['coords'] for r in dry]}; losses over {POINTS_DRYRUN_STEPS} steps on one batch "
          f"{[r['losses'] for r in dry]}; the four ranks' parameters and statistics bitwise equal: {same} "
          f"[{card}]", flush=True)
    if not (same and all(r["losses"] == dry[0]["losses"] for r in dry)
            and dry[0]["losses"][-1] < dry[0]["losses"][0]):
        raise SystemExit("phase 38: the (2, 2) dry-run contract fails")
    for r, run in enumerate(dry):
        launches[f"points_c_dryrun_rank{r}"] = run["launches"] + (0,)
    want = ((1 + POINTS_DRYRUN_STEPS) * CONVS_PER_FORWARD, POINTS_DRYRUN_STEPS * CONVS_PER_FORWARD)
    print(f"phase 38 (c) launches (conv forward, backward) by rank: {[r['launches'] for r in dry]} (every conv "
          f"on a rank that holds live rows of its queries: {want}) [{card}]", flush=True)
    if any(r["launches"] != want for r in dry if r["coords"][1] == 0):
        raise SystemExit("phase 38 (c): a first points rank did not launch every conv")
    out.update(launches=launches, step_median_s=med, collectives=coll, collective_share=share, peak_gib=peaks,
               rows=rows, dryrun_losses=dry[0]["losses"], seconds=time.perf_counter() - t0)
    print(f"phase 38: {out['seconds']:.2f} s [{card}]", flush=True)
    return out


# --- the conv's shared product alone (phase 39) --------------------------------

# phase 39's products, name: (rows, C*Q, O, G of a forward row map or None):
# the ScanNet level-0 block conv fully live (timed), rows that are not a
# multiple of the 128-row tile at O = 32, 64 and 18 (rows of 72 / 36 bytes:
# the value-by-value copies), the ScanNet level-4 (O = 320), ModelNet40
# level-5 (512) and global-vector (1024) widths, and G = 4 rows through a
# row map (mixF's level 0)
PRODUCT_CASES = {
    "scannet_level0": (131072, 2048, 64, None),
    "o32_ragged": (1000, 1024, 32, None),
    "o64_ragged": (4099, 2048, 64, None),
    "o18_unaligned": (777, 480, 18, None),
    "o320": (2051, 10240, 320, None),
    "o512": (1537, 16384, 512, None),
    "o1024": (264, 16384, 1024, None),
    "g4_rowmap": (4 * 301, 1024, 32, 4),
}
PRODUCT_TIMED = "scannet_level0"


def product_operands(layout: str, rows: int, cq: int, o: int, dtype, seed: int, dev) -> tuple:
    """``(a, b)`` of ``kernels.product`` at ``layout`` for a conv of
    ``rows`` rows, depth ``C*Q`` and ``O`` outputs: basis [rows, C*Q] and
    gout [rows, O] in ``dtype``, W [C*Q, O] float32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    basis = torch.randn(rows, cq, device=dev, generator=gen).to(dtype)
    gout = torch.randn(rows, o, device=dev, generator=gen).to(dtype)
    w = torch.randn(cq, o, device=dev, generator=gen) / cq ** 0.5
    return {"fwd": (basis, w), "dw": (basis, gout), "dbasis": (gout, w)}[layout]


def row_map(rows: int, g: int, dev) -> tuple:
    """``(rowmap, map_rows)``: ``rows / g`` ascending int32 entries with
    gaps, one -1 and one past ``map_rows``, which store nothing."""
    n = rows // g
    entries = torch.arange(n, dtype=torch.int32) * 2
    entries[n // 3], entries[-1] = -1, 2 * n + 5
    return entries.to(dev), 2 * n


def plans_agree(rows: int, cq: int, o: int, eb: int) -> bool:
    """The Python mirror of the plans (``kernels.product``) against the C
    plans at one conv shape: the product's, the forward's and the
    backward's."""
    import ctypes

    from se3conv3d_tpu_torch.kernels import product as kp
    from se3conv3d_tpu_torch.kernels.build import library
    from se3conv3d_tpu_torch.kernels.fused_equiv import FWD_SCRATCH_BYTES

    ok = True
    for layout, code in kp.LAYOUTS.items():
        sp, sc = ctypes.c_int(), ctypes.c_longlong()
        library("product").se3_product_plan(code, *product_dims(layout, rows, cq, o), eb, ctypes.byref(sp),
                                            ctypes.byref(sc))
        ok &= (sp.value, sc.value) == kp.product_plan(layout, *product_dims(layout, rows, cq, o), eb)
    c, q = cq // 32, 32
    chunk, splits, fwd_scratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    library("fwd").se3_fused_equiv_fwd_plan(rows, 1, q, c, o, FWD_SCRATCH_BYTES, eb, ctypes.byref(chunk),
                                            ctypes.byref(splits), ctypes.byref(fwd_scratch))
    ok &= (chunk.value, splits.value, fwd_scratch.value) == kp.fwd_plan(rows, 1, q, c, o, FWD_SCRATCH_BYTES, eb)
    bwd_scratch, w_splits, p_blocks = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    library("bwd").se3_fused_equiv_bwd_plan(rows, 1, q, c, o, eb, ctypes.byref(bwd_scratch),
                                            ctypes.byref(w_splits), ctypes.byref(p_blocks))
    ok &= (bwd_scratch.value, w_splits.value, p_blocks.value) == kp.bwd_plan(rows, 1, q, c, o, eb)
    return ok


def run_products(card, dev) -> dict:
    """39. the conv's shared product alone (``kernels.product``) against
    its plain version in float64 at ``PRODUCT_CASES``, the three layouts in
    both dtypes: within the conv kernels' bounds (forward ``KERNEL_RTOL``,
    d_w and dbasis ``BWD_RTOL`` of max |plain|; bfloat16 ``BF16_RTOL`` /
    ``BF16_MEAN_RTOL``, and where W is rounded (forward, dbasis) at most
    ``BF16_SOUND_SHARE`` of the error against W unrounded), two calls
    bitwise equal, one counted launch a call, the plans' Python mirror
    equal to the C plans; at ``PRODUCT_TIMED`` each call's ms (W's image
    included), the plain version's, ``torch.matmul``'s in the same dtype
    and the bound (:func:`product_bound`)."""
    from se3conv3d_tpu_torch.kernels import product as kp

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for ci, (name, (rows, cq, o, g)) in enumerate(PRODUCT_CASES.items()):
        if not plans_agree(rows, cq, o, 4) or not plans_agree(rows, cq, o, 2):
            raise SystemExit(f"phase 39: the plans' Python mirror differs from the C plans at {name}")
        out[name] = {}
        for dt in KERNEL_DTYPES:
            res = out[name][dtype_name(dt)] = {}
            for layout in kp.LAYOUTS:
                if g is not None and layout != "fwd":
                    continue
                a, b = product_operands(layout, rows, cq, o, dt, 390 + ci, dev)
                mapped = row_map(rows, g, dev) if g is not None else (None, 0)
                before = kp.product.launches
                got = kp.product(layout, a, b, mapped[0], g or 1, mapped[1])
                again = kp.product(layout, a, b, mapped[0], g or 1, mapped[1])
                torch.cuda.synchronize()
                launches = kp.product.launches - before
                ref = kp.product_reference(layout, a, b, mapped[0], g or 1, mapped[1])
                err = max_rel_err(got, ref)
                same = torch.equal(got, again)
                rtol = KERNEL_RTOL if layout == "fwd" else BWD_RTOL
                control = None
                if dt == torch.bfloat16 and layout != "dw":  # W left unrounded
                    control = max_rel_err(got, kp.product_reference(layout, a.float(), b, mapped[0], g or 1,
                                                                    mapped[1]).to(got.dtype))[2]
                ok = (same and launches == 2 and bool(torch.isfinite(got.float()).all()) and within(err, dt, rtol)
                      and (control is None or tells_apart(err[2], control)))
                res[layout] = dict(max_abs_err=err[0], max_rel_err=err[1], mean_rel_err=err[2],
                                   control_mean_rel_err=control, bitwise=same, dims=product_dims(layout, rows, cq, o))
                if name == PRODUCT_TIMED:
                    i, j, k = product_dims(layout, rows, cq, o)
                    res[layout].update(
                        ms=cuda_ms(lambda: kp.product(layout, a, b), 10),
                        plain_ms=cuda_ms(lambda: kp.product_reference(layout, a, b), 1),
                        library_ms=cuda_ms({"fwd": lambda: torch.matmul(a, b.to(dt)),
                                            "dw": lambda: torch.matmul(a.t(), b),
                                            "dbasis": lambda: torch.matmul(a, b.to(dt).t())}[layout], 10),
                        **product_bound(layout, i, j, k, dt))
                del a, b, got, again, ref
                x = res[layout]
                print(f"phase 39 product {layout} {dtype_name(dt)} {name} I,J,K={x['dims']}"
                      + (f" G={g} row map" if g else "") + f": max_abs_err={err[0]:.3e} max_rel_err={err[1]:.3e} "
                      f"mean_rel_err={err[2]:.3e} ({bound_text(dt, rtol)}"
                      + (f"; mean_rel_err {control_text(err[2], control)}" if control is not None else "")
                      + f"); two calls bitwise equal: {same}; launches {launches} of 2"
                      + (f"; ms {x['ms']:.4f} a call, plain {x['plain_ms']:.4f}, torch.matmul "
                         f"{x['library_ms']:.4f}, bound {x['bound_ms']:.4f} ({x['bound_by']})" if "ms" in x else "")
                      + f" [{card}]", flush=True)
                if not ok:
                    raise SystemExit(f"phase 39: the product {layout} ({dtype_name(dt)}) disagrees with its "
                                     f"plain version, repeats other bits or miscounts at {name}")
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 39: {out['seconds']:.2f} s [{card}]", flush=True)
    return out


def product_entry(products: dict, scan: dict) -> dict:
    """The shared product's entry of the kernels line: its launches inside
    the convs of the ScanNet train steps (phase 13, the main path), its
    errors over phase 39's cases, and phase 39's times of one call at the
    ScanNet level 0 (the forward's layout at the top, every layout under
    ``"by_layout"``), with the device ms of each call site in the conv
    passes of phase 9 (``"conv_passes"``)."""
    every = {f"scannet_train_{dt}_{mode}": sum(scan["train"][dt][mode]["product_launches"])
             for dt in SCANNET_DTYPES for mode in ("scatter", "sorted") if mode in scan["train"][dt]}
    cases = {k: v for k, v in products.items() if k != "seconds"}

    def errs(dt):
        return max(x["max_abs_err"] for case in cases.values() for x in case[dt].values())

    timed = {dt: cases[PRODUCT_TIMED][dt] for dt in SCANNET_DTYPES}
    f0, b0 = timed["float32"]["fwd"], timed["bfloat16"]["fwd"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    at = f"one call of kernels.product at the ScanNet level 0 (rows, C*Q, O = {PRODUCT_CASES[PRODUCT_TIMED][:3]})"
    return {
        "name": "wg_product", "route": "cuda", "source": "se3conv3d_tpu_torch/kernels/csrc/wg_product.cuh",
        "replaces": "se3conv3d_tpu/ops/pallas/fused_equiv.py:216",
        "also_replaces": ["se3conv3d_tpu/ops/pallas/fused_equiv.py:252", "se3conv3d_tpu/ops/pallas/fused_equiv.py:258"],
        "launches": sum(every.values()), "launches_by_path": every,
        "max_abs_err": errs("float32"), **{k: f0[k] for k in keys},
        "library_call": "torch.matmul, float32 without TF32, for basis . W", "at": at,
        "by_layout": timed["float32"],
        "conv_passes": {dt: scan["conv"][dt]["scannet_level0_block_conv"].get("products") for dt in SCANNET_DTYPES},
        "bf16": {"max_abs_err": errs("bfloat16"), **{k: b0[k] for k in keys},
                 "library_call": "torch.matmul, bfloat16", "at": at, "by_layout": timed["bfloat16"]},
        "seconds": products["seconds"],
    }


def edge_entry(scan: dict, mn: dict) -> dict:
    """The backward's per-edge pass's entry of the kernels line: its launches
    inside the backwards of the ScanNet train steps (phase 13, the main
    path; one a backward, gated), the backward's errors at phase 9's shapes
    (its ``d_feats``, ``d_proj`` and ``d_bias`` come from this pass), and
    its device ms at the ScanNet level 0 (phase 9's ``conv_passes``) beside
    :func:`edge_bound` and the two-``bmm`` yardstick
    (:func:`edge_matmul_ms`; no single PyTorch call computes the pass, so
    ``library_ms`` is null); ``plain_ms`` is the whole backward's plain
    version, which computes the pass's outputs with the rest; every phase-9
    shape under ``"by_shape"``, ModelNet40's level 5 under ``"modelnet"``,
    phase 9's SASS and plan checks under ``"checks"``."""
    every = {f"scannet_train_{dt}_{mode}": scan["train"][dt][mode]["edge_launches"]
             for dt in SCANNET_DTYPES for mode in ("scatter", "sorted") if mode in scan["train"][dt]}
    lvl0 = "scannet_level0_block_conv"

    def at(dt):
        conv = scan["conv"][dt]
        x, bwd = conv[lvl0]["edge"], conv[lvl0]["bwd"]
        return {"max_abs_err": max(v["bwd"]["max_abs_err"] for v in conv.values()), "ms": x["ms"],
                "plain_ms": bwd["plain_ms"], "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
                "library_ms": None, "yardstick_ms": x["yardstick_ms"],
                "by_shape": {k: v.get("edge") for k, v in conv.items()}}

    f0 = at("float32")
    return {
        "name": "edge_kernel", "route": "cuda", "source": "se3conv3d_tpu_torch/kernels/csrc/fused_equiv_bwd.cu",
        "replaces": "se3conv3d_tpu/ops/pallas/fused_equiv.py:266",
        "also_replaces": ["se3conv3d_tpu/ops/pallas/fused_equiv.py:268", "se3conv3d_tpu/ops/pallas/fused_equiv.py:273",
                          "se3conv3d_tpu/ops/pallas/fused_equiv.py:275"],
        "launches": sum(every.values()), "launches_by_path": every, **f0,
        "library_call": None, "yardstick": "two torch.bmm (dpne, d_feats), float32 without TF32, over gathered "
        "operands", "plain_call": "fused_equiv_bwd_reference (the whole backward)",
        "at": f"scannet level-0 block conv B,M,N,K,G,F,Q,C,O={SCANNET_SHAPES[lvl0]}",
        "bf16": {**at("bfloat16"), "yardstick": "two torch.bmm, bfloat16"},
        "modelnet": {k: v.get("edge") for k, v in mn["conv"].items() if isinstance(v, dict) and "edge" in v},
        "checks": scan["edge"],
    }


def kernels_line(dfaust: dict, scan: dict, mixf: dict, rot_i: dict, g4: dict, std: dict, mn: dict,
                 cli: dict, evals: dict, modes: dict, probes: dict, sites: dict, zoo: dict,
                 ddp: dict, mink: dict, fps: dict, points: dict, products: dict) -> dict:
    """The ``{"kernels": [...]}`` object: every kernel with its launches on
    the main paths, its error against its plain version, and its times at
    the ScanNet level-0 shape (float32), with the same for its bfloat16
    instantiation under ``"bf16"`` (each conv kernel's errors over the
    DFaust and ScanNet shapes of phases 2, 6 and 9 in that dtype), and the
    conv kernels' G = 4 instantiations under ``"g4"`` (their launches on the
    mixF path, their times at the mixF level-0 shape of phase 15); then the
    conv kernels' standard-geometry (kD = 3) instantiations, their launches
    on the standard paths of phases 19-20 and their times at the fully live
    ScanNet level-0 shape of phase 18 (every phase-18 shape under
    ``"by_shape"``); each conv entry's ModelNet40 launches (phase 22) are in
    its ``launches``, and its times at phase 21's shapes, with their plans,
    under ``"modelnet"``; the launches of the CLI runs of phases 23-25 are
    in each entry's ``launches`` (``cli_*`` paths), and those of the eval
    CLIs of phases 26-28 (``eval_*`` paths, forwards only), with the
    forward's times at the whole 1.5M-point room's level-0 shape of phase 28
    under ``"whole_scene_bf16"``; then the activations' and the kernel-point
    geometry's entries of phases 29-31 (:func:`mode_entries`); then the
    probe kernels' entries of phase 32 (:func:`probe_entries`); then those
    of the Mosaic probe sites of phase 33 (:func:`mosaic_site_entries`);
    the Q = 64 instantiations and the O = 1024 conv of phase 34
    (:func:`zoo_entries`); the conv entries' launches include phase 35's
    data-parallel paths (``ddp_*``: one calibration pass and one step each,
    rank by rank) and phase 38's point-parallel ones (``points_*``: the
    calibration pass and the gated 'sorted' step of (a) and of each rank of
    (b) by dtype, the prefix sum's launches among them, and each rank of
    (c)'s dry run); phases 36-37 (MinkUNet34A's cuDNN convs, FPS in PyTorch
    ops) launch no kernel of the port, and their readings close the line
    with phase 38's.  The conv's shared product (phase 39,
    :func:`product_entry`) follows the prefix sum, then the backward's
    per-edge pass (phase 9, :func:`edge_entry`)."""
    compared, bwd_compared = dfaust["fwd"], dfaust["bwd"]
    scan_conv, scan_cumsum, scan_train, scan_eval = scan["conv"], scan["cumsum"], scan["train"], scan["eval"]
    lvl0 = SCANNET_SHAPES["scannet_level0_block_conv"]
    at = f"scannet level-0 block conv B,M,N,K,G,F,Q,C,O={lvl0}"

    def paths(which):  # which: 0 forward, 1 backward, 2 prefix sum; (all, bf16) launches by path
        every, bf16 = {}, {}
        if which < 2:
            every["dfaust_eval"] = dfaust["eval_launches"] if which == 0 else 0
            every["dfaust_train"] = dfaust["train_launches"][which]
            every["dfaust_train_bf16"] = bf16["dfaust_train_bf16"] = dfaust["bf16_train_launches"][which]
            every["dfaust_mixf_eval"] = mixf["eval_launches"] if which == 0 else 0
            every["dfaust_mixf_train"] = mixf["train_launches"][which]
            # every launch of the scannet20_rot_I path is a bfloat16 one (gated)
            every["scannet20_rot_I_eval_bfloat16"] = bf16["scannet20_rot_I_eval_bfloat16"] = (
                rot_i["eval"]["launches"] if which == 0 else 0)
            every["scannet20_rot_I_train_bfloat16_scatter"] = bf16["scannet20_rot_I_train_bfloat16_scatter"] = (
                rot_i["train"]["scatter"]["launches"][which])
            for name, run in mn["runs"].items():
                if run["d"] == 9:
                    every[f"{name}_eval"] = run["eval_launches"] if which == 0 else 0
                    every[f"{name}_train"] = run["train_launches"][which]
            for name, run in cli.items():  # the CLI runs of phases 23-25 (kD = 9)
                every[f"cli_{name}"] = run["launches"][which]
                if name.startswith("scannet"):  # every launch a bfloat16 one (gated)
                    bf16[f"cli_{name}"] = run["launches"][which]
            for name in ("dfaust", "modelnet40", "scannet20"):  # the eval CLIs of phases 26-28
                every[f"eval_{name}"] = evals[name]["launches"][which]
            for name, n in ddp["launches"].items():  # phase 35, per configuration and rank
                every[name] = n[which]
            bf16["eval_scannet20"] = evals["scannet20"]["bf16_launches"] if which == 0 else 0
        else:
            every["cli_scannet20_sorted_step"] = cli["scannet20"]["cumsum_launches"]
        for name, n in points["launches"].items():  # phase 38, per configuration, dtype and rank
            if which < 2 or n[2]:
                every[name] = n[which]
                if "bfloat16" in name:  # every launch of this path is a bfloat16 one (gated)
                    bf16[name] = n[which]
        for dt in SCANNET_DTYPES:
            if which == 0:
                every[f"scannet_eval_{dt}"] = scan_eval[dt]["launches"]
                if dt == "bfloat16":
                    bf16[f"scannet_eval_{dt}"] = scan_eval[dt]["bf16_launches"]
            for mode in ("scatter", "sorted"):
                n = scan_train[dt][mode]["launches"][which]
                every[f"scannet_train_{dt}_{mode}"] = n
                if dt == "bfloat16":  # every launch of this path is a bfloat16 one (gated)
                    bf16[f"scannet_train_{dt}_{mode}"] = n
        return every, bf16

    def mn_entry(kind, lib_key, shapes):
        """The kernel at phase 21's shapes ``shapes`` (float32), the first
        one's times at the top."""
        by_shape = {k: {**mn["conv"][k][kind], "plan": mn["conv"][k]["plan"]} for k in shapes}
        x = by_shape[shapes[0]]
        return {"max_abs_err": max(v["max_abs_err"] for v in by_shape.values()), "ms": x["ms"],
                "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
                "library_ms": x[lib_key], "at": f"{shapes[0]} B,M,N,K,G,F,Q,C,O={MN_SHAPES[shapes[0]][0]} "
                "at the synthetic shapes' fill", "by_shape": by_shape}

    mn_equiv = [k for k, v in MN_SHAPES.items() if v[2] == 9]
    mn_std = [k for k, v in MN_SHAPES.items() if v[2] == 3]

    def conv_entry(kind, which, name, source, replaces, lib_key, lib_call):
        every, bf16_paths = paths(which)
        dfaust_shapes = compared if kind == "fwd" else bwd_compared
        by_shape = {dt: {**dfaust_shapes[dt], **{k: v[kind] for k, v in scan_conv[dt].items()}}
                    for dt in SCANNET_DTYPES}
        f0, b0 = by_shape["float32"]["scannet_level0_block_conv"], by_shape["bfloat16"]["scannet_level0_block_conv"]
        g4_shapes = {dt: {k: v[kind] for k, v in g4[dt].items()} for dt in SCANNET_DTYPES}
        g4_at = f"mixf level-0 block conv B,M,N,K,G,F,Q,C,O={G4_SHAPES['mixf_level0_block_conv'][0]}"

        def g4_entry(dt):
            x = g4_shapes[dt]["mixf_level0_block_conv"]
            return {"max_abs_err": max(v["max_abs_err"] for v in g4_shapes[dt].values()),
                    "ms": x["ms"], "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
                    "bound_by": x["bound_by"], "library_ms": x[lib_key], "at": g4_at,
                    "by_shape": g4_shapes[dt]}

        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(every.values()), "launches_by_path": every,
            "max_abs_err": max(v["max_abs_err"] for v in by_shape["float32"].values()),
            "ms": f0["ms"], "plain_ms": f0["plain_ms"], "bound_ms": f0["bound_ms"], "bound_by": f0["bound_by"],
            "bound_f32_ms": f0["bound_f32_ms"], "library_ms": f0[lib_key],
            "library_call": lib_call.format("float32 without TF32"), "at": at, "by_shape": by_shape["float32"],
            "bf16": {
                "launches": sum(bf16_paths.values()), "launches_by_path": bf16_paths,
                "max_abs_err": max(v["max_abs_err"] for v in by_shape["bfloat16"].values()),
                "ms": b0["ms"], "plain_ms": b0["plain_ms"], "bound_ms": b0["bound_ms"],
                "bound_by": b0["bound_by"], "bound_split_ms": b0["bound_f32_ms"],
                "library_ms": b0[lib_key], "library_call": lib_call.format("bfloat16"),
                "at": at, "by_shape": by_shape["bfloat16"],
            },
            "g4": {
                "launches": mixf["train_launches_by_g"][which].get(4, 0),
                "launches_by_g": {"dfaust_mixf_train": mixf["train_launches_by_g"][which]},
                "float32": g4_entry("float32"), "bfloat16": g4_entry("bfloat16"),
            },
            "modelnet": {"launches": sum(v for k, v in every.items() if k.startswith("modelnet40")),
                         "float32": mn_entry(kind, lib_key, mn_equiv)},
            **({"whole_scene_bf16": whole_scene} if kind == "fwd" else {}),
        }

    ws = evals["whole_scene_fwd"]
    whole_scene = {k: ws[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "live_rows", "index_ranges")}
    whole_scene["at"] = (f"whole 1.5M-point room's level-0 block conv B,M,N,K,G,F,Q,C,O={ws['shape']} at its "
                         f"live fill, bfloat16")

    def std_entry(kind, which, name, source, replaces, lib_key, lib_call):
        sd, ss = std["dfaust"], std["scannet"]
        every = {"dfaust_std_eval": sd["eval_launches"] if which == 0 else 0,
                 "dfaust_std_train": sd["train_launches"][which],
                 "scannet_std_eval_bfloat16": ss["eval"]["launches"] if which == 0 else 0}
        for mode in SCANNET_F32_MODE_ORDER:
            every[f"scannet_std_train_bfloat16_{mode}"] = ss["train"][mode]["launches"][which]
        for mname, run in mn["runs"].items():
            if run["d"] == 3:
                every[f"{mname}_eval"] = run["eval_launches"] if which == 0 else 0
                every[f"{mname}_train"] = run["train_launches"][which]
        bf16_paths = {k: v for k, v in every.items() if "bfloat16" in k}  # gated: every launch bf16
        by_shape = {dt: {k: v[kind] for k, v in std["conv"][dt].items()} for dt in SCANNET_DTYPES}
        f0, b0 = (by_shape[dt]["scannet_std_level0_block_conv"] for dt in ("float32", "bfloat16"))
        std_at = f"scannet level-0 block conv B,M,N,K,G,F,Q,C,O={lvl0}, standard geometry (D = 3)"
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(every.values()), "launches_by_path": every,
            "max_abs_err": max(v["max_abs_err"] for v in by_shape["float32"].values()),
            "ms": f0["ms"], "plain_ms": f0["plain_ms"], "bound_ms": f0["bound_ms"], "bound_by": f0["bound_by"],
            "library_ms": f0[lib_key], "library_call": lib_call.format("float32 without TF32"),
            "at": std_at, "by_shape": by_shape["float32"],
            "bf16": {
                "launches": sum(bf16_paths.values()), "launches_by_path": bf16_paths,
                "max_abs_err": max(v["max_abs_err"] for v in by_shape["bfloat16"].values()),
                "ms": b0["ms"], "plain_ms": b0["plain_ms"], "bound_ms": b0["bound_ms"],
                "bound_by": b0["bound_by"], "library_ms": b0[lib_key], "library_call": lib_call.format("bfloat16"),
                "at": std_at, "by_shape": by_shape["bfloat16"],
            },
            "modelnet": {"launches": sum(v for k, v in every.items() if k.startswith("modelnet40")),
                         "float32": mn_entry(kind, lib_key, mn_std)},
        }

    cum_every, _ = paths(2)
    cum_bf16 = {k: v for k, v in cum_every.items() if "bfloat16" in k or k.startswith("cli_scannet")}  # bf16 rows
    c0, c0b = scan_cumsum["scannet_level0_edges"], scan_cumsum["scannet_level0_edges_bf16"]
    cum_at = f"scannet level-0 edges [{lvl0[1] * lvl0[3]} x {lvl0[7]}]"
    fwd_call = ("torch.matmul, {}, for the weight contraction basis . W over the same live rows "
                "(no PyTorch call computes the whole forward)")
    bwd_call = ("torch.matmul, {}, for the d_w and dbasis products over the same live rows "
                "(no PyTorch call computes the whole backward)")
    fwd_src, bwd_src = (f"se3conv3d_tpu_torch/kernels/csrc/fused_equiv_{x}.cu" for x in ("fwd", "bwd"))
    fwd_tpu, bwd_tpu = "se3conv3d_tpu/ops/pallas/fused_equiv.py:196", "se3conv3d_tpu/ops/pallas/fused_equiv.py:227"
    return {"kernels": [
        conv_entry("fwd", 0, "fused_equiv_fwd", fwd_src, fwd_tpu, "library_ms", fwd_call),
        conv_entry("bwd", 1, "fused_equiv_bwd", bwd_src, bwd_tpu, "products_library_ms", bwd_call),
        std_entry("fwd", 0, "fused_equiv_fwd[kD=3]", fwd_src, fwd_tpu, "library_ms", fwd_call),
        std_entry("bwd", 1, "fused_equiv_bwd[kD=3]", bwd_src, bwd_tpu, "products_library_ms", bwd_call),
        {
            "name": "blocked_cumsum", "route": "cuda",
            "source": "se3conv3d_tpu_torch/kernels/csrc/segsum_cumsum.cu",
            "replaces": "se3conv3d_tpu/ops/pallas/segsum.py:38",
            "launches": sum(cum_every.values()), "launches_by_path": cum_every,
            "max_abs_err": max(v["max_abs_err"] for v in scan_cumsum.values()),
            "ms": c0["ms"], "plain_ms": c0["plain_ms"],
            "bound_ms": c0["bound_ms"], "bound_by": "bytes", "library_ms": c0["library_ms"],
            "library_call": "torch.cumsum along the rows with a float32 output",
            "at": cum_at, "by_shape": scan_cumsum,
            "bf16": {"launches": sum(cum_bf16.values()), "launches_by_path": cum_bf16,
                     "max_abs_err": c0b["max_abs_err"], "ms": c0b["ms"], "plain_ms": c0b["plain_ms"],
                     "bound_ms": c0b["bound_ms"], "bound_by": "bytes", "library_ms": c0b["library_ms"],
                     "at": cum_at + " bfloat16 rows"},
        }, product_entry(products, scan), edge_entry(scan, mn), *mode_entries(modes), *probe_entries(probes),
        *mosaic_site_entries(sites), *zoo_entries(zoo)],
        "probe_registers": probes["registers"], "mosaic_site_registers": sites["registers"],
        "other_conv_kinds": {k: modes[k] for k in ("kp_models", "act_models",
                                                                              "plain_kinds")},
        "scannet": {"eval": scan_eval, "train": scan_train, "grid_vs_brute": scan["grid"]},
        "dfaust": {"train_bf16": dfaust["bf16_train"]}, "dfaust_mixf": mixf, "scannet20_rot_I": rot_i,
        "standard": {"dfaust": std["dfaust"], "scannet": std["scannet"]},
        "modelnet40": {"runs": mn["runs"], "profile": mn["profile"]}, "cli": cli,
        "eval": {k: v for k, v in evals.items() if k != "whole_scene_fwd"},
        "model_zoo": {k: zoo[k] for k in ("variants", "ball_query", "q64_models", "attention", "seconds")}
        | {"modelnet_global": {k: v for k, v in zoo["modelnet_global"].items() if k != "conv"}},
        "data_parallel": ddp, "minkunet": mink, "fps": fps,
        "points_parallel": points}


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    import se3conv3d_tpu_torch
    if Path(se3conv3d_tpu_torch.__file__).resolve().parent.parent != REPO:
        print("chip_smoke: run it from the repository that holds it", file=sys.stderr)
        return 1
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels.build import build_libraries
    from se3conv3d_tpu_torch.models import presets
    from se3conv3d_tpu_torch.nn.blocks import DropPathDraws

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
    # 32. the probe kernels of experiments/chip_stage_time.py, bisect_fused.py
    # and chip_stream.py, at their scripts' default sizes
    probes = run_probes(card, dev)
    # 33. the Mosaic probe sites of experiments/bisect_accum.py,
    # bisect_accum2.py, probe_cellconv.py and probe_mosaic.py
    sites = run_mosaic_sites(card, dev)
    # 39. the conv's shared product alone, its three layouts in both dtypes
    products = run_products(card, dev)

    # 2. kernel vs plain
    shapes = {
        # name: B, M, N, K, G, F, Q, C, O
        "level1_block_conv": (32, 2048, 2048, 32, 2, 2, 32, 32, 32),
        "level4_block_conv": (32, 128, 128, 32, 2, 2, 32, 256, 256),
        "jax_bench_conv": (1, 65536, 65536, 16, 2, 2, 32, 64, 64),
    }
    compared = {dtype_name(dt): {} for dt in KERNEL_DTYPES}
    for dt in KERNEL_DTYPES:
        for i, (name, shp) in enumerate(shapes.items()):
            args = as_operands(conv_inputs(*shp, seed=10 + i, dev=dev), dt)
            compared[dtype_name(dt)][name] = forward_vs_plain(
                card, f"kernel_vs_plain {name}", shp, args, kfe.live_row_table(args[4]),
                conv_bounds(shp, args[3], args[4], dt)["fwd"], 15 + i)
            del args
            torch.cuda.empty_cache()

    # 3. the slice at full width
    batch = to_device(body_batch(BATCH, POINTS, seed=2), dev)
    trainer, dfaust_eval_run = dfaust_eval(card, dev, batch)
    launches = dfaust_eval_run["launches"]

    # 4. rotation invariance and 5. card vs CPU, on two clouds
    small = to_device(body_batch(2, POINTS, seed=4), dev)
    dfaust_card_vs_cpu(card, dev, trainer, small)
    # and both with the norms seeded, each beside a control it must fail
    dfaust_model_gates(card, dev, trainer, small, "dfaust")
    del trainer
    torch.cuda.empty_cache()

    # 6. backward kernel vs plain
    bwd_compared = {dtype_name(dt): {} for dt in KERNEL_DTYPES}
    for dt in KERNEL_DTYPES:
        for i, (name, shp) in enumerate(shapes.items()):
            args = as_operands(conv_inputs(*shp, seed=20 + i, dev=dev), dt)
            b, m, _, _, g_, _, _, _, o = shp
            gout = torch.randn(b, m, g_, o, device=dev, generator=torch.Generator(device=dev).manual_seed(30 + i))
            bwd_compared[dtype_name(dt)][name] = backward_vs_plain(
                card, f"bwd_kernel_vs_plain {name}", shp, args, gout, kfe.live_row_table(args[4]),
                conv_bounds(shp, args[3], args[4], dt)["bwd"], 35 + i)
            del args, gout
            torch.cuda.empty_cache()

    # 7. the training slice at full width, and its steps in bfloat16 beside it
    # (their times printed only: the DFaust recipe computes in float32)
    training = presets.DFAUST_I_ROT_PCA_2F_TRAINING
    bf16_trainer, dfaust_bf16 = dfaust_train(
        card, dev, batch, {**presets.DFAUST_I_ROT_PCA_2F_MODEL, "compute_dtype": "bfloat16"})
    del bf16_trainer
    torch.cuda.empty_cache()
    trainer, dfaust_steps = dfaust_train(card, dev, batch)
    print(f"train: steps after the first, float32 median {dfaust_steps['steady_s']:.4f} s (range "
          f"{min(dfaust_steps['all_s'][1:]):.4f}-{max(dfaust_steps['all_s'][1:]):.4f}), peak "
          f"{dfaust_steps['peak_gib']:.3f} GiB; bfloat16 median {dfaust_bf16['steady_s']:.4f} s (range "
          f"{min(dfaust_bf16['all_s'][1:]):.4f}-{max(dfaust_bf16['all_s'][1:]):.4f}), peak "
          f"{dfaust_bf16['peak_gib']:.3f} GiB [{card}]", flush=True)

    # 8. parameter gradients, card vs CPU, on two clouds
    small = to_device(body_batch(2, POINTS, seed=4), dev)
    dfaust_grads_card_vs_cpu(card, dev, trainer, small, RecordedDraws, training)
    del trainer
    torch.cuda.empty_cache()

    # 15.-16. the DFaust Monte-Carlo mixed-frame-count recipe: the conv
    # kernels at G = F = 4, then the recipe as written
    mixf_batch = to_device(body_batch(MIXF_BATCH, POINTS, seed=12), dev)
    fill = mixf_fill(dev, mixf_batch)
    print(f"mixf: max valid points per level {fill} [{card}]", flush=True)
    g4 = g4_conv_kernels(card, dev, fill)
    mixf = dfaust_mixf(card, dev, mixf_batch, small, RecordedDraws)
    del mixf_batch
    torch.cuda.empty_cache()
    # 17. the ScanNet recipe with random planar frames
    rot_i = scannet_rot_i(card, dev)

    # 18.-19. the standard geometry (kD = 3) and the DFaust standard recipe
    fill = mixf_fill(dev, batch, presets.DFAUST_I_STANDARD_MODEL)
    print(f"dfaust_std: max valid points per level {fill} [{card}]", flush=True)
    std = {"conv": std_conv_kernels(card, dev, fill),
           "dfaust": dfaust_standard(card, dev, batch, small, RecordedDraws, dfaust_steps)}
    # 29.-31. the other conv kinds: the activations and the kernel points
    modes = run_modes(card, dev, batch, small, fill)
    del batch, small
    torch.cuda.empty_cache()

    # 21.-22. the ModelNet40 classification recipes: the conv kernels at
    # their shapes (512 channels), then the three recipes
    mn_conv, mn_runs, mn_batch = run_modelnet(card, dev, RecordedDraws)

    scan = run_scannet(card, dev, RecordedDraws, DropPathDraws)
    # 20. the ScanNet standard recipe as written (bfloat16)
    std["scannet"] = scannet_standard(card, dev, RecordedDraws, DropPathDraws)
    # 23.-25. the training CLI on the DFaust, ModelNet40 and ScanNet recipes,
    # 26.-28. the evaluation CLIs on their runs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="se3conv_cli_") as tmp:
        cli = run_cli(card, dev, Path(tmp))
        evals = run_eval(card, dev, Path(tmp))
    # 34. the rest of the model zoo: the other blocks and heads, ball-query
    # frames, ClassNet's global feature vector, Q = 64, the attention convs
    zoo = run_zoo(card, dev, mn_batch)
    torch.cuda.empty_cache()
    # 35. data parallelism: one process, a one-rank NCCL group, two ranks
    ddp = run_ddp(card, dev)
    torch.cuda.empty_cache()
    # 36. the dense-voxel MinkUNet34A, 37. farthest-point sampling
    mink = run_minkunet(card, dev)
    torch.cuda.empty_cache()
    fps = run_fps(card, dev)
    torch.cuda.empty_cache()
    # 38. the (data, points) mesh: one process, (1, 2) and (2, 2) groups
    points = run_points(card, dev)
    torch.cuda.empty_cache()
    # the profiled ModelNet40 train step last: a profiled run slows the launches after it
    mn = dict(conv=mn_conv, runs=mn_runs, profile=modelnet_profile(card, dev, mn_batch))
    del mn_batch
    modelnet_conv_passes(card, dev, mn_conv)
    dfaust = dict(fwd=compared, bwd=bwd_compared, eval_launches=launches,
                  train_launches=dfaust_steps["launches"], bf16_train_launches=dfaust_bf16["bf16_launches"],
                  bf16_train=dfaust_bf16)
    print(f"chip_smoke: total {time.perf_counter() - started:.1f} s, the build included [{card}]", flush=True)
    print(json.dumps(kernels_line(dfaust, scan, mixf, rot_i, g4, std, mn, cli, evals, modes, probes, sites, zoo,
                                  ddp, mink, fps, points, products)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
