#!/usr/bin/env python3
"""A/B of the PyTorch port between two checkouts on one NVIDIA GPU, in turns.

    python3 chip_ab.py OLD_ROOT NEW_ROOT [--turns ABBA]

runs one process per turn (``A`` = OLD_ROOT, ``B`` = NEW_ROOT; by default
A, B, B, A), each importing ``se3conv3d_tpu_torch`` from its root and
driving it with the phases of the ``chip_smoke.py`` beside this file:

- the prefix-sum kernel at ``chip_smoke.py``'s phase-10 shapes
  (``cumsum_cases``; CUDA-event median of 20; null where a side's kernel
  does not take the payload);
- the conv forward and backward kernels (CUDA-event medians of 20 and 10;
  the backward in atomic-scatter mode; each given the live-row table where
  its wrapper takes one, as the main path gives it) at the ScanNet level-0
  and level-4 block convs, the padded level-0 conv and the DFaust level-1
  and level-4 convs and the JAX bench's conv;
- the DFaust eval and train steps (``chip_smoke.dfaust_eval``: median of 5
  eval steps of B=32 x 4096 after a calibration step; ``dfaust_train``:
  median of 5 train steps; the peak device memory of each);
- the ScanNet-20 ``scan_scenes`` train step (``chip_smoke.scannet_train``:
  6 rooms x 120,000 points, float32, the two backward modes in turns,
  median and peak device memory per mode);
- last (a profiled run slows the launches after it), the device ms of each
  conv forward and backward pass (``torch.profiler`` over 3 calls, the
  live-row table given) at ``PASS_SHAPES``, by kernel name in either
  package (``PASSES``: the shared product ``wg_product`` by call site, or
  the parent's ``tf32x3_gemm`` / ``bf16_gemm``), and the backward's passes
  at ``EDGE_CASES`` (G = 4, Q = 64, the kernel points at P = 13 and 55,
  relu, sin and linear: the per-edge pass ``edge_kernel`` at its other
  instantiations).

Each turn prints one JSON line; the last line holds every turn's numbers
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONV_SHAPES = {
    # name: (B, M, N, K, G, F, Q, C, O), live rows per example (None: every row)
    "scannet_level0": ((1, 131072, 131072, 24, 1, 1, 32, 64, 64), None),
    "scannet_level0_padded": ((1, 131072, 131072, 24, 1, 1, 32, 64, 64), 22_563),
    "scannet_level4": ((1, 512, 512, 24, 1, 1, 32, 320, 320), None),
    "jax_bench": ((1, 65536, 65536, 16, 2, 2, 32, 64, 64), None),
    "dfaust_level1": ((32, 2048, 2048, 32, 2, 2, 32, 32, 32), None),
    "dfaust_level4": ((32, 128, 128, 32, 2, 2, 32, 256, 256), None),
}
# the conv passes by kernel name, each alternative a tuple of substrings:
# the product's call sites as wg_product names them, or the parent's kernels
PASSES = {
    "fwd": (("basis_kernel", (("basis_kernel<", ", false, "),)),
            ("product", (("wg_product<", "SiteFwd"), ("tf32x3_gemm<true, false",),
                         ("bf16_gemm<float, true, true",))),
            ("sum_splits", (("sum_splits",),)),
            ("weights' copy", (("product_image",), ("round_bf16",)))),
    "bwd": (("basis_kernel", (("basis_kernel<", ", true, "),)),
            ("d_w product", (("wg_product<", "SiteDw"), ("tf32x3_gemm<false, false",),
                             ("bf16_gemm<float, false, false",))),
            ("dbasis product", (("wg_product<", "SiteDbasis"), ("tf32x3_gemm<true, true",),
                                ("bf16_gemm<__nv_bfloat16, true, true",))),
            ("edge_kernel", (("edge_kernel",),)), ("sum_partials", (("sum_partials",),)),
            ("weights' copy", (("product_image",), ("round_bf16",)))),
}
# name: (B, M, N, K, G, F, Q, C, O), operand dtypes: the ScanNet level 0
# fully live, and the ModelNet40 level-5 block conv fully live
PASS_SHAPES = {
    "scannet_level0": (CONV_SHAPES["scannet_level0"][0], ("float32", "bfloat16")),
    "modelnet_level5": ((12, 256, 256, 32, 2, 2, 32, 512, 512), ("float32",)),
}
# the backward's passes at its other instantiations: name: (shape, live rows
# per example or None, dtype, kind), kind an activation of the equivariant
# conv, "std" (kD = 3, gelu) or a kernel-point type ("kp_gauss": P = 13,
# "kp_gauss_double": P = 55, with the identity activation): G = 4 at the
# mixF level 0; Q = 64 at the DFaust level 0 (36,864 live rows); the kernel
# points at the standard ScanNet level 0 (bfloat16, its recipe's) and DFaust
# level 0 (float32); relu, sin and linear at the ScanNet level 0
DFAUST_Q64 = (32, 4096, 4096, 32, 2, 2, 64, 32, 32)
DFAUST_STD = (32, 4096, 4096, 32, 1, 1, 32, 32, 32)
EDGE_CASES = {
    **{f"mixf_level0_g4 {dt}": ((16, 4096, 4096, 32, 4, 4, 32, 32, 32), None, dt, "gelu")
       for dt in ("float32", "bfloat16")},
    "dfaust_level0_q64_g2 float32": (DFAUST_Q64, 1152, "float32", "gelu"),
    "dfaust_std_level0_q64 float32": (DFAUST_Q64[:4] + (1, 1) + DFAUST_Q64[6:], 1152, "float32", "std"),
    **{f"scannet_std_level0_{kind} bfloat16": (CONV_SHAPES["scannet_level0"][0], None, "bfloat16", kind)
       for kind in ("kp_gauss", "kp_gauss_double")},
    **{f"dfaust_std_level0_{kind} float32": (DFAUST_STD, 1152, "float32", kind)
       for kind in ("kp_gauss", "kp_gauss_double")},
    **{f"scannet_level0_{act} {dt}": (CONV_SHAPES["scannet_level0"][0], None, dt, act)
       for act in ("relu", "sin", "linear") for dt in ("float32", "bfloat16")},
}


def pass_profile(cs, kfe, dev) -> dict:
    """Device ms a call of each conv pass at ``PASS_SHAPES``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for i, (name, (shp, dtypes)) in enumerate(PASS_SHAPES.items()):
        for dt in dtypes:
            args, gout = cs.padded_conv_args(40 + i, shp, None, dev, getattr(torch, dt))
            live = kfe.live_row_table(args[4])
            runs = {"fwd": lambda: kfe.fused_equiv_fwd(*args, live_rows=live),
                    "bwd": lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live)}
            res = out[f"{name} {dt}"] = {}
            with torch.no_grad():
                for what, fn in runs.items():
                    fn()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(3):
                            fn()
                        torch.cuda.synchronize()
                    res[what] = {p: ms / 3 for p, ms in cs.pass_ms(cs.device_rows(prof), PASSES[what]).items()}
            del args, gout, live
            torch.cuda.empty_cache()
    for i, (name, (shp, n_live, dt, kind)) in enumerate(EDGE_CASES.items()):
        args, gout = cs.padded_conv_args(50 + i, shp, n_live, dev, getattr(torch, dt))
        opts = dict(act=kind)
        if kind == "std" or kind.startswith("kp"):
            args[1], opts["act"] = None, "gelu" if kind == "std" else "linear"
            args[5] = args[5][:3].contiguous()
            if kind.startswith("kp"):
                kp = cs.conv_kernel_points(kind, dev)
                gen = torch.Generator(device=dev).manual_seed(110 + i)
                args[0] = args[0].float()  # the kernel points read float32 offsets
                args[5] = torch.randn(kp.points.shape[0], shp[6], device=dev, generator=gen) * 0.3
                opts["kp"] = kp
        live = kfe.live_row_table(args[4])
        fn = lambda: kfe.fused_equiv_bwd(*args, gout, live_rows=live, **opts)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        out[f"edge {name}"] = {"bwd": {p: ms / 3 for p, ms in cs.pass_ms(cs.device_rows(prof), PASSES["bwd"]).items()}}
        del args, gout, live
        torch.cuda.empty_cache()
    return out


def side(root: str) -> int:
    sys.path.insert(0, str(Path(root).resolve()))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    import se3conv3d_tpu_torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    if Path(se3conv3d_tpu_torch.__file__).resolve().parent.parent != Path(root).resolve():
        print(f"chip_ab: se3conv3d_tpu_torch did not come from {root}", file=sys.stderr)
        return 1
    from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
    from se3conv3d_tpu_torch.kernels import segsum
    from se3conv3d_tpu_torch.kernels.build import build_libraries
    from se3conv3d_tpu_torch.ops import pne_conv as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda"), cs.card_line()
    build_libraries()
    fwd_ms, bwd_ms = {}, {}
    takes_table = "live_rows" in inspect.signature(kfe.fused_equiv_fwd).parameters
    for i, (name, (shp, live)) in enumerate(CONV_SHAPES.items()):
        args, gout = cs.padded_conv_args(i, shp, live, dev)
        table = {"live_rows": kfe.live_row_table(args[4])}
        with torch.no_grad():
            fwd_ms[name] = cs.cuda_ms(lambda: kfe.fused_equiv_fwd(*args, **(table if takes_table else {})), 20)
        bwd_ms[name] = cs.cuda_ms(lambda: kfe.fused_equiv_bwd(*args, gout, **table), 10)
        del args, gout, table
        torch.cuda.empty_cache()
    cumsum_ms = {}
    for name, (shape, dtype) in cs.cumsum_cases().items():
        x = torch.randn(*shape, device=dev, generator=torch.Generator(device=dev).manual_seed(60)).to(dtype)
        try:
            cumsum_ms[name] = cs.cuda_ms(lambda: segsum.blocked_cumsum(x), 20)
        except TypeError:  # a kernel that takes float32 payloads only
            cumsum_ms[name] = None
        del x
        torch.cuda.empty_cache()
    out = dict(root=root, cumsum_kernel_ms=cumsum_ms, fwd_kernel_ms=fwd_ms, bwd_kernel_ms=bwd_ms)
    batch = cs.to_device(cs.body_batch(cs.BATCH, cs.POINTS, seed=2), dev)
    trainer, out["dfaust_eval"] = cs.dfaust_eval(card, dev, batch)
    del trainer
    torch.cuda.empty_cache()
    trainer, out["dfaust_train"] = cs.dfaust_train(card, dev, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    rooms = cs.scannet_rooms(dev)
    trainer = cs.scannet_trainer(dev, {k: v[:1] for k, v in rooms.items()}, cs.scannet_recipes()["float32"])
    out["scannet_train"] = cs.scannet_train(card, dev, trainer, rooms, kfe, segsum, ops)
    del trainer, rooms
    torch.cuda.empty_cache()
    out["passes_ms"] = pass_profile(cs, kfe, dev)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="*", help="OLD_ROOT NEW_ROOT")
    parser.add_argument("--turns", default="ABBA")
    parser.add_argument("--side", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.side:
        return side(args.side)
    if len(args.roots) != 2:
        parser.error("give OLD_ROOT and NEW_ROOT")
    runs = []
    for turn in args.turns:
        root = args.roots["AB".index(turn)]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--side", root],
                              capture_output=True, text=True, env=env)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"turn {turn} {json.dumps(result)}", flush=True)
        runs.append(dict(turn=turn, **result))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "turns": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
