#!/usr/bin/env python3
"""Old against new on one NVIDIA GPU: the probe kernels redesigned for
Hopper, each checkout timed through its own wrappers, in turn.

    python3 probe_ab.py ROOT [ROOT ...] [--rounds 2] [--m 65536] [--sets stage,mosaic,cellconv]

Each ``ROOT`` is a checkout of this repository: ``.`` for this one, and
for instance a parent commit unpacked beside it with ``git archive`` into
the git-ignored ``scratch_checkout/``.  Round r runs one process a root, in
the given order on even rounds and reversed on odd ones (A B, then B A).
A process imports its root's ``se3conv3d_tpu_torch``, whose wrappers build
that root's kernel sources at first use, and times with this checkout's
``chip_smoke.graph_ms`` (device ms per call from a CUDA graph of 5 calls,
median of 5 replays):

- ``stage``: ``probes.stage_sum`` on ``chip_stage_time``'s inputs at ``M``
  rows (every stage, float32 and bfloat16) and b3 ``probes.batched_contract``
  on ``bisect_fused``'s inputs, beside ``torch.bmm``;
- ``mosaic``: every probe of ``mosaic_probes`` at the JAX script's shapes
  (the products of ``strided_product``, the six strided copies, p9 and
  p14), each beside its one PyTorch call (``chip_smoke.mosaic_library``:
  ``torch.matmul`` / ``einsum`` / ``bmm`` / ``tensordot``, ``clone`` /
  ``contiguous``, p9's ``einsum`` with ``eye(2)``, p14's broadcast
  product), p11 (``probes.grid_column_accum``) beside ``torch.sum(a, 0)``,
  and ``probes.block_total_accum`` at every ``bisect_accum`` trial and
  ``bisect_accum2`` combination, beside ``torch.sum(a)`` (and ``a * 2``
  where dfeat is written);
- ``cellconv``: p3 (``cellconv_probes.masked_dist_product``) at the JAX
  script's shape, beside ``torch.matmul(pne, cf)`` (its product alone).

A root's first process also reports its build's seconds (the sources at
once), per kernel the HGMMA (wgmma) and HMMA (mma.sync) instructions in the
libraries' SASS (``cuobjdump --dump-sass``; ``strided_product`` summed by
operand type as well), and, with ``mosaic`` or ``cellconv``, each
kernel's registers and shared memory (``cudaFuncGetAttributes``).  Every
root's stage sums must agree with the first root's within
``chip_smoke.PROBE_SCALAR_RTOL`` of the stage's sum of |values|, its b3,
p3 and product probes with their plain versions within 1e-5 of the plain
version's largest value (p3's pne bit for bit), its copies bit for bit,
p11's column sums within ``1e-6`` of each column's sum of |a|, its totals
with the float64 total within ``bisect_accum.SUM_RTOL`` of sum |a|.  The last
line is one JSON object: each median, its range, and the card's name and
power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
B3_RTOL = 1e-5
SETS = {"stage": ("probe_stage", "probe_bwd"), "mosaic": ("probe_mosaic", "probe_accum"),
        "cellconv": ("probe_cellconv",)}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def demangle(name: str) -> str:
    """The kernel and template arguments of a mangled tile_fwd / stage_fwd /
    strided_product name, shortened (tile_fwd<4,bf16>,
    strided_product<f32,0,1,0>: tile id and the two layouts)."""
    for kern in ("tile_fwd", "stage_fwd", "batched_contract", "strided_product", "masked_dist_product"):
        if kern in name:
            rest = name.rsplit(kern, 1)[1]
            if not rest.startswith("I"):
                return kern
            dtype = "bf16" if "bfloat16" in rest[:40] else "f32"
            if kern == "strided_product":
                args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0])
                return f"{kern}<{','.join([dtype] + args)}>"
            stage = rest[3] if rest.startswith("ILi") else "?"
            return f"{kern}<{stage},{dtype}>" if kern == "tile_fwd" else f"{kern}<{stage}>"
    return name[-40:]


def sass_counts(lib: Path) -> dict:
    """{kernel: [HGMMA, HMMA]} for the kernels of ``lib`` that hold either."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = demangle(line.split("Function :")[1].strip())
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "HMMA" in line
    return {k: v for k, v in counts.items() if any(v)}


def stage_times(res: dict, smoke, m: int, dev, side) -> None:
    import torch
    from se3conv3d_tpu_torch.experiments import bisect_fused, chip_stage_time as cst
    from se3conv3d_tpu_torch.kernels import probes

    args = cst.make_inputs(m, 32, dev)
    for dtype in (torch.float32, torch.bfloat16):
        for stage, kstage in cst.STAGES.items():
            key = f"{stage} {smoke.dtype_name(dtype)}"
            res["sums"][key] = float(probes.stage_sum(*args, stage=kstage, cdt=dtype))
            res["terms"][key] = float(probes.stage_forward_reference(*args, None, kstage, dtype).abs().sum())
            res["ms"][key] = smoke.graph_ms(lambda: probes.stage_sum(*args, stage=kstage, cdt=dtype), side)
    x, y = bisect_fused.draw("b3_dw2_contract11", 8, dev)
    ref = probes.batched_contract_reference(x, y)
    res["rel_err"]["b3"] = float((probes.batched_contract(x, y) - ref).abs().max() / ref.abs().max())
    res["ms"]["b3"] = smoke.graph_ms(lambda: probes.batched_contract(x, y), side)
    res["ms"]["b3 torch.bmm"] = smoke.graph_ms(lambda: torch.bmm(x.transpose(1, 2), y), side)


def mosaic_times(res: dict, smoke, dev, side) -> None:
    import torch
    from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2, probe_mosaic
    from se3conv3d_tpu_torch.kernels import mosaic_probes as mp, probes

    library = {**smoke.mosaic_library(dev), "p11_grid_accum": lambda a: torch.sum(a, 0)}
    names = [n for n, kind in mp.KIND.items() if kind == "product"]  # the products first, as before
    for i, name in enumerate(names + [n for n in library if n not in names]):
        xs = probe_mosaic.draw(name, 500 + i, dev)
        fn = mp.PROBES[name]
        res["rel_err"][name] = probe_mosaic.check(name, xs, fn(*xs))
        res["ms"][name] = smoke.graph_ms(lambda: fn(*xs), side)
        res["ms"][f"{name} library"] = smoke.graph_ms(lambda: library[name](*xs), side)
    cases = [(f"bisect_accum {name}", gn, bisect_accum.SHAPES[:n], d) for name, (gn, n, d) in bisect_accum.TRIALS.items()]
    cases += [(f"bisect_accum2 {bisect_accum2.tag(names, d)}", bisect_accum2.GRID,
               [bisect_accum2.SHAPES[n] for n in names], d) for names, d in bisect_accum2.COMBINATIONS]
    for i, (key, gn, shapes, d) in enumerate(cases):
        a = bisect_accum.draw(gn, 520 + i, dev)
        res["rel_err"][key] = bisect_accum.check_accum(a, probes.block_total_accum(a, shapes, d), shapes, d)
        res["ms"][key] = smoke.graph_ms(lambda: probes.block_total_accum(a, shapes, d), side)
        lib = (lambda: (a * 2.0, torch.sum(a))) if d else (lambda: torch.sum(a))
        res["ms"][f"{key} library"] = smoke.graph_ms(lib, side)
        del a
    res["attrs"].update({**mp.mosaic_kernel_attributes(), **probes.accum_kernel_attributes()})


def cellconv_times(res: dict, smoke, dev, side) -> None:
    import torch
    from se3conv3d_tpu_torch.experiments import probe_cellconv as pc
    from se3conv3d_tpu_torch.kernels import cellconv_probes as cc

    x = pc.draw("p3", 540, dev)
    pne = torch.empty(x["qp"].shape[0], x["cp"].shape[0], device=dev)
    res["rel_err"]["p3"] = pc.check("p3", x, pc.run("p3", x, pne), pne)
    res["ms"]["p3"] = smoke.graph_ms(lambda: pc.run("p3", x), side)
    res["ms"]["p3 library"] = smoke.graph_ms(lambda: torch.matmul(pne, x["cf"]), side)
    res["attrs"].update(cc.cellconv_kernel_attributes())


def worker(root: Path, m: int, first: bool, sets: list) -> dict:
    """Times ``root``'s wrappers; returns ms, the stage sums and their sums
    of |values|, the relative errors and, where ``first``, the build."""
    sys.path.insert(0, str(root))
    import torch

    smoke = load_smoke()
    from se3conv3d_tpu_torch.kernels import build, probes

    if not Path(probes.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"probe_ab: imported {probes.__file__}, not the one under {root}")
    res = {"ms": {}, "sums": {}, "terms": {}, "rel_err": {}, "attrs": {}}
    if first:
        t0 = time.perf_counter()
        libs = build.build_libraries(names=tuple(lib for s in sets for lib in SETS[s]))
        res["build_s"] = time.perf_counter() - t0
        res["sass"] = {name: sass_counts(path) for name, path in libs.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, side = torch.device("cuda"), torch.cuda.Stream()
    if "stage" in sets:
        stage_times(res, smoke, m, dev, side)
    if "mosaic" in sets:
        mosaic_times(res, smoke, dev, side)
    if "cellconv" in sets:
        cellconv_times(res, smoke, dev, side)
    return res


def sass_line(root: str, res: dict) -> str:
    counts = {k: v for lib in res["sass"].values() for k, v in lib.items()}
    by_type = {}
    for k, v in counts.items():
        if k.startswith("strided_product<"):
            key = "strided_product<" + k.split("<")[1].split(",")[0].rstrip(">") + "> (all)"
            by_type[key] = [x + y for x, y in zip(by_type.get(key, [0, 0]), v)]
    return (f"[{root}] build {res['build_s']:.1f} s; SASS (HGMMA, HMMA): "
            + "; ".join(f"{k} {v[0]}, {v[1]}" for k, v in {**counts, **by_type}.items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--sets", default="stage,mosaic", help="comma-separated: " + ", ".join(SETS))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sets = [s for s in a.sets.split(",") if s]
    if not sets or any(s not in SETS for s in sets):
        raise SystemExit(f"probe_ab: --sets takes {', '.join(SETS)}, got {a.sets!r}")
    if a.worker:
        print(json.dumps(worker(Path(a.roots[0]).resolve(), a.m, a.first, sets)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    card = smoke.card_line()
    runs = {root: [] for root in a.roots}
    for r in range(a.rounds):
        for root in (a.roots if r % 2 == 0 else a.roots[::-1]):
            cmd = [sys.executable, str(Path(__file__).resolve()), root, "--worker", "--m", str(a.m), "--sets", a.sets]
            p = subprocess.run(cmd + (["--first"] if not runs[root] else []), capture_output=True, text=True)
            if p.returncode:
                print(p.stdout[-4000:] + p.stderr[-8000:], file=sys.stderr)
                raise SystemExit(f"probe_ab: {root} failed in round {r}")
            res = json.loads(p.stdout.strip().splitlines()[-1])
            if "build_s" in res:
                print(sass_line(root, res), flush=True)
                for k, v in res.get("attrs", {}).items():
                    print(f"[{root}] {k}: {v['registers']} registers, {v['local_bytes']} local bytes, "
                          f"{v['static_smem']} + {v['dynamic_smem']} bytes of shared memory", flush=True)
            runs[root].append(res)
    first = runs[a.roots[0]][0]
    from se3conv3d_tpu_torch.experiments import bisect_accum

    for root, rs in runs.items():
        for res in rs:
            for key, total in res["sums"].items():
                rtol = smoke.PROBE_SCALAR_RTOL[torch.bfloat16 if "bfloat16" in key else torch.float32]
                if abs(total - first["sums"][key]) > rtol * first["terms"][key]:
                    raise SystemExit(f"probe_ab: {root} {key} sums to {total}, {a.roots[0]} to {first['sums'][key]}")
            for key, err in res["rel_err"].items():
                bound = bisect_accum.SUM_RTOL if key.startswith("bisect_accum") else B3_RTOL
                if err > bound:
                    raise SystemExit(f"probe_ab: {root} {key} reads {err:.3e} against its bound {bound:g}")
    ms = {f"{key} [{root}]": [res["ms"][key] for res in rs] for root, rs in runs.items() for key in rs[0]["ms"]}
    for key in first["ms"]:
        print(f"{key:40s} " + "  ".join(f"[{root}] {statistics.median(ms[f'{key} [{root}]']):.4f}"
                                         for root in a.roots) + f" ms [{card}]", flush=True)
    print(json.dumps({"card": card, "m": a.m, "rounds": a.rounds, "sets": sets,
                      "ms": {k: statistics.median(v) for k, v in ms.items()},
                      "range": {k: [min(v), max(v)] for k, v in ms.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
