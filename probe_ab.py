#!/usr/bin/env python3
"""Old against new on one NVIDIA GPU: the probe kernels redesigned for
Hopper, each checkout timed through its own wrappers, in turn.

    python3 probe_ab.py ROOT [ROOT ...] [--rounds 2] [--m 65536] [--sets stage,bisect,mosaic,copies,cellconv]

Each ``ROOT`` is a checkout of this repository: ``.`` for this one, and
for instance a parent commit unpacked beside it with ``git archive`` into
the git-ignored ``scratch_checkout/``.  Round r runs one process a root, in
the given order on even rounds and reversed on odd ones (A B, then B A).
A process imports its root's ``se3conv3d_tpu_torch``, whose wrappers build
that root's kernel sources at first use, and times with this checkout's
``chip_smoke.graph_ms`` (device ms per call from a CUDA graph, median of 5
replays) through :func:`floor_graph_ms`, which picks the calls a graph
from a first timing of 5 so that one replay runs at least
``GRAPH_FLOOR_MS``: each replay also costs a fixed ~11 us on an H100, which
at 5 calls of a kernel near a launch's floor (~1.8 us) is most of what a
graph of 5 reads:

- ``stage``: ``probes.stage_sum`` on ``chip_stage_time``'s inputs at ``M``
  rows (every stage, float32 and bfloat16) and b3 ``probes.batched_contract``
  on ``bisect_fused``'s inputs, beside ``torch.bmm``;
- ``bisect``: ``bisect_fused``'s s1-s6 (``probes.stage_forward``, the
  whole-tensor mode, at MP = 1024), each two calls bit for bit, beside the
  weight product alone (``torch.bmm`` of a ``[GQ, MP, C]`` basis with W),
  and each stage's registers, local bytes, shared memory and blocks an SM;
  b4 (``probes.rank3_accum``, two calls bit for bit) beside its two-call
  yardstick (``chip_smoke.BISECT_YARDSTICK``: ``torch.sum``, then a copy of
  the broadcast), b2 (``probes.expand_groups``) beside
  ``repeat_interleave``, b1 (``probes.gelu_jvp``, two calls bit for bit,
  within ``bisect_fused.RTOL``; its error over ``chip_smoke.gelu_jvp_sweep``
  printed beside ``chip_smoke.GELU_JVP_SWEEP_RTOL``) beside its yardstick
  ``F.gelu(a, approximate="tanh")`` and b5 (``probes.merge_back``, bit for
  bit ``2a``) beside ``torch.mul(a, 2.0)``, with ``stream_map``'s registers
  and shared memory where the root has it;
- ``mosaic``: every probe of ``mosaic_probes`` at the JAX script's shapes
  (the products of ``strided_product``, the six strided copies, p9 and
  p14), each beside its one PyTorch call (``chip_smoke.mosaic_library``:
  ``torch.matmul`` / ``einsum`` / ``bmm`` / ``tensordot``, ``clone`` /
  ``contiguous``, p9's ``einsum`` with ``eye(2)``, p14's broadcast
  product), p11 (``probes.grid_column_accum``) beside ``torch.sum(a, 0)``,
  and ``probes.block_total_accum`` at every ``bisect_accum`` trial and
  ``bisect_accum2`` combination, beside ``torch.sum(a)`` (and ``a * 2``
  where dfeat is written);
- ``copies``: the six strided copies, p9 and p14 of ``mosaic`` alone
  (cheap enough for many rounds);
- ``cellconv``: p3 (``cellconv_probes.masked_dist_product``) at the JAX
  script's shape, beside ``torch.matmul(pne, cf)`` (its product alone),
  and the gathers p1, p2 and p4 (``gather_blocks``, ``gather_sum_blocks``,
  bit for bit) beside their indexed calls (``tab[ids] * 2``,
  ``tab[ids].sum(1)``) and a ``clone`` of the same output.

A root's first process also reports its build's seconds (the sources at
once), per kernel the HGMMA (wgmma) and HMMA (mma.sync) instructions in the
libraries' SASS (``cuobjdump --dump-sass``; ``strided_product`` summed by
operand type as well), b1's kernel's MUFU.EX2 and all MUFU instructions
(for ``stream_map<GeluJvp>`` per value: one exponential a value), and, with ``mosaic`` or ``cellconv``, each
kernel's registers and shared memory (``cudaFuncGetAttributes``).  Every
root's stage sums must agree with the first root's within
``chip_smoke.PROBE_SCALAR_RTOL`` of the stage's sum of |values|, its b3,
p3 and product probes with their plain versions within 1e-5 of the plain
version's largest value (p3's pne bit for bit), its s1-s6 with theirs
within ``bisect_fused.RTOL`` of the same, its copies bit for bit,
p11's column sums within ``1e-6`` of each column's sum of |a|, its totals
with the float64 total within ``bisect_accum.SUM_RTOL`` of sum |a|.  The last
line is one JSON object: each median, its range, and the card's name and
power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
B3_RTOL = 1e-5
# one replay of a timed CUDA graph runs at least this long (ms), in at most
# GRAPH_MAX_CALLS calls
GRAPH_FLOOR_MS, GRAPH_MAX_CALLS = 0.1, 1000
SETS = {"stage": ("probe_stage", "probe_bwd"), "bisect": ("probe_stage", "probe_bwd"),
        "mosaic": ("probe_mosaic", "probe_accum"), "copies": ("probe_mosaic",), "cellconv": ("probe_cellconv",)}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def floor_graph_ms(graph_ms):
    """``graph_ms`` (``chip_smoke.graph_ms``: fn, side, calls) with its calls
    a graph picked from a first timing of 5: while one replay runs under
    :data:`GRAPH_FLOOR_MS`, again with at least twice the calls and enough,
    at the last reading, for the floor, so that a replay's fixed cost is
    about a tenth or less of what is read.  A kernel whose 5 calls already
    run that long is timed once, at 5 calls."""
    def timed(fn, side) -> float:
        calls, ms = 5, graph_ms(fn, side, 5)
        while ms * calls < GRAPH_FLOOR_MS and calls < GRAPH_MAX_CALLS:
            calls = min(GRAPH_MAX_CALLS, max(2 * calls, math.ceil(1.2 * GRAPH_FLOOR_MS / ms)))
            ms = graph_ms(fn, side, calls)
        return ms

    return timed


def demangle(name: str) -> str:
    """The kernel and template arguments of a mangled tile_fwd / stage_fwd /
    strided_product / stream_map / wg_product / edge_kernel name, shortened
    (tile_fwd<4,bf16>, strided_product<f32,0,1,0>: tile id and the two
    layouts; stream_map<GeluJvp>: the map; wg_product<SiteDw,bf16,64>: the
    conv product's call site, operand type and tile width;
    edge_kernel<f32,64,9,0>: operand type, pne columns, geometry, the
    activation switch)."""
    edge = re.search(r"11edge_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E", name)
    if edge:
        return f"edge_kernel<{'f32' if edge.group(1) == 'f' else 'bf16'},{edge.group(2)},{edge.group(3)},{edge.group(4)}>"
    for kern in ("tile_fwd", "stage_fwd", "batched_contract", "strided_product", "masked_dist_product",
                 "stream_map", "gelu_jvp", "wg_product"):
        if kern in name:
            rest = name.rsplit(kern, 1)[1]
            if not rest.startswith("I"):
                return kern
            if kern == "stream_map":
                return f"{kern}<{'GeluJvp' if 'GeluJvp' in rest else 'Scale2'}>"
            dtype = "bf16" if "bfloat16" in rest[:40] else "f32"
            if kern == "wg_product":
                site, bn = re.search(r"Site\w+?E", rest).group(0)[:-1], re.search(r"Li(\d+)E", rest).group(1)
                return f"{kern}<{site},{dtype},{bn}>"
            if kern == "strided_product":
                args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0])
                return f"{kern}<{','.join([dtype] + args)}>"
            stage = rest[3] if rest.startswith("ILi") else "?"
            return f"{kern}<{stage},{dtype}>" if kern == "tile_fwd" else f"{kern}<{stage}>"
    return name[-40:]


def is_b1(kernel: str) -> bool:
    """b1's kernel: gelu_jvp (the first design's) or stream_map<GeluJvp>."""
    return kernel == "gelu_jvp" or kernel.startswith("stream_map<GeluJvp")


def sass_counts(lib: Path, every: bool = False) -> dict:
    """{kernel: [HGMMA, HMMA, MUFU.EX2, MUFU]} for the kernels of ``lib``
    that hold HGMMA or HMMA, and b1's (:func:`is_b1`); with ``every``, for
    each kernel of ``lib``."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = demangle(line.split("Function :")[1].strip())
            counts[fn] = [0, 0, 0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "HMMA" in line
            counts[fn][2] += "MUFU.EX2" in line
            counts[fn][3] += "MUFU" in line
    return {k: v for k, v in counts.items() if every or any(v[:2]) or is_b1(k)}


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


def bisect_times(res: dict, smoke, dev, side) -> None:
    import torch
    from se3conv3d_tpu_torch.experiments import bisect_fused as bf
    from se3conv3d_tpu_torch.kernels import probes

    names = [n for n in bf.STAGES if n.startswith("s")]
    for i, name in enumerate(names):
        inputs = bf.draw(name, 60 + i, dev)
        fn = bf.STAGES[name]
        got = fn(*inputs)
        res["rel_err"][name] = bf.check(got, bf.REFERENCES[name](*inputs))
        if not torch.equal(got, fn(*inputs)):
            raise SystemExit(f"probe_ab: {name} gave other bits on a second call")
        res["ms"][name] = smoke.graph_ms(lambda: fn(*inputs), side)
    gen = torch.Generator(device=dev).manual_seed(66)
    basis = torch.randn(bf.GQ, bf.MP, bf.C, device=dev, generator=gen)
    res["ms"]["s4-s6 weight product alone torch.bmm"] = smoke.graph_ms(lambda: torch.bmm(basis, inputs[4]), side)
    res["attrs"].update({f"stage_fwd<{s}>": probes.stage_kernel_attributes(s, False) for s in probes.STAGES})
    (a,) = bf.draw("b4_rank3_accum", 68, dev)
    got = bf.STAGES["b4_rank3_accum"](a)
    res["rel_err"]["b4"] = bf.check(got, bf.REFERENCES["b4_rank3_accum"](a))
    if not torch.equal(got, bf.STAGES["b4_rank3_accum"](a)):
        raise SystemExit("probe_ab: b4 gave other bits on a second call")
    res["ms"]["b4"] = smoke.graph_ms(lambda: bf.STAGES["b4_rank3_accum"](a), side)
    yardstick = smoke.BISECT_YARDSTICK["b4_rank3_accum"]
    res["ms"]["b4 yardstick (torch.sum, a copy)"] = smoke.graph_ms(lambda: yardstick(a, *got.shape), side)
    (x,) = bf.draw("b2_gexp", 69, dev)
    res["rel_err"]["b2"] = bf.check(bf.STAGES["b2_gexp"](x), bf.REFERENCES["b2_gexp"](x))
    res["ms"]["b2"] = smoke.graph_ms(lambda: bf.STAGES["b2_gexp"](x), side)
    res["ms"]["b2 library"] = smoke.graph_ms(lambda: x.repeat_interleave(bf.Q, 0), side)
    (x,) = bf.draw("b1_jvp_gelu", 70, dev)
    got = bf.STAGES["b1_jvp_gelu"](x)
    res["rel_err"]["b1"] = bf.check(got, bf.REFERENCES["b1_jvp_gelu"](x))
    if not torch.equal(got, bf.STAGES["b1_jvp_gelu"](x)):
        raise SystemExit("probe_ab: b1 gave other bits on a second call")
    sweep = smoke.gelu_jvp_sweep(dev)
    res["b1_sweep_err"] = smoke.gelu_jvp_sweep_error(bf.STAGES["b1_jvp_gelu"](sweep), sweep)
    res["ms"]["b1"] = smoke.graph_ms(lambda: bf.STAGES["b1_jvp_gelu"](x), side)
    res["ms"]["b1 yardstick F.gelu(tanh)"] = smoke.graph_ms(lambda: smoke.BISECT_YARDSTICK["b1_jvp_gelu"](x), side)
    (x,) = bf.draw("b5_merge_back", 71, dev)
    got = bf.STAGES["b5_merge_back"](x)
    if not torch.equal(got.view(torch.int32), (x.reshape(got.shape) * 2.0).view(torch.int32)):
        raise SystemExit("probe_ab: b5 is not 2a bit for bit")
    res["ms"]["b5"] = smoke.graph_ms(lambda: bf.STAGES["b5_merge_back"](x), side)
    res["ms"]["b5 library torch.mul"] = smoke.graph_ms(lambda: torch.mul(x, 2.0), side)
    if hasattr(probes, "stream_kernel_attributes"):
        res["attrs"].update({f"stream_map<{op}>": probes.stream_kernel_attributes(op)
                             for op in ("gelu_jvp", "merge_back")})


def mosaic_times(res: dict, smoke, dev, side, copies_only: bool = False) -> None:
    import torch
    from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2, probe_mosaic
    from se3conv3d_tpu_torch.kernels import mosaic_probes as mp, probes

    library = {**smoke.mosaic_library(dev), "p11_grid_accum": lambda a: torch.sum(a, 0)}
    names = [n for n, kind in mp.KIND.items() if kind == "product"]  # the products first, as before
    names += [n for n in library if n not in names]
    for i, name in enumerate(names):
        if copies_only and mp.KIND[name] != "copy":
            continue
        xs = probe_mosaic.draw(name, 500 + i, dev)
        fn = mp.PROBES[name]
        res["rel_err"][name] = probe_mosaic.check(name, xs, fn(*xs))
        res["ms"][name] = smoke.graph_ms(lambda: fn(*xs), side)
        res["ms"][f"{name} library"] = smoke.graph_ms(lambda: library[name](*xs), side)
    if copies_only:
        return
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
    for i, part in enumerate(("p1", "p2", "p4")):
        x = pc.draw(part, 541 + i, dev)
        got = pc.run(part, x)
        res["rel_err"][part] = pc.check(part, x, got)
        t3 = (x["tab"] if "tab" in x else x["g"]).view(-1, pc.P, pc.C)
        lib = ((lambda: t3[x["ids"].long()] * 2.0) if part == "p1" else (lambda: t3[x["ids"].long()].sum(1)))
        res["ms"][part] = smoke.graph_ms(lambda: pc.run(part, x), side)
        res["ms"][f"{part} library"] = smoke.graph_ms(lib, side)
        res["ms"][f"{part} clone of the output"] = smoke.graph_ms(lambda: got.clone(), side)
    res["attrs"].update(cc.cellconv_kernel_attributes())


def worker(root: Path, m: int, first: bool, sets: list) -> dict:
    """Times ``root``'s wrappers (:func:`floor_graph_ms`); returns ms, the
    stage sums and their sums of |values|, the relative errors and, where
    ``first``, the build."""
    sys.path.insert(0, str(root))
    import torch

    smoke = load_smoke()
    smoke.graph_ms = floor_graph_ms(smoke.graph_ms)
    from se3conv3d_tpu_torch.kernels import build, probes

    if not Path(probes.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"probe_ab: imported {probes.__file__}, not the one under {root}")
    res = {"ms": {}, "sums": {}, "terms": {}, "rel_err": {}, "attrs": {}}
    if first:
        t0 = time.perf_counter()
        libs = build.build_libraries(names=tuple(dict.fromkeys(lib for s in sets for lib in SETS[s])))
        res["build_s"] = time.perf_counter() - t0
        res["sass"] = {name: sass_counts(path) for name, path in libs.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, side = torch.device("cuda"), torch.cuda.Stream()
    if "stage" in sets:
        stage_times(res, smoke, m, dev, side)
    if "bisect" in sets:
        bisect_times(res, smoke, dev, side)
    if "mosaic" in sets:
        mosaic_times(res, smoke, dev, side)
    elif "copies" in sets:
        mosaic_times(res, smoke, dev, side, copies_only=True)
    if "cellconv" in sets:
        cellconv_times(res, smoke, dev, side)
    return res


def sass_line(root: str, res: dict) -> str:
    counts = {k: v for lib in res["sass"].values() for k, v in lib.items()}
    by_type = {}
    for k, v in counts.items():
        if k.startswith("strided_product<"):
            key = "strided_product<" + k.split("<")[1].split(",")[0].rstrip(">") + "> (all)"
            by_type[key] = [x + y for x, y in zip(by_type.get(key, [0, 0]), v[:2])]
    mma = {k: v for k, v in {**counts, **by_type}.items() if any(v[:2])}
    # b1: stream_map<GeluJvp> maps 4 values a thread; gelu_jvp loops over float4s
    mufu = [f"{k} {v[2]}, {v[3]}" + (f" ({v[2] / 4:.2f} EX2 a value)" if k.startswith("stream_map") else "")
            for k, v in counts.items() if is_b1(k)]
    return (f"[{root}] build {res['build_s']:.1f} s; SASS (HGMMA, HMMA): "
            + "; ".join(f"{k} {v[0]}, {v[1]}" for k, v in mma.items())
            + ("; b1 SASS (MUFU.EX2, all MUFU): " + "; ".join(mufu) if mufu else ""))


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
                          f"{v['static_smem']} + {v['dynamic_smem']} bytes of shared memory"
                          + (f", {v['blocks_per_sm']} block(s) an SM" if "blocks_per_sm" in v else ""), flush=True)
            if "b1_sweep_err" in res and not runs[root]:
                print(f"[{root}] b1 over gelu_jvp_sweep: {res['b1_sweep_err']:.3e} of 1 + |float64| (bound "
                      f"{smoke.GELU_JVP_SWEEP_RTOL:g}, within: {res['b1_sweep_err'] <= smoke.GELU_JVP_SWEEP_RTOL})",
                      flush=True)
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
    print(json.dumps({"card": card, "m": a.m, "rounds": a.rounds, "graph_floor_ms": GRAPH_FLOOR_MS, "sets": sets,
                      "ms": {k: statistics.median(v) for k, v in ms.items()},
                      "range": {k: [min(v), max(v)] for k, v in ms.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
