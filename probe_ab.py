#!/usr/bin/env python3
"""Old against new on one NVIDIA GPU: the stage probe's tile-sum forward
(every stage, float32 and bfloat16) and b3 ``batched_contract``, each
checkout timed through its own wrappers, in turn.

    python3 probe_ab.py ROOT [ROOT ...] [--rounds 2] [--m 65536]

Each ``ROOT`` is a checkout of this repository: ``.`` for this one, and
for instance a parent commit unpacked beside it with ``git archive`` into
the git-ignored ``scratch_checkout/``.  Round r runs one process a root, in
the given order on even rounds and reversed on odd ones (A B, then B A).
A process imports its root's ``se3conv3d_tpu_torch``, whose wrappers build
that root's kernel sources at first use, draws ``chip_stage_time``'s
inputs at ``M`` rows and ``bisect_fused``'s b3 inputs, and times
``probes.stage_sum``, ``probes.batched_contract`` and ``torch.bmm`` with
this checkout's ``chip_smoke.graph_ms`` (device ms per call from a CUDA
graph of 5 calls, median of 5 replays).  A root's first process also
reports its build's seconds (the two sources at once) and, per kernel,
the HGMMA (wgmma) and HMMA (mma.sync) instructions in the libraries' SASS
(``cuobjdump --dump-sass``).  Every root's stage sums must agree with the
first root's within ``chip_smoke.PROBE_SCALAR_RTOL`` of the stage's sum of
|values|, and its b3 with the plain version within 1e-5 of the plain
version's largest value.  The last line is one JSON object: each median,
its range, and the card's name and power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
B3_RTOL = 1e-5


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def demangle(name: str) -> str:
    """The kernel and template arguments of a mangled tile_fwd / stage_fwd
    name, shortened (tile_fwd<4,bf16>)."""
    for kern in ("tile_fwd", "stage_fwd", "batched_contract"):
        if kern in name:
            rest = name.rsplit(kern, 1)[1]
            if not rest.startswith("I"):
                return kern
            stage = rest[3] if rest.startswith("ILi") else "?"
            return f"{kern}<{stage},{'bf16' if 'bfloat16' in rest[:40] else 'f32'}>" if kern == "tile_fwd" \
                else f"{kern}<{stage}>"
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


def worker(root: Path, m: int, first: bool) -> dict:
    """Times ``root``'s wrappers; returns ms, the stage sums and their sums
    of |values|, b3's relative error and, where ``first``, the build."""
    sys.path.insert(0, str(root))
    import torch

    smoke = load_smoke()
    from se3conv3d_tpu_torch.experiments import bisect_fused, chip_stage_time as cst
    from se3conv3d_tpu_torch.kernels import build, probes

    if not Path(probes.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"probe_ab: imported {probes.__file__}, not the one under {root}")
    res = {"ms": {}, "sums": {}, "terms": {}}
    if first:
        t0 = time.perf_counter()
        libs = build.build_libraries(names=("probe_stage", "probe_bwd"))
        res["build_s"] = time.perf_counter() - t0
        res["sass"] = {name: sass_counts(path) for name, path in libs.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, side = torch.device("cuda"), torch.cuda.Stream()
    args = cst.make_inputs(m, 32, dev)
    for dtype in (torch.float32, torch.bfloat16):
        for stage, kstage in cst.STAGES.items():
            key = f"{stage} {smoke.dtype_name(dtype)}"
            res["sums"][key] = float(probes.stage_sum(*args, stage=kstage, cdt=dtype))
            res["terms"][key] = float(probes.stage_forward_reference(*args, None, kstage, dtype).abs().sum())
            res["ms"][key] = smoke.graph_ms(lambda: probes.stage_sum(*args, stage=kstage, cdt=dtype), side)
    x, y = bisect_fused.draw("b3_dw2_contract11", 8, dev)
    ref = probes.batched_contract_reference(x, y)
    res["b3_rel_err"] = float((probes.batched_contract(x, y) - ref).abs().max() / ref.abs().max())
    res["ms"]["b3"] = smoke.graph_ms(lambda: probes.batched_contract(x, y), side)
    res["ms"]["b3 torch.bmm"] = smoke.graph_ms(lambda: torch.bmm(x.transpose(1, 2), y), side)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(Path(a.roots[0]).resolve(), a.m, a.first)))
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
            cmd = [sys.executable, str(Path(__file__).resolve()), root, "--worker", "--m", str(a.m)]
            p = subprocess.run(cmd + (["--first"] if not runs[root] else []), capture_output=True, text=True)
            if p.returncode:
                print(p.stdout[-4000:] + p.stderr[-8000:], file=sys.stderr)
                raise SystemExit(f"probe_ab: {root} failed in round {r}")
            res = json.loads(p.stdout.strip().splitlines()[-1])
            if "build_s" in res:
                print(f"[{root}] build of probe_stage_fwd.cu and probe_bwd_ops.cu at once {res['build_s']:.1f} s; "
                      "SASS (HGMMA, HMMA): " + "; ".join(f"{k} {v[0]}, {v[1]}" for lib in res["sass"].values()
                                                          for k, v in lib.items()), flush=True)
            runs[root].append(res)
    first = runs[a.roots[0]][0]
    for root, rs in runs.items():
        for res in rs:
            for key, total in res["sums"].items():
                rtol = smoke.PROBE_SCALAR_RTOL[torch.bfloat16 if "bfloat16" in key else torch.float32]
                if abs(total - first["sums"][key]) > rtol * first["terms"][key]:
                    raise SystemExit(f"probe_ab: {root} {key} sums to {total}, {a.roots[0]} to {first['sums'][key]}")
            if res["b3_rel_err"] > B3_RTOL:
                raise SystemExit(f"probe_ab: {root} b3 off its plain version by {res['b3_rel_err']:.3e} of its max")
    ms = {f"{key} [{root}]": [res["ms"][key] for res in rs] for root, rs in runs.items() for key in rs[0]["ms"]}
    for key in first["ms"]:
        print(f"{key:13s} " + "  ".join(f"[{root}] {statistics.median(ms[f'{key} [{root}]']):.4f}"
                                         for root in a.roots) + f" ms [{card}]", flush=True)
    print(json.dumps({"card": card, "m": a.m, "rounds": a.rounds,
                      "ms": {k: statistics.median(v) for k, v in ms.items()},
                      "range": {k: [min(v), max(v)] for k, v in ms.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
