#!/usr/bin/env python3
"""Variants of one probe kernel's source, built side by side and timed in
turns on one NVIDIA GPU.

    python3 probe_variants.py p3|p11 [--rounds 4]

Each variant is the kernel's source in this checkout with a few lines
replaced (``KERNELS``); the first is the source as it stands.  Every
variant is compiled with ``nvcc`` (``kernels.build``'s flags, all at once)
into its own library under the git-ignored ``kernels/_build/variants/``, and
called through the same C entry as the wrapper calls on the same inputs;
device ms per call from ``chip_smoke.graph_ms`` (a CUDA graph of 5 calls),
round r in the listed order on even rounds and reversed on odd ones, the
one PyTorch call (``torch.matmul(pne, cf)``, ``torch.sum(a, 0)``) timed
after each round.  A variant marked ``diagnostic`` computes something else
(it drops work to show what that work costs) and is timed only; every
other must give the plain version's result as the wrapper's checks hold
it (p3: pne bit for bit, the product within ``P3_RTOL`` of max |plain|;
p11: bit for bit ``probes.grid_column_in_kernel_order``).  Prints each
variant's registers and spills (``-Xptxas -v``), its check, and the median
and range of its times beside the card's name and power limit.  It runs on
the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# kernel: (source, C entry, ctypes argtypes, {variant: ([(old, new), ...], diagnostic)})
_ONE_PRODUCT = [("mma_tf32(lh[mt][nt], al[mt], bh[nt]);", ""), ("mma_tf32(hl[mt][nt], ah[mt], bl[nt]);", "")]
_NO_PNE = [("const float dx = __fsub_rn(qx, c.x), dy = __fsub_rn(qy, c.y), dz = __fsub_rn(qz, c.z);", ""),
           ("const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));",
            "const float d2 = qx - c.x;"),
           ("return d2 < kRadius2 ? __fadd_rn(__fmul_rn(d2, 3.f), 1.f) : 0.f;", "return d2;")]
_LO_RAW = [("// (d2 < 0.04) * (3 d2 + 1)", "__device__ __forceinline__ void split_raw(float x, uint32_t& hi, uint32_t& lo) "
            "{\n  hi = to_tf32(x);\n  lo = __float_as_uint(x - __uint_as_float(hi));\n}\n\n// (d2 < 0.04) * (3 d2 + 1)"),
           ("split_tf32(", "split_raw(")]
_AHEAD = "constexpr int kColAhead = 64;"
KERNELS = {
    "p3": ("probe_cellconv.cu", "se3_probe_masked_dist_product",
           [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
           {"as built": ([], False),
            "lo unrounded (the tensor cores read its top 19 bits)": (_LO_RAW, False),
            "32 x 64 tiles (a warp 16 x 64)": ([("constexpr int kMT = 2;", "constexpr int kMT = 1;"),
                                                ("constexpr int kNT = 4;", "constexpr int kNT = 8;")], False),
            "one product a tile (hi.hi)": (_ONE_PRODUCT, True),
            "no pne math": (_NO_PNE, True),
            "one product, no pne math": (_ONE_PRODUCT + _NO_PNE, True)}),
    "p11": ("probe_accum.cu", "se3_probe_grid_column_accum",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
            {"as built (64 rows ahead)": ([], False),
             "32 rows ahead": ([(_AHEAD, "constexpr int kColAhead = 32;")], False),
             "128 rows ahead": ([(_AHEAD, "constexpr int kColAhead = 128;")], False)}),
}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_variants", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"probe_variants: the source has no {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(kernel: str) -> dict:
    """{variant: (C entry, ptxas lines of the kernel)}, every variant
    compiled at once."""
    from se3conv3d_tpu_torch.kernels import build

    source, entry, argtypes, variants = KERNELS[kernel]
    csrc = build.SOURCES["probe_accum"].parent
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (csrc / source).read_text()
    procs = {}
    for i, (name, (edits, _)) in enumerate(variants.items()):
        path = out_dir / f"{kernel}_{i}.cu"
        path.write_text(variant_source(base, edits))
        procs[name] = (path, subprocess.Popen([build._nvcc(), "-Xptxas=-v", *build.NVCC_FLAGS, "-I", str(csrc),
                                               "-o", str(path.with_suffix(".so")), str(path)],
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kern_name = {"p3": "masked_dist_product", "p11": "grid_column_accum"}[kernel]
    built = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_variants: {name!r} does not build:\n{log[-4000:]}")
        lines, on = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                on = kern_name in line
            elif on and ("registers" in line or "spill" in line):
                lines.append(line.split(":", 1)[-1].strip())
        fn = getattr(ctypes.CDLL(str(path.with_suffix(".so"))), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[name] = (fn, "; ".join(lines))
    return built


def p3_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import probe_cellconv as pc
    from se3conv3d_tpu_torch.kernels import cellconv_probes as cc

    x = pc.draw("p3", 462, dev)
    nq, nc, c = x["qp"].shape[0], x["cp"].shape[0], x["cf"].shape[1]
    pne_plain = cc.masked_dist_pne(x["qp"], x["cp"])
    ref = cc.masked_dist_product_reference(x["qp"], x["cp"], x["cf"])

    def call(fn, pne=None):
        out = torch.empty(nq, c, device=dev)
        err = fn(x["qp"].data_ptr(), x["qp"].shape[1], nq, x["cp"].data_ptr(), x["cp"].shape[1], nc,
                 x["cf"].data_ptr(), c, out.data_ptr(), None if pne is None else pne.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        pne = torch.empty(nq, nc, device=dev)
        got = call(fn, pne)
        rel = float((got - ref).abs().max() / ref.abs().max())
        return rel <= pc.P3_RTOL and torch.equal(pne, pne_plain), f"pne bitwise {torch.equal(pne, pne_plain)}, " \
                                                                  f"product {rel:.3e} of max |plain|"

    return call, check, ("torch.matmul(pne, cf)", lambda: torch.matmul(pne_plain, x["cf"]))


def p11_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import probe_mosaic
    from se3conv3d_tpu_torch.kernels import probes

    (a,) = probe_mosaic.draw("p11_grid_accum", 440, dev)
    want = probes.grid_column_in_kernel_order(a)

    def call(fn):
        out = torch.empty(1, a.shape[1], device=dev)
        err = fn(a.data_ptr(), a.shape[0] // probes.TM, probes.TM, a.shape[1], out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        same = torch.equal(call(fn), want)
        return same, f"bitwise the stated order: {same}"

    return call, check, ("torch.sum(a, 0)", lambda: torch.sum(a, 0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_variants(a.kernel)
    dev, side = torch.device("cuda"), torch.cuda.Stream()
    call, check, (lib_name, lib) = (p3_calls if a.kernel == "p3" else p11_calls)(dev)
    diagnostic = {name: d for name, (_, d) in KERNELS[a.kernel][3].items()}
    for name, (fn, ptxas) in built.items():
        ok, what = check(fn)
        torch.cuda.synchronize()
        print(f"{name}: {ptxas}; {what}" + (" (diagnostic)" if diagnostic[name] else ""), flush=True)
        if not ok and not diagnostic[name]:
            raise SystemExit(f"probe_variants: {name!r} disagrees with the plain version")
    ms = {name: [] for name in list(built) + [lib_name]}
    names = list(built)
    for r in range(a.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            ms[name].append(smoke.graph_ms(lambda fn=built[name][0]: call(fn), side))
        ms[lib_name].append(smoke.graph_ms(lib, side))
    for name, v in ms.items():
        print(f"{name:55s} median {statistics.median(v):.4f} ms, range {min(v):.4f}-{max(v):.4f} [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
