"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, keyed by a hash of the flags, the
source and every header it includes from ``csrc/`` (``#include "..."``,
followed through the headers), in the git-ignored ``kernels/_build/``, and
loaded with ctypes.
:func:`build_libraries` compiles every source that is not built yet, one
``nvcc`` per source, all started together; :func:`library` builds one at
its first use.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "BUILD_DIR", "build_libraries", "library"]

_HERE = Path(__file__).resolve().parent
SOURCES = {
    "fwd": _HERE / "csrc" / "fused_equiv_fwd.cu",
    "bwd": _HERE / "csrc" / "fused_equiv_bwd.cu",
    "cumsum": _HERE / "csrc" / "segsum_cumsum.cu",
    "product": _HERE / "csrc" / "product.cu",
    "probe_stage": _HERE / "csrc" / "probe_stage_fwd.cu",
    "probe_bwd": _HERE / "csrc" / "probe_bwd_ops.cu",
    "probe_stream": _HERE / "csrc" / "probe_stream.cu",
    "probe_accum": _HERE / "csrc" / "probe_accum.cu",
    "probe_cellconv": _HERE / "csrc" / "probe_cellconv.cu",
    "probe_mosaic": _HERE / "csrc" / "probe_mosaic.cu",
}
BUILD_DIR = _HERE / "_build"
# --split-compile=0 runs the device compiler's passes on every core: the
# conv backward's 80 kernels build in about 32 s instead of 91 s on an
# 8-core host, with the same registers per kernel
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# name: [(symbol, argtypes, restype)]
_SIGNATURES = {
    "fwd": [("se3_fused_equiv_fwd", [_P] * 11 + [_I] * 14 + [_P], _I),
            ("se3_fused_std_fwd", [_P] * 10 + [_I] * 12 + [_P], _I),
            ("se3_fused_kp_fwd", [_P] * 12 + [_I] * 13 + [_F, _I, _P], _I),
            ("se3_fused_equiv_fwd_plan", [_I] * 5 + [_L, _I] + [_P] * 3, None)],
    "bwd": [("se3_fused_equiv_bwd", [_P] * 17 + [_I] * 14 + [_P], _I),
            ("se3_fused_std_bwd", [_P] * 16 + [_I] * 12 + [_P], _I),
            ("se3_fused_kp_bwd", [_P] * 18 + [_I] * 13 + [_F, _I, _P], _I),
            ("se3_fused_equiv_bwd_plan", [_I] * 6 + [_P] * 3, None),
            ("se3_fused_edge_plan", [_I] * 6 + [_P], _I),
            ("se3_fused_edge_attrs", [_I] * 7 + [_P], _I)],
    "product": [("se3_product_plan", [_I] * 5 + [_P] * 2, None),
                ("se3_product", [_I, _I, _P, _L, _P, _L, _P, _L, _P] + [_I] * 6 + [_P] * 2, _I)],
    "cumsum": [("se3_blocked_cumsum", [_P] * 3 + [_I, _L, _I, _I, _P], _I),
               ("se3_blocked_cumsum_words", [_I, _L, _I], _L)],
    "probe_stage": [("se3_probe_stage_fwd", [_P] * 9 + [_I] * 6 + [_P], _I),
                    ("se3_probe_stage_attrs", [_I] * 3 + [_P], _I)],
    "probe_bwd": [("se3_probe_gelu_jvp", [_P, _P, _L, _P], _I),
                  ("se3_probe_expand_groups", [_P, _P, _I, _I, _L, _P], _I),
                  ("se3_probe_batched_contract", [_P] * 3 + [_I] * 4 + [_P], _I),
                  ("se3_probe_rank3_accum", [_P] * 2 + [_I] * 6 + [_P], _I),
                  ("se3_probe_scale2", [_P, _P, _L, _P], _I),
                  ("se3_probe_stream_attrs", [_I, _P], _I)],
    "probe_stream": [("se3_probe_column_sums", [_P, _L, _I, _P, _P, _P], _I),
                     ("se3_probe_stream_blocks", [], _I)],
    "probe_accum": [("se3_probe_accum_blocks", [], _I),
                    ("se3_probe_block_total_accum", [_P, _L, _P, _P, _I, _L] + [_P, _L] * 3 + [_P], _I),
                    ("se3_probe_grid_column_accum", [_P, _I, _I, _I, _P, _P], _I),
                    ("se3_probe_accum_attrs", [_I, _P], _I)],
    "probe_cellconv": [("se3_probe_block_gather", [_P, _I, _I, _P, _I, _L, _I, _F, _I, _P, _P], _I),
                       ("se3_probe_masked_dist_product", [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P], _I),
                       ("se3_probe_cellconv_attrs", [_I, _P], _I)],
    "probe_mosaic": [("se3_probe_strided_product", [_P, _P, _I] + [_L] * 6 + [_I] * 14 + [_P] * 2, _I),
                     ("se3_probe_product_attrs", [_I] * 5 + [_P], _I),
                     ("se3_probe_strided_copy", [_P] + [_L] * 8 + [_I, _P, _P], _I),
                     ("se3_probe_blockdiag_build", [_P, _I, _I, _I, _P, _P], _I),
                     ("se3_probe_mid_write", [_P, _I, _I, _I, _P, _P], _I),
                     ("se3_probe_mosaic_attrs", [_I, _P], _I)],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _source_files(src: Path) -> list:
    """``src`` and every file it includes with quotes, found beside the
    including file, depth first, each once."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(SOURCES[name]):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{SOURCES[name].stem}_{digest.hexdigest()[:16]}.so"


def build_libraries(verbose: bool = False, names=tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the kernel sources that are not built yet, one ``nvcc`` per
    source, all started together; returns each shared library's path.
    ``verbose`` prints ``-Xptxas -v`` (registers, shared memory, spills)."""
    out = {name: _lib_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name].name} failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err, end="")
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built at first use."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_libraries(names=(name,))[name]))
            for symbol, argtypes, restype in _SIGNATURES[name]:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
    return _libs[name]
