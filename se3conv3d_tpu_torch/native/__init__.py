"""ctypes bindings for the native host-prep library (``pcprep.cpp``),
counterpart of ``se3conv3d_tpu/native/__init__.py``.

The library is compiled with ``g++`` at its first use into the git-ignored
``native/_build/``, keyed by a hash of the compiler flags and the source,
and loaded with ctypes.  Where it cannot be built or loaded, every entry
point returns None and the augmentations take their numpy path, which gives
the same result (``elastic_distortion``'s numpy path draws other noise, as
in the JAX package).

``calls`` counts, per entry point, the calls the library served, so a run
can show that its augmentations used it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["SOURCE", "BUILD_DIR", "calls", "load_library", "elastic_distortion", "voxel_keys",
           "crop_nearest", "select_nearest"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "pcprep.cpp"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

calls: Dict[str, int] = {"elastic_distortion": 0, "voxel_keys": 0, "crop_nearest": 0,
                         "select_nearest": 0}

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    """Where the library for the current source and flags is built."""
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpcprep-{key}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)  # atomic: concurrent builds each install a whole file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library; None where that fails."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.elastic_distortion.argtypes = [_F64, ctypes.c_int64, _F64, _F64, ctypes.c_int64,
                                           ctypes.c_uint64]
        lib.elastic_distortion.restype = None
        lib.voxel_keys.argtypes = [_F32, ctypes.c_int64, ctypes.c_float,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.voxel_keys.restype = None
        lib.crop_nearest.argtypes = [_F32, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _U8]
        lib.crop_nearest.restype = None
        lib.select_nearest.argtypes = [_F32, ctypes.c_int64, ctypes.c_int64, _U8]
        lib.select_nearest.restype = ctypes.c_int64
        _lib = lib
        return _lib


def elastic_distortion(pts: np.ndarray, granularity, magnitude, seed: int) -> Optional[np.ndarray]:
    """Elastic distortion of ``pts [n, 3]`` (float64 out); None where the
    library is absent."""
    lib = load_library()
    if lib is None:
        return None
    out = np.ascontiguousarray(pts, np.float64).copy()
    gran = np.ascontiguousarray(granularity, np.float64)
    mag = np.ascontiguousarray(magnitude, np.float64)
    if out.ndim != 2 or out.shape[1] != 3 or gran.shape != mag.shape:
        raise ValueError(f"points [n, 3] and equal level lists expected, got {out.shape}, "
                         f"{gran.shape}, {mag.shape}")
    lib.elastic_distortion(out.ctypes.data_as(_F64), out.shape[0], gran.ctypes.data_as(_F64),
                           mag.ctypes.data_as(_F64), len(gran),
                           ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF))
    calls["elastic_distortion"] += 1
    return out


def voxel_keys(pts: np.ndarray, cell: float) -> Optional[np.ndarray]:
    """Linearised voxel keys of ``pts [n, 3]``; None where the library is absent."""
    lib = load_library()
    if lib is None:
        return None
    p = np.ascontiguousarray(pts, np.float32)
    if p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"points [n, 3] expected, got {p.shape}")
    keys = np.empty(p.shape[0], np.int64)
    lib.voxel_keys(p.ctypes.data_as(_F32), p.shape[0], ctypes.c_float(cell),
                   keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    calls["voxel_keys"] += 1
    return keys


def crop_nearest(pts: np.ndarray, max_pts: int, seed: int) -> Optional[np.ndarray]:
    """Keep mask of the ``max_pts`` points nearest a seed point drawn from
    ``seed``; None where the library is absent."""
    lib = load_library()
    if lib is None:
        return None
    p = np.ascontiguousarray(pts, np.float32)
    if p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"points [n, 3] expected, got {p.shape}")
    keep = np.empty(p.shape[0], np.uint8)
    lib.crop_nearest(p.ctypes.data_as(_F32), p.shape[0], int(max_pts),
                     ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), keep.ctypes.data_as(_U8))
    calls["crop_nearest"] += 1
    return keep.astype(bool)


def select_nearest(d2: np.ndarray, max_pts: int) -> Optional[np.ndarray]:
    """Keep mask of the ``max_pts`` smallest of the float32 squared distances
    ``d2 [n]``: the set ``np.argsort(d2)[:max_pts]`` keeps.  None where the
    library is absent, or where that set depends on how a sort orders equal
    distances (the caller then sorts)."""
    lib = load_library()
    if lib is None:
        return None
    d = np.ascontiguousarray(d2, np.float32)
    if d.ndim != 1:
        raise ValueError(f"distances [n] expected, got {d.shape}")
    keep = np.empty(d.shape[0], np.uint8)
    if not lib.select_nearest(d.ctypes.data_as(_F32), d.shape[0], int(max_pts),
                              keep.ctypes.data_as(_U8)):
        return None
    calls["select_nearest"] += 1
    return keep.astype(bool)
