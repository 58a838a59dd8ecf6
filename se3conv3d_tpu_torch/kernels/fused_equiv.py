"""Fused equivariant PNE-conv forward: Hopper CUDA kernel + plain version.

Computes, for every query point m, out-frame g and output channel o::

    out[b,m,g,o] = sum_{q,c} W[c,q,o] * sum_{k,f: mask[b,m,k]}
                   gelu(P . [rel[b,m,k,g], rot6[b,m,k,g,f]] + bias)[q]
                   * feats[b, idx[b,m,k], f, c]

with exact (erf) gelu, ``P = proj_axes [9, Q]`` already scaled by the
layer's ``norm_neigh_dist`` on its three offset rows, and no normalisation
(the caller applies ``norm_num_neighs / F``).  All operands are float32.

Replaces ``se3conv3d_tpu/ops/pallas/fused_equiv.py:_fwd_kernel`` (the TPU
Pallas forward, reached through ``_fused_single_fwd`` / ``fused_pne_conv``).
It computes the same function, not the TPU layout: the TPU kernel read a
pre-gathered ``[M, E, C]`` feature block and a transposed, 128-lane-packed
geometry table; this one gathers features by ``idx``/``mask`` itself and
reads the per-edge geometry in its natural ``[B, M, K, G, ...]`` layout.

What bounds it on the card: at the slice's widths the per-edge embedding
``pne [M, K*F, G*Q]`` and the per-point ``basis [M, G*Q, C]`` are 0.5-2 GB
per conv in float32 if written out, and the gathered features as many
again.  The design keeps all three on chip: one block owns 8 query points
(one warp per point), stages each point's valid edges, their pne and the
gathered features in shared memory, reduces to ``basis`` in registers, and
contracts ``basis`` against ``W`` (read from L2 once per 8-point tile) in
the same block.  What remains is float32 FMA and shared-memory traffic:
no tensor cores yet (the recipe is float32), no TMA, no ``wgmma``.

``fused_equiv_fwd`` launches the kernel for CUDA tensors and runs
``fused_equiv_fwd_reference`` for CPU tensors; there is no other fallback.
The kernel is built with ``nvcc`` for ``sm_90a`` at its first launch, into
``kernels/_build/`` keyed by a hash of its source, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

__all__ = [
    "fused_equiv_fwd",
    "fused_equiv_fwd_reference",
    "build_library",
    "MAX_GQ",
]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "fused_equiv_fwd.cu"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# a pne row in the kernel's shared memory holds at most 64 (g, q) columns
MAX_GQ = 64


_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused conv kernel is built with the CUDA toolkit")


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/fused_equiv_fwd.cu`` (once per source hash); returns
    the shared library's path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"fused_equiv_fwd_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.se3_fused_equiv_fwd
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def fused_equiv_fwd_reference(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights):
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    b, m, k, g, _ = rel.shape
    f = rot6.shape[4]
    geo = torch.cat([rel[:, :, :, :, None, :].expand(b, m, k, g, f, 3), rot6], -1)
    pne = F.gelu(geo @ proj_axes + proj_biases)  # [B, M, K, G, F, Q], exact erf
    gathered = feats[torch.arange(b, device=feats.device)[:, None, None], idx]  # [B,M,K,F,C]
    gathered = gathered * mask[:, :, :, None, None].to(feats.dtype)
    basis = torch.einsum("bmkfc,bmkgfq->bmgcq", gathered, pne)
    return torch.einsum("bmgcq,cqo->bmgo", basis, conv_weights)


def _check(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights):
    tensors = dict(rel=rel, rot6=rot6, feats=feats, idx=idx, mask=mask,
                   proj_axes=proj_axes, proj_biases=proj_biases, conv_weights=conv_weights)
    dev = feats.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("rel", "rot6", "feats", "proj_axes", "proj_biases", "conv_weights"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    b, m, k, g, three = rel.shape
    bn, n, f, c = feats.shape
    q = proj_biases.shape[0]
    o = conv_weights.shape[2]
    want = {
        "rel": (b, m, k, g, 3),
        "rot6": (b, m, k, g, f, 6),
        "feats": (b, n, f, c),
        "idx": (b, m, k),
        "mask": (b, m, k),
        "proj_axes": (9, q),
        "proj_biases": (q,),
        "conv_weights": (c, q, o),
    }
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, expected {shape}")
    if g > 2 or g * q > MAX_GQ:
        raise ValueError(f"kernel takes G <= 2 and G*Q <= {MAX_GQ}, got G={g}, Q={q}")
    if b > 65535:
        raise ValueError("kernel takes at most 65535 batch elements")
    return b, m, n, k, g, f, q, c, o


def fused_equiv_fwd(
    rel: torch.Tensor,
    rot6: torch.Tensor,
    feats: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    proj_axes: torch.Tensor,
    proj_biases: torch.Tensor,
    conv_weights: torch.Tensor,
) -> torch.Tensor:
    """Fused conv forward ``-> [B, M, G, O]`` float32, un-normalised.

    Args:
      rel: ``[B, M, K, G, 3]`` edge offsets in the receiver frames.
      rot6: ``[B, M, K, G, F, 6]`` 6D relative rotations.
      feats: ``[B, N, F, C]`` source features.
      idx / mask: ``[B, M, K]`` int64 neighbor indices and bool validity.
      proj_axes: ``[9, Q]`` (offset rows pre-scaled); proj_biases ``[Q]``;
        conv_weights ``[C, Q, O]``.

    CPU tensors run :func:`fused_equiv_fwd_reference`.  CUDA tensors launch
    the kernel (forward only: it raises when a gradient is requested).
    """
    if feats.device.type == "cpu":
        return fused_equiv_fwd_reference(
            rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, m, n, k, g, f, q, c, o = _check(
        rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights
    )
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (feats, proj_axes, proj_biases, conv_weights)
    ):
        raise NotImplementedError("the fused conv kernel has no backward yet")
    out = torch.empty((b, m, g, o), dtype=torch.float32, device=feats.device)
    if b * m == 0 or o == 0:
        return out.zero_()
    lib = _library()
    with torch.cuda.device(feats.device):
        err = lib.se3_fused_equiv_fwd(
            rel.data_ptr(), rot6.data_ptr(), feats.data_ptr(), idx.data_ptr(),
            mask.data_ptr(), proj_axes.data_ptr(), proj_biases.data_ptr(),
            conv_weights.data_ptr(), out.data_ptr(),
            b, m, n, k, g, f, q, c, o, torch.cuda.current_stream(feats.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_equiv_fwd kernel launch failed: CUDA error {err}")
    fused_equiv_fwd.launches += 1
    return out


# kernel launches so far (CPU calls do not count); callers may reset it
fused_equiv_fwd.launches = 0
