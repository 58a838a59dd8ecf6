"""Local reference frames (counterpart of ``se3conv3d_tpu/core/frames.py``):
PCA frames from a neighborhood, global PCA frames per cloud, and uniformly
random (Monte-Carlo) frames.

The 3x3 eigensolver is the JAX package's closed form (Cardano eigenvalues,
cross-product eigenvectors) written as elementwise torch on per-component
scalar tensors.  The candidate frames follow the solver's eigenvector signs,
the det fix and the sign sets act on them, so only the same solver lets an
injected ``select_idx`` pick the same frame in both packages.  On a GPU it is
also the fast way: a batched 3x3 ``torch.linalg.eigh`` goes through a
library solver.

Conventions: eigenvalues ascending, eigenvectors as columns; a matrix with
``det < 0`` is negated whole; free frames use the column sign sets
``(1,1,1), (1,-1,-1), (-1,1,-1), (-1,-1,1)``; fixed-axis frames (axis 1 or
2) flip to descending order and use ``(1,1,1), (-1,-1,1)``.

The random parts take their draws as arguments (normals, uniforms or
scores) or from an explicit ``torch.Generator``, never from the global RNG.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from .pointcloud import gather_rows
from .rotation import planar_rotations, random_rotations

__all__ = [
    "FREE_SIGN_SETS",
    "FIXED_SIGN_SETS",
    "is_fixed_axis",
    "pca_frames",
    "pca_frames_from_components",
    "global_pca_frames",
    "shuffle_and_select_frames",
    "random_frames",
]

FREE_SIGN_SETS = ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0))
FIXED_SIGN_SETS = ((1.0, 1.0, 1.0), (-1.0, -1.0, 1.0))

_FIXED_AXIS_COLUMN_PERM = {1: (0, 2, 1), 2: (0, 1, 2)}
_SNAP_EPS = 1e-6


def is_fixed_axis(fixed_axis) -> bool:
    """Truthiness check of the reference (``fixed_axis=0`` -> free)."""
    return bool(fixed_axis)


def _s_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _s_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _s_where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _s_normalize(v):
    n = torch.sqrt(_s_dot(v, v))
    return tuple(x / n for x in v)


def _s_det_sym(xx, xy, xz, yy, yz, zz):
    return xx * (yy * zz - yz * yz) - xy * (xy * zz - yz * xz) + xz * (xy * yz - yy * xz)


def _eigh3x3_scalars(sxx, sxy, sxz, syy, syz, szz):
    """Closed-form symmetric eigh on 6 scalar entry tensors.

    Returns ``((lam_min, lam_mid, lam_max), V)`` with ``V[i][j]`` the i-th
    component of the j-th eigenvector (eigenvalues ascending).
    """
    scale = sxx.abs()
    for e in (sxy, sxz, syy, syz, szz):
        scale = torch.maximum(scale, e.abs())
    scale = scale.clamp(min=1e-30)
    bxx, bxy, bxz = sxx / scale, sxy / scale, sxz / scale
    byy, byz, bzz = syy / scale, syz / scale, szz / scale

    q = (bxx + byy + bzz) / 3.0
    cxx, cyy, czz = bxx - q, byy - q, bzz - q
    p2 = (cxx * cxx + cyy * cyy + czz * czz + 2.0 * (bxy * bxy + bxz * bxz + byz * byz)) / 6.0
    p = torch.sqrt(p2.clamp(min=0.0))
    safe_p = p.clamp(min=1e-30)
    detc = _s_det_sym(
        cxx / safe_p, bxy / safe_p, bxz / safe_p, cyy / safe_p, byz / safe_p, czz / safe_p
    )
    r = (detc / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min

    one = torch.ones_like(bxx)
    zero = torch.zeros_like(bxx)

    def eigvec_for(lmbda):
        r0 = (bxx - lmbda, bxy, bxz)
        r1 = (bxy, byy - lmbda, byz)
        r2 = (bxz, byz, bzz - lmbda)
        c01, c02, c12 = _s_cross(r0, r1), _s_cross(r0, r2), _s_cross(r1, r2)
        n01, n02, n12 = _s_dot(c01, c01), _s_dot(c02, c02), _s_dot(c12, c12)
        v = _s_where(n01 >= n02, c01, c02)
        nv = torch.maximum(n01, n02)
        v = _s_where(n12 > nv, c12, v)
        nv = torch.maximum(nv, n12)
        v = _s_where(nv > 1e-24, v, (one, zero, zero))
        return _s_normalize(v)

    v_min = eigvec_for(lam_min)
    v_max = eigvec_for(lam_max)
    v_mid = _s_cross(v_max, v_min)
    n_mid = torch.sqrt(_s_dot(v_mid, v_mid))
    alt = (-v_max[2], zero, v_max[0])
    alt = _s_where(torch.sqrt(_s_dot(alt, alt)) > 1e-12, alt, (zero, v_max[2], -v_max[1]))
    v_mid = _s_where(n_mid > 1e-12, v_mid, alt)
    v_mid = _s_normalize(v_mid)
    v_min = _s_normalize(_s_cross(v_mid, v_max))

    lam = (lam_min * scale, lam_mid * scale, lam_max * scale)
    cols = (v_min, v_mid, v_max)
    v = tuple(tuple(cols[j][i] for j in range(3)) for i in range(3))
    return lam, v


def _orient_positive(m):
    """Negate the whole matrix where ``det < 0``."""
    det = (
        m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
        - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
        + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0])
    )
    neg = det < 0
    return tuple(tuple(torch.where(neg, -m[i][j], m[i][j]) for j in range(3)) for i in range(3))


def _frames_from_cov_scalars(sxx, sxy, sxz, syy, syz, szz, fixed_axis, select_idx=None):
    """6 covariance entries -> ``[..., S, 3, 3]`` candidates (or the
    ``[..., F, 3, 3]`` picked by ``select_idx [..., F]``)."""
    _, v = _eigh3x3_scalars(sxx, sxy, sxz, syy, syz, szz)

    if is_fixed_axis(fixed_axis):
        axis = int(fixed_axis)
        vd = tuple(tuple(v[i][2 - j] for j in range(3)) for i in range(3))
        vd = _orient_positive(vd)
        # canonicalise the null-space column to +axis (SO(2) frames keep
        # the up-vector); flipping an in-plane column too keeps det = +1
        s = torch.sign(vd[axis][2])
        s = torch.where(s == 0, torch.ones_like(s), s)
        vd = tuple((vd[i][0] * s, vd[i][1], vd[i][2] * s) for i in range(3))
        perm = _FIXED_AXIS_COLUMN_PERM[axis]

        def snap(x):
            return torch.where(x.abs() < _SNAP_EPS, torch.zeros_like(x), x)

        frames = [
            tuple(tuple(snap(vd[i][perm[j]] * ss[perm[j]]) for j in range(3)) for i in range(3))
            for ss in FIXED_SIGN_SETS
        ]
    else:
        v = _orient_positive(v)
        frames = [
            tuple(tuple(v[i][j] * ss[j] for j in range(3)) for i in range(3))
            for ss in FREE_SIGN_SETS
        ]

    if select_idx is not None:
        picked = []
        for f in range(select_idx.shape[-1]):
            sel = select_idx[..., f]
            comp = [[frames[0][i][j] for j in range(3)] for i in range(3)]
            for s in range(1, len(frames)):
                hit = sel == s
                for i in range(3):
                    for j in range(3):
                        comp[i][j] = torch.where(hit, frames[s][i][j], comp[i][j])
            picked.append(comp)
        frames = picked

    return torch.stack(
        [torch.stack([torch.stack(list(row), -1) for row in f], -2) for f in frames], -3
    )


def pca_frames(
    positions: torch.Tensor,
    neigh_idx: torch.Tensor,
    neigh_mask: torch.Tensor,
    fixed_axis: Union[bool, int, None] = False,
    select_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-point PCA frames from a padded kNN neighborhood.

    Args:
      positions: ``[B, N, 3]``.
      neigh_idx / neigh_mask: ``[B, N, K]``; invalid neighbors are replaced
        by the center point (the reference's self-loop fill).
      fixed_axis: False -> 4 free frames; 1 or 2 -> 2 fixed-axis frames.
      select_idx: optional ``[B, N, F]`` candidate indices to keep.

    Returns:
      ``[B, N, S, 3, 3]`` (or ``[B, N, F, 3, 3]`` under ``select_idx``).
    """
    gathered = gather_rows(positions, neigh_idx)  # [B, N, K, 3]
    return pca_frames_from_components(
        positions, gathered.movedim(-1, 1), neigh_mask, fixed_axis, select_idx
    )


def pca_frames_from_components(
    positions: torch.Tensor,
    neigh_pos: torch.Tensor,
    neigh_mask: torch.Tensor,
    fixed_axis: Union[bool, int, None] = False,
    select_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`pca_frames` from component-major neighbor coordinates
    ``neigh_pos [B, 3, N, K]``."""
    if is_fixed_axis(fixed_axis) and int(fixed_axis) == 0:
        raise ValueError("fixed_axis=0 is unreachable in the reference; use False")
    comps = []
    for c in range(3):
        if is_fixed_axis(fixed_axis) and c == int(fixed_axis):
            comps.append(torch.zeros_like(neigh_mask, dtype=positions.dtype))
            continue
        comps.append(torch.where(neigh_mask, neigh_pos[:, c], positions[..., c : c + 1]))
    x, y, z = [p - p.mean(-1, keepdim=True) for p in comps]
    return _frames_from_cov_scalars(
        (x * x).sum(-1),
        (x * y).sum(-1),
        (x * z).sum(-1),
        (y * y).sum(-1),
        (y * z).sum(-1),
        (z * z).sum(-1),
        fixed_axis,
        select_idx=select_idx,
    )


def global_pca_frames(positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The 4 free PCA frames ``[B, 4, 3, 3]`` of each cloud's valid points
    (``positions [B, N, 3]``, ``mask [B, N]``), shared by all its points."""
    m = mask[..., None]
    count = mask.sum(-1, keepdim=True).clamp(min=1)[..., None].to(positions.dtype)
    mean = torch.where(m, positions, 0.0).sum(-2, keepdim=True) / count
    centered = torch.where(m, positions - mean, 0.0)
    cov = torch.einsum("bkd,bke->bde", centered, centered)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    return _frames_from_cov_scalars(cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1],
                                    cov[:, 1, 2], cov[:, 2, 2], False)


def shuffle_and_select_frames(
    frames: torch.Tensor,
    n_frames: int,
    generator: Optional[torch.Generator] = None,
    scores: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A uniformly random order of the S candidate frames ``[..., S, 3, 3]``
    per leading index, the first ``n_frames`` kept: ``[..., n_frames, 3, 3]``.
    The order is ``argsort`` of uniform ``scores [..., S]`` (injected, or
    drawn from ``generator``)."""
    s = frames.shape[-3]
    if n_frames > s:
        raise ValueError(f"n_frames={n_frames} exceeds the {s} candidate frames "
                         "(4 free / 2 fixed-axis PCA candidates)")
    if scores is None:
        scores = torch.rand(frames.shape[:-2], generator=generator, device=frames.device)
    perm = torch.argsort(scores, dim=-1, stable=True)[..., :n_frames]
    return torch.take_along_dim(frames, perm[..., None, None], dim=-3)


def random_frames(
    batch: int,
    n_points: int,
    n_frames: int,
    fixed_axis: Union[bool, int, None] = False,
    generator: Optional[torch.Generator] = None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Uniformly random frames ``[B, N, F, 3, 3]`` from ``B*N*F`` draws in
    the order ``(b, n, f)``: rotations uniform on SO(3) from normals
    ``[B*N*F, 4]``, or, with ``fixed_axis`` 1 or 2, rotations about that axis
    from uniforms ``[B*N*F]`` (``fixed_axis=0`` is free SO(3), the
    reference's truthiness quirk).  The draws are injected or come from
    ``generator``."""
    n = batch * n_points * n_frames
    if is_fixed_axis(fixed_axis):
        mats = planar_rotations(n, int(fixed_axis), generator, uniforms, device)
    else:
        mats = random_rotations(n, generator, normals, device)
    return mats.reshape(batch, n_points, n_frames, 3, 3)
