"""Rotation helpers (counterpart of ``se3conv3d_tpu/core/rotation.py``).

Quaternions are ``(w, x, y, z)``; a frame matrix stores its axes as columns.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "quaternion_to_matrix",
    "random_quaternions",
    "random_rotations",
    "planar_rotations",
    "matrix_to_rotation_6d",
    "matrix_to_quaternion",
    "relative_rotations",
]


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions ``[..., 4]`` (w first) -> rotation matrices ``[..., 3, 3]``."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        -1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def random_quaternions(
    n: int,
    generator: Optional[torch.Generator] = None,
    normals: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """``n`` random unit quaternions with non-negative real part.

    ``normals`` ``[n, 4]`` injects the standard-normal draws directly.
    """
    o = normals if normals is not None else torch.randn(
        n, 4, generator=generator, device=device
    )
    s = o.pow(2).sum(1, keepdim=True).sqrt()
    return o / torch.where(o[:, :1] < 0, -s, s)


def random_rotations(
    n: int,
    generator: Optional[torch.Generator] = None,
    normals: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """``n`` uniformly distributed rotation matrices ``[n, 3, 3]``."""
    return quaternion_to_matrix(random_quaternions(n, generator, normals, device))


def planar_rotations(
    n: int,
    axis: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """``n`` random rotations ``[n, 3, 3]`` about coordinate ``axis`` (0, 1
    or 2), by angles ``u * 2 pi`` of uniforms ``u`` in ``[0, 1)``:
    counter-clockwise for column vectors, in the layout of the JAX
    package's ``planar_rotations``.  ``uniforms`` ``[n]`` injects the
    draws directly."""
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    u = uniforms if uniforms is not None else torch.rand(n, generator=generator, device=device)
    ang = u * (2.0 * math.pi)
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(ang), torch.ones_like(ang)
    rows = {
        0: (o, z, z, z, c, -s, z, s, c),
        1: (c, z, s, z, o, z, -s, z, c),
        2: (c, -s, z, s, c, z, z, z, o),
    }[axis]
    return torch.stack(rows, -1).reshape(-1, 3, 3)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """First two *rows* of the matrix flattened -> ``[..., 6]``."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` -> quaternions ``[..., 4]`` (w
    first): of the four candidates, the one built from the largest ``|q_i|``
    (``se3conv3d_tpu/core/rotation.py:matrix_to_quaternion``, reference
    ``pc/RotationFunctions.py:114-173``)."""
    batch = m.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.reshape(batch + (9,)).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], -1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], -2)
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, -1)
    return torch.take_along_dim(quat_candidates, best[..., None, None], -2).squeeze(-2)


def relative_rotations(frames_a: torch.Tensor, frames_b: torch.Tensor) -> torch.Tensor:
    """All pairwise relative rotations ``A_g^T B_f``: ``[..., G, F, 3, 3]``."""
    return torch.einsum("...gij,...fik->...gfjk", frames_a, frames_b)
