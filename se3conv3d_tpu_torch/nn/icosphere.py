"""Icosphere kernel points for kernel-point convolutions (a copy of
``se3conv3d_tpu/nn/icosphere.py``: numpy only, kept here so the port
imports nothing of the JAX package).

Re-implements reference ``layers/IcoSpherePts.py:29-67`` without scipy:
unit icosahedron vertices, optional midpoint subdivision, and the same
fixed re-orientation quaternion (scipy xyzw ``[0.19322862, -0.68019314,
-0.19322862, 0.68019314]``, here w-first).
"""
from __future__ import annotations

import numpy as np

__all__ = ["icosphere_points"]

_REORIENT_QUAT_WFIRST = (0.68019314, 0.19322862, -0.68019314, -0.19322862)


def _quat_matrix(w, x, y, z):
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def icosphere_points(subdiv: int = 0) -> np.ndarray:
    """Vertices of a unit icosphere with ``subdiv`` midpoint subdivisions.

    Returns float64 ``[V, 3]`` (V = 12 for subdiv=0, 42 for subdiv=1, ...).
    """
    r = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1.0, r, 0.0], [1.0, r, 0.0], [-1.0, -r, 0.0], [1.0, -r, 0.0],
            [0.0, -1.0, r], [0.0, 1.0, r], [0.0, -1.0, -r], [0.0, 1.0, -r],
            [r, 0.0, -1.0], [r, 0.0, 1.0], [-r, 0.0, -1.0], [-r, 0.0, 1.0],
        ]
    )
    verts /= np.linalg.norm(verts[0])
    rot = _quat_matrix(*_REORIENT_QUAT_WFIRST)
    verts = list(verts @ rot.T)

    faces = [
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [5, 4, 9], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ]

    def midpoint(cache, i, j):
        key = (min(i, j), max(i, j))
        if key in cache:
            return cache[key]
        mid = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2.0
        verts.append(mid / np.linalg.norm(mid))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        cache = {}
        new_faces = []
        for a, b, c in faces:
            v1 = midpoint(cache, a, b)
            v2 = midpoint(cache, b, c)
            v3 = midpoint(cache, c, a)
            new_faces += [[a, v1, v3], [b, v2, v1], [c, v3, v2], [v1, v2, v3]]
        faces = new_faces

    return np.asarray(verts)
