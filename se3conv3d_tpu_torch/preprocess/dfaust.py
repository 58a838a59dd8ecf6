"""DFaust/AMASS offline preprocessing: posed SMPL meshes -> labelled clouds
(counterpart of ``se3conv3d_tpu/preprocess/dfaust.py``, a copy: it is numpy
only; the files it writes are those the port's ``data.DFaustDataset`` reads).

Counterpart of reference ``preprocess_data/preprocess_dfaust.py:25-214``:
sample ``n_points`` evenly from the posed body-mesh surface, carry the
SMPL linear-blend-skinning weights to each sample barycentrically, label
each point with its argmax joint (24 joints merged to 20 — hands into
forearms, feet into calves), add gaussian jitter, and save
``model_{i}_pc.pt`` / ``model_{i}_labels.pt`` pairs consumed by
``DFaustDataset``.

The SMPL forward pass needs the external ``smplx`` package and body-model
files; it is import-gated (``pose_smpl_body``).  Everything downstream of
the posed vertices is plain numpy and fully testable.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "sample_surface_even",
    "sample_labelled_cloud",
    "merge_joint_labels",
    "pose_smpl_body",
    "save_model_files",
]


def _triangle_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


def sample_surface_even(
    vertices: np.ndarray,
    faces: np.ndarray,
    count: int,
    rng: np.random.Generator,
    oversample: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Approximately even surface sampling.

    Area-weighted sampling of ``oversample * count`` candidates followed by
    radius rejection (the strategy behind trimesh's ``sample_surface_even``
    used by the reference, ``preprocess_dfaust.py:31-43``); short-falls are
    topped up with extra area-weighted draws, mirroring the reference's
    top-up branch.

    Returns:
      ``(face_idx [count], barycentric r [count, 2])`` in the reference's
      sqrt-parameterisation.
    """
    areas = _triangle_areas(vertices, faces)
    probs = areas / areas.sum()
    n_cand = count * oversample
    cand_faces = rng.choice(len(faces), size=n_cand, p=probs)
    r = rng.random((n_cand, 2))
    sqr = np.sqrt(r[:, 0:1])
    pts = (
        (1 - sqr) * vertices[faces[cand_faces, 0]]
        + sqr * (1 - r[:, 1:]) * vertices[faces[cand_faces, 1]]
        + sqr * r[:, 1:] * vertices[faces[cand_faces, 2]]
    )

    # Poisson-disk-style rejection on a hash grid.
    radius = np.sqrt(areas.sum() / (np.pi * count)) * 0.8
    cell = radius / np.sqrt(3.0)
    keys = np.floor((pts - pts.min(0)) / cell).astype(np.int64)
    occupied = {}
    keep = []
    for i in range(n_cand):
        k = tuple(keys[i])
        ok = True
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    j = occupied.get((k[0] + dx, k[1] + dy, k[2] + dz))
                    if j is not None and np.sum((pts[i] - pts[j]) ** 2) < radius**2:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            occupied[k] = i
            keep.append(i)
            if len(keep) == count:
                break
    keep = np.asarray(keep, np.int64)
    if len(keep) < count:
        extra = rng.choice(n_cand, size=count - len(keep))
        keep = np.concatenate([keep, extra])
    return cand_faces[keep], r[keep]


def merge_joint_labels(lbs_weights: np.ndarray) -> np.ndarray:
    """Argmax joint with the reference's 24 -> 20 merge
    (``preprocess_dfaust.py:92-99``): 22->20, 23->21 (hands), 10->7,
    11->8 (feet)."""
    joint = np.argmax(lbs_weights, axis=-1)
    joint = np.where(joint == 22, 20, joint)
    joint = np.where(joint == 23, 21, joint)
    joint = np.where(joint == 10, 7, joint)
    joint = np.where(joint == 11, 8, joint)
    return joint


def sample_labelled_cloud(
    vertices: np.ndarray,
    faces: np.ndarray,
    lbs_weights: np.ndarray,
    count: int = 15000,
    points_sigma: float = 1e-4,
    rng: Optional[np.random.Generator] = None,
):
    """Sample an evenly distributed labelled point cloud from a posed mesh.

    Reference ``get_pointcloud`` (``preprocess_dfaust.py:70-89``):
    barycentric interpolation of positions AND lbs weights at the same
    sample, merged argmax labels, gaussian jitter on positions only.

    Args:
      vertices: ``[V, 3]`` posed vertices; faces: ``[F, 3]``;
      lbs_weights: ``[V, J]`` skinning weights.
    Returns:
      ``(points [count, 3] float32, labels [count] int64)``.
    """
    rng = rng or np.random.default_rng(0)
    face_idx, r = sample_surface_even(vertices, faces, count, rng)
    sqr = np.sqrt(r[:, 0:1])
    w0, w1, w2 = (1 - sqr), sqr * (1 - r[:, 1:]), sqr * r[:, 1:]
    tri = faces[face_idx]
    pts = w0 * vertices[tri[:, 0]] + w1 * vertices[tri[:, 1]] + w2 * vertices[tri[:, 2]]
    lbs = (
        w0 * lbs_weights[tri[:, 0]]
        + w1 * lbs_weights[tri[:, 1]]
        + w2 * lbs_weights[tri[:, 2]]
    )
    labels = merge_joint_labels(lbs)
    pts = pts + points_sigma * rng.standard_normal(pts.shape)
    return pts.astype(np.float32), labels.astype(np.int64)


def pose_smpl_body(betas, global_orient, body_pose, model_folder: str,
                   gender: str = "neutral"):
    """Run the SMPL forward pass (requires the external ``smplx`` package
    and body-model files; reference ``preprocess_dfaust.py:102-126``)."""
    try:
        import smplx  # noqa: F401
        import torch
    except ImportError as e:  # pragma: no cover - external dependency
        raise ImportError(
            "pose_smpl_body requires the 'smplx' package and SMPL model "
            "files; install smplx and download the body models to use the "
            "offline DFaust preprocessing"
        ) from e
    model = smplx.create(model_folder, model_type="smpl", gender=gender)
    out = model(
        betas=torch.as_tensor(betas, dtype=torch.float32).reshape(1, -1)[:, :10],
        global_orient=torch.as_tensor(global_orient, dtype=torch.float32).reshape(1, 3),
        body_pose=torch.as_tensor(body_pose, dtype=torch.float32).reshape(1, -1),
        return_verts=True,
    )
    return (
        out.vertices.detach().numpy()[0],
        model.faces.astype(np.int64),
        model.lbs_weights.detach().numpy(),
    )


def save_model_files(out_dir: str, index: int, points: np.ndarray,
                     labels: np.ndarray):
    """Write the ``model_{i}_pc.pt`` / ``model_{i}_labels.pt`` pair the
    loaders consume (torch serialization, like the reference)."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    torch.save(torch.from_numpy(points), os.path.join(out_dir, f"model_{index}_pc.pt"))
    torch.save(
        torch.from_numpy(labels), os.path.join(out_dir, f"model_{index}_labels.pt")
    )
