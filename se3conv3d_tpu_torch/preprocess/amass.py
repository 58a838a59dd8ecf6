"""AMASS archive readers + the DFaust dataset regeneration loop (counterpart
of ``se3conv3d_tpu/preprocess/amass.py``, a copy: it is numpy only).

Counterpart of reference ``preprocess_data/preprocessing_dataset.py:11-106``
(``AMASSPreLoadDataset``) and the ``preload_data`` loop of
``preprocess_data/preprocess_dfaust.py:127-214``:

  * the *train* source is one joblib archive ``DFaust_67_train.pth.tar``
    holding a list of sequences, each a dict with ``fname``,
    ``markers [T, ...]``, ``poses [T, P]``, ``trans [T, 3]`` and
    ``betas [10]`` (repeated per frame on load);
  * the *test* source is a directory ``MPI_Limits/*.tar`` of
    webdataset-style tars whose members are ``<key>.input.pth`` torch
    payloads with the same fields per single frame.  Read here with plain
    ``tarfile`` + ``torch.load`` — no webdataset dependency.

Per-frame consumption (the reference's ``__getitem__`` +
``preload_data``): ``rotations`` reshaped ``[-1, 3]`` axis-angle,
``global_orient = pose[:3]``, ``body_pose = pose[3:66]`` padded with six
zeros (the two hand joints), ``betas[:10]``, translation zeroed before
posing.
"""
from __future__ import annotations

import glob
import io
import os
import tarfile
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

__all__ = [
    "AmassFrames",
    "load_amass_train",
    "load_amass_test",
    "iter_pose_params",
    "regenerate_dfaust",
]


@dataclass
class AmassFrames:
    """Flat per-frame AMASS data (sequences concatenated).

    ``fnames`` has ONE ENTRY PER FRAME (the owning sequence's name
    repeated), so index i across every field refers to the same frame.
    """

    markers: np.ndarray  # [N, ...] marker positions
    poses: np.ndarray  # [N, P] axis-angle body poses
    trans: np.ndarray  # [N, 3]
    betas: np.ndarray  # [N, 10+] body shapes (repeated per frame)
    fnames: List[str]  # [N] owning-sequence name per frame

    def __len__(self) -> int:
        return self.trans.shape[0]


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_amass_train(src_data_path: str,
                     archive: str = "DFaust_67_train.pth.tar") -> AmassFrames:
    """Load the joblib-pickled DFaust training archive.

    Reference ``preprocessing_dataset.py:43-67``: sequences concatenate
    along the frame axis; per-sequence ``betas`` repeat once per frame.
    """
    import joblib

    data = joblib.load(os.path.join(src_data_path, archive))
    markers, poses, trans, betas, fnames = [], [], [], [], []
    for seq in data:
        t = _to_numpy(seq["markers"]).shape[0]
        fnames.extend([seq["fname"]] * t)  # one entry per frame
        markers.append(_to_numpy(seq["markers"]))
        poses.append(_to_numpy(seq["poses"]))
        trans.append(_to_numpy(seq["trans"]))
        betas.append(np.repeat(_to_numpy(seq["betas"])[None, :], t, axis=0))
    return AmassFrames(
        markers=np.concatenate(markers),
        poses=np.concatenate(poses),
        trans=np.concatenate(trans),
        betas=np.concatenate(betas),
        fnames=fnames,
    )


def load_amass_test(src_data_path: str, subdir: str = "MPI_Limits") -> AmassFrames:
    """Load the MPI_Limits webdataset tars (one frame per sample).

    Reference ``preprocessing_dataset.py:69-89``; tars are read in
    name-sorted order, one ``<key>.input.pth`` torch payload per sample
    (``wds.WebDataset(...).decode().to_tuple("input.pth")`` semantics),
    stacked along a new frame axis.
    """
    import torch

    markers, poses, trans, betas, fnames = [], [], [], [], []
    tars = sorted(
        glob.glob(os.path.join(src_data_path, subdir, "*.tar")),
        key=lambda p: os.path.splitext(os.path.basename(p))[0],
    )
    if not tars:
        raise FileNotFoundError(
            f"no .tar archives under {os.path.join(src_data_path, subdir)}"
        )
    for tar_path in tars:
        with tarfile.open(tar_path) as tf:
            for member in tf:
                if not member.isfile() or not member.name.endswith("input.pth"):
                    continue
                payload = torch.load(
                    io.BytesIO(tf.extractfile(member).read()),
                    map_location="cpu", weights_only=False,
                )
                fnames.append(payload["fname"])
                markers.append(_to_numpy(payload["markers"]))
                poses.append(_to_numpy(payload["poses"]))
                trans.append(_to_numpy(payload["trans"]))
                betas.append(_to_numpy(payload["betas"]))
    return AmassFrames(
        markers=np.stack(markers),
        poses=np.stack(poses),
        trans=np.stack(trans),
        betas=np.stack(betas),
        fnames=fnames,
    )


def iter_pose_params(frames: AmassFrames) -> Iterator[dict]:
    """Per-frame SMPL posing parameters.

    The reference's ``__getitem__`` + ``SMPLX_layer`` unpacking
    (``preprocessing_dataset.py:96-106``, ``preprocess_dfaust.py:100-125``):
    axis-angle pose split into global orient (first joint) and 21 body
    joints padded with two zero hand joints; translation zeroed.
    """
    for i in range(len(frames)):
        pose = frames.poses[i].reshape(-1).astype(np.float32)
        body_pose = np.concatenate([pose[3:66], np.zeros(6, np.float32)])
        yield {
            "global_orient": pose[:3],
            "body_pose": body_pose,
            "betas": frames.betas[i].reshape(-1)[:10].astype(np.float32),
            "fname": frames.fnames[i],
        }


def regenerate_dfaust(
    frames: AmassFrames,
    out_dir: str,
    model_folder: Optional[str] = None,
    num_points: int = 15000,
    points_sigma: float = 0.001,
    pose_fn=None,
    seed: int = 0,
) -> int:
    """Archive -> ``model_{i}_pc.pt`` / ``model_{i}_labels.pt`` files.

    The reference's ``preload_data`` loop (``preprocess_dfaust.py:127-186``):
    pose each frame's SMPL body (zero translation), sample ``num_points``
    evenly from the surface with barycentric LBS labels, save per-index
    torch pairs consumed by ``DFaustDataset``.

    Args:
      pose_fn: ``(params dict) -> (vertices [V,3], faces [F,3],
        lbs_weights [V,J])`` — defaults to the smplx-gated
        :func:`~se3conv3d_tpu_torch.preprocess.dfaust.pose_smpl_body`; injectable
        so tests can run without SMPL model files.
    Returns:
      number of frames written.
    """
    from .dfaust import pose_smpl_body, sample_labelled_cloud, save_model_files

    if pose_fn is None:
        if model_folder is None:
            raise ValueError("model_folder is required without a custom pose_fn")

        def pose_fn(p):
            return pose_smpl_body(
                p["betas"], p["global_orient"], p["body_pose"], model_folder
            )

    rng = np.random.default_rng(seed)
    for idx, params in enumerate(iter_pose_params(frames)):
        vertices, faces, lbs = pose_fn(params)
        pts, labels = sample_labelled_cloud(
            vertices, faces, lbs, count=num_points,
            points_sigma=points_sigma, rng=rng,
        )
        save_model_files(out_dir, idx, pts, labels)
    return len(frames)
