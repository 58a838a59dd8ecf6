"""ScanNet prediction output helpers (copied from
``se3conv3d_tpu/utils/scannet_io.py``, numpy only, without its
random-colour writer, which the port does not call).

Counterpart of reference ``tasks/SemSeg/scannet_io.py:3-43``: the official
20-class color palette, the benchmark class-id remap, and txt writers for
colored point clouds / per-point label files.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "SCANNET20_COLORS",
    "SCANNET_CLASS_IDS_20",
    "save_scannet20_scene_colors",
    "save_scannet20_scene_labels",
]

SCANNET20_COLORS = np.array(
    [
        [0, 0, 0],
        [174, 199, 232],  # wall
        [152, 223, 138],  # floor
        [31, 119, 180],  # cabinet
        [255, 187, 120],  # bed
        [188, 189, 34],  # chair
        [140, 86, 75],  # sofa
        [255, 152, 150],  # table
        [214, 39, 40],  # door
        [197, 176, 213],  # window
        [148, 103, 189],  # bookshelf
        [196, 156, 148],  # picture
        [23, 190, 207],  # counter
        [247, 182, 210],  # desk
        [219, 219, 141],  # curtain
        [255, 127, 14],  # refrigerator
        [158, 218, 229],  # shower curtain
        [44, 160, 44],  # toilet
        [112, 128, 144],  # sink
        [227, 119, 194],  # bathtub
        [82, 84, 163],  # otherfurniture
    ]
)

# nyu40 benchmark ids of the 20 evaluated classes (+0 = unannotated).
SCANNET_CLASS_IDS_20 = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
)


def save_scannet20_scene_colors(path, pts, labels):
    colors = SCANNET20_COLORS[labels] / 255.0
    np.savetxt(path, np.concatenate((pts, colors), -1))


def save_scannet20_scene_labels(path, labels):
    np.savetxt(
        path,
        SCANNET_CLASS_IDS_20[labels].reshape((-1,)),
        fmt="%i",
        delimiter="\t",
    )
