"""Offline dataset preprocessing (counterpart of ``se3conv3d_tpu/preprocess``):
AMASS archive readers and the DFaust regeneration, host-side numpy."""
from .amass import (
    AmassFrames,
    iter_pose_params,
    load_amass_test,
    load_amass_train,
    regenerate_dfaust,
)
from .dfaust import (
    merge_joint_labels,
    pose_smpl_body,
    sample_labelled_cloud,
    sample_surface_even,
    save_model_files,
)
