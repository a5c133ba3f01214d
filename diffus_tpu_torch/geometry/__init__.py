from diffus_tpu_torch.geometry.affine import (
    voxel_to_world,
    world_to_voxel,
    transform_point,
    transform_direction,
    mri_to_us_point,
    us_to_mri_point,
    mri_to_us_slice,
    us_to_mri_slice,
)
from diffus_tpu_torch.geometry.fan import (
    fan_directions_2d,
    canonical_fan,
    pose_fan_directions,
    fan_angles,
)
from diffus_tpu_torch.geometry.calibration import (
    ConeCalibration,
    apex_and_direction_from_edges,
    cone_us_to_mri,
    cone_mask,
    cone_segment_mask,
)
