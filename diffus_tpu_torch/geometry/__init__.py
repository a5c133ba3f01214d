from diffus_tpu_torch.geometry.fan import (
    fan_directions_2d,
    canonical_fan,
    pose_fan_directions,
    fan_angles,
)
