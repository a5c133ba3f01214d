"""Sharding over a (pose, ray) device mesh (``diffus_tpu/parallel``): one
controller, blocks on the mesh's devices, whole results on its first."""

from diffus_tpu_torch.parallel.mesh import (
    make_mesh,
    default_mesh,
    pose_sharding,
    pose_ray_sharding,
    replicated,
)
from diffus_tpu_torch.parallel.shard import (
    replicate,
    sharded_render_sweep,
    sharded_sweep_frames,
    make_sharded_train_step,
    shard_batch,
    sharded_recover_pose_multistart,
)
from diffus_tpu_torch.parallel.tp import (
    tp_shard_params,
    tp_train_on_table,
)
