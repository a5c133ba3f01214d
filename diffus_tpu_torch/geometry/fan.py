"""Fan-beam direction generation (``diffus_tpu/geometry/fan.py:19-84``).

The fan lives in the transducer's local frame and a differentiable pose
rotation places it, so 6-DoF pose gradients flow into the render.
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.types import BeamGeometry, TransducerPose, rotvec_to_matrix


def _angles(opening_angle: float, n_rays: int, device) -> torch.Tensor:
    return torch.linspace(-opening_angle / 2.0, opening_angle / 2.0, n_rays,
                          dtype=torch.float32, device=device)


def fan_directions_2d(
    direction_2d, opening_angle: float, n_rays: int, plane: str = "xy",
    device="cpu",
) -> torch.Tensor:
    """Fan of unit vectors around a 2D median direction, in a fixed plane
    (``fan.py:19-45``): ``cos(a) d + sin(a) [-d1, d0]`` over
    ``linspace(-half, half, n_rays)``, third component zero.

    Returns: ``(n_rays, 3)`` float32.
    """
    d = torch.as_tensor(direction_2d, dtype=torch.float32, device=device)[:2]
    d = d / torch.linalg.norm(d)
    ortho = torch.stack([-d[1], d[0]])
    angles = _angles(opening_angle, n_rays, device)
    v = torch.cos(angles)[:, None] * d[None, :] + torch.sin(angles)[:, None] * ortho[None, :]
    zeros = torch.zeros((n_rays, 1), dtype=v.dtype, device=device)
    if plane == "xy":
        return torch.cat([v, zeros], dim=1)
    if plane == "yz":
        return torch.cat([zeros, v], dim=1)
    if plane == "xz":
        return torch.cat([v[:, :1], zeros, v[:, 1:]], dim=1)
    raise ValueError(f"unknown plane {plane!r}")


def canonical_fan(opening_angle: float, n_rays: int, device="cpu") -> torch.Tensor:
    """Directions ``[sin a, cos a, 0]`` in the transducer frame; the median
    ray is local +y (``fan.py:48-58``)."""
    angles = _angles(opening_angle, n_rays, device)
    return torch.stack([torch.sin(angles), torch.cos(angles), torch.zeros_like(angles)],
                       dim=1)


def pose_fan_directions(pose: TransducerPose, geometry: BeamGeometry) -> torch.Tensor:
    """Rotate the canonical fan by the pose (``fan.py:61-77``).

    The ``(n_rays, 3) x (3, 3)`` product is a broadcast sum, not a matmul,
    so it is full f32 whatever the TF32 setting: TF32 would put ~1e-3
    relative noise on every ray direction, which stalls fine pose descents
    (the JAX package forces ``Precision.HIGHEST`` here for the same reason).
    """
    fan = canonical_fan(geometry.opening_angle, geometry.n_rays, pose.rotvec.device)
    rot = rotvec_to_matrix(pose.rotvec)
    return (fan[:, None, :] * rot[None, :, :]).sum(dim=-1)


def fan_angles(geometry: BeamGeometry, device="cpu") -> torch.Tensor:
    """Per-ray angles (radians) across the fan (``fan.py:80-84``)."""
    return _angles(geometry.opening_angle, geometry.n_rays, device)
