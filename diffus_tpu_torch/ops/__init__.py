"""Core differentiable ops: propagation scan, sampling, image formation."""

from diffus_tpu_torch.ops.propagation import (
    reflection_coeff,
    echo_amplitudes,
    echo_time_delays,
    depth_attenuation,
)
