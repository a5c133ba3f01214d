from diffus_tpu_torch.utils.profiling import stage_timer, profile_trace, block_and_time
from diffus_tpu_torch.utils.debug import checked, assert_finite
