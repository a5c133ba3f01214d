from diffus_tpu_torch.utils.profiling import profile_trace, span
from diffus_tpu_torch.utils.debug import checked, assert_finite
