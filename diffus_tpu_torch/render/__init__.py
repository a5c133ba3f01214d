from diffus_tpu_torch.render.renderer import (
    render_frame,
    render_bmode,
    render_sweep,
    frame_time_delays,
    simulate_rays,
    trace_rays,
    mri_projection,
)
