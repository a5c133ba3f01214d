from diffus_tpu_torch.viz.plots import (
    plot_frame,
    sector_points,
    plot_sector,
    plot_sector_bmode,
    plot_histogram,
    plot_edge_lines,
    plot_cone_overlay,
    plot_median_line,
    plot_aligned_pair,
    plot_volume_3d,
    plot_voxels,
    plot_slice,
    plot_slices,
)
from diffus_tpu_torch.viz.isosurface import marching_tetrahedra, plot_volume_isosurface
from diffus_tpu_torch.viz.video import render_video, render_video_frame, save_gif
