"""Image and GIF files of frames, with matplotlib where it is installed and
Pillow where it is not (the port's own; ``viz``'s other modules are copies
of ``diffus_tpu/viz``, which need matplotlib)."""

from __future__ import annotations

import numpy as np


def _gray8(img) -> np.ndarray:
    """``img`` scaled to its own min..max as 8-bit gray (``imshow``'s clim)."""
    img = np.asarray(img, np.float64)
    lo, hi = np.nanmin(img), np.nanmax(img)
    scaled = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    return np.round(np.nan_to_num(scaled) * 255.0).astype(np.uint8)


def save_frames_gif(frames, path: str, fps: int = 10) -> None:
    """An animated GIF of 2D frames, one GIF frame each: ``save_gif`` of
    ``render_video_frame`` where matplotlib is installed, else Pillow's
    gray frames, each scaled to its own min..max as ``render_video_frame``
    scales them."""
    try:
        import matplotlib
    except ImportError:
        from PIL import Image

        images = [Image.fromarray(_gray8(f)) for f in frames]
        # disposal 1 and no optimize: every frame is written whole, none merged
        images[0].save(path, save_all=True, append_images=images[1:], loop=0,
                       duration=round(1000 / fps), disposal=1, optimize=False)
        return
    from diffus_tpu_torch.viz.video import render_video_frame, save_gif

    matplotlib.use("Agg", force=False)
    save_gif(render_video_frame(frames), path, fps=fps)


def save_image(img, path: str) -> None:
    """A 2D array as a gray PNG scaled to its min..max: ``plt.imsave(...,
    cmap="gray")`` where matplotlib is installed, else Pillow's 8-bit image
    of the same scaling."""
    try:
        import matplotlib
    except ImportError:
        from PIL import Image

        Image.fromarray(_gray8(img)).save(path)
        return
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    plt.imsave(path, np.asarray(img), cmap="gray")
