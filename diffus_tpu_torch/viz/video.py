"""Animation helpers for multi-pose sweeps (``src/utils.py:55-116``)."""

from __future__ import annotations

import numpy as np


def render_video(triplet_list, xlim=(0, 1), ylim=(0, 1), cmap="viridis",
                 interval: int = 100):
    """Animate (x, y, intensity) scatter frames; returns a FuncAnimation
    (``src/utils.py:55-86``)."""
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig, ax = plt.subplots()
    x0, y0, i0 = (np.asarray(a) for a in triplet_list[0])
    sc = ax.scatter(x0, y0, c=i0, s=1, cmap=cmap, vmin=i0.min(), vmax=i0.max())
    ax.set_facecolor("black")
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_xticks([])
    ax.set_yticks([])
    title = ax.set_title("Frame 0")

    def animate(i):
        x, y, intensity = (np.asarray(a) for a in triplet_list[i])
        sc.set_offsets(np.column_stack((x.ravel(), y.ravel())))
        sc.set_array(intensity.ravel())
        sc.set_clim(vmin=intensity.min(), vmax=intensity.max())
        title.set_text(f"Frame {i}")
        return (sc,)

    plt.close(fig)
    return animation.FuncAnimation(
        fig, animate, frames=len(triplet_list), interval=interval, blit=False
    )


def render_video_frame(frames, cmap="gray", interval: int = 100):
    """Animate a list of 2D images (``src/utils.py:88-116``)."""
    import matplotlib.pyplot as plt
    from matplotlib import animation

    frames = [np.asarray(f) for f in frames]
    fig, ax = plt.subplots()
    im = ax.imshow(frames[0], cmap=cmap, vmin=frames[0].min(), vmax=frames[0].max())
    ax.set_xticks([])
    ax.set_yticks([])
    title = ax.set_title("Frame 0")

    def animate(i):
        im.set_array(frames[i])
        im.set_clim(vmin=frames[i].min(), vmax=frames[i].max())
        title.set_text(f"Frame {i}")
        return (im,)

    plt.close(fig)
    return animation.FuncAnimation(
        fig, animate, frames=len(frames), interval=interval, blit=False
    )


def save_gif(anim, path: str, fps: int = 10) -> None:
    """Write an animation to a GIF (the reference's ``animation.gif``
    artifact, ``[DEPR] fix_propagation_full_transmission.ipynb`` cell 17)."""
    anim.save(path, writer="pillow", fps=fps)
