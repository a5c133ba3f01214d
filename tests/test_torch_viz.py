"""The port's ``viz`` copies against ``diffus_tpu.viz``: the same text, the
import lines mapped, and the same numbers from ``sector_points`` and
``marching_tetrahedra``; and the port's own ``viz.images``."""

from pathlib import Path

import numpy as np
import pytest

import diffus_tpu.viz as jviz
import diffus_tpu_torch.viz as tviz
from diffus_tpu.phantoms import brain_phantom_3d

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["__init__.py", "plots.py", "video.py", "isosurface.py"])
def test_viz_is_a_copy(name):
    original = (ROOT / "diffus_tpu" / "viz" / name).read_text()
    copy = (ROOT / "diffus_tpu_torch" / "viz" / name).read_text()
    assert copy == original.replace("diffus_tpu.", "diffus_tpu_torch.")
    assert "import jax" not in copy


def test_sector_points_match():
    rng = np.random.default_rng(0)
    frame = rng.uniform(0.0, 1.0, (16, 24))
    angles = np.linspace(-0.4, 0.4, 16)
    for args in ((frame, angles), (frame, angles, 0.5)):
        got, want = tviz.sector_points(*args), jviz.sector_points(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _sphere():
    g = np.arange(16) - 7.5
    return np.sqrt(sum(a ** 2 for a in np.meshgrid(g, g, g, indexing="ij")))


@pytest.mark.parametrize("field, level, step", [
    (_sphere(), 6.0, 1), (_sphere(), 6.0, 2), (brain_phantom_3d((16, 16, 16)), 1.55e6, 1),
], ids=["sphere", "sphere-step2", "phantom"])
def test_marching_tetrahedra_match(field, level, step):
    got = tviz.marching_tetrahedra(field, level=level, step=step)
    want = jviz.marching_tetrahedra(field, level=level, step=step)
    assert len(got[1]) > 0
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)


@pytest.mark.parametrize("matplotlib_installed", [True, False])
def test_images_write_png_and_gif_with_or_without_matplotlib(tmp_path, monkeypatch,
                                                            matplotlib_installed):
    """``viz.images`` (the port's own): a PNG of the array's shape and a GIF
    of one frame a frame, through matplotlib or, without it, Pillow, whose
    pixels are the array scaled to its min..max in 8-bit gray."""
    import sys

    from PIL import Image

    from diffus_tpu_torch.viz.images import save_frames_gif, save_image

    if not matplotlib_installed:
        monkeypatch.setitem(sys.modules, "matplotlib", None)   # its import raises
    img = np.linspace(-2.0, 6.0, 12 * 20).reshape(12, 20)
    save_image(img, str(tmp_path / "a.png"))
    png = Image.open(tmp_path / "a.png")
    assert png.size == (20, 12)
    if not matplotlib_installed:
        np.testing.assert_array_equal(np.asarray(png), np.round((img + 2.0) / 8.0 * 255.0))
    frames = [img * k for k in (1.0, -1.0, 0.5)]
    save_frames_gif(frames, str(tmp_path / "a.gif"), fps=10)
    assert Image.open(tmp_path / "a.gif").n_frames == 3
