"""The animation workload on ``diffus_tpu_torch``: multi-pose sweep -> GIF
(the port of ``examples/sweep_animation.py``, same arguments, defaults and
output line).

Reproduces the reference's ``img/animation.gif`` loop
(``[DEPR] fix_propagation_full_transmission.ipynb`` cells 14-17: render
one frame per source depth with artifacts on) as a single batched sweep.
The artifacts' noise comes from a ``torch.Generator`` seeded 0 on the
device; frame ``p`` draws what the ``p``-th of the sweep's single-frame
renders would.

    python examples/torch/sweep_animation.py --out sweep.gif
    python examples/torch/sweep_animation.py --size 256 --poses 33 --rays 256 --samples 512 \\
        --pallas --interp trilinear_fused
    python examples/torch/sweep_animation.py --device cpu --size 48 --poses 6

Runs on ``--device`` (default ``cuda``; without a card it stops and says to
pass ``--device cpu``).  ``--pallas`` runs the echo scan through kernel K1,
``--interp trilinear`` (or ``trilinear_fused``) the sampler through K2.  The GIF is written
with matplotlib where it is installed, else with Pillow.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.impedance import default_table_points, tabular_impedance_volume
from diffus_tpu_torch.phantoms import t1_phantom_3d
from diffus_tpu_torch.render import render_sweep
from diffus_tpu_torch.types import RenderConfig

INTERPS = ["nearest", "trilinear", "trilinear_bf16", "trilinear_fused"]


def sweep_scene(size: int, poses: int, rays: int, device="cpu"):
    """``(impedance volume, (poses, 3) sources, (rays, 3) fan)``: the tissue
    table applied to the T1 phantom at ``size``^3, and the reference's sweep
    of the source depth over a window (cells 14-17)."""
    t1 = torch.from_numpy(t1_phantom_3d((size,) * 3)).to(device)
    tx, ty = default_table_points(device=device)
    z_vol = tabular_impedance_volume(t1, tx, ty)
    half = size / 2
    sources = np.stack([np.array([half + 20, d, half - 10], np.float32)
                        for d in np.linspace(2, 2 + poses - 1, poses)])
    directions = fan_directions_2d([0.0, 1.0], np.radians(45.0), rays, device=device)
    return z_vol, torch.from_numpy(sources).to(device), directions


def sweep_config(**fields) -> RenderConfig:
    """The sweep's render config: artifacts on; ``fields`` adds
    ``use_pallas`` and ``interp``."""
    return RenderConfig(attenuation_coeff=1e-4, artifacts=True, **fields)


def render(z_vol, sources, directions, samples: int, cfg: RenderConfig,
           seed: int = 0) -> torch.Tensor:
    """The sweep's ``(poses, rays, samples)`` frames, the artifacts' noise
    drawn from a generator seeded ``seed`` on the volume's device."""
    generator = torch.Generator(device=z_vol.device).manual_seed(seed)
    return render_sweep(z_vol, sources, directions, samples, cfg, generator)[3]


def write_gif(frames: torch.Tensor, out: str) -> None:
    """One GIF frame a pose, depth downwards, at 10 frames a second."""
    from diffus_tpu_torch.viz.images import save_frames_gif

    save_frames_gif([f.T for f in frames.cpu().numpy()], out, fps=10)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="sweep.gif")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--poses", type=int, default=33)
    ap.add_argument("--rays", type=int, default=128)
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--pallas", action="store_true",
                    help="run the echo scan through the CUDA kernel (K1)")
    ap.add_argument("--interp", default="nearest", choices=INTERPS,
                    help="sampler (trilinear, trilinear_fused: the CUDA kernel K2 on the card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu where there is no card)")
    args = ap.parse_args(argv)
    from diffus_tpu_torch.cli import _device

    device = _device(args)
    z_vol, sources, directions = sweep_scene(args.size, args.poses, args.rays, device)
    cfg = sweep_config(use_pallas=args.pallas, interp=args.interp)
    frames = render(z_vol, sources, directions, args.samples, cfg)
    write_gif(frames, args.out)
    print(f"wrote {args.out}: {args.poses} frames")


if __name__ == "__main__":
    main()
