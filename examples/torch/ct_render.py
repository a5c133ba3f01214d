"""Cross-modality rendering demos on ``diffus_tpu_torch``: CT lung,
transcranial US, heart MRI, generic MRI (the port of
``examples/ct_render.py``, same arguments, defaults and output line).

The reference demonstrates these on private data
(``[DEMO] CT Render Lung.ipynb``: 3 views at 60-100 samples x 200 rays
with artifacts; ``additional_data/{CT_scan, transcranial_US, heart_MRI}``
ship only READMEs).  This runner reproduces the workflows on synthetic
phantoms, or on real volumes via ``--volume``.

    python examples/torch/ct_render.py --modality ct --out ct.png
    python examples/torch/ct_render.py --modality transcranial --out tc.png
    python examples/torch/ct_render.py --view side --pallas --interp trilinear_fused
    python examples/torch/ct_render.py --device cpu --size 32 --out ct.png

Runs on ``--device`` (default ``cuda``; without a card it stops and says to
pass ``--device cpu``).  ``--pallas`` runs the echo scan through kernel K1,
``--interp trilinear`` (or ``trilinear_fused``) the sampler through K2.  The PNG is written
with matplotlib where it is installed, else with Pillow.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.impedance import (
    crude_ct_impedance,
    default_table_points,
    schneider_webb_impedance,
    tabular_impedance_volume,
)
from diffus_tpu_torch.phantoms import (
    ct_lung_phantom_3d,
    heart_phantom_3d,
    t1_phantom_3d,
    transcranial_phantom_3d,
)
from diffus_tpu_torch.render import render_frame
from diffus_tpu_torch.types import RenderConfig

MODALITIES = ["ct", "ct-crude", "transcranial", "mri", "heart"]
INTERPS = ["nearest", "trilinear", "trilinear_bf16", "trilinear_fused"]

# The CT lung calibration opening angle carried across the reference's CT
# notebooks (``[DEMO] CT Vivek data.ipynb`` cell 6).
CT_OPENING_ANGLE = 0.9157579425453843

# The three canonical stored views of ``[DEMO] CT Render Lung.ipynb``
# (cells 14-28), as configs the way ``CASE_PRESETS`` stores ReMIND poses.
# ``generate_cone_directions`` builds the fan in the (x, y) plane from the
# first two direction components (``src/cone.py:242-258``); the notebook
# then permutes columns (``directions[:, [2, 1, 0]]`` etc.) and flips
# signs — ``perm``/``flip`` record the COMPOSED column permutation and
# sign flips.  ``source`` is in the private ``ctLung.nii.gz`` volume's
# voxel coordinates (not shipped); rendering a phantom keeps the view's
# beam geometry and uses the standard phantom source instead.
CT_VIEW_PRESETS = {
    # cells 16-17: direction [-1, 0.4] (3rd comp unused by the reference
    # fan gen), 1.5x opening, 100 samples, start=10, no artifacts
    "front": dict(source=(490.0, 180.0, 120.0), direction=(-1.0, 0.4),
                  opening_scale=1.5, perm=(0, 1, 2), flip=(1, 1, 1),
                  n_rays=200, num_samples=100, start=10, artifacts=False),
    # cells 20-21: fan permuted [2, 1, 0] with the y column negated,
    # 80 samples, start=5, artifacts on
    "side": dict(source=(136.0, 8.0, 19.0), direction=(0.0, -1.0),
                 opening_scale=1.0, perm=(2, 1, 0), flip=(1, -1, 1),
                 n_rays=200, num_samples=80, start=5, artifacts=True),
    # cells 25-28: permutation chain [2,1,0] -> [1,2,0] -> [0,2,1]
    # composes to [1, 2, 0]; 1.2x opening, start=20, artifacts on
    "third": dict(source=(20.0, 160.0, 120.0), direction=(0.0, -1.0),
                  opening_scale=1.2, perm=(1, 2, 0), flip=(1, 1, 1),
                  n_rays=200, num_samples=100, start=20, artifacts=True),
}


def view_directions(view: str, n_rays: int | None = None, device="cpu") -> torch.Tensor:
    """Fan directions for a stored CT view (permutation + flips applied)."""
    p = CT_VIEW_PRESETS[view]
    fan = fan_directions_2d(p["direction"], p["opening_scale"] * CT_OPENING_ANGLE,
                            n_rays or p["n_rays"], device=device)
    return fan[:, list(p["perm"])] * torch.tensor(p["flip"], dtype=fan.dtype, device=device)


def load_raw(modality: str, size: int, volume: str | None = None) -> np.ndarray:
    """The modality's raw volume: ``volume``'s file, else its phantom at
    ``size``^3 (Hounsfield units for CT, impedance for the transcranial and
    heart phantoms, T1 intensity for MRI)."""
    if volume:
        from diffus_tpu_torch.cli import _load_volume

        return _load_volume(volume)
    shape = (size,) * 3
    if modality.startswith("ct"):
        return ct_lung_phantom_3d(shape)
    if modality == "transcranial":
        return transcranial_phantom_3d(shape)
    if modality == "heart":
        # EMIDEC-layout cardiac phantom (the reference's heart_MRI config
        # ships only the dataset README)
        return heart_phantom_3d(shape)
    return t1_phantom_3d(shape)


def impedance(modality: str, raw: torch.Tensor) -> torch.Tensor:
    """The modality's impedance volume of ``raw``."""
    if modality == "ct":
        return schneider_webb_impedance(raw)           # Schneider + Webb fit
    if modality == "ct-crude":
        return crude_ct_impedance(raw)                 # closed-form model
    if modality in ("transcranial", "heart"):
        return raw                                     # already impedance
    tx, ty = default_table_points(device=raw.device)
    return tabular_impedance_volume(raw, tx, ty)


def render(z_vol: torch.Tensor, view: str | None, rays: int, samples: int,
           from_file: bool = False, **fields) -> torch.Tensor:
    """The demo's frame of ``z_vol``: a stored CT ``view`` (its fan, samples,
    start and artifacts, the noise from a generator seeded 0 on the volume's
    device; its notebook source when the volume came from a file), else a
    50-degree fan of ``rays`` x ``samples``.  ``fields``: more
    :class:`RenderConfig` fields (``use_pallas``, ``interp``)."""
    device = z_vol.device
    half = z_vol.shape[0] / 2
    # start just inside the body: the crude CT model maps air (-1000 HU)
    # to exactly Z=0, and a ray born in a Z=0 region NaNs out (and is
    # zeroed, faithfully to the reference's nan_to_num semantics)
    src = torch.tensor([half, 0.2 * z_vol.shape[1], half], dtype=torch.float32, device=device)
    generator = None
    if view:
        p = CT_VIEW_PRESETS[view]
        dirs = view_directions(view, device=device)
        samples = p["num_samples"]
        cfg = RenderConfig(attenuation_coeff=1e-4, start=p["start"], artifacts=p["artifacts"],
                           **fields)
        if from_file:
            src = torch.tensor(p["source"], dtype=torch.float32, device=device)
        if p["artifacts"]:
            generator = torch.Generator(device=device).manual_seed(0)
    else:
        dirs = fan_directions_2d([0.0, 1.0], np.radians(50.0), rays, device=device)
        cfg = RenderConfig(attenuation_coeff=1e-4, **fields)
    return render_frame(z_vol, src, dirs, samples, cfg, generator=generator)[3]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modality", default="ct", choices=MODALITIES)
    ap.add_argument("--view", default=None, choices=sorted(CT_VIEW_PRESETS),
                    help="stored CT lung view preset (overrides rays/samples)")
    ap.add_argument("--volume", default=None, help="optional NIfTI/np volume")
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--rays", type=int, default=200)   # CT notebook config
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--pallas", action="store_true",
                    help="run the echo scan through the CUDA kernel (K1)")
    ap.add_argument("--interp", default="nearest", choices=INTERPS,
                    help="sampler (trilinear, trilinear_fused: the CUDA kernel K2 on the card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu where there is no card)")
    args = ap.parse_args(argv)
    from diffus_tpu_torch.cli import _device

    device = _device(args)
    raw = torch.from_numpy(load_raw(args.modality, args.size, args.volume)).to(device)
    z_vol = impedance(args.modality, raw)
    frame = render(z_vol, args.view, args.rays, args.samples, from_file=bool(args.volume),
                   use_pallas=args.pallas, interp=args.interp)

    from diffus_tpu_torch.viz.images import save_image

    save_image(frame.abs().cpu().numpy().T, args.out)
    print(f"{args.modality}: frame {tuple(frame.shape)}, "
          f"|echo| max {float(frame.abs().max()):.4f} -> {args.out}")


if __name__ == "__main__":
    main()
