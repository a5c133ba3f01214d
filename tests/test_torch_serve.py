"""The port's ``RendererService`` against ``diffus_tpu``'s ``render_sweep``."""

import numpy as np
import pytest
import torch

import diffus_tpu.render.renderer as jr
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.types import RenderConfig as JConfig
from diffus_tpu_torch.serve import RendererService
from diffus_tpu_torch.types import BeamGeometry, RenderConfig
from torch_parity import frame_rel_err, run_both, seeded

VOL = brain_phantom_3d((24, 24, 24))
GEO = BeamGeometry(n_rays=6, num_samples=20)
FIELDS = [{"attenuation_coeff": 1e-4},
          {"attenuation_coeff": 1e-4, "interp": "trilinear_fused", "use_pallas": True}]


def _sources(p, seed):
    return (np.array([12.0, 1.5, 12.0]) + seeded(seed).uniform(-2.5, 2.5, (p, 3))
            ).astype(np.float32)


@pytest.mark.parametrize("fields", FIELDS, ids=["nearest", "trilinear_fused"])
def test_service_matches_render_sweep(fields):
    svc = RendererService(VOL, GEO, RenderConfig(**fields), batch_tiers=(4, 1))
    assert svc.batch_tiers == (1, 4)
    assert svc.warmup() >= 0.0
    dirs = svc.directions.numpy()
    for p in (1, 3, 9):
        srcs = _sources(p, p)
        got = svc.render(srcs)
        assert got.shape == (p, 6, 20)
        _, want = run_both(
            lambda v, s, d: jr.render_sweep(v, s, d, 20, JConfig(**fields))[3],
            lambda *a: None, VOL, srcs, dirs)
        assert frame_rel_err(got.numpy(), want) < 1e-4
        torch.testing.assert_close(
            got, torch.stack([svc.render(s)[0] for s in srcs]), rtol=1e-6, atol=1e-7)


def test_service_counts_requests_and_frames():
    svc = RendererService(VOL, GEO, RenderConfig(attenuation_coeff=1e-4, start=2),
                          batch_tiers=(1, 4))
    empty = svc.render(np.zeros((0, 3), np.float32))
    assert empty.shape == (0, 6, 18)
    assert svc.render([12.0, 1.5, 12.0]).shape == (1, 6, 18)
    for p in (1, 3, 9):
        svc.render(_sources(p, 10 + p))
    # 9 poses = tiers 4 + 4 + 1; 3 poses pad to 4
    assert svc.snapshot_stats() == {"requests": 4, "frames": 14, "padded_frames": 1,
                                    "batches": 6}


def test_service_update_volume():
    svc = RendererService(VOL, GEO, RenderConfig(attenuation_coeff=1e-4), batch_tiers=(1,))
    src = _sources(1, 20)
    before = svc.render(src)
    new = VOL.copy()
    new[:, 8:10, :] = 7.8e6               # a bone slab across every ray
    svc.update_volume(new)
    after = svc.render(src)
    assert not torch.equal(before, after)
    want = RendererService(new, GEO, RenderConfig(attenuation_coeff=1e-4),
                           batch_tiers=(1,)).render(src)
    torch.testing.assert_close(after, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        svc.update_volume(VOL[:20])
    with pytest.raises(ValueError, match="tier"):
        RendererService(VOL, GEO, batch_tiers=())
