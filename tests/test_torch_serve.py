"""The port's ``RendererService`` against ``diffus_tpu``'s ``render_sweep`` and
``RendererService``: scenes, crop, coalescing, the adaptive window and the
latency statistics, on the CPU."""

import inspect
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.render.renderer as jr
import diffus_tpu.serve as jserve
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.types import BeamGeometry as JGeometry
from diffus_tpu.types import RenderConfig as JConfig
from diffus_tpu_torch.kernels.trilinear_cuda import _check
from diffus_tpu_torch.serve import RendererService, _Pending
from diffus_tpu_torch.types import BeamGeometry, RenderConfig
from torch_parity import frame_rel_err, run_both, seeded

VOL = brain_phantom_3d((24, 24, 24))
GEO = BeamGeometry(n_rays=6, num_samples=20)
FIELDS = [{"attenuation_coeff": 1e-4},
          {"attenuation_coeff": 1e-4, "interp": "trilinear_fused", "use_pallas": True}]
SMALL = brain_phantom_3d((16, 16, 16))
SMALL_GEO = {"n_rays": 4, "num_samples": 8}
SRC = np.array([8.0, 1.0, 8.0], np.float32)
TIMEOUT = 60


def _sources(p, seed):
    return (np.array([12.0, 1.5, 12.0]) + seeded(seed).uniform(-2.5, 2.5, (p, 3))
            ).astype(np.float32)


def _pair(vol, geo=SMALL_GEO, fields=None, **kwargs):
    """The same service in both packages: (port on the CPU, JAX)."""
    fields = fields or {"attenuation_coeff": 1e-4}
    return (RendererService(vol, BeamGeometry(**geo), RenderConfig(**fields), device="cpu",
                            **kwargs),
            jserve.RendererService(vol, JGeometry(**geo), JConfig(**fields), **kwargs))


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "a request thread hung"


@pytest.mark.parametrize("fields", FIELDS, ids=["nearest", "trilinear_fused"])
def test_service_matches_render_sweep(fields):
    svc = RendererService(VOL, GEO, RenderConfig(**fields), batch_tiers=(4, 1), device="cpu")
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


@pytest.mark.parametrize("fields", FIELDS, ids=["nearest", "trilinear_fused"])
def test_service_matches_jax_service_per_scene(fields):
    """Both packages' services over the same volumes, config and tiers:
    per-scene routing, the inventory and the per-scene counters agree, and
    each scene's frames match at frame-max-relative 1e-4."""
    vol_b = VOL.copy()
    vol_b[10:14, 6:14, 8:16] = 7.8e6   # a structurally different case: a bone block
    ours, theirs = _pair(VOL, {"n_rays": 6, "num_samples": 20}, fields, batch_tiers=(1, 4))
    for svc in (ours, theirs):
        svc.add_scene("case_b", vol_b)
    for scene in ("default", "case_b"):
        for p in (1, 3):
            srcs = _sources(p, 40 + p)
            got = ours.render(srcs, scene=scene).numpy()
            want = np.asarray(theirs.render(srcs, scene=scene))
            assert frame_rel_err(got, want) < 1e-4, (scene, p)
    assert ours.scenes() == theirs.scenes() == {
        "default": {"shape": [24, 24, 24], "staged": "raw", "cropped": False},
        "case_b": {"shape": [24, 24, 24], "staged": "raw", "cropped": False}}
    st, jst = ours.snapshot_stats(), theirs.snapshot_stats()
    assert st["scenes"] == jst["scenes"] == {
        "default": {"requests": 2, "frames": 4, "recoveries": 0},
        "case_b": {"requests": 2, "frames": 4, "recoveries": 0}}
    src = _sources(1, 7)
    assert not np.allclose(ours.render(src).numpy(), ours.render(src, scene="case_b").numpy())
    with pytest.raises(KeyError, match="resident scenes"):
        ours.render(SRC, scene="missing")


def test_service_counts_requests_and_frames():
    svc = RendererService(VOL, GEO, RenderConfig(attenuation_coeff=1e-4, start=2),
                          batch_tiers=(1, 4), device="cpu")
    empty = svc.render(np.zeros((0, 3), np.float32))
    assert empty.shape == (0, 6, 18)
    assert svc.render([12.0, 1.5, 12.0]).shape == (1, 6, 18)
    for p in (1, 3, 9):
        svc.render(_sources(p, 10 + p))
    # 9 poses = tiers 4 + 4 + 1; 3 poses pad to 4
    stats = svc.snapshot_stats()
    assert {k: stats[k] for k in ("requests", "frames", "padded_frames", "batches",
                                  "recoveries")} == {"requests": 4, "frames": 14,
                                                     "padded_frames": 1, "batches": 6,
                                                     "recoveries": 0}
    assert stats["window_ms"] == 3.0
    assert stats["scenes"] == {"default": {"requests": 4, "frames": 14, "recoveries": 0}}
    # requests run one at a time are rendered alone: device tensors, 'dispatched'
    assert stats["latency_dispatched_ms"]["n"] == 4 and "latency_pulled_ms" not in stats


def test_service_update_volume():
    svc = RendererService(VOL, GEO, RenderConfig(attenuation_coeff=1e-4), batch_tiers=(1,),
                          device="cpu")
    src = _sources(1, 20)
    before = svc.render(src)
    new = VOL.copy()
    new[:, 8:10, :] = 7.8e6               # a bone slab across every ray
    svc.update_volume(new)
    after = svc.render(src)
    assert not torch.equal(before, after)
    want = RendererService(new, GEO, RenderConfig(attenuation_coeff=1e-4),
                           batch_tiers=(1,), device="cpu").render(src)
    torch.testing.assert_close(after, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        svc.update_volume(VOL[:20])
    with pytest.raises(ValueError, match="tier"):
        RendererService(VOL, GEO, batch_tiers=(), device="cpu")


def test_service_update_volume_reshape_and_recrop():
    """A new shape is refused without ``allow_reshape`` and re-staged with
    it; a cropped scene re-staged that way gets the crop of the NEW volume.
    Both packages end with the same staged shape and frames."""
    big = brain_phantom_3d((20, 20, 20))
    ours, theirs = _pair(SMALL, batch_tiers=(1,))
    with pytest.raises(ValueError, match="allow_reshape"):
        ours.update_volume(big)
    src = np.array([10.0, 1.0, 10.0], np.float32)
    for svc in (ours, theirs):
        svc.update_volume(big, allow_reshape=True)
    assert ours.volume.shape == (20, 20, 20)
    torch.testing.assert_close(ours.render(src), torch.from_numpy(np.array(theirs.render(src))),
                               rtol=1e-6, atol=1e-7)

    full = np.zeros((28, 28, 28), np.float32)
    full[4:20, 4:20, 4:20] = SMALL
    bigger = np.zeros((32, 32, 32), np.float32)
    bigger[2:26, 2:26, 2:26] = brain_phantom_3d((24, 24, 24))
    ours, theirs = _pair(full, batch_tiers=(1,), crop=True, crop_margin=0)
    crop0 = tuple(ours.volume.shape)
    assert crop0 == tuple(theirs.volume.shape) and crop0 < (28, 28, 28)
    for svc in (ours, theirs):
        svc.update_volume(bigger, allow_reshape=True)
    assert tuple(ours.volume.shape) == tuple(theirs.volume.shape) != crop0
    np.testing.assert_array_equal(ours._get_scene("default").offset.numpy(),
                                  np.asarray(theirs._get_scene("default").offset))
    src = np.array([14.0, 3.0, 14.0], np.float32)   # the NEW original frame
    torch.testing.assert_close(ours.render(src), torch.from_numpy(np.array(theirs.render(src))),
                               rtol=1e-6, atol=1e-7)


def test_service_crop_mode_transparent_to_clients():
    """``crop=True``: clients keep original coordinates.  The crop box, the
    offset and the frames match the JAX service, and the uncropped service,
    at ``tests/test_serve.py``'s tolerance; an original-shape update re-applies
    the same box."""
    vol = np.zeros((40, 44, 42), np.float32)
    vol[8:32, 6:38, 7:35] = (brain_phantom_3d((24, 32, 28)) / 1e6).astype(np.float32)
    geo = {"n_rays": 6, "num_samples": 14, "opening_angle": float(np.radians(30))}
    fields = {"attenuation_coeff": 1e-4, "interp": "trilinear"}
    ours, theirs = _pair(vol, geo, fields, batch_tiers=(2,), crop=True, crop_margin=4)
    full = RendererService(vol, BeamGeometry(**geo), RenderConfig(**fields), batch_tiers=(2,),
                           device="cpu")
    assert tuple(ours.volume.shape) == tuple(theirs.volume.shape) < tuple(full.volume.shape)
    sc = ours._get_scene("default")
    np.testing.assert_array_equal(sc.offset.numpy(),
                                  np.asarray(theirs._get_scene("default").offset))
    assert ours.scenes()["default"] == theirs.scenes()["default"]
    srcs = np.array([20.0, 9.0, 20.0], np.float32)[None] + seeded(3).uniform(
        -1, 1, (3, 3)).astype(np.float32)
    got = ours.render(srcs).numpy()
    np.testing.assert_allclose(got, np.asarray(theirs.render(srcs)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, full.render(srcs).numpy(), rtol=1e-5, atol=1e-7)
    for svc in (ours, theirs, full):
        svc.update_volume(vol * 1.1)
    got = ours.render(srcs[:1]).numpy()
    np.testing.assert_allclose(got, np.asarray(theirs.render(srcs[:1])), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, full.render(srcs[:1]).numpy(), rtol=1e-5, atol=1e-7)


def test_service_recover_pose_crop_coordinates():
    """A cropped scene's recovery takes and returns original coordinates."""
    from diffus_tpu_torch.train.pose_recovery import render_pose
    from diffus_tpu_torch.types import TransducerPose

    full = np.zeros((32, 32, 32), np.float32)
    full[6:30, 4:28, 6:30] = brain_phantom_3d((24, 24, 24))
    s = RendererService(full, BeamGeometry(n_rays=8, num_samples=16,
                                           opening_angle=float(np.radians(40))),
                        RenderConfig(attenuation_coeff=1e-4), batch_tiers=(1, 4),
                        crop=True, crop_margin=0, device="cpu")
    assert tuple(s.volume.shape) != (32, 32, 32)
    true = np.array([18.0, 5.5, 18.0], np.float32)
    offset = s._get_scene("default").offset
    target = render_pose(s.volume, TransducerPose.create(torch.from_numpy(true) - offset),
                         s._recovery_config().as_base())
    res = s.recover_pose(target, true + np.array([0.7, -0.4, 0.5], np.float32), count=2,
                         radius=0.8, rot_scale=0.0, phases=((0.0, 0.15, 0.0, 50),), seed=3)
    assert np.linalg.norm(np.array(res["position"]) - true) < 0.5
    assert s.snapshot_stats()["scenes"]["default"]["recoveries"] == 1


def test_service_remove_scene_and_its_stats():
    s = RendererService(SMALL, BeamGeometry(**SMALL_GEO), RenderConfig(attenuation_coeff=1e-4),
                        batch_tiers=(1,), device="cpu")
    s.add_scene("b", SMALL * 2.0)
    s.render(SRC, scene="b")
    assert s.snapshot_stats()["scenes"]["b"]["requests"] == 1
    s.remove_scene("b")
    assert set(s.scenes()) == {"default"} and "b" not in s.snapshot_stats()["scenes"]
    with pytest.raises(KeyError, match="resident scenes"):
        s.remove_scene("b")
    with pytest.raises(ValueError, match="cannot be removed"):
        s.remove_scene("default")
    s.add_scene("b", SMALL * 2.0)      # a namesake starts from zero
    assert s.snapshot_stats()["scenes"]["b"]["requests"] == 0
    # a request holding a removed scene's snapshot still renders
    req = _Pending(torch.from_numpy(SRC[None]), s._get_scene("b"))
    s.remove_scene("b")
    with s._lock:
        s._queue.append(req)
        s._dispatching = True
    s._drain()
    assert req.event.is_set() and req.error is None
    assert bool(torch.isfinite(req.result).all())


def test_service_coalescing_isolated_per_scene():
    """Interleaved queued requests of two scenes drain as one batch per scene
    (never one mixed batch), in order within each scene."""
    s = RendererService(SMALL, BeamGeometry(**SMALL_GEO), RenderConfig(attenuation_coeff=1e-4),
                        batch_tiers=(1, 4), device="cpu")
    s.add_scene("b", SMALL[::-1].copy())
    want = {"default": s.render(SRC)[0], "b": s.render(SRC, scene="b")[0]}
    base = s.snapshot_stats()["batches"]
    names = ("default", "b", "default", "b")
    reqs = [_Pending(torch.from_numpy(SRC[None] + 0.0), s._get_scene(n)) for n in names]
    with s._lock:
        s._queue.extend(reqs)
        s._dispatching = True
    s._drain()
    for r, name in zip(reqs, names):
        assert r.event.is_set() and r.error is None and r.pulled
        torch.testing.assert_close(r.result[0], want[name], rtol=1e-6, atol=1e-7)
    assert s.snapshot_stats()["batches"] == base + 2


def test_service_coalesces_concurrent_singletons():
    """8 concurrent 1-pose requests become fewer than 8 batches, and each
    frame equals the request rendered alone."""
    s = RendererService(SMALL, BeamGeometry(**SMALL_GEO), RenderConfig(attenuation_coeff=1e-4),
                        batch_tiers=(1, 8), device="cpu")
    srcs = SRC[None] + seeded(3).uniform(-2, 2, (8, 3)).astype(np.float32)
    alone = [s.render(x)[0] for x in srcs]
    base = s.snapshot_stats()["batches"]
    frames = s._frames

    def slow(volume, sources):
        time.sleep(0.2)                 # a wide window: stragglers enqueue behind it
        return frames(volume, sources)

    s._frames = slow
    barrier = threading.Barrier(8)
    results = [None] * 8

    def worker(i):
        barrier.wait(timeout=TIMEOUT)
        results[i] = s.render(srcs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    batches = s.snapshot_stats()["batches"] - base
    assert 1 <= batches < 8, f"8 concurrent requests took {batches} batches"
    for got, want in zip(results, alone):
        torch.testing.assert_close(got[0], want, rtol=1e-6, atol=1e-7)


def test_service_coalesced_error_reaches_every_waiter():
    s = RendererService(SMALL, BeamGeometry(**SMALL_GEO), RenderConfig(attenuation_coeff=1e-4),
                        batch_tiers=(1, 4), device="cpu")

    def broken(volume, sources):
        time.sleep(0.15)
        raise RuntimeError("device fell over")

    s._frames = broken
    barrier = threading.Barrier(4)
    outs = [None] * 4

    def worker(i):
        barrier.wait(timeout=TIMEOUT)
        try:
            s.render(SRC)
        except RuntimeError as e:
            outs[i] = str(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    assert outs == ["device fell over"] * 4
    assert not s._dispatching and not s._queue


def test_service_leader_abort_does_not_strand_queue():
    """A leader that unwinds outside a render (an interrupt in the window's
    sleep) fails its waiters and lets the next request lead."""
    s = RendererService(SMALL, BeamGeometry(**SMALL_GEO), RenderConfig(attenuation_coeff=1e-4),
                        batch_tiers=(1, 4), device="cpu")
    waiter = _Pending(torch.from_numpy(SRC[None]), s._get_scene("default"))
    drain = s._drain

    def exploding():
        s._queue.append(waiter)
        raise KeyboardInterrupt("simulated interrupt")

    s._drain = exploding
    with pytest.raises(KeyboardInterrupt):
        s.render(SRC)
    assert waiter.event.is_set() and "leader aborted" in str(waiter.error)
    s._drain = drain
    assert bool(torch.isfinite(s.render(SRC)).all())
    assert not s._dispatching and not s._queue


def _window_rounds(svc, pending, srcs):
    """Drive a service's adaptive window through fixed rounds; the
    ``window_ms`` after each.  ``pending(src, scene)`` makes a request."""
    seq = [svc.snapshot_stats()["window_ms"]]

    def drain(reqs):
        with svc._lock:
            svc._queue.extend(reqs)
            svc._dispatching = True
        svc._drain()
        assert all(r.event.is_set() and r.error is None for r in reqs)
        seq.append(svc.snapshot_stats()["window_ms"])

    a, b = svc._get_scene("default"), svc._get_scene("b")
    drain([pending(srcs[i], a) for i in range(3)])        # coalesced: grow
    for _ in range(4):                                     # lone: halve to the floor
        svc.render(srcs[0])
        seq.append(svc.snapshot_stats()["window_ms"])
    for _ in range(6):                                     # coalesced: up to the ceiling
        drain([pending(srcs[0], a), pending(srcs[1], a)])
    drain([pending(srcs[0], a), pending(srcs[0], b)])      # scene-constrained, then lone
    return seq


def test_service_adaptive_window_same_rounds_as_jax():
    kwargs = {"batch_tiers": (1, 4), "adaptive_window": True, "coalesce_window_s": 0.004,
              "window_bounds_s": (0.001, 0.008)}
    ours, theirs = _pair(SMALL, **kwargs)
    for svc in (ours, theirs):
        svc.add_scene("b", SMALL * 2.0)
    srcs = [np.array([[8.0, 1.0 + i, 8.0]], np.float32) for i in range(3)]
    seq = _window_rounds(ours, lambda x, sc: _Pending(torch.from_numpy(x), sc), srcs)
    jseq = _window_rounds(theirs, lambda x, sc: jserve._Pending(jnp.asarray(x), sc), srcs)
    assert seq == jseq
    assert seq[:6] == [4.0, 6.0, 3.0, 1.5, 1.0, 1.0] and seq[-2:] == [8.0, 4.0]
    with pytest.raises(ValueError, match="window_bounds"):
        RendererService(SMALL, BeamGeometry(**SMALL_GEO), adaptive_window=True,
                        window_bounds_s=(0.01, 0.001), device="cpu")


def test_service_latency_percentiles_match_jax_keys():
    """Requests rendered alone are 'dispatched'; waiters of a coalesced batch
    get host slices and are 'pulled', in both packages."""
    ours, theirs = _pair(SMALL, batch_tiers=(1, 4))
    stats, waited = [], []
    for svc in (ours, theirs):
        for i in range(3):
            svc.render(np.array([8.0, 1.0 + i, 8.0], np.float32))
        st = svc.snapshot_stats()
        assert st["latency_dispatched_ms"]["n"] == 3 and "latency_pulled_ms" not in st
        with svc._lock:
            svc._dispatching = True     # hold the queue: arrivals become waiters
        results = [None, None]

        def wait_on(i, svc=svc, results=results):
            results[i] = svc.render(np.array([[8.0, 2.0 + i, 8.0]], np.float32))

        threads = [threading.Thread(target=wait_on, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + TIMEOUT
        while len(svc._queue) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(svc._queue) == 2
        svc._drain()
        _join(threads)
        st = svc.snapshot_stats()
        assert st["latency_pulled_ms"]["n"] == 2
        assert st["latency_pulled_ms"]["p50_ms"] <= st["latency_pulled_ms"]["p95_ms"] \
            <= st["latency_pulled_ms"]["max_ms"]
        stats.append(st)
        waited.append(results)
    assert set(stats[0]) == set(stats[1])
    for kind in ("latency_pulled_ms", "latency_dispatched_ms"):
        assert set(stats[0][kind]) == set(stats[1][kind]) == {"n", "p50_ms", "p95_ms", "max_ms"}
    assert all(torch.is_tensor(r) and r.shape == (1, 4, 8) for r in waited[0])
    assert all(isinstance(r, np.ndarray) for r in waited[1])


def test_service_bf16_trilinear_fused_renders_plain_on_the_cpu():
    """``RenderConfig(dtype="bfloat16", interp="trilinear_fused")``: on the CPU
    the service samples the bf16 volume through ``march_trilinear``, the same
    values as the plain ``trilinear`` sampler on it; the card's kernel takes
    float32 only and raises ``TypeError`` for it, no quiet fallback
    (``tests/test_torch_cuda.py::test_service_bf16_trilinear_fused_raises``)."""
    fields = {"attenuation_coeff": 1e-4, "dtype": "bfloat16", "use_pallas": True}
    fused = RendererService(VOL, GEO, RenderConfig(interp="trilinear_fused", **fields),
                            device="cpu")
    plain = RendererService(VOL, GEO, RenderConfig(interp="trilinear", **fields), device="cpu")
    srcs = _sources(3, 50)
    got = fused.render(srcs)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, plain.render(srcs), rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32"):
        _check(torch.ones((4, 4, 4), dtype=torch.bfloat16))


def test_service_defaults_to_the_card():
    """No ``device`` means the card; where there is none the service raises
    instead of serving on the CPU."""
    assert inspect.signature(RendererService).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        svc = RendererService(VOL, GEO, RenderConfig(attenuation_coeff=1e-4), batch_tiers=(1,))
        assert svc.device.type == "cuda" and svc.volume.device.type == "cuda"
        assert svc.render(_sources(1, 30)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RendererService(VOL, GEO, RenderConfig(attenuation_coeff=1e-4))
