"""The chest-CT data-generation cell (``bmode.lung256``) on the CPU: the
reference's frozen pieces (``reference/bmode.py``) against the port's at
tiny sizes, the kind's draws under the seed, the three readers on traces
made by hand, and whole runs of a tiny copy of the cell, correct as the
program is and not correct with the control or a fault in its place."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.harness import bmode as H
from benchmark.harness import faults, main, manifest, traffic
from benchmark.harness.trace import TraceView
from benchmark.reference import bmode as B
from benchmark.tests.conftest import make_copy

SEED = 2**31 + 977
READERS = ("bmode.artifacts_us_per_frame", "bmode.artifacts_roofline", "bmode.idle_in_sweep")


def test_the_cell_loads_with_the_sources_shapes():
    cell = manifest.cell("bmode.lung256")
    cfg, mix = cell.config, cell.traffic
    assert cell.chips == 1 and mix["kind"] == "bmode"
    assert cfg["ct"]["shape"] == [512, 512, 512] and cfg["ct"]["count"] == 4
    assert cfg["volume"]["count"] == 0
    g, r = cfg["geometry"], cfg["render"]
    assert (g["n_rays"], g["num_samples"], g["direction_2d"]) == (200, 100, [0.0, -1.0])
    assert g["opening_angle"] == 1.2 * 0.9157579425453843
    assert r == {"attenuation_coeff": 1e-4, "start": 20, "interp": "nearest",
                 "reflection_mode": "parity", "use_pallas": True, "artifacts": True,
                 "std_radial": 0.01, "std_local": 0.15, "max_sigma": 4.0,
                 "sharpen_alpha": 5.0, "dtype": "float32"}
    assert (mix["poses"], mix["spacing"], mix["origin_jitter"], mix["plane"], mix["pool"]) == (
        256, 0.5, [64.0, 0.0, 32.0], [0, 2], 64)
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert cell.limits.keys() == {"frame_err"}


# the frozen pieces against the port's


def test_the_calibration_table_is_the_programs():
    from diffus_tpu_torch.impedance.ct import _ORDER, SCHNEIDER_HU, SCHNEIDER_RHO

    want = list(zip(SCHNEIDER_HU[_ORDER].tolist(), SCHNEIDER_RHO[_ORDER].tolist()))
    assert [hu for hu, _ in B.SCHNEIDER] == [hu for hu, _ in want]
    np.testing.assert_allclose([rho for _, rho in B.SCHNEIDER], [rho for _, rho in want],
                               rtol=1e-7)


@pytest.mark.parametrize("shape", [(24, 24, 24), (17, 30, 26)])
def test_ct_anatomy_is_the_phantoms(shape):
    from diffus_tpu_torch.phantoms import ct_lung_phantom_3d

    assert torch.equal(B.ct_hu(shape), torch.from_numpy(ct_lung_phantom_3d(shape)))


def test_the_map_is_the_programs():
    from diffus_tpu_torch.impedance import schneider_webb_impedance

    hu = torch.linspace(-1100.0, 2500.0, 36_001)
    np.testing.assert_allclose(schneider_webb_impedance(hu).double().numpy(),
                               B.schneider_webb(hu.double()).numpy(), rtol=2e-6)


def test_the_maps_step_is_where_the_programs_float32_sum_puts_it():
    """The calibration gives 1003 HU two densities (1000, then 1020 kg/m^3),
    so the map jumps at 3 HU.  A float32 CT value within 3e-5 below 3 HU
    sums with 1000 to 1003 exactly in float32: the program's map takes the
    upper density there, and so does the reference, which forms HU + 1000
    in the CT's dtype; formed in float64 the sum stays below the step."""
    from diffus_tpu_torch.impedance import schneider_webb_impedance

    hu = torch.tensor([2.9999771118164062, 2.99, 3.01], dtype=torch.float32)
    got = schneider_webb_impedance(hu).double()
    want = B.schneider_webb(hu, torch.float64)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    below = B.schneider_webb(hu.double())
    assert float(want[0] / below[0]) == pytest.approx(1.02, rel=1e-3)
    torch.testing.assert_close(below[1:], want[1:], rtol=1e-6, atol=0)


@pytest.mark.parametrize("direction,angle,rays", [((0.0, -1.0), 1.0989095310544612, 200),
                                                  ((0.3, 1.0), 0.7, 13)])
def test_the_fan_is_the_programs_bit_for_bit(direction, angle, rays):
    from diffus_tpu_torch.geometry import fan_directions_2d

    assert torch.equal(B.fan_toward(direction, angle, rays, "cpu"),
                       fan_directions_2d(direction, angle, rays))


def test_the_normals_are_the_programs_draws_in_order():
    from diffus_tpu_torch.ops.artifacts import draw_speckle_arcs

    image = torch.zeros((2, 3, 7, 11))
    radial, local = draw_speckle_arcs(image, torch.Generator().manual_seed(4))
    r, lo = B.draw_normals(torch.Generator().manual_seed(4), 6, 7, 11)
    assert torch.equal(radial.reshape(6, 11), r) and torch.equal(local.reshape(6, 7, 11), lo)


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("rays,samples,max_sigma", [(12, 17, 4.0), (40, 30, 4.0), (9, 5, 2.0)])
def test_the_stack_is_the_programs(rays, samples, max_sigma):
    """Speckle arcs, lateral blur and sharpen in float64, each held to the
    port's on the same image and normals.  The port's sharpen blurs with
    float32 taps (``ops/filters.py`` ``gaussian_kernel1d``): 1e-7 of a
    frame's scale, times the sharpen's 5."""
    from diffus_tpu_torch.ops import artifacts as A

    g = torch.Generator().manual_seed(rays)
    image = torch.randn((3, rays, samples), generator=g, dtype=torch.float64)
    radial = torch.randn((3, samples), generator=g, dtype=torch.float64)
    local = torch.randn((3, rays, samples), generator=g, dtype=torch.float64)
    speck = B.speckle_arcs(image, radial, local, 0.01, 0.15)
    assert _gap(speck, A.speckle_arcs(image, radial, local, 0.01, 0.15)) < 1e-14
    assert _gap(B.lateral_blur(speck, max_sigma),
                A.depth_dependent_lateral_blur(speck, max_sigma)) < 1e-14
    assert _gap(B.sharpen(speck, 5.0), A.sharpen(speck, 5.0)) < 2e-6
    render = {"std_radial": 0.01, "std_local": 0.15, "max_sigma": max_sigma,
              "sharpen_alpha": 5.0}
    want = A.sharpen(A.depth_dependent_lateral_blur(
        A.speckle_arcs(image, radial, local, 0.01, 0.15), max_sigma), 5.0)
    assert _gap(B.artifacts(image, radial, local, render), want) < 2e-6


# the kind's draws


def test_the_kinds_draws_follow_the_seed():
    ct = {"shape": [12, 16, 14], "count": 2, "texture_hu": 20.0, "texture_grid": 4}
    a, b, c = (list(H.ct_cases(ct, s, "cpu")) for s in (SEED, SEED, SEED + 1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    base = B.ct_hu(tuple(ct["shape"]))
    air = base == B.AIR_HU
    assert torch.equal(a[0][air], base[air]) and not torch.equal(a[0][~air], base[~air])
    mix = manifest.cell("bmode.lung256").traffic
    apex = manifest.cell("bmode.lung256").config["apex"]
    p, q = traffic.sweep(mix, apex, 4, SEED), traffic.sweep(mix, apex, 4, SEED)
    assert len(p) == 64 and all(s == t and torch.equal(x, y) for (s, x), (t, y) in zip(p, q))
    mids = torch.stack([x.double().mean(0) for _, x in p])
    assert ((mids - torch.tensor(apex, dtype=torch.float64)).abs()
            <= torch.tensor([64.0, 0.0, 32.0], dtype=torch.float64) + 1e-3).all()


# the readers on traces made by hand


def _ev(name, ts, dur, cat):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def _trace(k1=True, counter=True, spans=True):
    """Two calls: the sources' copy in, the graph (gather, K1, the stack's
    kernels), the output copy.  Graph of call 1 over [10, 60] µs: K1 [20,
    25], the stack [26, 40] and [45, 60]; call 2 over [110, 150]: K1 [115,
    120], the stack [120, 150].  ``render.sweep`` spans [0, 70] and [100,
    160]."""
    calls = ((0, 70, [(2, 2, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
                      (10, 8, "void gather_kernel<float>(float*)", "kernel"),
                      (20, 5, "K1", "kernel"),
                      (26, 14, "void at::native::distribution_kernel(float*)", "kernel"),
                      (45, 15, "void at::native::reduce_kernel(float*)", "kernel"),
                      (62, 3, "Memcpy DtoD (Device -> Device)", "gpu_memcpy")]),
             (100, 60, [(102, 2, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
                        (110, 8, "void gather_kernel<float>(float*)", "kernel"),
                        (115, 5, "K1", "kernel"),
                        (120, 30, "void at::native::distribution_kernel(float*)", "kernel"),
                        (152, 3, "Memcpy DtoD (Device -> Device)", "gpu_memcpy")]))
    ev = []
    for start, length, ops in calls:
        for ts, dur, name, cat in ops:
            if name == "K1":
                if not k1:
                    continue
                name = "void echo_scan_kernel<8>(float const*, float*)"
            ev.append(_ev(name, ts, dur, cat))
        if spans:
            ev.append(_ev("render.sweep", start, length, "user_annotation"))
    work = {"graph_spans_us": [[10.0, 60.0], [110.0, 150.0]],
            "stack_bytes_per_frame": H.stack_bytes(200, 80)}
    if counter:
        work["artifact_frames"] = 512
    return TraceView(ev, 200e-6, units=2, work=work)


def test_the_readers_by_hand():
    t = _trace()
    stack = (14 + 15 + 30) * 1e-6
    assert manifest.reader("bmode.artifacts_us_per_frame")(t) == pytest.approx(1e6 * stack / 512)
    assert manifest.reader("bmode.artifacts_roofline")(t) == pytest.approx(
        100.0 * 512 * H.stack_bytes(200, 80) / 3.35e12 / stack)
    # device busy under the spans: [2, 4], [10, 18], [20, 25], [26, 40], [45, 60],
    # [62, 65]; [102, 104], [110, 150] (three kernels, two overlapping), [152, 155]
    busy = (2 + 8 + 5 + 14 + 15 + 3) + (2 + 40 + 3)
    assert manifest.reader("bmode.idle_in_sweep")(t) == pytest.approx(
        100.0 * (130 - busy) * 1e-6 / 200e-6)


@pytest.mark.parametrize("missing", ["k1", "counter", "spans", "graphs"])
def test_a_reader_reads_none_where_its_input_is_missing(missing):
    t = _trace(k1=missing != "k1", counter=missing != "counter", spans=missing != "spans")
    if missing == "graphs":
        t.work.pop("graph_spans_us")
    values = {name: manifest.reader(name)(t) for name in READERS}
    if missing == "spans":
        assert values["bmode.idle_in_sweep"] is None
        assert values["bmode.artifacts_us_per_frame"] is not None
    else:
        assert values["bmode.artifacts_us_per_frame"] is None
        assert values["bmode.artifacts_roofline"] is None
        assert values["bmode.idle_in_sweep"] is not None


# whole runs of a tiny copy of the cell


TINY_CT = {"shape": [24, 24, 24], "count": 2, "texture_grid": 8}
TINY_GEOMETRY = {"n_rays": 12, "num_samples": 20}
TINY_MIX = {"poses": 3, "pool": 4, "warm_s": 0.0, "check_pool": 3, "check_requests": 2,
            "origin_jitter": [1.0, 0.0, 1.0], "trace_requests": 2}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with ``tiny.bmode``: the cell at 24^3, 12 rays
    x 20 samples, start 3, its apexes in the air over the right lung (so
    the frames hold the skin and the pleural line), added as new files."""
    root = make_copy(tmp_path_factory.mktemp("bmode"))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "ctlung512-bmode.json").read_text())
    cfg["ct"].update(TINY_CT)
    cfg["geometry"].update(TINY_GEOMETRY)
    cfg["render"]["start"] = 3
    cfg["apex"] = [12.0, 22.6, 16.0]
    (b / "configs" / "tiny-ct.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "lung256.json").read_text())
    (b / "traffic" / "tiny-lung.json").write_text(json.dumps(dict(mix, **TINY_MIX)))
    # float32 frames sit ~1e-6 from the reference here; the control ~7e-3
    (b / "limits" / "tiny.bmode.json").write_text(json.dumps({"frame_err": 1e-4}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tiny.bmode", "config": "tiny-ct", "traffic": "tiny-lung",
                           "chips": 1, "why": "a tiny cell of the tests"})
    next(x for x in m["end_to_end"] if x["name"] == "frames_per_s")["workloads"].append(
        "tiny.bmode")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return manifest.cell("tiny.bmode", root)


def _run(cell, control=False, fault=None):
    with faults.planted(fault):
        line = main.run(cell, SEED, 0.5, False, "cpu", control=control)
    return line


def test_tiny_cell_is_correct(tiny):
    line = _run(tiny)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert line["metrics"]["frames_per_s"]["value"] > 0
    per_call = line["_notes"]["check_details"]["frame_err_per_call"]
    assert len(per_call) == 2 and all(e < 1e-5 for _, e in per_call)


@pytest.mark.parametrize("control,fault", [(True, None), (False, "half_batch"),
                                           (False, "altered")], ids=["control", "half_batch",
                                                                     "altered"])
def test_control_and_faults_are_not_correct(tiny, control, fault):
    line = _run(tiny, control, fault)
    assert not line["correct"]
    assert line["checks"]["frame_err"]["value"] > 10 * line["checks"]["frame_err"]["limit"]


def test_graph_spans_by_correlation_and_the_view_after():
    """A graph's device work is found by its correlation with its
    ``cudaGraphLaunch``; the tracer's view reads the trace exported once."""
    from benchmark.harness.trace import Tracer

    def ev(name, cat, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    trace = {"traceEvents": [
        ev("cudaGraphLaunch", "cuda_runtime", 5, 3, 7), ev("gather", "kernel", 10, 5, 7),
        ev("void echo_scan_kernel<8>(float*)", "kernel", 16, 2, 7),
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 20, 5, 7),
        ev("cudaLaunchKernel", "cuda_runtime", 6, 1, 8), ev("copy", "kernel", 26, 2, 8),
        ev("cudaGraphLaunch", "cuda_runtime", 40, 3, 9), ev("gather", "kernel", 44, 6, 9)]}
    tracer = Tracer(False, "cpu")
    tracer.prof, tracer.done, tracer.t = H._Exported(trace), True, [0.0, 1e-4]
    assert H.graph_spans(tracer) == [[10.0, 25.0], [44.0, 50.0]]
    view = tracer.view(units=2)
    assert view.kernels("echo_scan_kernel") == (1, pytest.approx(2e-6))
