"""The ported examples (``examples/torch/*.py``) against the JAX scripts
(``examples/*.py``), stage by stage, on the CPU at the JAX tests' small
sizes.

Each script is loaded from its file, as ``tests/test_examples.py`` loads
``examples/ct_render.py``.  The same numpy inputs go through both packages;
frames are compared frame-max-relative (``torch_parity.frame_rel_err``):
below 1e-5 for nearest and 1e-4 for the trilinear samplers, the tolerances
of ``tests/test_torch_render.py``.  Every group runs the fused path
(``--pallas --interp trilinear_fused``: the kernels' plain versions here,
against JAX's Pallas kernels in interpret mode).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import frame_rel_err

ROOT = Path(__file__).resolve().parent.parent
FUSED = {"use_pallas": True, "interp": "trilinear_fused"}
# (RenderConfig fields, frame tolerance)
PATHS = [pytest.param(({}, 1e-5), id="nearest"),
         pytest.param((FUSED, 1e-4), id="trilinear_fused+pallas")]
SCRIPTS = ["ct_render", "sweep_animation", "full_pipeline", "serve_client"]


def _load(name: str, jax_script: bool = False):
    path = ROOT / "examples" / ("" if jax_script else "torch") / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{name}_{'jax' if jax_script else 'torch'}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(mod, argv, monkeypatch, capsys) -> list:
    """The JAX script's ``main()`` run with ``argv``: its printed lines."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()
    return capsys.readouterr().out.splitlines()


# -- every script ------------------------------------------------------------


@pytest.mark.parametrize("name", SCRIPTS)
def test_sources_import_only_the_port(name):
    text = (ROOT / "examples" / "torch" / f"{name}.py").read_text()
    assert "diffus_tpu_torch" in text
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "flax", "diffus_tpu"), line


@pytest.mark.skipif(torch.cuda.is_available(), reason="the message is for a machine without CUDA")
@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_default_to_the_card_and_stop_without_one(name):
    with pytest.raises(SystemExit, match="pass --device cpu"):
        _load(name).main([])


# -- ct_render ------------------------------------------------------------------


def test_ct_view_presets_equal_the_jax_scripts():
    port, ref = _load("ct_render"), _load("ct_render", jax_script=True)
    assert port.CT_OPENING_ANGLE == ref.CT_OPENING_ANGLE
    assert port.CT_VIEW_PRESETS == ref.CT_VIEW_PRESETS


@pytest.mark.parametrize("view", ["front", "side", "third"])
@pytest.mark.parametrize("n_rays", [16, None])
def test_view_directions_equal_jax(view, n_rays):
    port, ref = _load("ct_render"), _load("ct_render", jax_script=True)
    want = np.asarray(ref.view_directions(view, n_rays))
    got = port.view_directions(view, n_rays).numpy()
    assert got.shape == want.shape == (n_rays or 200, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _jax_modality_frame(modality, size, rays, samples, view=None, **fields):
    """JAX's ``examples/ct_render.py`` ``main()``, up to its frame."""
    import diffus_tpu.impedance as jimp
    import diffus_tpu.phantoms as jph
    from diffus_tpu.geometry import fan_directions_2d
    from diffus_tpu.render import render_frame
    from diffus_tpu.types import RenderConfig

    ref = _load("ct_render", jax_script=True)
    shape = (size,) * 3
    raw = jnp.asarray({"ct": jph.ct_lung_phantom_3d, "ct-crude": jph.ct_lung_phantom_3d,
                       "transcranial": jph.transcranial_phantom_3d,
                       "heart": jph.heart_phantom_3d, "mri": jph.t1_phantom_3d}[modality](shape))
    if modality == "ct":
        z_vol = jimp.schneider_webb_impedance(raw)
    elif modality == "ct-crude":
        z_vol = jimp.crude_ct_impedance(raw)
    elif modality in ("transcranial", "heart"):
        z_vol = raw
    else:
        z_vol = jimp.tabular_impedance_volume(raw, *jimp.default_table_points())
    half = size / 2
    src = jnp.array([half, 0.2 * size, half])
    if view:
        p = ref.CT_VIEW_PRESETS[view]
        dirs, samples = ref.view_directions(view), p["num_samples"]
        cfg = RenderConfig(attenuation_coeff=1e-4, start=p["start"], artifacts=p["artifacts"],
                           **fields)
    else:
        dirs = fan_directions_2d([0.0, 1.0], np.radians(50.0), rays)
        cfg = RenderConfig(attenuation_coeff=1e-4, **fields)
    return np.asarray(render_frame(z_vol, src, dirs, samples, cfg)[3])


def _port_modality_frame(modality, size, rays, samples, view=None, **fields):
    port = _load("ct_render")
    raw = torch.from_numpy(port.load_raw(modality, size))
    return port.render(port.impedance(modality, raw), view, rays, samples, **fields).numpy()


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("modality", ["ct", "ct-crude", "transcranial", "mri", "heart"])
def test_modality_frames_match_jax(modality, path):
    fields, tol = path
    want = _jax_modality_frame(modality, 32, 16, 32, **fields)
    got = _port_modality_frame(modality, 32, 16, 32, **fields)
    assert got.shape == want.shape == (16, 32)
    assert np.all(np.isfinite(got)) and float(np.abs(got).max()) > 0
    assert frame_rel_err(got, want) < tol


@pytest.mark.parametrize("path", PATHS)
def test_artifact_free_view_matches_jax(path):
    fields, tol = path
    want = _jax_modality_frame("ct", 32, 0, 0, view="front", **fields)
    got = _port_modality_frame("ct", 32, 0, 0, view="front", **fields)
    assert got.shape == want.shape == (200, 90)
    assert frame_rel_err(got, want) < tol


@pytest.mark.parametrize("view", ["side", "third"])
def test_artifact_views_render_and_repeat(view):
    """The views with artifacts: their shape (start skipped), finite, the
    same from the seed, and the fused path's frame the plain trilinear
    path's on the same noise."""
    p = _load("ct_render").CT_VIEW_PRESETS[view]
    plain = _port_modality_frame("ct", 32, 0, 0, view=view)
    again = _port_modality_frame("ct", 32, 0, 0, view=view)
    assert plain.shape == (200, p["num_samples"] - p["start"])
    assert np.all(np.isfinite(plain))
    np.testing.assert_array_equal(plain, again)
    tri = _port_modality_frame("ct", 32, 0, 0, view=view, interp="trilinear")
    fused = _port_modality_frame("ct", 32, 0, 0, view=view, **FUSED)
    assert frame_rel_err(fused, tri) < 1e-4


def test_ct_render_main_prints_the_jax_line_and_writes_a_png(tmp_path, monkeypatch, capsys):
    """On the JAX script's defaults (nearest) the printed line is JAX's, to
    the character; through the fused path the printed |echo| max is JAX's
    fused frame's, within one unit of its last printed digit."""
    from PIL import Image

    out = str(tmp_path / "ct.png")
    args = ["--size", "32", "--rays", "16", "--samples", "32", "--out", out]
    want = _jax_main(_load("ct_render", jax_script=True), args, monkeypatch, capsys)
    (tmp_path / "ct.png").unlink()
    _load("ct_render").main(args + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want
    assert Image.open(out).size == (16, 32)
    _load("ct_render").main(args + ["--device", "cpu"] + ["--pallas", "--interp",
                                                          "trilinear_fused"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == 1 and got[0].startswith("ct: frame (16, 32), |echo| max ")
    assert got[0].endswith(f" -> {out}")
    fused_max = float(np.abs(_jax_modality_frame("ct", 32, 16, 32, **FUSED)).max())
    assert abs(float(got[0].split("max ")[1].split()[0]) - fused_max) <= 1e-4


# -- sweep_animation -------------------------------------------------------------

SWEEP = dict(size=48, poses=4, rays=16, samples=32)


def _jax_sweep(artifacts: bool, **fields):
    """JAX's ``examples/sweep_animation.py`` ``main()``, up to its frames."""
    from diffus_tpu.geometry import fan_directions_2d
    from diffus_tpu.impedance import default_table_points, tabular_impedance_volume
    from diffus_tpu.phantoms import t1_phantom_3d
    from diffus_tpu.render import render_sweep
    from diffus_tpu.types import RenderConfig

    s = SWEEP
    z_vol = tabular_impedance_volume(jnp.asarray(t1_phantom_3d((s["size"],) * 3)),
                                     *default_table_points())
    half = s["size"] / 2
    sources = jnp.asarray(np.stack([np.array([half + 20, d, half - 10], np.float32)
                                    for d in np.linspace(2, 2 + s["poses"] - 1, s["poses"])]))
    directions = fan_directions_2d([0.0, 1.0], np.radians(45.0), s["rays"])
    cfg = RenderConfig(attenuation_coeff=1e-4, artifacts=artifacts, **fields)
    keys = jax.random.split(jax.random.PRNGKey(0), s["poses"])
    frames = render_sweep(z_vol, sources, directions, s["samples"], cfg,
                          keys if artifacts else None)[3]
    return np.asarray(frames), keys, cfg


@pytest.mark.parametrize("path", PATHS)
def test_sweep_scene_and_clean_frames_match_jax(path):
    fields, tol = path
    port = _load("sweep_animation")
    z_vol, sources, directions = port.sweep_scene(SWEEP["size"], SWEEP["poses"], SWEEP["rays"])
    assert sources.shape == (SWEEP["poses"], 3)
    cfg = port.sweep_config(**fields)
    assert cfg.artifacts
    import dataclasses

    clean = port.render(z_vol, sources, directions, SWEEP["samples"],
                        dataclasses.replace(cfg, artifacts=False)).numpy()
    want = _jax_sweep(False, **fields)[0]
    assert clean.shape == want.shape == (SWEEP["poses"], SWEEP["rays"], SWEEP["samples"])
    assert frame_rel_err(clean, want) < tol


@pytest.mark.parametrize("path", PATHS)
def test_sweep_with_artifacts_fed_jax_noise_matches_jax(path):
    """JAX's frames with its keys' noise against the port's artifact stack on
    the port's clean frames fed the same normals (each frame's key split in
    two: the radial and the local draws of ``add_speckle_arcs``)."""
    import dataclasses

    from diffus_tpu_torch.ops.artifacts import depth_dependent_lateral_blur, sharpen, speckle_arcs

    fields, tol = path
    port = _load("sweep_animation")
    z_vol, sources, directions = port.sweep_scene(SWEEP["size"], SWEEP["poses"], SWEEP["rays"])
    cfg = port.sweep_config(**fields)
    clean = port.render(z_vol, sources, directions, SWEEP["samples"],
                        dataclasses.replace(cfg, artifacts=False))
    want, keys, _ = _jax_sweep(True, **fields)
    got = []
    for p in range(SWEEP["poses"]):
        k1, k2 = jax.random.split(keys[p])
        radial = torch.from_numpy(np.array(jax.random.normal(k1, (SWEEP["samples"],))))
        local = torch.from_numpy(np.array(jax.random.normal(k2, clean.shape[1:])))
        x = speckle_arcs(clean[p], radial, local, cfg.std_radial, cfg.std_local)
        got.append(sharpen(depth_dependent_lateral_blur(x, cfg.max_sigma), cfg.sharpen_alpha))
    assert frame_rel_err(torch.stack(got).numpy(), want) < tol
    # the script's own draw: the same stack on the same clean frames
    drawn = port.render(z_vol, sources, directions, SWEEP["samples"], cfg)
    assert drawn.shape == clean.shape and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("matplotlib_installed", [True, False])
def test_sweep_main_writes_a_gif_of_n_frames(tmp_path, monkeypatch, capsys,
                                            matplotlib_installed):
    from PIL import Image

    if not matplotlib_installed:
        monkeypatch.setitem(sys.modules, "matplotlib", None)   # its import raises
    out = str(tmp_path / "sweep.gif")
    _load("sweep_animation").main(
        ["--device", "cpu", "--size", "48", "--poses", "5", "--rays", "16", "--samples", "24",
         "--out", out, "--pallas", "--interp", "trilinear_fused"])
    assert capsys.readouterr().out.splitlines() == [f"wrote {out}: 5 frames"]
    assert Image.open(out).n_frames == 5


# -- full_pipeline -----------------------------------------------------------------

PIPE = dict(n=24, rays=16)


def _jax_stages(rcfg_fields):
    """JAX's ``examples/full_pipeline.py`` ``main()``, stages 1-3."""
    from diffus_tpu.impedance import default_table_points, tabular_impedance_volume
    from diffus_tpu.ops.splat import differentiable_splat
    from diffus_tpu.phantoms import t1_phantom_3d
    from diffus_tpu.scene import build_scene_from_edges
    from diffus_tpu.types import RenderConfig

    n = PIPE["n"]
    scene = build_scene_from_edges(
        m_left=1.0, b_left=0.0, m_right=-1.0, b_right=2.0 * (n / 2.0),
        us_affine=np.eye(4, dtype=np.float32), t1_affine=np.eye(4, dtype=np.float32),
        slice_idx=n // 2, n_rays=PIPE["rays"], d1=0.0, d2=float(n // 2))
    t1 = jnp.asarray(t1_phantom_3d((n,) * 3))
    z_true = tabular_impedance_volume(t1, *default_table_points())
    rcfg = RenderConfig(attenuation_coeff=1e-4, **rcfg_fields)
    x, y, _, frame = scene.render(z_true, rcfg)
    target = differentiable_splat(x.astype(jnp.float32), y.astype(jnp.float32), frame, 32, 32,
                                  2.0)
    return scene, t1, z_true, frame, target, rcfg


PIPE_PATHS = [pytest.param(({"interp": "trilinear"}, 1e-4), id="trilinear"),
              pytest.param((FUSED, 1e-4), id="trilinear_fused+pallas")]


@pytest.mark.parametrize("path", PIPE_PATHS)
def test_pipeline_stages_1_to_3_match_jax(path):
    from diffus_tpu_torch.types import RenderConfig

    fields, tol = path
    port = _load("full_pipeline")
    jscene, _, jz, jframe, jtarget, _ = _jax_stages(fields)
    scene = port.calibrate(PIPE["n"], PIPE["rays"])
    np.testing.assert_allclose(scene.source.numpy(), np.asarray(jscene.source), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(scene.directions.numpy(), np.asarray(jscene.directions), rtol=0,
                               atol=1e-6)
    assert scene.geometry.num_samples == jscene.geometry.num_samples == PIPE["n"] // 2
    assert scene.calibration.opening_angle == pytest.approx(
        float(jscene.calibration.opening_angle), abs=1e-6)
    t1, z_true = port.impedance(PIPE["n"])
    np.testing.assert_allclose(z_true.numpy(), np.asarray(jz), rtol=1e-6, atol=0)
    frame, target = port.render_target(scene, z_true, RenderConfig(attenuation_coeff=1e-4,
                                                                   **fields))
    assert frame.shape == jframe.shape and target.shape == jtarget.shape == (32, 32)
    assert frame_rel_err(frame.numpy(), np.asarray(jframe)) < tol
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=1e-4,
                               atol=1e-4 * max(float(np.abs(jtarget).max()), 1e-30))


def _jax_initial_model():
    """The JAX script's initial MLP (``init_params(PRNGKey(0))``) as the
    port's module."""
    from diffus_tpu.impedance.mlp import init_params as jinit
    from diffus_tpu_torch.convert import mlp_state_from_flax
    from diffus_tpu_torch.impedance.mlp import ImpedanceMLP

    model = ImpedanceMLP((32, 32))
    model.load_state_dict(mlp_state_from_flax(jinit(jax.random.PRNGKey(0), (32, 32))))
    return model


@pytest.mark.parametrize("path", PIPE_PATHS)
def test_pipeline_training_matches_jax_from_its_weights(path, monkeypatch):
    """Stage 4 at the JAX script's defaults (size 48, 24 rays, 25 epochs),
    the port from JAX's initial weights (``convert.mlp_state_from_flax``):
    the first two losses (before any update, after one Adam step) within
    rtol 1e-5 of JAX's; the rest within rtol 5e-3 (a loss that jumps 0.58
    -> 0.75 -> 0.12 in steps 3-5 amplifies f32 rounding: 1.7e-3 at most,
    measured); the loss falls in both, as the script asserts."""
    import diffus_tpu_torch.train.impedance_train as ti
    from diffus_tpu.train.impedance_train import ImpedanceTrainConfig, train_impedance
    from diffus_tpu_torch.types import RenderConfig

    fields, _ = path
    n, rays, epochs = 48, 24, 25
    monkeypatch.setitem(PIPE, "n", n)
    monkeypatch.setitem(PIPE, "rays", rays)
    port = _load("full_pipeline")
    jscene, jt1, _, _, jtarget, jrcfg = _jax_stages(fields)
    tcfg = ImpedanceTrainConfig(
        num_samples=jscene.geometry.num_samples, slice_index=n // 2, epochs=epochs, lr=0.01,
        loss="masked_mse_edge", image_shape=(32, 32), splat_axes=(0, 1), render=jrcfg)
    _, want = train_impedance(jax.random.PRNGKey(0), jt1, jtarget, jscene.source,
                              jscene.directions, tcfg, mask=jnp.ones((32, 32), bool))
    want = np.asarray(want)
    monkeypatch.setattr(ti, "init_params", lambda generator, hidden, device=None:
                        _jax_initial_model().to(device))
    scene = port.calibrate(n, rays)
    t1, z_true = port.impedance(n)
    rcfg = RenderConfig(attenuation_coeff=1e-4, **fields)
    _, target = port.render_target(scene, z_true, rcfg)
    got = port.train(scene, t1, target, epochs, rcfg).numpy()
    assert got.shape == want.shape == (epochs,)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=0)
    assert got[-1] < got[0] and want[-1] < want[0]


def test_pipeline_main_runs_and_its_assertions_hold(monkeypatch, capsys):
    """``main()`` at size 24 through the fused path from JAX's initial
    weights: the five stage lines and the last, past the script's two
    assertions (the loss falls, the position error falls).  (From the
    port's own seed-0 draw the training is chaotic on this scene: at size
    48 its f32 loss rises or falls with the CPU's thread count.)"""
    import diffus_tpu_torch.train.impedance_train as ti

    monkeypatch.setattr(ti, "init_params", lambda generator, hidden, device=None:
                        _jax_initial_model().to(device))
    _load("full_pipeline").main(["--device", "cpu", "--size", "24", "--rays", "16",
                                 "--epochs", "25", "--pose-steps", "60", "--pallas",
                                 "--interp", "trilinear_fused"])
    lines = capsys.readouterr().out.splitlines()
    assert [line[:3] for line in lines[:5]] == ["[1]", "[2]", "[3]", "[4]", "[5]"]
    assert lines[0] == "[1] scene: apex=[12. 12. 12.], angle=90.0 deg, samples=12"
    assert lines[-1].startswith("full pipeline OK in ")


# -- serve_client ------------------------------------------------------------------

SERVE = dict(d=32, rays=16, samples=48)


def _jax_service_frames(fields):
    from diffus_tpu.phantoms import brain_phantom_3d
    from diffus_tpu.serve import RendererService
    from diffus_tpu.types import BeamGeometry, RenderConfig

    svc = RendererService(brain_phantom_3d((SERVE["d"],) * 3),
                          BeamGeometry(n_rays=SERVE["rays"], num_samples=SERVE["samples"]),
                          RenderConfig(attenuation_coeff=1e-4, **fields), batch_tiers=(1, 4))
    return np.asarray(svc.render(_load("serve_client").request_sources(SERVE["d"])))


@pytest.mark.parametrize("path", PATHS)
def test_render_over_the_wire_matches_jax_service(path):
    import threading

    from diffus_tpu_torch.serve import make_http_server

    fields, tol = path
    port = _load("serve_client")
    svc = port.make_service(SERVE["d"], SERVE["rays"], SERVE["samples"],
                            interp=fields.get("interp", "nearest"),
                            pallas=fields.get("use_pallas", False))
    server = make_http_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        sources = port.request_sources(SERVE["d"])
        got = port.decode_frames(port.post(f"{url}/render", {"sources": sources.tolist()}))
    finally:
        server.shutdown()
        server.server_close()
    want = _jax_service_frames(fields)
    assert got.shape == want.shape == (4, SERVE["rays"], SERVE["samples"])
    # the float64 plain render of the same poses (the service's fan)
    from diffus_tpu.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.types import RenderConfig

    plain = RenderConfig(attenuation_coeff=1e-4,
                         interp="trilinear" if fields else "nearest")
    vol64 = torch.from_numpy(brain_phantom_3d((SERVE["d"],) * 3)).double()
    ref = np.stack([render_frame(vol64, torch.from_numpy(s), svc.directions, SERVE["samples"],
                                 plain)[3].numpy() for s in sources])
    # the port within tol of float64; JAX within tol of the port, beyond
    # JAX's own distance from float64 (its fused path, the Pallas tile
    # blend in interpret mode, is 1.2e-4 from it at these poses; the
    # port's 7.7e-7)
    assert frame_rel_err(got, ref) < tol
    assert frame_rel_err(got, want) < tol + frame_rel_err(want, ref)


def test_npy_b64_round_trips():
    port = _load("serve_client")
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(port.decode_frames({"npy_b64": port.npy_b64(a)}), a)


def test_serve_client_main_runs_on_the_cpu(capsys):
    _load("serve_client").main(["--device", "cpu", "--size", str(SERVE["d"]), "--rays",
                                str(SERVE["rays"]), "--samples", str(SERVE["samples"]),
                                "--pallas", "--interp", "trilinear_fused"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("serving at http://127.0.0.1:")
    assert lines[1].startswith(f"rendered (4, {SERVE['rays']}, {SERVE['samples']}) over the wire")
    assert lines[2].startswith("recovered pose over the wire")
    assert lines[3] == "volume swapped; frames changed: True"
    assert lines[5] == "scene routing works: case_b frames differ: True"
    assert lines[-1] == "serve client demo OK"
