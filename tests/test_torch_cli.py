"""The port's CLI against ``diffus_tpu.cli``: each subcommand, run through
``main([...])`` of both packages on a small NIfTI file the test writes,
gives the same ``.npy`` (frame-max-relative 1e-4) and the same JSON keys.
The port runs with ``--device cpu``; without it, where there is no card,
every subcommand stops with a message that says to pass ``--device cpu``."""

import base64
import io
import json
import socketserver
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import diffus_tpu.cli as jcli
import diffus_tpu_torch.cli as tcli
from diffus_tpu.io import save_nifti
from diffus_tpu.phantoms import t1_phantom_3d
from torch_parity import frame_rel_err

CPU = ["--device", "cpu"]
TIMEOUT = 60


@pytest.fixture(scope="module")
def t1_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "t1.nii.gz")
    save_nifti(path, t1_phantom_3d((24, 24, 24)))
    return path


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("pallas", [[], ["--pallas"]], ids=["plain", "pallas"])
def test_render_and_sweep_match(tmp_path, t1_path, pallas):
    common = ["--volume", t1_path, "--source", "12", "1.3", "12", "--rays", "8",
              "--samples", "16", *pallas]
    for sub, extra in (("render", []), ("sweep", ["--poses", "3", "--jitter", "1.0"])):
        out = {}
        for name, main, flags in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
            out[name] = str(tmp_path / f"{sub}_{name}.npy")
            assert main([sub, *common, *extra, "--out", out[name], *flags]) == 0
        got, want = np.load(out["port"]), np.load(out["jax"])
        assert got.shape == want.shape == ((8, 16) if sub == "render" else (3, 8, 16))
        assert got.dtype == want.dtype == np.float32
        assert frame_rel_err(got, want) < 1e-4, sub


def test_render_image_and_sweep_gif(tmp_path, t1_path):
    pytest.importorskip("matplotlib")
    common = ["--volume", t1_path, "--source", "12", "1", "12", "--rays", "4", "--samples",
              "12", *CPU]
    assert tcli.main(["render", *common, "--out", str(tmp_path / "f.npy"), "--image",
                      str(tmp_path / "f.png"), "--image-size", "16"]) == 0
    assert tcli.main(["sweep", *common, "--poses", "2", "--out", str(tmp_path / "s.npy"),
                      "--gif", str(tmp_path / "s.gif")]) == 0
    assert (tmp_path / "f.png").stat().st_size > 0 and (tmp_path / "s.gif").stat().st_size > 0


def test_selftest_matches(capsys):
    """Both selftests hold their render to the float64 dense-solve oracle on
    the same inputs; the port's error is its render's distance from JAX's
    oracle (``diffus_tpu.ops.reference_oracle``), and the two packages'
    renders are within 1e-6 of each other on that scale."""
    from diffus_tpu.ops.reference_oracle import render_frame_dense
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render import render_frame
    from diffus_tpu_torch.types import RenderConfig

    assert jcli.main(["selftest"]) == 0
    want = _last_json(capsys)
    assert tcli.main(["selftest", *CPU]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) == {"parity_max_rel_err", "ok"}
    assert got["ok"] and got["parity_max_rel_err"] < 1e-3
    vol = brain_phantom_3d((32, 32, 32))
    src = np.array([16.0, 1.0, 16.0], np.float32)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), 8)
    frame = render_frame(torch.from_numpy(vol), torch.from_numpy(src), dirs, 24,
                         RenderConfig(attenuation_coeff=1e-4))[3].double().numpy()
    oracle = render_frame_dense(vol, src, dirs.numpy(), 24, 1e-4, 0)[3]
    err = float(np.max(np.abs(frame - oracle)) / (np.max(np.abs(oracle)) + 1e-12))
    assert got["parity_max_rel_err"] == err
    assert abs(got["parity_max_rel_err"] - want["parity_max_rel_err"]) < 1e-6


def test_selftest_catches_a_fault_of_the_render(monkeypatch, capsys):
    """A fault in the port's render that every path shares (here a frame
    scaled by 1.01) fails the selftest: it is held to the oracle, not to the
    port's own plain path, which would carry the same fault."""
    import diffus_tpu_torch.render as trender

    render_frame = trender.render_frame

    def scaled(*args, **kwargs):
        *coords, frame = render_frame(*args, **kwargs)
        return (*coords, frame * 1.01)

    monkeypatch.setattr(trender, "render_frame", scaled)
    assert tcli.main(["selftest", *CPU]) == 1
    got = _last_json(capsys)
    assert not got["ok"] and got["parity_max_rel_err"] > 5e-3


@pytest.mark.parametrize("starts", [1, 2])
def test_recover_pose_matches(t1_path, capsys, starts):
    args = ["recover-pose", "--volume", t1_path, "--true-source", "12", "1", "12", "--source",
            "12.8", "1.9", "11.5", "--rays", "8", "--samples", "16", "--steps", "30",
            "--lr", "0.05", "--starts", str(starts), "--radius", "0.5"]
    assert jcli.main(args) == 0
    want = _last_json(capsys)
    assert tcli.main(args + CPU) == 0
    got = _last_json(capsys)
    assert list(got) == list(want)
    assert got["loss_last"] < got["loss_first"] and np.all(np.isfinite(got["position"]))
    if starts == 1:   # the same start: the same first loss (the starts' draws differ)
        assert abs(got["loss_first"] - want["loss_first"]) <= 1e-4 * want["loss_first"]


def test_recover_pose_annealed_keys(t1_path, capsys):
    assert tcli.main(["recover-pose", "--volume", t1_path, "--true-source", "12", "1", "12",
                      "--source", "12.5", "1.5", "11.7", "--rays", "4", "--samples", "12",
                      "--annealed", "--starts", "2", "--radius", "0.5", *CPU]) == 0
    got = _last_json(capsys)
    # the keys of diffus_tpu/cli.py's annealed result
    assert list(got) == ["annealed", "starts", "best", "loss_first", "loss_last", "position",
                         "rotvec"]
    assert got["starts"] == 2 and np.isfinite(got["loss_last"])


def test_train_impedance_and_mlp_inference(tmp_path, t1_path, capsys):
    target = np.abs(np.random.default_rng(0).normal(size=(12, 12))).astype(np.float32)
    np.save(tmp_path / "us.npy", target)
    args = ["train-impedance", "--t1", t1_path, "--us", str(tmp_path / "us.npy"), "--source",
            "12", "1", "12", "--rays", "8", "--samples", "12", "--slice-index", "12",
            "--epochs", "2", "--loss", "masked_mse_edge"]
    assert jcli.main(args) == 0
    want = capsys.readouterr().out.strip().splitlines()
    ckpt = str(tmp_path / "mlp.pt")
    assert tcli.main(args + ["--checkpoint", ckpt] + CPU) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0].split(":")[0] == want[0].split(":")[0] == "loss"
    assert np.all(np.isfinite([float(v) for v in got[0].split(":")[1].split("->")]))
    assert got[1] == f"wrote checkpoint {ckpt}"
    # the trained MLP maps the volume for a render
    out = str(tmp_path / "mlp_frame.npy")
    assert tcli.main(["render", "--volume", t1_path, "--impedance", "mlp",
                      "--impedance-checkpoint", ckpt, "--source", "12", "1", "12", "--rays",
                      "4", "--samples", "12", "--out", out, *CPU]) == 0
    assert np.load(out).shape == (4, 12) and np.all(np.isfinite(np.load(out)))


def _serve(main, argv, monkeypatch):
    """Run ``main(['serve', ...])`` with ``serve_forever`` replaced by a short
    run: the real loop on a thread, a few requests, a shutdown."""
    seen = {}
    serve_forever = socketserver.BaseServer.serve_forever

    def short_run(server, poll_interval=0.5):
        loop = threading.Thread(target=serve_forever, args=(server,), daemon=True)
        loop.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(f"{url}/scenes", timeout=TIMEOUT) as r:
                seen["scenes"] = json.load(r)
            for scene in ("default", "b"):
                req = urllib.request.Request(f"{url}/render", method="POST", data=json.dumps(
                    {"sources": [[12.0, 1.0, 12.0]], "scene": scene}).encode())
                with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                    seen[scene] = np.load(io.BytesIO(base64.b64decode(json.load(r)["npy_b64"])))
        finally:
            server.shutdown()
            loop.join(timeout=TIMEOUT)
        raise KeyboardInterrupt   # what ends serve_forever at a terminal

    monkeypatch.setattr(socketserver.BaseServer, "serve_forever", short_run)
    assert main(argv) == 0
    monkeypatch.undo()
    return seen


def test_serve_matches(tmp_path, t1_path, capsys, monkeypatch):
    padded = np.zeros((32, 32, 32), np.float32)
    padded[4:28, 4:28, 4:28] = t1_phantom_3d((24, 24, 24))
    save_nifti(str(tmp_path / "b.nii"), padded)
    argv = ["serve", "--volume", t1_path, "--scene", f"b={tmp_path / 'b.nii'}", "--rays", "4",
            "--samples", "12", "--tiers", "1", "2", "--port", "0", "--crop",
            "--adaptive-window"]
    want = _serve(jcli.main, argv, monkeypatch)
    want_status = _last_json(capsys)
    got = _serve(tcli.main, argv + CPU, monkeypatch)
    got_status = _last_json(capsys)
    assert set(got_status) == set(want_status) == {"listening", "warmup_s", "tiers", "scenes"}
    assert got_status["scenes"] == want_status["scenes"] == ["b", "default"]
    assert got["scenes"] == want["scenes"] and got["scenes"]["b"]["cropped"]
    for scene in ("default", "b"):
        assert frame_rel_err(got[scene], want[scene]) < 1e-4, scene


def test_serve_mesh_flags_wait_for_parallel(t1_path):
    """A mesh larger than the devices (``--device cpu``: one) stops with
    ``make_mesh``'s message, in ``serve`` and ``train-cases`` alike."""
    for sub in (["serve", "--volume", t1_path], ["train-cases", "--manifest", "none.json"]):
        with pytest.raises(SystemExit, match="need 2 devices, have 1"):
            tcli.main([*sub, "--mesh-pose", "2", *CPU])


def test_serve_over_a_mesh_matches(t1_path, capsys, monkeypatch):
    """``serve --mesh-pose 1 --mesh-ray 1`` builds no mesh, as JAX's CLI
    builds one only above 1 x 1; its frames equal JAX's server's with the
    same flags."""
    import diffus_tpu_torch.serve as tserve

    meshes = []

    class Recording(tserve.RendererService):
        def __init__(self, *args, mesh=None, **kwargs):
            meshes.append(mesh)
            super().__init__(*args, mesh=mesh, **kwargs)

    argv = ["serve", "--volume", t1_path, "--scene", f"b={t1_path}", "--rays", "4",
            "--samples", "12", "--tiers", "1", "--port", "0", "--mesh-pose", "1",
            "--mesh-ray", "1"]
    want = _serve(jcli.main, argv, monkeypatch)
    capsys.readouterr()
    monkeypatch.setattr(tserve, "RendererService", Recording)
    got = _serve(tcli.main, argv + CPU, monkeypatch)
    assert meshes == [None]
    for scene in ("default", "b"):
        assert frame_rel_err(got[scene], want[scene]) < 1e-4, scene


def test_train_cases_matches(tmp_path, t1_path, capsys, monkeypatch):
    """A two-case manifest of NIfTI volumes, both packages from the same flax
    weights: the same JSON line.  The first loss (the same weights) to rtol
    1e-5; the last, after one Adam step from each package's own gradients,
    to rtol 5e-3: on this phantom some gradient entries are f32 noise, and
    Adam's first step moves each by ~lr * sign(g) (``test_torch_train.py``)."""
    import diffus_tpu.train.driver as jdriver
    import diffus_tpu_torch.train.driver as tdriver
    from diffus_tpu.impedance.mlp import init_params as jinit
    from diffus_tpu_torch.convert import mlp_state_from_flax
    from diffus_tpu_torch.impedance.mlp import ImpedanceMLP

    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0)))

    def converted(generator, hidden=(32, 32), device=None):
        model = ImpedanceMLP(hidden)
        model.load_state_dict(mlp_state_from_flax(params))
        return model.to(device)

    monkeypatch.setattr(jdriver, "init_params", lambda key, hidden=(32, 32): params)
    monkeypatch.setattr(tdriver, "init_params", converted)
    rng = np.random.default_rng(3)
    save_nifti(str(tmp_path / "t1b.nii"), t1_phantom_3d((24, 24, 24)) * np.float32(1.3))
    entries = []
    for i, t1 in enumerate((t1_path, str(tmp_path / "t1b.nii"))):
        np.save(tmp_path / f"target{i}.npy", rng.uniform(0, 1, (8, 12)).astype(np.float32))
        entries.append({"t1": t1, "target": str(tmp_path / f"target{i}.npy"),
                        "source": [12.0 + i, 1.0, 12.0]})
    entries[1]["mask"] = str(tmp_path / "mask.npy")
    np.save(tmp_path / "mask.npy", rng.uniform(size=(8, 12)) > 0.2)
    (tmp_path / "cases.json").write_text(json.dumps(entries))
    argv = ["train-cases", "--manifest", str(tmp_path / "cases.json"), "--rays", "8",
            "--samples", "12", "--slice-index", "12", "--epochs", "2", "--batch-size", "2",
            "--interp", "trilinear"]
    assert jcli.main(argv) == 0
    want = _last_json(capsys)
    assert tcli.main(argv + ["--checkpoint", str(tmp_path / "ckpt"), *CPU]) == 0
    got = _last_json(capsys)
    assert list(got) == list(want) == ["cases", "steps", "loss_first", "loss_last"]
    assert (got["cases"], got["steps"]) == (want["cases"], want["steps"]) == (2, 2)
    np.testing.assert_allclose(got["loss_first"], want["loss_first"], rtol=1e-5)
    np.testing.assert_allclose(got["loss_last"], want["loss_last"], rtol=5e-3)
    # the Adam step moved the loss by more than that tolerance, so a CLI
    # that dropped the update could not pass the line above
    for out in (got, want):
        assert abs(out["loss_last"] - out["loss_first"]) > 2 * 5e-3 * abs(out["loss_first"])
    assert (tmp_path / "ckpt" / "latest").exists()


@pytest.mark.parametrize("argv", [
    ["selftest"],
    ["render", "--volume", "{t1}"],
    ["sweep", "--volume", "{t1}"],
    ["recover-pose", "--volume", "{t1}", "--source", "12", "1", "12"],
    ["train-impedance", "--t1", "{t1}", "--us", "{t1}"],
    ["train-cases", "--manifest", "{t1}"],
    ["serve", "--volume", "{t1}", "--port", "0"],
], ids=lambda a: a[0])
def test_default_device_is_the_card(t1_path, argv):
    """``--device`` defaults to ``cuda``: without a card the subcommand stops
    and says to pass ``--device cpu``; it never runs quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs")
    with pytest.raises(SystemExit, match="pass --device cpu"):
        tcli.main([a.format(t1=t1_path) for a in argv])
