"""``bench_torch.py`` and ``bench_apps_torch.py`` against the JAX scripts
``bench.py`` and ``bench_apps.py``, on the CPU at small sizes (the scripts'
module constants, shrunk with monkeypatch; ``--device cpu``, so every
wrapper runs its plain version).

- the key sets are the JAX scripts' (read from their sources), with the
  differences each port script's docstring names, listed here;
- the inputs are the JAX scripts' draws from ``default_rng(0)``;
- the guards' small scene renders within 1e-5 (frame-max relative) of
  JAX's ``render_frame`` on the same numpy inputs, and within 1e-5 of the
  float64 oracle; a frame or a K2 output scaled by 1.01 fails the bench;
- the held check (each timed workload's first call against float64) fails
  the bench when K1b's or K2b's gradient is scaled by 1.01, and its rule
  holds a path to its non-finite entries;
- the training step from JAX's ``init_params(PRNGKey(0))`` gives JAX's
  loss on the same inputs (rtol 1e-4, ``tests/test_torch_train.py``'s),
  and, from sources whose fan crosses the trained slice, JAX's weights
  after the first Adam step;
- the recovery records carry JAX's keys; every roofline fraction is at
  most 1.
"""

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench_apps_torch as bapps
import bench_torch as bt
import diffus_tpu.train.impedance_train as jtrain
import diffus_tpu_torch.render.renderer as trenderer
from diffus_tpu.impedance.mlp import init_params as jinit
from diffus_tpu.ops.splat import splat_frame as jsplat
from diffus_tpu.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu.render.renderer import render_frame as jrender
from diffus_tpu.types import RenderConfig as JConfig
from diffus_tpu_torch.convert import mlp_state_from_flax
from diffus_tpu_torch.impedance.mlp import ImpedanceMLP
from torch_parity import frame_rel_err

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
SMALL = dict(N_RAYS=16, NUM_SAMPLES=32, VOLUME_DIM=32, POSE_BATCH=4, SWEEP_ITERS=2,
             TRILINEAR_ITERS=2, SINGLE_ITERS=3, TRAIN_DIM=32, TRAIN_RAYS=16, TRAIN_SAMPLES=32,
             TRAIN_IMAGE=(32, 32), TRAIN_ITERS=2, POSE_RAYS=8, POSE_SAMPLES=16, POSE_ITERS=3)
APPS_SMALL = dict(DIM=32, RAYS=16, SAMPLES=32, POSES=4, IMAGE=(32, 32), POSE_RAYS=8,
                  POSE_SAMPLES=16, POSE_ITERS=3, RECOVERY_STARTS=2, ENVELOPE_RADII=(2.0, 4.0),
                  RECOVERY_PHASES=((2.0, 0.3, 0.02, 3), (0.0, 0.1, 0.005, 3)))
# the keys each port script leaves out of its JAX script's, and adds
BENCH_REMOVED = {"target_fps", "gate_floors_fps", "jax_version", "trilinear_pallas_prop",
                 "train_pallas_prop"}
BENCH_ADDED = {"torch_version", "cuda_version", "launches", "launches_note", "tile_max_rel_err",
               "held_to_f64", "tile_workload_max_rel_err",
               "single_frame_latency_device_ms", "sweep_device_ms", "trilinear_device_ms",
               "trilinear_bf16_device_ms", "train_step_device_ms", "pose_step_device_ms",
               "graph_launches", "graph_equal", "single_frame_latency_eager_ms",
               "single_frame_latency_eager_device_ms", "sweep_eager_ms", "sweep_eager_device_ms",
               "trilinear_eager_ms", "trilinear_eager_device_ms", "trilinear_bf16_eager_ms",
               "trilinear_bf16_eager_device_ms", "train_step_eager_ms",
               "train_step_eager_device_ms", "pose_step_eager_ms", "pose_step_eager_device_ms"}
APPS_ADDED = {"launches", "launches_note", "parity_max_rel_err", "tile_max_rel_err", "held_to_f64",
              "pass",
              "gates", "sweep_device_ms_per_pose", "train_step_device_ms",
              "train_step_ssim_device_ms", "pose_grad_step_device_ms",
              "graph_launches", "graph_equal", "sweep_eager_ms_per_pose",
              "sweep_eager_device_ms_per_pose", "train_step_eager_ms", "train_step_eager_device_ms",
              "train_step_ssim_eager_ms", "train_step_ssim_eager_device_ms",
              "pose_grad_step_eager_ms", "pose_grad_step_eager_device_ms"}
JAX_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|diffus_tpu)(\.|\s|$)",
                        re.MULTILINE)


def _shrink(mp):
    for name, value in SMALL.items():
        mp.setattr(bt, name, value)
    for name, value in APPS_SMALL.items():
        mp.setattr(bapps, name, value)


@pytest.fixture
def small(monkeypatch):
    _shrink(monkeypatch)


def _run(main) -> tuple:
    """``main(["--device", "cpu"])``: its exit code and its JSON record."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(CPU)
    lines = [line for line in out.getvalue().splitlines() if line.startswith("{")]
    assert len(lines) == 1, out.getvalue()
    return rc, json.loads(lines[0])


@pytest.fixture(scope="module")
def records():
    """Each port script's record at the small sizes, run once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp)
        return {"bench": _run(bt.main), "apps": _run(bapps.main)}


def _source_tree(name: str) -> ast.Module:
    return ast.parse((ROOT / name).read_text())


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _jax_bench_keys() -> set:
    """The keys of ``bench.py``'s record: the dict literal in ``main`` that holds ``gates``."""
    for node in ast.walk(_function(_source_tree("bench.py"), "main")):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "gates" in keys:
                return keys
    raise AssertionError("bench.py's record not found")


def _jax_apps_keys() -> set:
    """The keys of ``bench_apps.py``'s ``results``: its initial dict and every
    ``results[...] =``."""
    keys = set()
    for node in ast.walk(_function(_source_tree("bench_apps.py"), "main")):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "results" and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and getattr(node.targets[0].value, "id", None) == "results":
            keys.add(node.targets[0].slice.value)
    return keys


def _jax_recovery_keys() -> set:
    """The keys of the dict that ``diffus_tpu``'s ``pose_recovery_benchmark`` returns."""
    tree = ast.parse((ROOT / "diffus_tpu" / "train" / "pose_recovery.py").read_text())
    fn = _function(tree, "pose_recovery_benchmark")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


# -- the scripts as programs ----------------------------------------------------------


@pytest.mark.parametrize("script", ["bench_torch.py", "bench_apps_torch.py"])
def test_scripts_import_no_jax(script):
    """Neither script imports jax, flax, optax or the JAX package, in its source
    or through what it imports."""
    assert not JAX_IMPORT.search((ROOT / script).read_text())
    code = (f"import {script[:-3]}, sys\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'optax', 'diffus_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("script", ["bench_torch.py", "bench_apps_torch.py"])
def test_scripts_stop_without_a_card(script):
    """``--device`` defaults to ``cuda``: without a card the script says to
    pass ``--device cpu`` and exits 1; it never runs quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs")
    out = subprocess.run([sys.executable, script], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 1 and "pass --device cpu" in out.stderr, out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("which", ["bench", "apps"])
def test_key_sets_are_the_jax_scripts(records, which):
    rc, record = records[which]
    assert rc == 0 and record["pass"] and all(record["gates"].values()), record
    if which == "bench":
        assert set(record) == (_jax_bench_keys() - BENCH_REMOVED) | BENCH_ADDED
    else:
        assert set(record) == _jax_apps_keys() | APPS_ADDED


@pytest.mark.parametrize("which", ["bench", "apps"])
def test_cpu_launches_nothing_and_says_so(records, which):
    """Off the card the plain versions run: every count is 0, and the note says
    the launches gate holds nothing; every workload of REQUIRED is counted."""
    record = records[which][1]
    required = bt.REQUIRED if which == "bench" else bapps.REQUIRED
    assert set(record["launches"]) == set(required)
    assert all(n == 0 for counts in record["launches"].values() for n in counts.values())
    assert "holds nothing" in record["launches_note"] and record["device"] == "cpu"
    assert all(v is None for k, v in record.items() if "device_ms" in k)


def test_launches_gate_on_the_card():
    """On the card the gate requires each named kernel of each workload."""
    cuda = torch.device("cuda")
    counts = {k: 1 for k in bt.launch_counts()}
    ok, _ = bt.launches_gate({w: dict(counts) for w in bt.REQUIRED}, bt.REQUIRED, cuda)
    assert ok
    launches = {w: dict(counts) for w in bt.REQUIRED}
    launches["pose_step"]["trilinear_bwd"] = 0
    ok, note = bt.launches_gate(launches, bt.REQUIRED, cuda)
    assert not ok and "pose_step: trilinear_bwd" in note


def test_roofline_fractions_are_at_most_one(records):
    record = records["bench"][1]
    for name in ("nearest_roofline", "trilinear_roofline"):
        roof = record[name]
        assert 0 < roof["roofline_fraction"] <= 1
        assert roof["bound_ms_per_frame"] == pytest.approx(
            roof["bytes_per_frame"] / bt.HBM_BYTES_PER_S * 1e3)
    # a frame measured at its bound reads 1
    assert bt.roofline(100, 4096, 4, 16, 1.0, None)["roofline_fraction"] <= 1.0
    bound = bt.roofline(100, 4096, 4, 16, 1.0, None)["bound_ms_per_frame"]
    assert bt.roofline(100, 4096, 4, 16, bound, bound)["device_roofline_fraction"] == 1.0


def test_recovery_records_carry_the_jax_keys(records):
    record = records["apps"][1]
    keys = _jax_recovery_keys()
    runs = [record["pose_recovery"], *record["pose_recovery_envelope"].values()]
    assert list(record["pose_recovery_envelope"]) == [str(float(r))
                                                      for r in APPS_SMALL["ENVELOPE_RADII"]]
    for run in runs:
        assert set(run) == keys
        assert 0.0 <= run["success_rate"] <= 1.0 and run["count"] == 2
    assert [r["global_stage"] for r in runs] == [False, True, True]


# -- inputs and guards ------------------------------------------------------------


def test_inputs_are_the_jax_scripts_draws():
    """``bench.py``'s and ``bench_apps.py``'s draws from ``default_rng(0)``, in
    their order and counts, at the full sizes."""
    rng = np.random.default_rng(0)
    base = np.array([128.0, 4.0, 128.0], np.float32)
    sets = [base[None, :] + rng.uniform(-8, 8, (32, 3)).astype(np.float32) for _ in range(25)]
    singles = [base + rng.uniform(-8, 8, 3).astype(np.float32) for _ in range(97)]
    tri = [base[None, :] + rng.uniform(-8, 8, (32, 3)).astype(np.float32)
           for _ in range((3 + 1) * (12 + 1) + 1)]
    srcs = [np.array([64.0, 4.0, 64.0], np.float32) + rng.uniform(-4, 4, 3).astype(np.float32)
            for _ in range(145)]
    got = bt.draw_inputs(np.random.default_rng(0))
    for name, want in (("sweep", sets), ("singles", singles), ("trilinear", tri),
                       ("steps", srcs)):
        assert len(got[name]) == len(want)
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got[name], want))

    rng = np.random.default_rng(0)
    base = np.array([64.0, 4.0, 64.0], np.float32)
    sets = [np.tile(base, (16, 1)) + rng.uniform(-4, 4, (16, 3)).astype(np.float32)
            for _ in range(8)]
    pose = [base + rng.uniform(-4, 4, 3).astype(np.float32) for _ in range(97)]
    got = bapps.draw_inputs(np.random.default_rng(0))
    assert all(np.array_equal(g, w) for g, w in zip(got["sets"], sets)) and len(got["sets"]) == 8
    assert all(np.array_equal(g, w) for g, w in zip(got["pose"], pose)) and len(got["pose"]) == 97


def test_guard_frame_matches_jax_and_the_oracle():
    """The guards' scene of the full-size bench (the 256^3 phantom at every 8th
    voxel): the port's frame through its K1 path within 1e-5 of JAX's
    ``render_frame`` (bench.py's guard config) on the same numpy inputs, and
    the parity guard below 1e-5."""
    small, src, dirs = bt.guard_scene(brain_phantom_3d((256,) * 3))
    assert small.shape == (32, 32, 32)
    got = bt.parity_frame(small, src, dirs, torch.device("cpu")).numpy()
    want = np.asarray(jrender(jnp.asarray(small), jnp.asarray(src), jnp.asarray(dirs),
                              bt.GUARD_SAMPLES, JConfig(attenuation_coeff=1e-4))[3])
    assert got.shape == want.shape == (bt.GUARD_RAYS, bt.GUARD_SAMPLES)
    assert frame_rel_err(got, want) < 1e-5
    checks = bt.guards(brain_phantom_3d((256,) * 3), torch.device("cpu"), {})
    assert checks["parity_max_rel_err"] < 1e-5 and checks["tile_max_rel_err"] == 0.0


def _scaled_frame(render_frame):
    def scaled(*args, **kwargs):
        *coords, frame = render_frame(*args, **kwargs)
        return (*coords, frame * 1.01)
    return scaled


def _scaled_values(march):
    def scaled(*args, **kwargs):
        idx, values = march(*args, **kwargs)
        return idx, values * 1.01
    return scaled


@pytest.mark.parametrize("fault", ["render", "k2"])
def test_guards_fail_the_bench_under_a_fault(small, monkeypatch, capsys, fault):
    """A frame scaled by 1.01 fails the parity guard, a K2 output scaled by
    1.01 the tile guard: the script prints a ``"pass": false`` record and
    exits 1."""
    if fault == "render":
        monkeypatch.setattr(bt, "render_frame", _scaled_frame(bt.render_frame))
    else:
        monkeypatch.setattr(bt, "march_trilinear_fused", _scaled_values(bt.march_trilinear_fused))
    for main in (bt.main, bapps.main):
        assert main(CPU) == 1
        record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert record["pass"] is False
        assert ("parity check" if fault == "render" else "tile trilinear guard") \
            in record["error"]


class _GradScaled(torch.autograd.Function):
    """The identity, with its gradient scaled by 1.01."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * 1.01


def _k2b_scaled(march):
    def scaled(*args, **kwargs):
        idx, values = march(*args, **kwargs)
        return idx, _GradScaled.apply(values)
    return scaled


def _k1b_scaled(echo):
    def scaled(r, *args, **kwargs):
        return echo(_GradScaled.apply(r), *args, **kwargs)
    return scaled


@pytest.mark.parametrize("fault", ["k1b", "k2b"])
def test_held_check_fails_the_bench_under_a_gradient_fault(small, monkeypatch, capsys, fault):
    """K1b's or K2b's gradient scaled by 1.01 (the renderer's kernel calls,
    their values untouched, so the guards pass) fails the held gate of both
    scripts at the step workloads: ``"pass": false``, exit 1."""
    if fault == "k2b":
        monkeypatch.setattr(trenderer, "march_trilinear_fused",
                            _k2b_scaled(trenderer.march_trilinear_fused))
    else:
        monkeypatch.setattr(trenderer, "echo_fused", _k1b_scaled(trenderer.echo_fused))
    for main, steps in ((bt.main, ("train_step", "pose_step")),
                        (bapps.main, ("train_step", "train_step_ssim", "pose_grad_step"))):
        assert main(CPU) == 1
        record = json.loads(capsys.readouterr().out.strip().splitlines()[0])
        gates = record["gates"]
        assert record["pass"] is False and not gates["held"]
        assert gates["parity"] and gates["tile"] and gates["launches"]
        held = record["held_to_f64"]
        for workload in steps:
            assert not all(ok for *_, ok in held[workload].values()), (workload, held[workload])
        # the forward workloads are untouched
        assert all(ok for w in held if w not in steps for *_, ok in held[w].values())


def test_held_rule():
    """The kernel path within max(floor, 2x the plain f32 path's distance) of
    float64; a path whose non-finite entries are not float64's is inf."""
    ref = torch.tensor([1.0, 2.0, float("nan"), 4.0], dtype=torch.float64)

    def runs(kernel, plain_f32):
        return lambda on_plain, dtype: {
            "grad x": ref if dtype == torch.float64 else (plain_f32 if on_plain else kernel)}

    near = ref.float() * (1 + 1e-6)
    assert bt.held(runs(near, ref.float()))["grad x"][2]
    far = ref.float() * (1 + 1e-2)
    assert bt.held(runs(far, far))["grad x"][2]             # 2x the plain path's own
    e_k, e_p, ok = bt.held(runs(far, near))["grad x"]
    assert not ok and e_k == pytest.approx(1e-2, rel=1e-3) and e_p < 2e-6
    finite = torch.tensor([1.0, 2.0, 3.0, 4.0])
    e_k, _, ok = bt.held(runs(finite, ref.float()))["grad x"]
    assert e_k == float("inf") and not ok
    # where the plain path's is inf, the floor alone
    assert bt.held(runs(near, finite))["grad x"][2]
    assert not bt.held(runs(far, finite))["grad x"][2]
    assert bt.held_gate({"w": {"a": [0.0, 0.0, True]}})
    assert not bt.held_gate({"w": {"a": [0.0, 0.0, True], "b": [1.0, 0.0, False]}})


# -- the training step against JAX's ---------------------------------------------


def test_training_step_loss_matches_jax(small):
    """The bench's training step (its setup, its first call), from JAX's
    ``init_params(PRNGKey(0))`` through ``mlp_state_from_flax``, against JAX's
    ``train_step`` with bench.py's config on the same inputs."""
    srcs = bt.draw_inputs(np.random.default_rng(0))["steps"]
    cpu = torch.device("cpu")
    setup = bt.training_setup(cpu, srcs[0])
    params = jinit(jax.random.PRNGKey(0))
    model = ImpedanceMLP((32, 32))
    model.load_state_dict(mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    before = [v.clone() for v in model.state_dict().values()]
    clock = bt.Clock(cpu)
    launches = {}
    got = bt.training_step(model, setup, bt.on(cpu, srcs), clock, launches, "train_step",
                           bt.TRAIN_ITERS)

    dim = bt.TRAIN_DIM
    vol = jnp.asarray(brain_phantom_3d((dim,) * 3))
    t1 = jnp.asarray(t1_phantom_3d((dim,) * 3))
    dirs = jnp.asarray(setup["directions"].numpy())
    jcfg = jtrain.ImpedanceTrainConfig(
        num_samples=bt.TRAIN_SAMPLES, slice_index=dim // 2, lr=0.01, loss="masked_mse_edge",
        image_shape=bt.TRAIN_IMAGE, splat_axes=(0, 1),
        render=JConfig(attenuation_coeff=1e-4, interp="trilinear", use_pallas=True))
    x, y, _, frame = jrender(vol, jnp.asarray(srcs[0]), dirs, bt.TRAIN_SAMPLES,
                             JConfig(attenuation_coeff=1e-4, interp="trilinear"))
    target = jsplat((x, y, None), frame, (0, 1), bt.TRAIN_IMAGE)
    assert frame_rel_err(setup["target"].numpy(), np.asarray(target)) < 1e-4
    want = jtrain.train_step(params, optax.adam(jcfg.lr).init(params), t1, target,
                             jnp.ones(bt.TRAIN_IMAGE, bool), jnp.asarray(srcs[0]), dirs, jcfg)[2]
    np.testing.assert_allclose(got["loss_first"], float(want), rtol=1e-4)
    assert set(launches) == {"train_step"}
    # the steps ran on a copy: the weights given are left as they were
    assert all(torch.equal(p, q) for p, q in zip(model.state_dict().values(), before))


def test_training_step_update_matches_jax(small):
    """The weights after the bench's first training call against the params
    that JAX's ``train_step`` returns, from JAX's ``init_params(PRNGKey(0))``
    on the same inputs.  bench.py's sources put the fan's plane beside the
    trained slice, where the MLP's gradient is 0 and Adam moves nothing, so
    here the sources' third coordinate is moved to the slice (+0.25).  The
    first Adam step moves each weight by lr x sign(gradient): it must equal
    JAX's wherever JAX's gradient is beyond ``tests/test_torch_train.py``'s
    gradient tolerance (2e-3 of its largest entry), and be within 2 lr of it
    elsewhere."""
    srcs = bt.draw_inputs(np.random.default_rng(0))["steps"]
    srcs = [np.array([s[0], s[1], bt.TRAIN_DIM // 2 + 0.25], np.float32) for s in srcs]
    cpu = torch.device("cpu")
    setup = bt.training_setup(cpu, srcs[0])
    params = jinit(jax.random.PRNGKey(0))
    model = ImpedanceMLP((32, 32))
    model.load_state_dict(mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = bt.training_step(model, setup, bt.on(cpu, srcs), bt.Clock(cpu), {}, "train_step",
                           bt.TRAIN_ITERS)["params_first"]

    dim = bt.TRAIN_DIM
    t1 = jnp.asarray(t1_phantom_3d((dim,) * 3))
    dirs = jnp.asarray(setup["directions"].numpy())
    target, src = jnp.asarray(setup["target"].numpy()), jnp.asarray(srcs[0])
    mask = jnp.ones(bt.TRAIN_IMAGE, bool)
    jcfg = jtrain.ImpedanceTrainConfig(
        num_samples=bt.TRAIN_SAMPLES, slice_index=dim // 2, lr=0.01, loss="masked_mse_edge",
        image_shape=bt.TRAIN_IMAGE, splat_axes=(0, 1),
        render=JConfig(attenuation_coeff=1e-4, interp="trilinear", use_pallas=True))
    new = jtrain.train_step(params, optax.adam(jcfg.lr).init(params), t1, target, mask, src,
                            dirs, jcfg)[0]
    grads = jax.grad(lambda p: jtrain._loss_value(
        jtrain.synth_forward(p, t1, src, dirs, jcfg), target, mask, jcfg))(params)
    want = mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, new))
    jgrad = mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    start = mlp_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert set(got) == set(want)
    for name, w in want.items():
        g, w, j = got[name].numpy(), w.numpy(), jgrad[name].numpy()
        sure = np.abs(j) > 2e-3 * np.abs(j).max()
        assert sure.mean() > 0.5, name
        np.testing.assert_allclose(g[sure], w[sure], rtol=0, atol=1e-6)
        assert np.abs(g - w).max() <= 2 * jcfg.lr + 1e-6
        # a step of lr moved every weight the gradient reached
        np.testing.assert_allclose(np.abs(g - start[name].numpy())[sure], jcfg.lr, rtol=1e-3)


# the pose of the bench's first trilinear call (inputs["trilinear"][0]) whose
# frame holds the call's largest distance from float64, and that distance's pixel
RESONANT_POSE, RESONANT_PIXEL = 30, (52, 288)
_JAX_F64_FRAMES = """
import sys
import numpy as np
import jax.numpy as jnp
from diffus_tpu.ops.propagation import depth_attenuation, echo_amplitudes, reflection_coeff
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.render.renderer import trace_rays
src, dirs = (np.load(p).astype(np.float64) for p in sys.argv[1:3])
vol = jnp.asarray(brain_phantom_3d((256,) * 3).astype(np.float64))
frames = []
for s in src:
    _, z = trace_rays(vol, jnp.asarray(s), jnp.asarray(dirs), 512, "trilinear")
    r = reflection_coeff(z[:, :-1], z[:, 1:])
    frames.append(np.asarray(depth_attenuation(echo_amplitudes(r, mode="parity"), 1e-4)))
np.save(sys.argv[3], np.stack(frames))
"""


def test_first_trilinear_call_is_as_far_from_f64_in_jax(tmp_path):
    """The bench's first trilinear call is 2.3% off float64 on both of the
    port's f32 paths (PERF.md, Findings).  At the call's first pose and at
    the pose that holds that distance, JAX's f32 frame is as far from its
    float64 frame (JAX casts the samples to f32 in ``render_frame``, so its
    f64 frame is composed from its stages under ``JAX_ENABLE_X64``, in a
    subprocess) as the port's plain f32 frame is from the port's f64, at the
    same pixel: the ray leaves the head there (a reflection coefficient
    below -0.99), and the echo scan amplifies the f32 rounding of the
    samples.  The two f64 frames agree to 1e-9 on the same directions."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.phantoms import brain_phantom_3d as tphantom
    from diffus_tpu_torch.render.renderer import render_frame as trender, simulate_rays
    from diffus_tpu_torch.types import RenderConfig

    assert (bt.VOLUME_DIM, bt.N_RAYS, bt.NUM_SAMPLES) == (256, 256, 512)
    src = bt.draw_inputs(np.random.default_rng(0))["trilinear"][0][[0, RESONANT_POSE]]
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), 256).numpy()
    paths = [str(tmp_path / f) for f in ("src.npy", "dirs.npy", "j64.npy")]
    np.save(paths[0], src)
    np.save(paths[1], dirs)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    jax64 = subprocess.Popen([sys.executable, "-c", _JAX_F64_FRAMES, *paths], env=env,
                             cwd=ROOT)
    try:
        vol = tphantom((256,) * 3)
        cfg = JConfig(attenuation_coeff=1e-4, interp="trilinear")
        j32 = np.stack([np.asarray(jrender(jnp.asarray(vol), jnp.asarray(s), jnp.asarray(dirs),
                                           512, cfg)[3]) for s in src])
        tcfg = RenderConfig(attenuation_coeff=1e-4, interp="trilinear_plain")
        port = {dt: np.stack([trender(torch.from_numpy(vol).to(dt), torch.from_numpy(s).to(dt),
                                      torch.from_numpy(dirs).to(dt), 512, tcfg)[3].numpy()
                              for s in src]) for dt in (torch.float32, torch.float64)}
        assert jax64.wait(timeout=120) == 0
    finally:
        jax64.kill()
    j64 = np.load(paths[2])
    for p, pose in enumerate((0, RESONANT_POSE)):
        ref = port[torch.float64][p]
        assert frame_rel_err(ref, j64[p]) < 1e-9
        d_jax = np.abs(j32[p] - j64[p])
        d_port = np.abs(port[torch.float32][p] - ref)
        e_jax, e_port = (frame_rel_err(d + j64[p], j64[p]) for d in (d_jax, d_port))
        assert 0.5 <= e_jax / e_port <= 2.0, (pose, e_jax, e_port)
        if pose == RESONANT_POSE:
            assert e_jax > 1e-2 and e_port > 1e-2, (e_jax, e_port)
            for d in (d_jax, d_port):
                assert np.unravel_index(np.argmax(d), d.shape) == RESONANT_PIXEL
    ray, sample = RESONANT_PIXEL
    r = simulate_rays(torch.from_numpy(vol).double(), torch.from_numpy(src[1]).double(),
                      torch.from_numpy(dirs[ray:ray + 1]).double(), 512, "trilinear_plain")[1]
    assert float(r[0, :sample].min()) < -0.99


@pytest.mark.parametrize("which", ["bench", "apps"])
def test_cpu_times_the_eager_path_alone(records, which):
    """Off the card no graph is captured: the eager times beside the graphs'
    are None, no replay launched anything, and nothing was compared."""
    record = records[which][1]
    graphed = bt.GRAPHED if which == "bench" else bapps.GRAPHED
    assert set(record["graph_launches"]) == set(graphed)
    assert all(n == 0 for counts in record["graph_launches"].values() for n in counts.values())
    assert all(v is None for k, v in record.items() if "_eager_" in k)
    assert all(v is None for v in record["graph_equal"].values())
    assert record["gates"]["graph_launches"] and record["gates"]["graph_equal"]
