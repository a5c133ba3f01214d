"""``chip_smoke.py``'s trajectory check (phases 7 and 10) on made-up
trajectories, on the CPU: what it holds, which starts it drops, and when
it fails."""

import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
T, S, C = 3, 4, 3
NEAR_SHARE = SMOKE.NEAR / 10   # a made-up plain path this far off stays near f64


def _traj(seed: int = 0) -> dict:
    """An f64 trajectory of S starts that moves 0.5-1.5 a step, and plain and
    kernel copies 1e-5 of a move from it (the kernel's 1.5x the plain's)."""
    g = torch.Generator().manual_seed(seed)
    steps = torch.rand((T, S, C), generator=g, dtype=torch.float64) + 0.5
    f64 = {"x": torch.cat([torch.zeros(1, S, C, dtype=torch.float64), steps.cumsum(0)]),
           "grad x": torch.rand((T, S, C), generator=g, dtype=torch.float64) + 0.5,
           "loss": torch.rand((T, S), generator=g, dtype=torch.float64) + 1.0}

    def off(scale):
        return {"x": f64["x"] + scale * 1e-5, "grad x": f64["grad x"] * (1 + scale * 1e-5),
                "loss": f64["loss"] * (1 + scale * 1e-5)}

    return {"f64": f64, "plain": off(1.0), "kernel": off(1.5)}


def test_kernel_within_the_floor_passes_and_every_start_is_kept():
    out = SMOKE._trajectory_check("made up", _traj(), 1e-3, 1e-3)
    assert out["kept_until"] == [T] * S
    assert [r["kept"] for r in out["rows"]] == [S] * T


@pytest.mark.parametrize("name", ["x", "grad x", "loss"])
def test_kernel_beyond_twice_the_plain_distance_fails(name):
    traj = _traj()
    rows = slice(1, None) if name == "x" else slice(None)
    traj["plain"][name][rows] = traj["f64"][name][rows] * (1 + NEAR_SHARE / 3)
    traj["kernel"][name][rows] = traj["f64"][name][rows] * (1 + 5 * NEAR_SHARE / 3)
    with pytest.raises(AssertionError, match=f"{name}: the kernel path"):
        SMOKE._trajectory_check("made up", traj, 1e-4, 1e-4)
    out = SMOKE._trajectory_check("made up", traj, 1e-4, 1e-4, strict=False)
    assert all(r["kernel_beyond"] for r in out["rows"])


@pytest.mark.parametrize("name", ["x", "grad x"])
def test_a_start_leaves_where_its_plain_path_leaves_f64(name):
    """From the step where start 1's plain f32 state or gradient is not
    within NEAR of f64, the kernel path there is held to nothing (NaN
    included); the other starts are held as before."""
    traj = _traj()
    rows = 2 if name == "x" else 1   # steps 2 and 3: state row t is after update t
    traj["plain"][name][rows:, 1] += 10.0
    traj["kernel"][name][rows:, 1] = float("nan")
    out = SMOKE._trajectory_check("made up", traj, 1e-3, 1e-3)
    assert out["kept_until"] == [T, 1, T, T]
    bad = _traj()
    bad["kernel"]["x"][2:, 0] += 1.0
    bad["plain"][name][rows:, 1] += 10.0
    with pytest.raises(AssertionError, match="start 0"):
        SMOKE._trajectory_check("made up", bad, 1e-3, 1e-3)


def test_a_start_leaves_where_its_plain_path_is_not_finite():
    traj = _traj()
    traj["plain"]["loss"][1, 2] = float("inf")
    traj["kernel"]["loss"][1:, 2] = float("nan")
    assert SMOKE._trajectory_check("made up", traj, 1e-3, 1e-3)["kept_until"] == [T, T, 1, T]


def test_a_kernel_path_not_finite_where_plain_is_fails():
    traj = _traj()
    traj["kernel"]["grad x"][0, 3, 0] = float("nan")
    with pytest.raises(AssertionError, match="not finite at step 1, start 3"):
        SMOKE._trajectory_check("made up", traj, 1e-3, 1e-3)


def test_every_start_leaving_fails():
    traj = _traj()
    traj["plain"]["x"][T:] += 10.0
    with pytest.raises(AssertionError, match="every start left"):
        SMOKE._trajectory_check("made up", traj, 1e-3, 1e-3)


def test_distances_are_in_units_of_the_f64_move_and_gradient():
    traj = _traj()
    dist = SMOKE._trajectory_distances(traj)
    moved = (traj["f64"]["x"][1:] - traj["f64"]["x"][0]).abs().amax(dim=(1, 2))
    unit = torch.cummax(moved, dim=0).values[:, None]
    assert torch.allclose(dist["x"]["plain"], torch.full((T, S), 1e-5, dtype=torch.float64)
                          / unit)
    scale = traj["f64"]["grad x"].abs().amax(dim=-1)
    want = (traj["f64"]["grad x"] * 1e-5).abs().amax(dim=-1) / scale
    assert torch.allclose(dist["grad x"]["plain"], want)
    assert torch.allclose(dist["loss"]["kernel"], torch.full((T, S), 1.5e-5,
                                                             dtype=torch.float64))
