"""The general generator: the same seed gives the same units."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import inputs, manifest, traffic

APEX = [128.0, 4.0, 128.0]


def _mix(name: str) -> dict:
    return json.loads((manifest.BENCH / "traffic" / f"{name}.json").read_text())


def _same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("mix", ["sweep256", "train50", "recover8"])
def test_generator_is_deterministic(mix):
    m = _mix(mix)
    seed = 2**31 + 12345

    def draw(s):
        if m["kind"] == "sweep":
            return traffic.sweep(m, APEX, 4, s)
        if m["kind"] == "train":
            return traffic.train(m, APEX, s, "cpu")
        return traffic.recover(dict(m, starts=8, radius=3.0, rot_scale=0.05), APEX, s, "cpu")

    assert _same(draw(seed), draw(seed))
    assert not _same(draw(seed), draw(seed + 1))


def test_sweep_requests_are_segments():
    m = _mix("sweep256")
    for scene, src in traffic.sweep(m, APEX, 4, 99)[:4]:
        assert 0 <= scene < 4 and src.shape == (256, 3) and src.dtype == torch.float32
        step = (src[1:] - src[:-1]).double().norm(dim=-1)
        assert torch.allclose(step, torch.full_like(step, 0.5), atol=1e-4)
        assert float(src[:, 1].sub(4.0).abs().max()) == 0.0


def test_inputs_are_deterministic():
    cfg = {"kind": "impedance", "shape": [16, 16, 16], "count": 2, "texture": 0.03,
           "texture_grid": 4}
    a, b = inputs.volumes(cfg, 5, "cpu"), inputs.volumes(cfg, 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[0], a[1])
    assert float(min(v.min() for v in a)) >= 400.0 * (1 - 1e-6)   # air is 400 Rayl
    w1 = inputs.mlp_weights((32, 32), 3, inputs.generator(5, "cpu", 6))
    w2 = inputs.mlp_weights((32, 32), 3, inputs.generator(5, "cpu", 6))
    assert all(torch.equal(x, y) for p, q in zip(w1, w2) for x, y in zip(p, q))
    assert [tuple(t.shape) for t in w1[0]] == [(32, 1), (32,), (32, 32), (32,), (1, 32), (1,)]


def test_checked_units_include_the_first():
    picks = traffic.checked(4, 48, 123)
    assert picks[0] == 0 and len(picks) == 4 and picks == traffic.checked(4, 48, 123)


def test_checked_updates_are_drawn_in_their_ranges():
    ranges = [[13, 37], [4, 8]]
    picks = [traffic.checked_updates(ranges, 2**40 + s, u) for s in range(4) for u in range(8)]
    assert all(13 <= a <= 37 and 4 <= b <= 8 for a, b in picks)
    assert len({a for a, _ in picks}) > 3
    assert traffic.checked_updates(ranges, 9, 1) == traffic.checked_updates(ranges, 9, 1)
    for name in ("train50", "recover8"):
        assert all(lo >= 4 for lo, _ in _mix(name)["check_updates"])   # replays
