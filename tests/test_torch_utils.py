"""The port's ``utils`` against ``diffus_tpu.utils``: the debug guards raise
where JAX's do, and the timing helpers return positive times."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import diffus_tpu.utils as jutils
import diffus_tpu.utils.timing as jtiming
import diffus_tpu_torch.utils as tutils
import diffus_tpu_torch.utils.timing as ttiming
from diffus_tpu_torch.utils.debug import CheckError

# (function on the package's array module, input, JAX's message or None)
CASES = [
    (lambda m, x: m.log(x), [1.0, 2.0], None),
    (lambda m, x: m.log(x), [-1.0], "nan generated by primitive: log"),
    (lambda m, x: 1.0 / x, [0.0], "division by zero"),
    (lambda m, x: x * 2.0, [float("nan")], "nan generated by primitive: mul"),
    (lambda m, x: m.exp(x), [1000.0], None),                  # inf is not checked
    (lambda m, x: m.nan_to_num(m.log(x)), [-1.0], "nan generated by primitive: log"),
    (lambda m, x: m.sqrt(x - 3.0), [2.0, 4.0], "nan generated by primitive: sqrt"),
]


@pytest.mark.parametrize("fn, x, message", CASES,
                         ids=["ok", "log", "div", "nan-in", "inf", "cleaned", "sqrt"])
def test_checked_raises_where_jax_does(fn, x, message):
    jf = jutils.checked(lambda v: fn(jnp, v))
    tf = tutils.checked(lambda v: fn(torch, v))
    if message is None:
        np.testing.assert_allclose(tf(torch.tensor(x)).numpy(), np.asarray(jf(jnp.array(x))),
                                   rtol=1e-6)
        return
    with pytest.raises(checkify.JaxRuntimeError, match=message):
        jf(jnp.array(x))
    with pytest.raises(CheckError, match=message) as err:
        tf(torch.tensor(x))
    assert "test_torch_utils.py" in str(err.value)       # the caller's line


def test_checked_integer_division_by_zero():
    with pytest.raises(checkify.JaxRuntimeError, match="division by zero"):
        jutils.checked(lambda v: v // v)(jnp.array([0], jnp.int32))
    with pytest.raises(CheckError, match="division by zero"):
        tutils.checked(lambda v: v // v)(torch.tensor([0], dtype=torch.int32))
    assert tutils.checked(lambda v: v // 2)(torch.tensor([4])).tolist() == [2]


@pytest.mark.parametrize("tree, raises", [
    ({"a": np.ones(3, np.float32), "b": (np.arange(3),)}, False),
    ([np.array([1.0, np.nan], np.float32)], True),
    ((np.ones(2, np.float32), np.array([np.inf], np.float32)), True),
])
def test_assert_finite_matches(tree, raises):
    for fn, conv in ((jutils.assert_finite, jnp.asarray), (tutils.assert_finite, torch.as_tensor)):
        converted = [conv(leaf) for leaf in _leaves(tree)]
        if raises:
            with pytest.raises(FloatingPointError, match="bad: non-finite values in leaf"):
                fn(converted, "bad")
        else:
            assert fn(converted, "ok") is converted


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def test_profiling_helpers(tmp_path):
    with tutils.profile_trace(str(tmp_path)):
        with tutils.span("test.span"):
            torch.ones(64).sum()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "test.span" and e.get("cat") == "user_annotation"
               for e in events)


def test_timing_helpers_match_jax():
    assert ttiming.readback((torch.arange(4.0), "meta")) == jtiming.readback(
        (jnp.arange(4.0), "meta")) == 6.0
    assert ttiming.readback(()) == jtiming.readback(()) == 0.0
    assert ttiming.measure_sync_ms(n=2, device="cpu") > 0
    calls = []

    def fn(x):
        calls.append(float(x[0]))
        return x * 2

    args = [(torch.full((3,), float(i)),) for i in range(7)]
    assert ttiming.readback_time_ms(fn, args[:4], n=3) > 0
    # warm-up on args[0], then the timed calls on unique inputs in order
    assert calls == [0.0, 1.0, 2.0, 3.0]
    assert ttiming.readback_time_ms(fn, args[:4], n=3, sync_ms=1e9) > 0   # the floor
    with pytest.raises(ValueError, match="unique"):
        ttiming.readback_time_ms(fn, args[:4], n=4)
    calls.clear()
    assert ttiming.robust_readback_time_ms(fn, args, n=6, repeats=3) > 0
    assert calls == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    with pytest.raises(ValueError, match="unique"):
        ttiming.robust_readback_time_ms(fn, args[:3], n=6, repeats=3)
    with pytest.raises(ValueError, match="repeats"):
        ttiming.robust_readback_time_ms(fn, args, n=2, repeats=4)
