"""Failure detection: explicit NaN and division guards for debugging
(``diffus_tpu/utils/debug.py``).

The renderer keeps the reference's silent ``nan_to_num`` after the solve,
so a degenerate scene (zero-impedance regions, a singular system) turns
into zeros.  :func:`checked` makes that visible: it runs a function with
every PyTorch operation checked, as JAX's ``checkify`` with its float
checks does, and raises at the first operation that produced a NaN or
divided by zero, naming the operation and the line of the caller's code
that ran it.  Every check copies a flag to the host, so on the card each
operation synchronizes the device: a debugging tool, never the hot path.
"""

from __future__ import annotations

import functools
import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# operations whose second operand (or only, for reciprocal) divides
_DIVISIONS = frozenset(("div", "floor_divide", "remainder", "fmod", "reciprocal"))
_TORCH_DIR = os.path.dirname(torch.__file__)


class CheckError(FloatingPointError):
    """A :func:`checked` function produced a NaN or divided by zero."""


def _caller() -> str:
    """``file:line (function)`` of the innermost frame outside torch and
    this module: the user's line that ran the failing operation."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename != __file__ and not frame.filename.startswith(_TORCH_DIR):
            return f"{frame.filename}:{frame.lineno} ({frame.name})"
    return "unknown"


def _any(pred, tree) -> bool:
    return any(bool(pred(t).any()) for t in tree_leaves(tree)
               if torch.is_tensor(t) and (t.is_floating_point() or t.is_complex()
                                          or pred is _is_zero))


def _is_zero(t: torch.Tensor) -> torch.Tensor:
    return t == 0


class _FloatChecks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _DIVISIONS:
            divisor = args[0] if name == "reciprocal" else args[1]
            if (_any(_is_zero, divisor) if torch.is_tensor(divisor) else divisor == 0):
                raise CheckError(f"division by zero at {_caller()}")
        out = func(*args, **(kwargs or {}))
        if _any(torch.isnan, out):
            raise CheckError(f"nan generated by primitive: {name} at {_caller()}")
        return out


def checked(fn):
    """Wrap ``fn`` so that it raises :class:`CheckError` where the unchecked
    version would produce a NaN in any operation, or divide by zero.

    Returns a callable with the same signature.  Every operation is checked
    on the host (a device synchronization each): use it while debugging,
    not in the hot path.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapper


def assert_finite(tree, name: str = "value"):
    """Raise ``FloatingPointError`` if a floating leaf of ``tree`` (nested
    tuples, lists, dicts of tensors or arrays) holds a NaN or an infinity.
    Copies a flag to the host, so it waits for the device."""
    for i, leaf in enumerate(tree_leaves(tree)):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{name}: non-finite values in leaf {i}")
    return tree
