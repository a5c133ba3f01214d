"""Faults planted in the program underneath a run, to see ``correct``
come out false: each is a context manager that patches the port.

- ``state_unchanged``: an optimizer step that runs and leaves the
  parameters as they were (a rate of 0);
- ``state_unchanged_replay``: the same in the captured step alone, which
  its replays repeat, the eager steps before the capture as they are;
- ``half_batch``: half of the rays left out, their place taken by the
  other half's (a mean over the rest of the batch);
- ``altered``: one value of every frame altered where it is produced,
  and every loss of a training or recovery step (5% more).

One chip, so there is no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "state_unchanged_replay", "half_batch", "altered")
STEP_FAULTS = ("state_unchanged", "state_unchanged_replay")   # of cells with an optimizer


def _half_rays(fn):
    def wrapped(*args, **kwargs):
        idx, vals = fn(*args, **kwargs)
        n = vals.shape[-2]
        keep = vals.narrow(-2, 0, n // 2)
        rest = vals.narrow(-2, 2 * (n // 2), n - 2 * (n // 2))
        return idx, torch.cat([keep, keep, rest], -2)
    return wrapped


def _altered(fn):
    def wrapped(*args, **kwargs):
        idx, vals = fn(*args, **kwargs)
        bump = torch.zeros_like(vals)
        bump[..., 0, -1] = 0.05 * vals.detach().abs().amax()
        return idx, vals + bump
    return wrapped


def _scaled(fn):
    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs) * 1.05
    return wrapped


def _rate_zero(step, captured_only: bool):
    """``Adam.step`` with every group's rate 0 for the step (in a capture
    only, with ``captured_only``): its moments and step count advance,
    its parameters stay."""
    def wrapped(self, *args, **kwargs):
        if captured_only and not (torch.cuda.is_available()
                                  and torch.cuda.is_current_stream_capturing()):
            return step(self, *args, **kwargs)
        rates = [g["lr"] for g in self.param_groups]
        for g in self.param_groups:
            g["lr"] = g["lr"] * 0 if torch.is_tensor(g["lr"]) else 0.0
        try:
            return step(self, *args, **kwargs)
        finally:
            for g, lr in zip(self.param_groups, rates):
                g["lr"] = lr
    # as hooked as the step it wraps, so that the optimizer's hooks run once a step
    wrapped.hooked = getattr(step, "hooked", False)
    return wrapped


@contextlib.contextmanager
def planted(fault: str | None):
    """The port with ``fault`` planted (nothing for None)."""
    if fault is None:
        yield
        return
    import diffus_tpu_torch.render.renderer as renderer
    import diffus_tpu_torch.serve as serve
    import diffus_tpu_torch.train.impedance_train as impedance_train
    import diffus_tpu_torch.train.pose_recovery as pose_recovery

    saved = [(torch.optim.Adam, "step", torch.optim.Adam.step),
             (impedance_train, "_loss_value", impedance_train._loss_value),
             (pose_recovery, "pose_loss", pose_recovery.pose_loss)] + [
        (m, "_render", m._render) for m in (renderer, serve, pose_recovery)]
    try:
        if fault in STEP_FAULTS:
            torch.optim.Adam.step = _rate_zero(torch.optim.Adam.step,
                                               fault == "state_unchanged_replay")
        elif fault in ("half_batch", "altered"):
            fn = (_half_rays if fault == "half_batch" else _altered)(renderer._render)
            for m in (renderer, serve, pose_recovery):
                m._render = fn
            if fault == "altered":
                impedance_train._loss_value = _scaled(impedance_train._loss_value)
                pose_recovery.pose_loss = _scaled(pose_recovery.pose_loss)
        else:
            raise ValueError(f"unknown fault {fault!r}; the faults are {FAULTS}")
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)
