"""Checkpoints of training state with ``torch.save``
(``diffus_tpu/train/checkpoint.py``, which uses orbax).

A checkpoint is one file.  A save over an existing checkpoint replaces
it, as orbax's ``force=True`` does: the state is written to a temporary
file beside it and moved into place with ``os.replace``, so a reader
never sees a half-written file.
"""

from __future__ import annotations

import os
import tempfile

import torch


def save_checkpoint(path: str, state) -> None:
    """Save ``state`` (e.g. ``{'params': state_dict, 'opt_state': ..., 'step': int}``)."""
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(state, fh)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, map_location=None):
    """Load a checkpoint written by :func:`save_checkpoint`: tensors, plain
    containers and numbers only (``weights_only=True``), never arbitrary
    pickled objects."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
