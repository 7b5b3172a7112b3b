"""Random sampling and global seeding.

Counterpart of ``mxnet_tpu/random.py`` (the reference's
``python/mxnet/random.py``: ``seed``, ``uniform``, ``normal`` over
``ndarray.cc:786-792``). The draws come from one explicit
``torch.Generator`` per device, made on first use; ``seed`` reseeds every
generator made so far and those made later, so one seed reproduces the
stream on each device. The values are not the JAX package's (a torch
generator cannot replay JAX's key splits): they are held by
reproducibility and by their moments.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import current_context
from .ndarray import _device, _maybe_out

__all__ = ["seed", "uniform", "normal"]

_GENERATORS = {}
_SEED = [None]


def _generator(device):
    gen = _GENERATORS.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_SEED[0] if _SEED[0] is not None
                        else int(np.random.randint(0, 2 ** 31 - 1)))
        _GENERATORS[device] = gen
    return gen


def seed(seed_state):
    """Seed the generators of every device (reference: random.py:39)."""
    if not isinstance(seed_state, (int, np.integer)):
        raise ValueError("seed_state must be int")
    _SEED[0] = int(seed_state)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED[0])


def _draw(fill, shape, ctx, out):
    if out is not None:
        shape, ctx = out.shape, out.context
    ctx = ctx or current_context()
    dev = _device(ctx)
    val = torch.empty(tuple(shape or (1,)), dtype=torch.float32, device=dev)
    fill(val, _generator(dev))
    return _maybe_out(val, out, ctx)


def uniform(low, high, shape=None, ctx=None, out=None):
    """Uniform samples in [low, high) (reference: random.py:12)."""
    return _draw(lambda t, g: t.uniform_(low, high, generator=g), shape,
                 ctx, out)


def normal(mean, stdvar, shape=None, ctx=None, out=None):
    """Gaussian samples (reference: random.py:26)."""
    return _draw(lambda t, g: t.normal_(mean, stdvar, generator=g), shape,
                 ctx, out)
