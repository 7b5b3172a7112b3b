"""Functional optimizer adapters for the fused trainer.

Counterpart of ``mxnet_tpu/parallel/optim.py`` (l.29-46): each
``optimizer.Optimizer`` maps to an ``(init_fn, update_fn)`` pair,

    state              = init_fn(weight)
    new_ws, new_states = update_fn(weights, grads, states, lr, t)

``update_fn`` takes lists of tensors (all of a model's parameters at
once, where the JAX package maps it over a pytree); ``lr`` is a float or
a 0-dim tensor on the weights' device (the trainer's captured step reads
it from there); ``t`` is the 1-based update count (SGD does not read it:
a captured step would see only its value at capture). The math is the
optimizer's own (``SGD._step``), so the imperative and the fused paths
agree. PyTorch runs eagerly, so
``update_fn`` updates the weights and the states IN PLACE, under
``torch.no_grad()``, and returns them.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .. import optimizer as opt_mod

__all__ = ["make_functional"]


def _sgd(opt):
    def init(w):
        return opt.create_state(None, w)

    @torch.no_grad()
    def update(ws, gs, states, lr, t):
        moms = None if opt.momentum == 0.0 else list(states)
        opt._step(list(ws), list(gs), moms, lr, opt.wd)
        return ws, states
    return init, update


_FACTORIES = {opt_mod.SGD: _sgd}


def make_functional(optimizer):
    """(init_fn, update_fn) for an Optimizer instance (dispatch over MRO,
    so ccSGD, an SGD subclass, resolves to the SGD math)."""
    for klass in type(optimizer).__mro__:
        if klass in _FACTORIES:
            return _FACTORIES[klass](optimizer)
    raise MXNetError("no functional adapter for optimizer %s (the PyTorch "
                     "port has SGD and ccSGD so far)"
                     % type(optimizer).__name__)
