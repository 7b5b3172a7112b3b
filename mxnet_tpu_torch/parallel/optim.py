"""Functional optimizer adapters and the trainers' optimizer-state layout.

Counterpart of ``mxnet_tpu/parallel/optim.py`` (l.29-178): each
``optimizer.Optimizer`` maps to an ``(init_fn, update_fn)`` pair,

    state = init_fn(weight)
    update_fn(weights, grads, states, lr, t, gen)

``init_fn`` returns a weight's state as the tuple of its leaves in the
JAX package's tree order (SGD with momentum: ``(mom,)``; Adam and AdamW:
``(mean, var)``; RMSProp: ``(n, g, delta)``; AdaFactor: ``(vr, vc)`` or
``(v,)``, then ``m`` with ``beta1``; plain SGD, SGLD and Test: ``()``).
``update_fn`` takes lists (the units the trainer updates: the whole flat
parameter buffer at once for the elementwise optimizers, each weight for
AdaFactor, whose ``update_fn.per_weight`` is True) and updates the
weights and the states IN PLACE under ``torch.no_grad()``. ``lr`` and
``t`` (the 1-based update count: Adam's bias correction, AdaFactor's
``beta2_t``) are host numbers or 0-dim f32 tensors on the weights'
device: a captured step reads them from there at every replay, where a
host number would be frozen at its value at capture. ``gen`` is the
generator SGLD draws its noise from (one registered with the trainer's
captured step). The math is the optimizer's own ``_step``, so the
imperative and the fused paths agree.

:class:`FlatOptState` lays the state out once for ``ParallelTrainer``,
``SequenceParallelTrainer`` and ``PipelineTrainer``; for ZeRO-1 it holds
one rank's chunk of it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .. import optimizer as opt_mod

__all__ = ["make_functional", "FlatOptState"]


def _elementwise(nleaves):
    """The adapter of an optimizer whose ``_step`` works on lists of
    tensors element by element, with ``nleaves(opt)`` state buffers a
    weight."""
    def factory(opt):
        n = nleaves(opt)

        def init(w):
            return tuple(torch.zeros_like(w) for _ in range(n))

        @torch.no_grad()
        def update(ws, gs, states, lr, t, gen=None):
            bufs = [list(b) for b in zip(*states)] if n else []
            opt._step(list(ws), list(gs), bufs, lr, t, gen)
        return init, update
    return factory


def _adafactor(opt):
    def init(w):
        return tuple(opt.create_state(None, w))

    @torch.no_grad()
    def update(ws, gs, states, lr, t, gen=None):
        for w, g, s in zip(ws, gs, states):
            opt._step(w, g, list(s), lr, t)
    update.per_weight = True
    return init, update


_FACTORIES = {
    opt_mod.SGD: _elementwise(lambda o: int(o.momentum != 0.0)),
    opt_mod.SGLD: _elementwise(lambda o: 0),
    opt_mod.Adam: _elementwise(lambda o: 2),   # AdamW is a subclass
    opt_mod.AdaFactor: _adafactor,
    opt_mod.AdaGrad: _elementwise(lambda o: 1),
    opt_mod.RMSProp: _elementwise(lambda o: 3),
    opt_mod.AdaDelta: _elementwise(lambda o: 2),
    # the JAX adapter keeps no state (the imperative Test holds w)
    opt_mod.Test: _elementwise(lambda o: 0),
}


def make_functional(optimizer):
    """(init_fn, update_fn) for an Optimizer instance (dispatch over the
    MRO, so ccSGD resolves to SGD's math and AdamW to Adam's adapter,
    whose ``_step`` reads the decoupled decay)."""
    for klass in type(optimizer).__mro__:
        if klass in _FACTORIES:
            return _FACTORIES[klass](optimizer)
    raise MXNetError("no functional adapter for optimizer %s"
                     % type(optimizer).__name__)


class FlatOptState:
    """The optimizer state of a flat parameter buffer.

    The trainers keep their parameters in ONE flat f32 buffer (``names``
    in order, of ``shapes``; the buffer may end in padding that no name
    covers). An elementwise optimizer's state is its leaves a weight as
    flat buffers of the same size, updated in one ``update_fn`` call over
    the whole buffer (a few launches whatever the number of weights);
    AdaFactor's factored moments are per weight, so its leaves are tensors
    of their own and its update runs per weight, over views of the
    parameter and gradient buffers.

    ZeRO-1 (``shards > 1``, elementwise optimizers only): the flat buffer
    is padded to a multiple of ``shards``, and this state covers chunk
    ``index`` of it, ``1/shards`` of the whole: :meth:`update` updates that
    chunk of the parameters alone, the other ranks update theirs, and the
    trainer all-gathers the chunks. Every shipped elementwise optimizer
    computes each element from that element's weight, gradient and state
    alone, so the chunked update equals the whole one bit for bit.

    The buffers are allocated once: a captured step holds their addresses
    (``buffers()`` is its ``mutable=`` list), so :meth:`reset` and
    :meth:`load` copy into them and never rebind them.
    """

    def __init__(self, optimizer, names, shapes, flat, shards=1, index=0):
        self.init_fn, self._update = make_functional(optimizer)
        self.per_weight = getattr(self._update, "per_weight", False)
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self._numels = [int(np.prod(s)) for s in self.shapes]
        self.shards, self.index = int(shards), int(index)
        if self.shards > 1 and (self.per_weight
                                or flat.numel() % self.shards):
            raise MXNetError("FlatOptState: %d shards need an elementwise "
                             "optimizer over a buffer padded to a multiple "
                             "of them" % self.shards)
        self.units = self._fresh(flat)

    def chunk(self, flat):
        """This state's chunk of a flat buffer (the whole when unsharded)."""
        if self.shards == 1:
            return flat
        return flat.view(self.shards, -1)[self.index]

    def _fresh(self, flat):
        if self.per_weight:
            return [tuple(self.init_fn(v)) for v in self.views(flat)]
        return [tuple(self.init_fn(self.chunk(flat)))]

    def views(self, flat):
        """Each weight's view of a flat buffer, in its shape."""
        flat = flat.narrow(0, 0, sum(self._numels))
        return [p.view(s) for p, s in zip(flat.split(self._numels),
                                          self.shapes)]

    def buffers(self):
        """Every state tensor, once."""
        return [b for unit in self.units for b in unit]

    def by_name(self):
        """``{name: (leaf, ...)}``: each weight's state leaves in the JAX
        package's tree order (views of the flat buffers for an
        elementwise optimizer). A chunked state has no whole leaves: the
        trainer gathers the chunks."""
        if self.per_weight:
            return dict(zip(self.names, self.units))
        if self.shards > 1:
            raise MXNetError("FlatOptState.by_name: a ZeRO-1 chunk holds "
                             "no whole leaf; gather the chunks first")
        per_leaf = [self.views(b) for b in self.units[0]]
        return {n: tuple(v[i] for v in per_leaf)
                for i, n in enumerate(self.names)}

    @torch.no_grad()
    def update(self, flat, grad, lr, t, gen=None):
        """One update of ``flat`` (this state's chunk of it) by the flat
        gradient ``grad``."""
        if self.per_weight:
            self._update(self.views(flat), self.views(grad), self.units,
                         lr, t, gen)
        else:
            self._update([self.chunk(flat)], [self.chunk(grad)], self.units,
                         lr, t, gen)

    @torch.no_grad()
    def reset(self, flat):
        """Back to the optimizer's initial state for ``flat``."""
        for bufs, fresh in zip(self.units, self._fresh(flat)):
            for b, v in zip(bufs, fresh):
                b.copy_(v)

    @torch.no_grad()
    def load(self, leaves_by_name, what="set_optimizer_states"):
        """Copy ``{name: [array, ...]}`` (each weight's leaves in the JAX
        package's order, numpy arrays or tensors) into the buffers."""
        for name, have in self.by_name().items():
            vals = leaves_by_name.get(name)
            if vals is None or len(vals) != len(have):
                raise MXNetError(
                    "%s: checkpoint state for %r does not match this "
                    "trainer's optimizer (saved %s leaves, need %d) — "
                    "resuming a run under a different optimizer is not "
                    "supported" % (what, name,
                                   "no" if vals is None else len(vals),
                                   len(have)))
            for dst, v in zip(have, vals):
                src = v.detach() if isinstance(v, torch.Tensor) \
                    else torch.from_numpy(np.array(v))
                if tuple(src.shape) != tuple(dst.shape):
                    raise MXNetError("%s: state of %r has shape %s, the "
                                     "trainer's %s" % (
                                         what, name, tuple(src.shape),
                                         tuple(dst.shape)))
                dst.copy_(src)
