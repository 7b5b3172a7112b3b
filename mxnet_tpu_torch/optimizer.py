"""Weight-update optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (the reference's
``python/mxnet/optimizer.py``, ``src/optimizer/sgd-inl.h``): the registry
(``register``, ``create``), the base class's lr, weight decay,
``rescale_grad``, ``clip_gradient``, per-index lr scales and
``lr_scheduler`` plumbing, the optimizers ``SGD``, ``ccSGD``, ``SGLD``,
``Adam``, ``AdamW``, ``AdaFactor``, ``AdaGrad``, ``RMSProp``, ``AdaDelta``
and ``Test``, and ``get_updater`` with its state snapshots.

Each optimizer's math lives once, in its ``_step``, IN PLACE (the weights
and the state are updated where they lie, so an update allocates no
second copy of either). The elementwise optimizers' ``_step`` takes lists
of weights, gradients and state buffers and runs PyTorch's multi-tensor
``_foreach`` ops, so an update of all of a model's parameters is a few
launches whatever their number; AdaFactor's takes one weight (its
factored moments and its RMS clip are per weight). The imperative
``update()`` calls ``_step`` with the learning rate and the update count
``t`` as host floats (the bias corrections in ``math``); the trainers'
functional adapters (``parallel.optim.make_functional``) call the same
``_step`` with both as 0-dim device tensors, which a captured step reads
afresh at every replay.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .ndarray import _tensor_of

__all__ = ["Optimizer", "SGD", "SGLD", "ccSGD", "Adam", "AdamW",
           "AdaGrad", "RMSProp", "AdaDelta", "AdaFactor", "Test", "create",
           "get_updater", "register"]


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _pow(base, e):
    """``base ** e`` on the device when either is a tensor, else on the
    host."""
    if isinstance(base, torch.Tensor) or isinstance(e, torch.Tensor):
        return torch.pow(base, e)
    return base ** e


class Optimizer:
    """Base optimizer with the reference's registry and lr plumbing."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, rescale_grad=1.0, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise ValueError("Cannot find optimizer %s" % name)
        return Optimizer.opt_registry[name.lower()](
            rescale_grad=rescale_grad, **kwargs)

    def __init__(self, rescale_grad=1.0, arg_names=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None):
        self.sym = sym  # kept for parity with the JAX package
        self.rescale_grad = float(rescale_grad)
        self.lr = float(learning_rate)
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = float(wd)
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}
        self.lr_scale = {}
        self.idx2name = {} if arg_names is None else dict(
            enumerate(arg_names))

    def set_lr_scale(self, args_lrscale):
        """Per-index lr multipliers (reference ``set_lr_scale``)."""
        self.lr_scale = args_lrscale.copy()

    def set_lr_mult(self, args_lr_mult):
        self.lr_scale = args_lr_mult.copy()

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self.lr_scale.get(index, 1.0)

    def create_state(self, index, weight):
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _clip_rescale(self, gs):
        """``rescale_grad * g`` for each of the gradients ``gs``, clipped
        to ``clip_gradient`` (new tensors; ``gs`` are left as they
        were)."""
        gs = torch._foreach_mul(gs, self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(gs, -self.clip_gradient)
            torch._foreach_clamp_max_(gs, self.clip_gradient)
        return gs

    def _lr_t(self, index):
        """(lr, t) of the next update of ``index``, counting it."""
        lr = self._get_lr(index)
        self._update_count(index)
        return lr, self._index_update_count[index]


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros(weight, n):
    return tuple(torch.zeros_like(weight) for _ in range(n))


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay (reference optimizer.py:163,
    src/optimizer/sgd-inl.h:21-161)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = float(momentum)

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def _step(self, ws, gs, bufs, lr, t=None, gen=None):
        """``g' = clip(rescale * g) + wd * w``; without momentum ``w -= lr
        * g'``; with it (``bufs = [moms]``) ``mom = momentum * mom - lr *
        g'`` and ``w += mom``."""
        gs = self._clip_rescale(gs)
        if self.wd:
            torch._foreach_add_(gs, ws, alpha=self.wd)
        torch._foreach_mul_(gs, lr)
        if not bufs:
            torch._foreach_sub_(ws, gs)
        else:
            (moms,) = bufs
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, gs)
            torch._foreach_add_(ws, moms)

    def update(self, index, weight, grad, state):
        lr, _ = self._lr_t(index)
        self._step([weight], [grad], [] if state is None else [[state]], lr)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference optimizer.py:254):
    ``w -= lr / 2 * g'`` plus gaussian noise of standard deviation
    ``sqrt(lr)``, drawn from ``gen`` (the default generator of the
    weight's device in ``update()``)."""

    def create_state(self, index, weight):
        return None

    @torch.no_grad()
    def _step(self, ws, gs, bufs, lr, t=None, gen=None):
        gs = self._clip_rescale(gs)
        if self.wd:
            torch._foreach_add_(gs, ws, alpha=self.wd)
        torch._foreach_mul_(gs, lr / 2)
        torch._foreach_sub_(ws, gs)
        noise = [torch.randn(w.shape, generator=gen, device=w.device,
                             dtype=w.dtype) for w in ws]
        torch._foreach_mul_(noise, _sqrt(lr))
        torch._foreach_add_(ws, noise)

    def update(self, index, weight, grad, state):
        lr, _ = self._lr_t(index)
        self._step([weight], [grad], [], lr)


@register
class ccSGD(SGD):
    """The reference's C++ SGD (src/optimizer/sgd-inl.h); the same math as
    SGD here."""


@register
class Adam(Optimizer):
    """Adam (reference optimizer.py:425; Kingma & Ba 2014) with the
    time-step bias correction, ``t`` the weight's own update count (the
    JAX package's: the reference's shared ``time`` realized per index)."""

    decoupled = False

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, decay_factor=(1 - 1e-8), **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.decay_factor = decay_factor

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def _step(self, ws, gs, bufs, lr, t, gen=None):
        """``bufs = [means, vars]``. ``lr_t = lr sqrt(1 - beta2^t) / (1 -
        beta1^t)``; ``m = beta1 m + (1 - beta1) g'``, ``v = beta2 v + (1 -
        beta2) g'^2``, ``w -= lr_t m / (sqrt(v) + eps)``. Adam folds the
        weight decay into ``g'``; AdamW subtracts ``lr wd w`` from the
        weight instead."""
        means, variances = bufs
        lr_t = lr * _sqrt(1.0 - _pow(self.beta2, t)) \
            / (1.0 - _pow(self.beta1, t))
        gs = self._clip_rescale(gs)
        decay = None
        if self.wd and self.decoupled:
            decay = torch._foreach_mul(ws, lr * self.wd)
        elif self.wd:
            torch._foreach_add_(gs, ws, alpha=self.wd)
        torch._foreach_mul_(means, self.beta1)
        torch._foreach_add_(means, gs, alpha=1 - self.beta1)
        torch._foreach_mul_(variances, self.beta2)
        torch._foreach_addcmul_(variances, gs, gs, value=1 - self.beta2)
        denom = torch._foreach_sqrt(variances)
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_div(means, denom)
        torch._foreach_mul_(upd, lr_t)
        torch._foreach_sub_(ws, upd)
        if decay is not None:
            torch._foreach_sub_(ws, decay)

    def update(self, index, weight, grad, state):
        lr, t = self._lr_t(index)
        self._step([weight], [grad], [[state[0]], [state[1]]], lr, t)


@register
class AdamW(Adam):
    """Adam with DECOUPLED weight decay (Loshchilov & Hutter 2017): ``w -=
    lr wd w`` beside the adaptive step, scaled by the schedule's lr but
    not by the bias correction."""

    decoupled = True


@register
class AdaFactor(Optimizer):
    """Adafactor (Shazeer & Stern 2018): for rank >= 2 weights the second
    moment is a row factor and a column factor (``v ~ r (x) c / mean(r)``),
    ``beta2_t = 1 - t^-decay_rate``, the update RMS-clipped at
    ``clipping_threshold`` and (``scale_by_param``) scaled by ``max(eps2,
    RMS(w))``; ``beta1 > 0`` adds a first moment; the weight decay is
    decoupled."""

    def __init__(self, learning_rate=0.01, beta1=0.0, decay_rate=0.8,
                 epsilon1=1e-30, epsilon2=1e-3, clipping_threshold=1.0,
                 scale_by_param=True, factored=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = float(beta1)
        self.decay_rate = float(decay_rate)
        self.epsilon1 = float(epsilon1)
        self.epsilon2 = float(epsilon2)
        self.clipping_threshold = float(clipping_threshold)
        self.scale_by_param = bool(scale_by_param)
        self.factored = bool(factored)

    def _factored(self, shape):
        return self.factored and len(shape) >= 2

    def create_state(self, index, weight):
        shape, kw = tuple(weight.shape), dict(dtype=weight.dtype,
                                              device=weight.device)
        if self._factored(shape):
            state = [torch.zeros(shape[:-1], **kw),
                     torch.zeros(shape[:-2] + shape[-1:], **kw)]
        else:
            state = [torch.zeros(shape, **kw)]
        if self.beta1 > 0:
            state.append(torch.zeros(shape, **kw))
        return state

    @torch.no_grad()
    def _step(self, w, g, state, lr, t):
        """One weight ``w`` and its ``state`` (laid out as
        ``create_state``'s), in place."""
        (g,) = self._clip_rescale([g])
        beta2t = 1.0 - _pow(t, -self.decay_rate)
        g2 = g * g + self.epsilon1
        if self._factored(w.shape):
            vr, vc = state[0], state[1]
            vr.mul_(beta2t).add_(g2.mean(dim=-1) * (1 - beta2t))
            vc.mul_(beta2t).add_(g2.mean(dim=-2) * (1 - beta2t))
            r = vr / vr.mean(dim=-1, keepdim=True)
            u = g / (torch.sqrt(r)[..., None]
                     * torch.sqrt(vc)[..., None, :])
        else:
            v = state[0]
            v.mul_(beta2t).add_(g2 * (1 - beta2t))
            u = g / torch.sqrt(v)
        rms_u = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms_u / self.clipping_threshold, min=1.0)
        scale = lr
        if self.scale_by_param:
            scale = lr * torch.clamp(torch.sqrt(torch.mean(w * w)),
                                     min=self.epsilon2)
        u = scale * u
        if self.beta1 > 0:
            m = state[-1]
            m.mul_(self.beta1).add_(u * (1 - self.beta1))
            u = m
        decay = w * (lr * self.wd) if self.wd else None
        w.sub_(u)
        if decay is not None:
            w.sub_(decay)

    def update(self, index, weight, grad, state):
        lr, t = self._lr_t(index)
        self._step(weight, grad, state, lr, float(t))


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference optimizer.py:550; Duchi et al. 2011)."""

    def __init__(self, learning_rate=0.05, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    @torch.no_grad()
    def _step(self, ws, gs, bufs, lr, t=None, gen=None):
        """``bufs = [hists]``: ``h += g'^2``, ``w -= lr (g' / sqrt(h +
        eps) + wd w)``."""
        (hists,) = bufs
        gs = self._clip_rescale(gs)
        torch._foreach_addcmul_(hists, gs, gs)
        denom = torch._foreach_add(hists, self.float_stable_eps)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_div(gs, denom)
        if self.wd:
            torch._foreach_add_(upd, ws, alpha=self.wd)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(ws, upd)

    def update(self, index, weight, grad, state):
        lr, _ = self._lr_t(index)
        self._step([weight], [grad], [[state]], lr)


@register
class RMSProp(Optimizer):
    """RMSProp (reference optimizer.py:586; Tieleman & Hinton, with the
    Graves-style momentum terms gamma1/gamma2)."""

    def __init__(self, learning_rate=0.002, gamma1=0.95, gamma2=0.9,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2

    def create_state(self, index, weight):
        return _zeros(weight, 3)  # n, g, delta

    @torch.no_grad()
    def _step(self, ws, gs, bufs, lr, t=None, gen=None):
        """``bufs = [ns, gavgs, deltas]``: ``n = (1 - g1) g'^2 + g1 n``,
        ``gavg = (1 - g1) g' + g1 gavg``, ``delta = g2 delta - lr g' /
        sqrt(n - gavg^2 + 1e-4)``, ``w += delta``."""
        ns, gavgs, deltas = bufs
        gs = self._clip_rescale(gs)
        if self.wd:
            torch._foreach_add_(gs, ws, alpha=self.wd)
        torch._foreach_mul_(ns, self.gamma1)
        torch._foreach_addcmul_(ns, gs, gs, value=1 - self.gamma1)
        torch._foreach_mul_(gavgs, self.gamma1)
        torch._foreach_add_(gavgs, gs, alpha=1 - self.gamma1)
        denom = torch._foreach_addcmul(ns, gavgs, gavgs, value=-1.0)
        torch._foreach_add_(denom, 1e-4)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_div(gs, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_mul_(deltas, self.gamma2)
        torch._foreach_sub_(deltas, upd)
        torch._foreach_add_(ws, deltas)

    def update(self, index, weight, grad, state):
        lr, _ = self._lr_t(index)
        self._step([weight], [grad], [[s] for s in state], lr)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference optimizer.py:662; Zeiler 2012); no learning
    rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def _step(self, ws, gs, bufs, lr=None, t=None, gen=None):
        """``bufs = [acc_gs, acc_deltas]``: ``acc_g = rho acc_g + (1 - rho)
        g'^2``, ``d = sqrt(acc_delta + eps) / sqrt(acc_g + eps) g'``,
        ``acc_delta = rho acc_delta + (1 - rho) d^2``, ``w -= wd w + d``."""
        acc_gs, acc_deltas = bufs
        gs = self._clip_rescale(gs)
        torch._foreach_mul_(acc_gs, self.rho)
        torch._foreach_addcmul_(acc_gs, gs, gs, value=1 - self.rho)
        cur = torch._foreach_add(acc_deltas, self.epsilon)
        torch._foreach_sqrt_(cur)
        den = torch._foreach_add(acc_gs, self.epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(cur, den)
        torch._foreach_mul_(cur, gs)
        torch._foreach_mul_(acc_deltas, self.rho)
        torch._foreach_addcmul_(acc_deltas, cur, cur, value=1 - self.rho)
        if self.wd:
            torch._foreach_sub_(ws, torch._foreach_mul(ws, self.wd))
        torch._foreach_sub_(ws, cur)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._step([weight], [grad], [[s] for s in state])


@register
class Test(Optimizer):
    """Test optimizer: ``w -= rescale * g`` (reference optimizer.py:718);
    the imperative state holds the new weight."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    @torch.no_grad()
    def _step(self, ws, gs, bufs, lr=None, t=None, gen=None):
        torch._foreach_sub_(ws, torch._foreach_mul(gs, self.rescale_grad))
        for dst in bufs:
            torch._foreach_copy_(dst, ws)

    def update(self, index, weight, grad, state):
        self._step([weight], [grad], [[state]])


def _state_to_host(state):
    """Optimizer state -> picklable host structure: tensor leaves become
    numpy arrays; tuple/list/None structure is kept. Numpy leaves only, so
    the JAX package's ``set_states`` reads the blob too."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_state_to_host(s) for s in state)
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy().copy()
    return np.asarray(state)


def _state_from_host(state):
    """Inverse of :func:`_state_to_host`: leaves come back as CPU
    tensors."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_state_from_host(s) for s in state)
    return torch.from_numpy(np.array(state))


def _state_to(state, device):
    """A state (restored on the host by ``set_states``) on ``device``."""
    if isinstance(state, (tuple, list)):
        return type(state)(_state_to(x, device) for x in state)
    if isinstance(state, torch.Tensor) and state.device != device:
        return state.to(device)
    return state


def get_updater(optimizer):
    """Close an optimizer into ``updater(index, grad, weight)`` (tensors
    or NDArrays, updated in place) with lazily created per-index state
    (reference ``get_updater``).

    ``get_states()``/``set_states()`` snapshot and restore the per-index
    state and the optimizer's update counts (bias corrections, lr
    schedules), so a resumed run continues the same trajectory; the
    snapshot is the JAX package's, numpy leaves included, so either
    package restores the other's."""
    states = {}
    restored = set()  # indices whose state set_states left on the host

    def updater(index, grad, weight):
        # NDArrays update through their tensors (views of their storage)
        grad, weight = _tensor_of(grad), _tensor_of(weight)
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        elif index in restored:
            restored.discard(index)
            states[index] = _state_to(states[index], weight.device)
        optimizer.update(index, weight, grad, states[index])

    def get_states():
        return {
            "states": {k: _state_to_host(v) for k, v in states.items()},
            "update_count": dict(optimizer._index_update_count),
            "num_update": optimizer.num_update,
        }

    def set_states(blob):
        states.clear()
        states.update({k: _state_from_host(v)
                       for k, v in blob["states"].items()})
        restored.clear()
        restored.update(states)
        optimizer._index_update_count = dict(blob["update_count"])
        optimizer.num_update = blob["num_update"]

    updater.states = states
    updater.optimizer = optimizer
    updater.get_states = get_states
    updater.set_states = set_states
    return updater
