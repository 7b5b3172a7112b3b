"""Weight-update optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (the reference's
``python/mxnet/optimizer.py`` registry and SGD, ``src/optimizer/
sgd-inl.h``): the registry (``register``, ``create``), the base class's
lr, weight decay, ``rescale_grad``, ``clip_gradient`` and ``lr_scheduler``
plumbing, and ``SGD``/``ccSGD`` (momentum, weight decay). The update math
lives once, in ``SGD._step``, on lists of torch tensors and IN PLACE
(the weights and the momentum buffers are updated where they lie, so a
step allocates no second copy of either), with PyTorch's multi-tensor
``_foreach`` ops, so one update of all of a model's parameters is a few
launches instead of several per parameter; the imperative ``update()``
and the trainer's ``parallel.optim.make_functional`` both call it. The other
optimizers of the JAX package (Adam, AdamW, AdaFactor, SGLD, AdaGrad,
RMSProp, AdaDelta) belong to a later slice.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "ccSGD", "create", "register"]


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
        self.idx2name = {} if arg_names is None else dict(
            enumerate(arg_names))
        self.rescale_grad = float(rescale_grad)
        self.lr = float(learning_rate)
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = float(wd)
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr

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


register = Optimizer.register
create = Optimizer.create_optimizer


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
    def _step(self, ws, gs, moms, lr, wd):
        """For lists of weights ``ws``, gradients ``gs`` and momentum
        buffers ``moms`` (None without momentum): ``g' = clip(rescale *
        g) + wd * w``; without momentum ``w -= lr * g'``; with it ``mom =
        momentum * mom - lr * g'`` and ``w += mom``. ``ws`` and ``moms``
        are updated in place. ``lr`` is a float or a 0-dim tensor on the
        weights' device (the trainer's step program sets that tensor
        before each run); either way ``lr * g'`` is one product."""
        gs = self._clip_rescale(gs)
        if wd:
            torch._foreach_add_(gs, ws, alpha=wd)
        torch._foreach_mul_(gs, lr)
        if moms is None:
            torch._foreach_sub_(ws, gs)
        else:
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, gs)
            torch._foreach_add_(ws, moms)
        return ws, moms

    def update(self, index, weight, grad, state):
        lr = self._get_lr()
        self._update_count(index)
        self._step([weight], [grad], None if state is None else [state], lr,
                   self.wd)


@register
class ccSGD(SGD):
    """The reference's C++ SGD (src/optimizer/sgd-inl.h); the same math as
    SGD here."""
