"""Legacy learning-rate scheduler module.

Counterpart of ``mxnet_tpu/misc.py`` (the reference's
``python/mxnet/misc.py``): the original
``LearningRateScheduler``/``FactorScheduler`` pair that predates
``lr_scheduler.py``. Kept for API compatibility; new code should use
:mod:`mxnet_tpu_torch.lr_scheduler`. Semantics match the reference: the factor
scheduler returns ``base_lr * factor**(iteration // step)`` and logs when
the rate changes.
"""
from __future__ import annotations

import logging

__all__ = ["LearningRateScheduler", "FactorScheduler"]


class LearningRateScheduler:
    """Base class: maps an iteration count to a learning rate. The owner
    (optimizer) assigns ``base_lr`` after construction, so the default
    here only matters for standalone use."""

    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, iteration):
        raise NotImplementedError("must override this")


class FactorScheduler(LearningRateScheduler):
    """Staircase decay: multiply the rate by ``factor`` once per ``step``
    iterations, i.e. ``base_lr * factor**(iteration // step)``.

    The schedule itself is stateless (any iteration can be queried out
    of order); the only state is the last rate returned, kept so each
    decay is logged exactly once.
    """

    def __init__(self, step, factor=0.1):
        super().__init__()
        if step < 1:
            raise ValueError("step must be a positive iteration count")
        if factor >= 1.0:
            raise ValueError("factor must be < 1 so the rate decays")
        self.step = step
        self.factor = factor
        self.old_lr = None

    def __call__(self, iteration):
        if self.old_lr is None:
            self.old_lr = self.base_lr
        lr = self.base_lr * self.factor ** (iteration // self.step)
        if lr != self.old_lr:
            self.old_lr = lr
            logging.info("Iteration %d: learning rate decayed to %.5f",
                         iteration, lr)
        return lr
