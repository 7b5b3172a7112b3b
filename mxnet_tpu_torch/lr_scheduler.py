"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (the reference's
``python/mxnet/lr_scheduler.py``): ``FactorScheduler`` (lr *= factor every
``step`` updates), ``MultiFactorScheduler`` (at each step of a list),
``CosineScheduler`` (linear warmup, then cosine decay) and
``PolyScheduler`` (polynomial decay). Schedulers are called with the
global update count.
"""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "CosineScheduler", "PolyScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^(floor(num_update/step))."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at %0.5e, "
                             "will not change in the future", num_update,
                             self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Reduce lr by factor at each step in an increasing step list."""

    def __init__(self, step, factor=1):
        super().__init__()
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay from base_lr to final_lr over max_update steps, after a
    linear warmup from warmup_begin_lr over warmup_steps."""

    def __init__(self, max_update, final_lr=0.0, warmup_steps=0,
                 warmup_begin_lr=0.0):
        super().__init__()
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        if warmup_steps >= max_update:
            raise ValueError("warmup_steps must be < max_update")
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.warmup_begin_lr + \
                (self.base_lr - self.warmup_begin_lr) * \
                num_update / max(self.warmup_steps, 1)
        t = min(num_update - self.warmup_steps,
                self.max_update - self.warmup_steps)
        frac = t / (self.max_update - self.warmup_steps)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            0.5 * (1 + math.cos(math.pi * frac))


class PolyScheduler(LRScheduler):
    """Polynomial decay: lr = final_lr + (base_lr - final_lr) * (1 -
    t/max_update)^power."""

    def __init__(self, max_update, power=2.0, final_lr=0.0):
        super().__init__()
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = max_update
        self.power = power
        self.final_lr = final_lr

    def __call__(self, num_update):
        t = min(num_update, self.max_update)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1.0 - t / self.max_update) ** self.power
