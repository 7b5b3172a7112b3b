"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (the reference's
``python/mxnet/initializer.py``): dispatch on the parameter's name
(``*_bias`` -> 0, ``*_gamma`` -> 1, ``*_beta`` -> 0, ``*_weight`` and
``*embed`` (e.g. ``pos_embed``) -> the weight draw, ``*_moving_mean`` ->
0, ``*_moving_var`` -> 1, ...), with ``Uniform``, ``Normal`` and
``Xavier`` draws. An initializer fills a torch tensor in place,
``init(name, tensor, generator)``; the draws come from the explicit
``torch.Generator`` on the host, then are copied to the tensor's device,
so one seed gives the same weights on every device. They are not the JAX
package's draws: tests carry weights across as numpy arrays instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Uniform", "Normal", "Xavier"]


class Initializer:
    """Base: dispatch on the parameter's name."""

    def __call__(self, name, arr, generator=None):
        if not isinstance(name, str):
            raise TypeError("name must be string")
        if not isinstance(arr, torch.Tensor):
            raise TypeError("arr must be a torch tensor")
        with torch.no_grad():
            self._dispatch(name, arr, generator)

    def _dispatch(self, name, arr, gen):
        if name.endswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            arr.fill_(0.0)
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        elif name.endswith("beta"):
            arr.fill_(0.0)
        elif name.endswith("weight"):
            self._init_weight(name, arr, gen)
        elif name.endswith("embed"):
            # learned embeddings (e.g. pos_embed) init like weights
            self._init_weight(name, arr, gen)
        elif "_expert_w" in name:
            self._init_expert(name, arr, gen)  # MoE expert kernels
        elif "_expert_b" in name:
            arr.fill_(0.0)
        elif name.endswith("moving_mean") or name.endswith("moving_avg"):
            arr.fill_(0.0)
        elif name.endswith("moving_var"):
            arr.fill_(1.0)
        else:
            raise ValueError("Unknown initialization pattern for %s" % name)

    @staticmethod
    def _init_bilinear(_, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype="float32")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr.copy_(torch.from_numpy(weight.reshape(shape)))

    def _init_expert(self, name, arr, gen):
        """MoE expert banks [X, out, in]: each expert's 2-D kernel on its
        own, so the fans are per expert."""
        if arr.dim() <= 2:
            self._init_weight(name, arr, gen)
            return
        for x in range(arr.shape[0]):
            self._init_weight(name, arr[x], gen)

    def _init_weight(self, name, arr, gen):
        raise NotImplementedError("Must override it")

    @staticmethod
    def _fill(arr, draw):
        arr.copy_(draw.to(arr.dtype))


class Uniform(Initializer):
    """Uniform draw on [-scale, scale]."""

    def __init__(self, scale=0.07):
        self.scale = float(scale)

    def _init_weight(self, _, arr, gen):
        draw = torch.rand(arr.shape, generator=gen) * (2 * self.scale) \
            - self.scale
        self._fill(arr, draw)


class Normal(Initializer):
    """Zero-mean gaussian draw with standard deviation ``sigma``."""

    def __init__(self, sigma=0.01):
        self.sigma = float(sigma)

    def _init_weight(self, _, arr, gen):
        self._fill(arr, torch.randn(arr.shape, generator=gen) * self.sigma)


class Xavier(Initializer):
    """Xavier/Glorot init: a draw scaled by ``sqrt(magnitude / factor)``,
    ``factor`` a fan statistic of the weight; convolution kernels
    [O, I, *K] count the receptive field into both fans."""

    _FACTOR = {"avg": lambda fi, fo: (fi + fo) / 2.0,
               "in": lambda fi, fo: fi,
               "out": lambda fi, fo: fo}

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if factor_type not in self._FACTOR:
            raise ValueError("Incorrect factor type")
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError("Unknown random type")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr, gen):
        receptive = float(np.prod(arr.shape[2:])) if arr.dim() > 2 else 1.0
        fans = arr.shape[1] * receptive, arr.shape[0] * receptive
        scale = math.sqrt(self.magnitude
                          / self._FACTOR[self.factor_type](*fans))
        if self.rnd_type == "uniform":
            draw = torch.rand(arr.shape, generator=gen) * (2 * scale) - scale
        else:
            draw = torch.randn(arr.shape, generator=gen) * scale
        self._fill(arr, draw)
