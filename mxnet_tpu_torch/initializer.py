"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (the reference's
``python/mxnet/initializer.py``): dispatch on the parameter's name
(``*_bias`` -> 0, ``*_gamma`` -> 1, ``*_beta`` -> 0, ``*_weight`` and
``*embed`` (e.g. ``pos_embed``) -> the weight draw, ``*_moving_mean`` ->
0, ``*_moving_var`` -> 1, ...), with ``Uniform``, ``Normal``, ``Xavier``,
``MSRAPrelu`` and ``Orthogonal`` draws; ``Load`` (from a parameter dict or
a ``.params`` file) and ``Mixed`` (by name pattern) compose them. An
initializer fills an NDArray or a torch tensor in place,
``init(name, arr, generator)``; the draws come from the explicit
``torch.Generator`` on the host, then are copied to the tensor's device,
so one seed gives the same weights on every device. They are not the JAX
package's draws: tests carry weights across as numpy arrays instead.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

__all__ = ["Initializer", "Load", "Mixed", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu"]


def _tensor(arr):
    """The tensor an NDArray wraps (its writes reach the NDArray)."""
    from .ndarray import _tensor_of
    return _tensor_of(arr)


class Initializer:
    """Base: dispatch on the parameter's name."""

    def __call__(self, name, arr, generator=None):
        if not isinstance(name, str):
            raise TypeError("name must be string")
        arr = _tensor(arr)
        if not isinstance(arr, torch.Tensor):
            raise TypeError("arr must be an NDArray or a torch tensor")
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


class Load:
    """Initialize from a parameter dict (or a ``.params`` file; ``arg:``
    and ``aux:`` prefixes are dropped), falling back to ``default_init``
    for the names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import _load_tensors
            param = _load_tensors(param)
        self.param = {}
        for name, arr in param.items():
            if name.startswith("arg:") or name.startswith("aux:"):
                name = name[4:]
            self.param[name] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        arr = _tensor(arr)
        if name in self.param:
            src = _tensor(self.param[name])
            if tuple(arr.shape) != tuple(np.shape(src)):
                raise ValueError(
                    "Parameter %s cannot be initialized from loading. "
                    "Shape mismatch, target %s vs loaded %s"
                    % (name, tuple(arr.shape), tuple(np.shape(src))))
            with torch.no_grad():
                arr.copy_(torch.as_tensor(np.asarray(src))
                          if not isinstance(src, torch.Tensor) else src)
        else:
            if self.default_init is None:
                raise ValueError(
                    "Cannot Initialize %s. Not found in loaded param and "
                    "no default Initializer is provided." % name)
            self.default_init(name, arr, generator)


class Mixed:
    """Initialize each parameter with the first initializer whose regex
    pattern matches its name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("Mixed needs one initializer a pattern")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator)
                return
        raise ValueError("Parameter name %s did not match any pattern."
                         % name)


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


class Orthogonal(Initializer):
    """Orthogonal init (Saxe et al. 2013): the weight's [out, in] matrix
    is ``scale`` times the orthonormal factor of an SVD of a uniform
    (``rand_type="uniform"``) or gaussian draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr, gen):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=gen,
                             dtype=torch.float64) * 2.0 - 1.0
        else:
            tmp = torch.randn((nout, nin), generator=gen,
                              dtype=torch.float64)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        self._fill(arr, (self.scale * res).reshape(arr.shape))


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


class MSRAPrelu(Xavier):
    """MSRA init for PReLU nets (He et al. 2015): a gaussian Xavier draw of
    magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
