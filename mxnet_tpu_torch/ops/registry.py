"""Declarative operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py`` (the reference's
``OperatorProperty`` registry and ``dmlc::Parameter`` typed
hyperparameters). An op is declarative metadata plus a forward function
on torch tensors: ``forward(params, ins, aux, is_train, generator)``
returns ``(outs, new_aux)``; ``generator`` is the ``torch.Generator`` of
ops that draw random numbers at training time.
"""
from __future__ import annotations

import ast
import contextlib
import threading

import numpy as np
import torch

from ..base import MXNetError

REQUIRED = object()


_TAPE = threading.local()


class DrawTape:
    """The training draws of one forward, kept for its recompute.

    A checkpointed forward (``parallel.sharded.remat_walk``, a 1F1B
    stage's backward) runs its ops twice; under ``record()`` every draw
    of :func:`uniform` and :func:`keep_mask` is kept, and under
    ``replay()`` the same draws are handed back in order instead of drawn
    again, so the recompute applies the forward's dropout masks and rrelu
    slopes. The generators are not touched: no state is read or set, so
    it holds under CUDA graph capture, and the step leaves them where a
    step without the recompute does (the JAX package's ``jax.checkpoint``
    replays the same key). A dropout site keeps its bool mask, the bytes
    a step without the recompute saves for its backward."""

    def __init__(self):
        self.draws = []
        self._next = None

    @contextlib.contextmanager
    def record(self):
        self.draws, self._next = [], None
        with self._active():
            yield self

    @contextlib.contextmanager
    def replay(self):
        self._next = 0
        with self._active():
            yield self

    @contextlib.contextmanager
    def _active(self):
        held = getattr(_TAPE, "tape", None)
        _TAPE.tape = self
        try:
            yield
        finally:
            _TAPE.tape = held

    def _draw(self, make):
        if self._next is None:
            out = make()
            self.draws.append(out)
            return out
        if self._next >= len(self.draws):
            raise MXNetError("recompute draws more than its forward drew")
        out = self.draws[self._next]
        self._next += 1
        return out


def _drawn(make):
    tape = getattr(_TAPE, "tape", None)
    return make() if tape is None else tape._draw(make)


def uniform(shape, generator, device, dtype=torch.float32):
    """An op's training draw: ``torch.rand(shape)`` from ``generator``,
    or, inside a :class:`DrawTape`, the draw its forward recorded."""
    return _drawn(lambda: torch.rand(tuple(shape), generator=generator,
                                     device=device, dtype=dtype))


def keep_mask(shape, keep, generator, device):
    """A dropout mask: ``torch.rand(shape) < keep`` from ``generator``,
    or, inside a :class:`DrawTape`, the mask its forward recorded."""
    return _drawn(lambda: torch.rand(tuple(shape), generator=generator,
                                     device=device) < keep)


def _parse_shape(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    if isinstance(v, str):
        val = ast.literal_eval(v)
        if isinstance(val, (tuple, list)):
            return tuple(int(x) for x in val)
        return (int(val),)
    raise MXNetError("cannot parse shape param: %r" % (v,))


def _parse_bool(v):
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes")
    return bool(v)


_PARSERS = {
    "int": lambda v: int(float(v)) if isinstance(v, str) else int(v),
    "float": float,
    "bool": _parse_bool,
    "str": str,
    "shape": _parse_shape,
}


class Param:
    """A typed hyperparameter (dmlc::Parameter field equivalent)."""

    def __init__(self, ptype, default=REQUIRED, desc=""):
        if ptype not in _PARSERS:
            raise ValueError("unknown param type " + ptype)
        self.ptype = ptype
        self.default = default
        self.desc = desc

    def parse(self, value):
        return _PARSERS[self.ptype](value)


class OpSpec:
    """Base class for operator specifications: subclasses set ``name``
    and ``params`` ({pname: Param}) and override the interface methods."""

    name = None
    aliases = ()
    params = {}

    def arguments(self, p):
        """Ordered data-input names (ListArguments)."""
        return ["data"]

    def outputs(self, p):
        """Output names (ListOutputs)."""
        return ["output"]

    def aux_states(self, p):
        """Auxiliary (non-differentiable, op-mutated) state names."""
        return []

    def is_collective(self, p):
        """True for an op that computes across the ranks of a mesh axis
        (ring attention): the SPMD walk of ``parallel/graph.py`` then calls
        its ``forward_ranks`` with every rank's inputs at once."""
        return False

    def integer_arguments(self, p):
        """Argument names whose values are INDICES (class ids, token ids).
        Mixed-precision compute casts must skip them: bfloat16 represents
        integers exactly only up to 256, so casting a label or token
        tensor silently corrupts ids above that."""
        return ()

    def infer_shape(self, p, in_shapes):
        """(in_shapes) -> (in_shapes, out_shapes, aux_shapes); ``None``
        entries for what cannot be inferred yet, MXNetError on
        inconsistency."""
        raise NotImplementedError

    def infer_type(self, p, in_types):
        """(in_types) -> (in_types, out_types, aux_types) as torch dtypes,
        ``None`` where unknown. Default: every input takes the first known
        input's type, the outputs follow it, the aux states are f32."""
        dt = next((t for t in in_types if t is not None), None)
        return ([dt] * len(in_types), [dt] * len(self.outputs(p)),
                [torch.float32] * len(self.aux_states(p)))

    def forward(self, p, ins, aux, is_train, generator):
        """(list of tensors, aux list) -> (outs, new_aux)."""
        raise NotImplementedError

    def parse_params(self, kwargs):
        p = {}
        for k, v in kwargs.items():
            if k not in self.params:
                raise MXNetError("%s: unknown parameter %s" % (self.name, k))
            p[k] = self.params[k].parse(v)
        for k, pd in self.params.items():
            if k not in p:
                if pd.default is REQUIRED:
                    raise MXNetError("%s: missing required parameter %s"
                                     % (self.name, k))
                p[k] = pd.default
        return p

    def param_str(self, p):
        """Stringify params for JSON serialization (dmlc-style)."""
        return {k: _to_str(v) for k, v in p.items()}


def _to_str(v):
    if isinstance(v, tuple):
        return "(" + ",".join(str(x) for x in v) + ")"
    if isinstance(v, bool):
        return "True" if v else "False"
    return str(v)


REGISTRY: dict[str, OpSpec] = {}


def register(cls):
    """Class decorator: instantiate and register an OpSpec."""
    spec = cls()
    assert spec.name, cls
    REGISTRY[spec.name] = spec
    for alias in spec.aliases:
        REGISTRY[alias] = spec
    return cls


def get(name):
    if name not in REGISTRY:
        raise MXNetError("operator %s is not registered" % name)
    return REGISTRY[name]


def shape_assign(cur, expect, what):
    """Merge a possibly-unknown current shape with an expected one
    (SHAPE_ASSIGN_CHECK equivalent: 0/None dims are wildcards)."""
    if cur is None:
        return expect
    if expect is None:
        return cur
    if len(cur) != len(expect):
        raise MXNetError("shape mismatch for %s: %s vs %s" % (what, cur, expect))
    out = []
    for a, b in zip(cur, expect):
        if a in (0, None):
            out.append(b)
        elif b in (0, None):
            out.append(a)
        elif a != b:
            raise MXNetError("shape mismatch for %s: %s vs %s" % (what, cur, expect))
        else:
            out.append(a)
    return tuple(out)


def same_shape_infer(p, in_shapes, n_out=1):
    """All inputs and outputs share one shape (elementwise ops)."""
    known = None
    for s in in_shapes:
        known = shape_assign(known, s, "elementwise input")
    return [known] * len(in_shapes), [known] * n_out, []
