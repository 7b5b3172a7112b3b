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

import numpy as np

from ..base import MXNetError

REQUIRED = object()


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
