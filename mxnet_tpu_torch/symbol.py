"""Symbolic graph composition.

Counterpart of ``mxnet_tpu/symbol.py`` (the reference's
``python/mxnet/symbol.py`` and ``src/symbol/symbol.cc``): a Symbol is a
pure-Python DAG of ``_Node`` records. What must match the JAX package
exactly is the user-visible contract — argument ordering (DFS), naming
(``fc1_weight``, ``fc1_output``), composition and the JSON schema
(nodes/arg_nodes/heads) of checkpoints — so a graph saved by either
package loads in the other. ``bind``/``simple_bind`` give an
``Executor`` (``executor.py``), ``parallel.make_graph_fn`` executes a
symbol for the trainers, and the decoder walks ``_topo()`` itself. Type
inference works on torch dtypes and reports numpy types, as the JAX
package does (bfloat16, which numpy lacks, as ``torch.bfloat16``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .attribute import AttrScope
from .name import NameManager
from .ops import registry as _reg
from .ops.registry import REGISTRY, shape_assign

__all__ = ["Symbol", "Variable", "Group", "load", "load_json", "maximum",
           "minimum", "pow"]


class _Node:
    """One graph node: an operator application or a variable (op=None)."""

    __slots__ = ("op_name", "spec", "params", "name", "inputs", "attrs")

    def __init__(self, op_name, spec, params, name, inputs, attrs=None):
        self.op_name = op_name      # registered name used at creation
        self.spec = spec            # OpSpec or None for variables
        self.params = params        # parsed param dict
        self.name = name
        self.inputs = inputs        # list[(node, out_index)]
        self.attrs = attrs or {}

    @property
    def is_var(self):
        return self.spec is None

    def output_names(self):
        if self.is_var:
            return [self.name]
        outs = self.spec.outputs(self.params)
        if len(outs) == 1:
            return [self.name + "_output"]
        return [self.name + "_" + o for o in outs]


class Symbol:
    """A (possibly multi-output) view of a graph: list of (node, index)."""

    def __init__(self, heads):
        self._heads = list(heads)

    def _topo(self):
        """Post-DFS order over reachable nodes (reference DFSVisit —
        defines argument ordering)."""
        order, seen = [], set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._heads:
            visit(node)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo() if n.is_var]

    def list_outputs(self):
        return [node.output_names()[idx] for node, idx in self._heads]

    def list_auxiliary_states(self):
        out = []
        for n in self._topo():
            if not n.is_var:
                out.extend(n.name + "_" + a
                           for a in n.spec.aux_states(n.params))
        return out

    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    # -- attributes ------------------------------------------------------
    def attr(self, key):
        if len(self._heads) != 1:
            raise MXNetError("attr() needs a single-output symbol")
        return self._heads[0][0].attrs.get(key, None)

    def attr_dict(self):
        """name -> attrs for every node (reference list_attr(recursive))."""
        return {n.name: dict(n.attrs) for n in self._topo() if n.attrs}

    def _set_attr(self, **kwargs):
        node = self._heads[0][0]
        for k, v in kwargs.items():
            if not isinstance(v, str):
                raise MXNetError("attribute values must be strings")
            node.attrs[k] = v

    # -- composition ------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: replace free variables of a copy of self with the given
        symbols (reference Symbol::Compose, symbol.cc)."""
        name = kwargs.pop("name", None)
        s = self._clone()
        variables = {n.name: n for n in s._topo() if n.is_var}
        replace = {}
        if args:
            varnames = [n.name for n in s._topo() if n.is_var]
            if len(args) > len(varnames):
                raise MXNetError("too many positional compose args")
            for vn, sym in zip(varnames, args):
                replace[id(variables[vn])] = sym._single_head()
        for k, sym in kwargs.items():
            if not isinstance(sym, Symbol):
                raise MXNetError("compose expects Symbols")
            if k not in variables:
                raise MXNetError("unknown compose argument %s" % k)
            replace[id(variables[k])] = sym._single_head()
        if not replace:
            raise MXNetError("compose needs at least one argument")
        for n in s._topo():
            n.inputs = [replace[id(inp)] if id(inp) in replace else (inp, idx)
                        for inp, idx in n.inputs]
        s._heads = [replace[id(h)] if id(h) in replace else (h, i)
                    for h, i in s._heads]
        if name is not None and len(s._heads) == 1:
            s._heads[0][0].name = name
        return s

    def _single_head(self):
        if len(self._heads) != 1:
            raise MXNetError("expected single-output symbol")
        return self._heads[0]

    def _clone(self):
        """Deep-copy the graph structure; OpSpecs stay shared."""
        memo = {}

        def copy_node(node):
            if id(node) in memo:
                return memo[id(node)]
            new = _Node(node.op_name, node.spec,
                        dict(node.params) if node.params else {},
                        node.name, [], dict(node.attrs))
            memo[id(node)] = new
            new.inputs = [(copy_node(i), idx) for i, idx in node.inputs]
            return new

        return Symbol([(copy_node(n), i) for n, i in self._heads])

    def __copy__(self):
        return self._clone()

    def __deepcopy__(self, memo):
        return self._clone()

    def __reduce__(self):
        return (load_json, (self.tojson(),))

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %s not found; outputs: %s"
                                 % (index, names))
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (self[i] for i in range(len(self._heads)))

    def get_internals(self):
        """Group over every output of every node (reference GetInternals)."""
        heads = []
        for n in self._topo():
            nout = 1 if n.is_var else len(n.spec.outputs(n.params))
            heads.extend((n, i) for i in range(nout))
        return Symbol(heads)

    # arithmetic sugar (reference symbol.py __add__ etc.)
    def _binop(self, other, opname, scalar_op, rscalar_op=None, reverse=False):
        if isinstance(other, Symbol):
            if reverse:
                return _create(opname, [other, self], {})
            return _create(opname, [self, other], {})
        if isinstance(other, (int, float, np.number)):
            op = (rscalar_op or scalar_op) if reverse else scalar_op
            return _create(op, [self], {"scalar": float(other)})
        raise TypeError("unsupported operand type " + str(type(other)))

    def __add__(self, o):
        return self._binop(o, "_Plus", "_PlusScalar")

    def __radd__(self, o):
        return self._binop(o, "_Plus", "_PlusScalar", reverse=True)

    def __sub__(self, o):
        return self._binop(o, "_Minus", "_MinusScalar", "_RMinusScalar")

    def __rsub__(self, o):
        return self._binop(o, "_Minus", "_MinusScalar", "_RMinusScalar",
                           reverse=True)

    def __mul__(self, o):
        return self._binop(o, "_Mul", "_MulScalar")

    def __rmul__(self, o):
        return self._binop(o, "_Mul", "_MulScalar", reverse=True)

    def __truediv__(self, o):
        return self._binop(o, "_Div", "_DivScalar", "_RDivScalar")

    def __rtruediv__(self, o):
        return self._binop(o, "_Div", "_DivScalar", "_RDivScalar",
                           reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, o):
        return self._binop(o, "_Power", "_PowerScalar", "_RPowerScalar")

    def __neg__(self):
        return self.__mul__(-1.0)

    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes); (None,None,None)
        when underdetermined; raises MXNetError on inconsistency."""
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, s in zip(arg_names, args):
                if s is not None:
                    known[name] = tuple(s)
        for k, v in kwargs.items():
            if k in arg_names:
                known[k] = tuple(v)
        entry_shapes, aux_shapes_map = self._run_shape_inference(known)
        arg_shapes = []
        complete = True
        node_map = {n.name: n for n in self._topo() if n.is_var}
        for name in arg_names:
            s = entry_shapes.get((id(node_map[name]), 0))
            if s is None or any(x in (0, None) for x in s):
                complete = False
            arg_shapes.append(s)
        out_shapes = [entry_shapes.get((id(n), i)) for n, i in self._heads]
        aux_shapes = []
        for n in self._topo():
            if not n.is_var:
                aux_shapes.extend(aux_shapes_map.get(id(n), []))
        if not complete or any(s is None for s in out_shapes):
            return None, None, None
        return arg_shapes, out_shapes, aux_shapes

    def _run_shape_inference(self, known):
        entry = {}
        aux_map = {}
        topo = self._topo()
        for n in topo:
            if n.is_var and n.name in known:
                entry[(id(n), 0)] = tuple(known[n.name])
        for _ in range(3):  # fixpoint passes (weight shapes flow backward)
            changed = False
            for n in topo:
                if n.is_var:
                    continue
                in_shapes = [entry.get((id(inp), idx))
                             for inp, idx in n.inputs]
                try:
                    new_in, outs, auxs = n.spec.infer_shape(n.params, in_shapes)
                except MXNetError as e:
                    raise MXNetError("%s (op %s '%s')" % (e, n.op_name, n.name))
                for (inp, idx), s in zip(n.inputs, new_in):
                    if s is None:
                        continue
                    key = (id(inp), idx)
                    merged = shape_assign(entry.get(key), s,
                                          "input of " + n.name)
                    if merged != entry.get(key):
                        entry[key] = merged
                        changed = True
                for i, s in enumerate(outs):
                    if s is None:
                        continue
                    key = (id(n), i)
                    merged = shape_assign(entry.get(key), s,
                                          "output of " + n.name)
                    if merged != entry.get(key):
                        entry[key] = merged
                        changed = True
                if auxs and not any(a is None for a in auxs):
                    aux_map[id(n)] = [tuple(a) for a in auxs]
            if not changed:
                break
        return entry, aux_map

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) (reference symbol.py
        infer_type, static_graph.cc InferNodeTypes), or (None, None, None)
        when underdetermined. Types go in as anything ``torch_dtype``
        takes and come back as numpy types, bfloat16 as
        ``torch.bfloat16``."""
        from .ndarray import _np_dtype
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, t in zip(arg_names, args):
                if t is not None:
                    known[name] = torch_dtype(t)
        for k, v in kwargs.items():
            if k in arg_names:
                known[k] = torch_dtype(v)
        entry = {}
        aux_map = {}
        topo = self._topo()
        for n in topo:
            if n.is_var and n.name in known:
                entry[(id(n), 0)] = known[n.name]
        for _ in range(3):
            changed = False
            for n in topo:
                if n.is_var:
                    continue
                in_types = [entry.get((id(inp), idx)) for inp, idx in n.inputs]
                new_in, outs, auxs = n.spec.infer_type(n.params, in_types)
                for (inp, idx), t in zip(n.inputs, new_in):
                    if t is not None and entry.get((id(inp), idx)) is None:
                        entry[(id(inp), idx)] = torch_dtype(t)
                        changed = True
                for i, t in enumerate(outs):
                    if t is not None and entry.get((id(n), i)) is None:
                        entry[(id(n), i)] = torch_dtype(t)
                        changed = True
                aux_map[id(n)] = [torch_dtype(t) if t else None
                                  for t in auxs]
            if not changed:
                break
        var_types = {n.name: entry.get((id(n), 0)) for n in topo
                     if n.is_var}
        arg_types = [var_types[nm] for nm in arg_names]
        out_types = [entry.get((id(n), i)) for n, i in self._heads]
        aux_types = []
        for n in topo:
            if not n.is_var:
                aux_types.extend(aux_map.get(id(n), []))
        if any(t is None for t in arg_types) \
                or any(t is None for t in out_types):
            return None, None, None

        def np_type(t):
            t = _np_dtype(t)
            return t if t == torch.bfloat16 else t.type
        return ([np_type(t) for t in arg_types],
                [np_type(t) for t in out_types],
                [np_type(t) for t in aux_types])

    def debug_str(self):
        lines = []
        for n in self._topo():
            if n.is_var:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join("%s[%d]" % (inp.name, idx)
                                for inp, idx in n.inputs)
                lines.append("%s(%s) -> %s" % (n.op_name, ins, n.name))
        return "\n".join(lines)

    # -- binding (executor.py) ----------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    def simple_bind(self, ctx, grad_req="write", **kwargs):
        """Shape-inferred, allocated bind (reference symbol.py:590): every
        argument, gradient and aux state a zero NDArray on ``ctx``."""
        from . import ndarray as nd
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("simple_bind: cannot infer all shapes from %s"
                             % (kwargs,))
        arg_types, _, aux_types = self.infer_type()
        if arg_types is None:
            arg_types = [np.float32] * len(arg_shapes)
            aux_types = [np.float32] * len(aux_shapes)
        args = [nd.zeros(s, ctx, dtype=t)
                for s, t in zip(arg_shapes, arg_types)]
        if grad_req != "null":
            grads = {name: nd.zeros(s, ctx, dtype=t)
                     for name, s, t in
                     zip(self.list_arguments(), arg_shapes, arg_types)}
        else:
            grads = None
        aux = [nd.zeros(s, ctx, dtype=t)
               for s, t in zip(aux_shapes, aux_types)]
        return self.bind(ctx, args, grads, grad_req, aux)

    def grad(self, wrt):
        raise MXNetError(
            "Symbol.grad is not supported: bind with args_grad instead "
            "(the reference's graph-level grad is subsumed by jax.vjp)")

    def tojson(self):
        topo = self._topo()
        nid = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for n in topo:
            nodes.append({
                "op": "null" if n.is_var else n.op_name,
                "param": {} if n.is_var else n.spec.param_str(n.params),
                "name": n.name,
                "inputs": [[nid[id(inp)], idx] for inp, idx in n.inputs],
                "backward_source_id": -1,
                **({"attr": dict(n.attrs)} if n.attrs else {}),
            })
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(topo) if n.is_var],
            "heads": [[nid[id(n)], idx] for n, idx in self._heads],
        }, indent=2)

    def save(self, fname):
        """Write ``tojson()`` to ``fname``, a path or a URI
        (``stream.open_stream``)."""
        from .stream import open_stream  # URI dispatch (dmlc::Stream)
        with open_stream(fname, "w") as f:
            f.write(self.tojson())


def Variable(name, attr=None):
    """Create a variable symbol (reference symbol.py Variable)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = AttrScope.current().get(attr)
    return Symbol([(_Node(None, None, None, name, [], attrs), 0)])


def Group(symbols):
    """Group symbols into one multi-output symbol (reference Group)."""
    heads = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Expect Symbols in Group")
        heads.extend(s._heads)
    return Symbol(heads)


def _create(op_name, sym_args, kwargs):
    """Instantiate an operator node (the autogen atomic-symbol ctor path,
    reference symbol.py:914 _make_atomic_symbol_function)."""
    spec = _reg.get(op_name)
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    param_kwargs = {k: v for k, v in kwargs.items()
                    if not isinstance(v, Symbol)}
    # variadic ops infer num_args from the positional inputs
    if "num_args" in spec.params and "num_args" not in param_kwargs and sym_args:
        param_kwargs["num_args"] = len(sym_args)
    params = spec.parse_params(param_kwargs)
    attrs = AttrScope.current().get(attr)
    hint = op_name.lower().lstrip("_")
    name = NameManager.current().get(name, hint)

    arg_names = spec.arguments(params)
    inputs = [None] * len(arg_names)
    if len(sym_args) > len(arg_names):
        raise MXNetError("%s: too many positional inputs" % op_name)
    for i, s in enumerate(sym_args):
        if not isinstance(s, Symbol):
            raise TypeError("%s: positional inputs must be Symbols" % op_name)
        inputs[i] = s._single_head()
    for k, s in sym_kwargs.items():
        if k not in arg_names:
            raise MXNetError("%s: unknown input %s (expected %s)"
                             % (op_name, k, arg_names))
        i = arg_names.index(k)
        if inputs[i] is not None:
            raise MXNetError("%s: input %s given twice" % (op_name, k))
        inputs[i] = s._single_head()
    # missing inputs become free variables named <opname>_<argname>
    for i, inp in enumerate(inputs):
        if inp is None:
            var = Variable(name + "_" + arg_names[i])
            inputs[i] = var._single_head()
    node = _Node(op_name, spec, params, name, inputs, attrs)
    return Symbol([(node, i) for i in range(len(spec.outputs(params)))])


def load_json(json_str):
    """Load a symbol from the reference JSON schema."""
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        if jn["op"] == "null":
            n = _Node(None, None, None, jn["name"], [],
                      dict(jn.get("attr", {})))
        else:
            spec = _reg.get(jn["op"])
            params = spec.parse_params(jn.get("param", {}))
            n = _Node(jn["op"], spec, params, jn["name"], [],
                      dict(jn.get("attr", {})))
        nodes.append(n)
    for n, jn in zip(nodes, data["nodes"]):
        n.inputs = [(nodes[i], idx) for i, idx, *_ in jn["inputs"]]
    return Symbol([(nodes[i], idx) for i, idx in data["heads"]])


def load(fname):
    """A Symbol from a JSON file, a path or a URI (``stream.open_stream``)."""
    from .stream import open_stream
    with open_stream(fname, "r") as f:
        return load_json(f.read())


def _sym_or_scalar_binop(sym_op, scalar_op, name):
    def func(lhs, rhs):
        lsym, rsym = isinstance(lhs, Symbol), isinstance(rhs, Symbol)
        if lsym and rsym:
            return _create(sym_op, [lhs, rhs], {})
        if lsym:
            return _create(scalar_op, [lhs], {"scalar": float(rhs)})
        if rsym:
            # max/min are symmetric
            return _create(scalar_op, [rhs], {"scalar": float(lhs)})
        # two plain numbers: the reference computes the value directly
        if name == "maximum":
            return lhs if lhs > rhs else rhs
        return lhs if lhs < rhs else rhs
    func.__name__ = name
    return func


maximum = _sym_or_scalar_binop("_Maximum", "_MaximumScalar", "maximum")
minimum = _sym_or_scalar_binop("_Minimum", "_MinimumScalar", "minimum")


def pow(base, exp):
    """Elementwise power over symbols/scalars (reference symbol.py pow)."""
    bsym, esym = isinstance(base, Symbol), isinstance(exp, Symbol)
    if bsym and esym:
        return _create("_Power", [base, exp], {})
    if bsym:
        return _create("_PowerScalar", [base], {"scalar": float(exp)})
    if esym:
        return _create("_RPowerScalar", [exp], {"scalar": float(base)})
    raise TypeError("pow needs at least one Symbol")


# generated atomic symbol constructors: sym.FullyConnected etc.

def _make_symbol_function(op_name):
    def func(*args, **kwargs):
        return _create(op_name, list(args), kwargs)
    func.__name__ = op_name
    func.__doc__ = "%s operator (params: %s)." % (
        op_name, ", ".join(REGISTRY[op_name].params) or "none")
    return func


def _init_symbol_module():
    g = globals()
    for op_name in list(REGISTRY):
        if op_name not in g:
            g[op_name] = _make_symbol_function(op_name)


_init_symbol_module()
