"""Symbolic graph composition.

Counterpart of ``mxnet_tpu/symbol.py`` (the reference's
``python/mxnet/symbol.py`` and ``src/symbol/symbol.cc``): a Symbol is a
pure-Python DAG of ``_Node`` records. What must match the JAX package
exactly is the user-visible contract — argument ordering (DFS), naming
(``fc1_weight``, ``fc1_output``), composition and the JSON schema
(nodes/arg_nodes/heads) of checkpoints — so a graph saved by either
package loads in the other. ``parallel.make_graph_fn`` executes a
symbol and the decoder walks ``_topo()`` itself; binding (``Executor``)
belongs to a later slice.
"""
from __future__ import annotations

import json

import numpy as np

from .base import MXNetError
from .attribute import AttrScope
from .name import NameManager
from .ops import registry as _reg
from .ops.registry import REGISTRY, shape_assign

__all__ = ["Symbol", "Variable", "load", "load_json"]


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

    def _single_head(self):
        if len(self._heads) != 1:
            raise MXNetError("expected single-output symbol")
        return self._heads[0]

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
        with open(fname, "w") as f:
            f.write(self.tojson())


def Variable(name, attr=None):
    """Create a variable symbol (reference symbol.py Variable)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = AttrScope.current().get(attr)
    return Symbol([(_Node(None, None, None, name, [], attrs), 0)])


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
    with open(fname, "r") as f:
        return load_json(f.read())


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
