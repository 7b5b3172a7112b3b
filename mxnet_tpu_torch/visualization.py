"""Network visualization and summaries.

Counterpart of ``mxnet_tpu/visualization.py`` (pure Python over the
symbol; the text it makes is the JAX package's byte for byte). Parity:
``python/mxnet/visualization.py`` — ``plot_network`` (graphviz
digraph of a symbol) and ``print_summary`` (layer table with shapes and
parameter counts).
"""
from __future__ import annotations

import json

from .base import MXNetError
from . import symbol as sym_mod

__all__ = ["plot_network", "print_summary", "network_dot"]

_NODE_STYLE = {
    "FullyConnected": ("box", "#fb8072"),
    "Convolution": ("box", "#fb8072"),
    "Deconvolution": ("box", "#fb8072"),
    "Activation": ("box", "#ffffb3"),
    "LeakyReLU": ("box", "#ffffb3"),
    "BatchNorm": ("box", "#bebada"),
    "Pooling": ("box", "#80b1d3"),
    "Concat": ("box", "#fdb462"),
    "SoftmaxOutput": ("box", "#b3de69"),
    "Flatten": ("box", "#fdb462"),
    "Reshape": ("box", "#fdb462"),
}


def network_dot(symbol, title="plot", shape=None):
    """Build graphviz dot source for a symbol (no graphviz dependency)."""
    nodes = symbol._topo()
    shapes = {}
    if shape is not None:
        arg_shapes, out_shapes, _ = symbol.infer_shape(**shape)
        if arg_shapes is None:
            raise MXNetError("plot_network: cannot infer shapes")
        # map node -> primary output shape via internals
        internals = symbol.get_internals()
        _, int_shapes, _ = internals.infer_shape(**shape)
        for (node, idx), s in zip(internals._heads, int_shapes):
            shapes[(id(node), idx)] = s
    lines = ["digraph %s {" % json.dumps(title),
             'node [fontsize=10];', 'edge [fontsize=10];']
    ids = {}
    for i, n in enumerate(nodes):
        ids[id(n)] = "node%d" % i
        if n.is_var:
            label = n.name
            shape_attr, color = "oval", "#8dd3c7"
        else:
            label = "%s\\n%s" % (n.name, n.op_name)
            shape_attr, color = _NODE_STYLE.get(n.op_name, ("box", "#d9d9d9"))
        lines.append('%s [label="%s", shape=%s, style=filled, '
                     'fillcolor="%s"];' % (ids[id(n)], label, shape_attr,
                                           color))
    for n in nodes:
        if n.is_var:
            continue
        for inp, idx in n.inputs:
            attr = ""
            s = shapes.get((id(inp), idx))
            if s is not None:
                attr = ' [label="%s"]' % "x".join(str(x) for x in s)
            lines.append("%s -> %s%s;" % (ids[id(inp)], ids[id(n)], attr))
    lines.append("}")
    return "\n".join(lines)


def plot_network(symbol, title="plot", shape=None):
    """Return a ``graphviz.Digraph`` if graphviz is installed, else the
    dot source string (reference returns a Digraph; dot text keeps the
    function usable without the optional dependency)."""
    dot_src = network_dot(symbol, title=title, shape=shape)
    try:
        import graphviz
        return graphviz.Source(dot_src)
    except ImportError:
        return dot_src


def print_summary(symbol, shape=None, line_length=98):
    """Print a layer-by-layer summary table (reference print_summary)."""
    nodes = [n for n in symbol._topo()]
    shapes = {}
    param_shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, int_shapes, _ = internals.infer_shape(**shape)
        for (node, idx), s in zip(internals._heads, int_shapes):
            shapes[(id(node), 0 if idx else idx)] = s
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        param_shapes = dict(zip(symbol.list_arguments(), arg_shapes))
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]
    widths = [0.4, 0.25, 0.15, 0.2]
    positions = [int(line_length * sum(widths[:i + 1]))
                 for i in range(len(widths))]

    def print_row(cols):
        line = ""
        for c, pos in zip(cols, positions):
            line += str(c)
            line = line[:pos - 1].ljust(pos)
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total = 0
    data_names = set(shape or ())
    for n in nodes:
        if n.is_var:
            continue
        out_s = shapes.get((id(n), 0), "")
        n_params = 0
        for inp, _ in n.inputs:
            if inp.is_var and inp.name not in data_names \
                    and inp.name in param_shapes:
                ps = param_shapes[inp.name]
                k = 1
                for d in ps:
                    k *= d
                n_params += k
        total += n_params
        prev = ",".join(inp.name for inp, _ in n.inputs
                        if not inp.is_var)[:30]
        print_row(["%s (%s)" % (n.name, n.op_name), out_s, n_params, prev])
        print("_" * line_length)
    print("Total params: {:,}".format(total))
    print("_" * line_length)
    return total
