"""Checkpoints: ``prefix-symbol.json`` + ``prefix-NNNN.params``.

Counterpart of ``save_checkpoint``/``load_checkpoint`` in
``mxnet_tpu/model.py`` (the reference's ``model.py:311``/``:338``): the
same file names and ``arg:``/``aux:`` key prefixes, so a checkpoint
written by either package loads in the other. ``params_from_numpy``
carries parameters across from the JAX package (as numpy arrays) and
places them on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError, refuse_unported, torch_dtype
from .context import resolve_device

__all__ = ["save_checkpoint", "load_checkpoint", "params_from_numpy"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    optimizer_states=None):
    """Save ``prefix-symbol.json`` and ``prefix-%04d.params``.
    ``optimizer_states`` (the JAX package's ``prefix-%04d.states``)
    raises unless None: it belongs to a later slice."""
    refuse_unported("save_checkpoint",
                    optimizer_states=(optimizer_states, None))
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    symbol.save("%s-symbol.json" % prefix)
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params); arrays are CPU tensors."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def params_from_numpy(arg_params, device, dtype=None, symbol=None,
                      input_shapes=None):
    """Place a dict of numpy arrays (e.g. the JAX package's parameters,
    ``{k: np.asarray(v)}``) on ``device`` as torch tensors. The names and
    ``[out, in]`` layouts are the JAX package's own, so nothing is
    transposed. ``dtype`` casts floating arrays (integer ones keep
    theirs). With ``symbol`` (and ``input_shapes`` for its data inputs,
    e.g. ``{"data": (1, T)}``) every shape is checked against the
    symbol's ``infer_shape`` first, and a mismatch raises."""
    if symbol is not None:
        arg_shapes, _, _ = symbol.infer_shape(**dict(input_shapes or {}))
        if arg_shapes is None:
            raise MXNetError("params_from_numpy: the symbol's shapes are "
                             "underdetermined; pass input_shapes for its "
                             "data inputs")
        for name, want in zip(symbol.list_arguments(), arg_shapes):
            if name in arg_params \
                    and tuple(np.shape(arg_params[name])) != tuple(want):
                raise MXNetError(
                    "params_from_numpy: %s has shape %s, the symbol "
                    "wants %s" % (name, np.shape(arg_params[name]),
                                  tuple(want)))
    dev = resolve_device(device)
    cast = None if dtype is None else torch_dtype(dtype)
    out = {}
    for k, v in arg_params.items():
        t = torch.as_tensor(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else torch.as_tensor(v)
        if cast is not None and t.is_floating_point():
            t = t.to(cast)
        out[k] = t.to(dev)
    return out
