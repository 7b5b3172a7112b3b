"""Executor: a bound symbol graph on NDArrays.

Counterpart of ``mxnet_tpu/executor.py`` (l.63-418; the reference's
``python/mxnet/executor.py`` over ``graph_executor.cc``: bind, then
forward and backward with ``grad_req`` write/add/null, aux states that
the forward updates, the monitor callback). Where the JAX package traces
the graph into one program and keeps ``jax.vjp``'s residuals, the port
walks the graph eagerly (``ops.fusion.eval_graph`` with the executor's
``FusionPlan``, so the fused chains run as the repo's kernels on the
card: ``fused_linear``, ``fused_conv_bn_act``, ``matmul_stats``,
``flash_attention``), and torch autograd keeps the residuals:

* ``forward(is_train=True)`` reads the current storage of ``arg_arrays``
  at every call (users write ``exe.arg_dict["data"][:] = batch`` between
  calls), records the walk for autograd, and writes the outputs and the
  new aux states (BatchNorm's moving statistics) into their NDArrays with
  ``copy_``. The recorded graph lives until the next ``forward``, so
  ``backward`` twice after one ``forward`` gives the same gradients (and
  ``grad_req="add"`` adds them twice).
* ``backward`` after an inference forward recomputes the train forward
  for its residuals and discards its aux updates (JAX l.227-238).
* Each kernel reaches its backward through its ``autograd.Function``.
* ``MXNET_BACKWARD_DO_MIRROR=1`` runs the walk under
  ``torch.utils.checkpoint`` (non-reentrant): the activations are
  recomputed in the backward. The draws of dropout come from a copy of
  the executor's generator taken before the walk, so the recomputation
  draws the same values.
* ``reshape`` returns an executor over views of this one's arrays.

The walk is eager: the executor's programs are not captured as CUDA
graphs.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Executor"]


def _normalize_dict_or_list(vals, names, what, allow_missing=False):
    if vals is None:
        return [None] * len(names)
    if isinstance(vals, dict):
        out = []
        for n in names:
            if n in vals:
                out.append(vals[n])
            elif allow_missing:
                out.append(None)
            else:
                raise MXNetError("%s: missing entry for %s" % (what, n))
        return out
    vals = list(vals)
    if len(vals) != len(names):
        raise MXNetError("%s: expected %d entries, got %d"
                         % (what, len(names), len(vals)))
    return vals


def _nbytes(arrays):
    return sum(a.size * a._tensor.element_size() for a in arrays
               if a is not None)


class Executor:
    """A bound computation graph."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None,
                 _outputs=None):
        self._symbol = symbol
        self._ctx = ctx
        self._device = resolve_device(ctx)
        self._group2ctx = group2ctx or {}
        self._monitor_callback = None
        self._monitor_should_run = None

        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self._arg_names = arg_names
        self._aux_names = aux_names

        self.arg_arrays = _normalize_dict_or_list(args, arg_names, "args")
        if any(a is None for a in self.arg_arrays):
            raise MXNetError("bind: every argument needs an array")
        self.grad_arrays = _normalize_dict_or_list(
            args_grad, arg_names, "args_grad", allow_missing=True)
        self.aux_arrays = _normalize_dict_or_list(
            aux_states, aux_names, "aux_states")
        shapes = {n: a.shape for n, a in zip(arg_names, self.arg_arrays)}
        if any(a is None for a in self.aux_arrays):
            # bind without aux states allocates zeros of the inferred shapes
            _, _, aux_shapes = symbol.infer_shape(**shapes)
            if aux_shapes is None:
                raise MXNetError("bind: cannot infer aux shapes")
            self.aux_arrays = [a if a is not None else nd.zeros(s, ctx)
                               for a, s in zip(self.aux_arrays, aux_shapes)]

        if isinstance(grad_req, str):
            reqs = [grad_req] * len(arg_names)
        elif isinstance(grad_req, dict):
            reqs = [grad_req.get(n, "null") for n in arg_names]
        else:
            reqs = list(grad_req)
        self._grad_req = ["null" if g is None else r
                          for r, g in zip(reqs, self.grad_arrays)]

        arg_shapes, out_shapes, _ = symbol.infer_shape(**shapes)
        if out_shapes is None:
            raise MXNetError("bind: cannot infer output shapes from %s"
                             % (shapes,))
        for name, a, s in zip(arg_names, self.arg_arrays, arg_shapes):
            if tuple(a.shape) != tuple(s):
                raise MXNetError("bind: argument %s has shape %s, expected "
                                 "%s" % (name, a.shape, s))
        if _outputs is not None:
            self._out_arrays = _outputs
        else:
            arg_types = [a.dtype for a in self.arg_arrays]
            _, out_types, _ = symbol.infer_type(*arg_types)
            if out_types is None:
                out_types = [self.arg_arrays[0].dtype] * len(out_shapes)
            self._out_arrays = [nd.empty(s, ctx, dtype=t)
                                for s, t in zip(out_shapes, out_types)]

        from .ops.fusion import FusionPlan
        self._topo = symbol._topo()
        self._fusion_plan = FusionPlan(self._topo, symbol._heads)
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)))
        self._graph = None       # (outs, leaves) of the last train walk
        self._last_state = None  # the generator before the last forward

    # -- the walk -----------------------------------------------------------
    def _walk(self, arg_vals, aux_vals, is_train, gen, fuse=True):
        from .ops.fusion import eval_graph
        return eval_graph(self._topo, self._symbol._heads, arg_vals,
                          aux_vals, is_train, gen,
                          plan=self._fusion_plan if fuse else None)

    def _copy_gen(self, state):
        gen = torch.Generator(device=self._device)
        gen.set_state(state)
        return gen

    def _train_walk(self, state):
        """The train walk recorded for autograd, from the arrays' current
        storage, with draws from a copy of the generator at ``state``.
        Returns (outs, new_aux, (outs, leaves), the generator's state
        after the walk)."""
        vals, leaves, slots = [], [], []
        for i, (a, req) in enumerate(zip(self.arg_arrays, self._grad_req)):
            t = a._tensor.detach()
            if req != "null":
                t = t.requires_grad_(True)
                leaves.append(t)
                slots.append(i)
            vals.append(t)
        # the walk's aux inputs are copies: the forward writes the arrays
        aux = [a._tensor.detach().clone() for a in self.aux_arrays]
        n_out = len(self._symbol._heads)
        end = {}

        def run(*leaf_vals):
            av = list(vals)
            for i, t in zip(slots, leaf_vals):
                av[i] = t
            gen = self._copy_gen(state)
            outs, new_aux, _ = self._walk(av, aux, True, gen)
            end.setdefault("state", gen.get_state())
            return tuple(outs) + tuple(new_aux)

        with torch.enable_grad():
            if leaves and os.environ.get("MXNET_BACKWARD_DO_MIRROR",
                                         "0") == "1":
                from torch.utils.checkpoint import checkpoint
                res = checkpoint(run, *leaves, use_reentrant=False)
            else:
                res = run(*leaves)
        outs = list(res[:n_out])
        return outs, list(res[n_out:]), (outs, leaves), end["state"]

    # -- public API -----------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self._arg_names:
                raise MXNetError("forward: unknown argument %s" % k)
            dst = self.arg_arrays[self._arg_names.index(k)]
            if isinstance(v, NDArray):
                v.copyto(dst)
            else:
                dst[:] = v
        self._graph = None  # the previous walk's residuals go
        state = self._gen.get_state()
        self._last_state = state
        if self._monitor_callback is not None and (
                self._monitor_should_run is None
                or self._monitor_should_run()):
            self._run_monitor(is_train, state)
        if is_train:
            outs, new_aux, self._graph, end = self._train_walk(state)
            self._gen.set_state(end)
        else:
            with torch.no_grad():
                outs, new_aux, _ = self._walk(
                    [a._tensor for a in self.arg_arrays],
                    [a._tensor for a in self.aux_arrays], False, self._gen)
        for dst, val in zip(self._out_arrays, outs):
            dst._set(val)
        for dst, val in zip(self.aux_arrays, new_aux):
            dst._set(val)
        return self.outputs

    def backward(self, out_grads=None):
        if self._graph is None:
            # after an inference forward (or none): the train walk for its
            # residuals; its aux updates are dropped, so the visible state
            # stays what forward() produced
            if self._last_state is None:
                raise MXNetError("backward: call forward first")
            _, _, self._graph, _ = self._train_walk(self._last_state)
        outs, leaves = self._graph
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [nd._tensor_of(g).to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        diff = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        grads = [None] * len(leaves)
        if diff and leaves:
            grads = torch.autograd.grad(
                [o for o, _ in diff], leaves, [h for _, h in diff],
                retain_graph=True, allow_unused=True)
        grads = iter(grads)
        with torch.no_grad():
            for g_arr, req in zip(self.grad_arrays, self._grad_req):
                if req == "null":
                    continue
                g = next(grads)
                if req == "add":
                    if g is not None:
                        g_arr._tensor.add_(g.to(g_arr._tensor.dtype))
                elif g is None:
                    g_arr._tensor.zero_()
                else:
                    g_arr._set(g)

    @property
    def outputs(self):
        return self._out_arrays

    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values in (reference executor.py
        copy_params_from): NDArrays, or arrays ``__setitem__`` takes."""
        for params, names, table, what in (
                (arg_params, self._arg_names, self.arg_dict, "arg"),
                (aux_params or {}, self._aux_names, self.aux_dict, "aux")):
            for name, arr in params.items():
                if name in names:
                    if isinstance(arr, NDArray):
                        arr.copyto(table[name])
                    else:
                        table[name][:] = arr
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %s" % (what, name))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes over views of this one's
        arrays where they fit (a batch shrink slices axis 0), so writes
        through either are seen by both (reference shape-bucketed
        executors sharing one memory pool, ``graph_executor.h:48-55``)."""
        new_shapes = {n: a.shape for n, a in zip(self._arg_names,
                                                 self.arg_arrays)}
        new_shapes.update(kwargs)
        arg_shapes, out_shapes, _ = self._symbol.infer_shape(**new_shapes)
        if arg_shapes is None:
            raise MXNetError("reshape: cannot infer shapes")

        def make_view(base, shape):
            if base is None:
                return None
            if tuple(base.shape) == tuple(shape):
                return base
            if (base.shape[1:] == tuple(shape[1:])
                    and shape[0] <= base.shape[0]):
                return base.slice(0, shape[0])
            if not allow_up_sizing and np.prod(shape) > base.size:
                raise MXNetError("reshape: %s -> %s grows buffer; pass "
                                 "allow_up_sizing=True" % (base.shape, shape))
            return nd.zeros(shape, self._ctx, dtype=base.dtype)

        new_args = [make_view(a, s) for a, s in zip(self.arg_arrays,
                                                    arg_shapes)]
        new_grads = [make_view(g, s) for g, s in zip(self.grad_arrays,
                                                     arg_shapes)]
        new_outs = [make_view(o, s) for o, s in zip(self._out_arrays,
                                                    out_shapes)]
        return Executor(self._symbol, self._ctx, new_args,
                        new_grads if any(g is not None for g in new_grads)
                        else None,
                        self._grad_req, self.aux_arrays,
                        group2ctx=self._group2ctx, _outputs=new_outs)

    # -- monitor and debugging -----------------------------------------------
    def set_monitor_callback(self, callback, should_run=None):
        """Install ``callback(name, NDArray)`` for every node output;
        ``should_run`` (a predicate of no arguments) gates the extra walk
        so a Monitor with interval N pays only on sampled batches."""
        self._monitor_callback = callback
        self._monitor_should_run = should_run

    @torch.no_grad()
    def _run_monitor(self, is_train, state):
        """One unfused walk (every op's own output exists, the fused
        chains' members too) with the forward's draws, reporting each
        node output in topological order, as the JAX package names and
        orders them."""
        _, _, env = self._walk([a._tensor for a in self.arg_arrays],
                               [a._tensor for a in self.aux_arrays],
                               bool(is_train), self._copy_gen(state),
                               fuse=False)
        for n in self._topo:
            if n.is_var:
                continue
            for j, out_name in enumerate(n.output_names()):
                v = env.get((id(n), j))
                if v is not None:
                    self._monitor_callback(
                        out_name, NDArray._from_tensor(v.clone(), self._ctx))

    def _peak_temp_bytes(self):
        """Peak bytes one inference walk allocates beyond its outputs, on
        the card (None on the host, where torch keeps no such count).
        Resets the device's peak counter (``torch.cuda.max_memory_allocated``
        reads this walk's peak afterwards)."""
        if self._device.type != "cuda":
            return None
        torch.cuda.synchronize(self._device)
        base = torch.cuda.memory_allocated(self._device)
        torch.cuda.reset_peak_memory_stats(self._device)
        with torch.no_grad():
            outs, _, _ = self._walk([a._tensor for a in self.arg_arrays],
                                    [a._tensor for a in self.aux_arrays],
                                    False, self._copy_gen(
                                        self._gen.get_state()))
        torch.cuda.synchronize(self._device)
        peak = torch.cuda.max_memory_allocated(self._device) - base
        out_bytes = sum(o.numel() * o.element_size() for o in outs)
        del outs
        return peak - out_bytes if peak > out_bytes else 0

    def debug_str(self):
        """The graph, then the memory of the bound program (reference
        ``GraphExecutor::Print``'s 'Total N MB'): argument and output
        bytes, and on the card the peak temporary bytes of one inference
        forward, measured (``torch.cuda.max_memory_allocated``).

        On the card the first call resets the device's peak-memory
        counter (``torch.cuda.reset_peak_memory_stats``) to take that
        measurement: read the process's peak before calling it."""
        lines = [self._symbol.debug_str()]
        if not hasattr(self, "_plan_memory"):
            self._plan_memory = (
                _nbytes(self.arg_arrays + self.aux_arrays),
                _nbytes(self._out_arrays + self.aux_arrays),
                self._peak_temp_bytes())
        arg_b, out_b, temp_b = self._plan_memory
        mb = 2.0 ** 20
        plan = ["Memory plan (measured on %s):" % self._device,
                "  argument  %.2f MB" % (arg_b / mb),
                "  output    %.2f MB" % (out_b / mb)]
        if temp_b is not None:
            plan.append("  temp      %.2f MB" % (temp_b / mb))
        plan.append("Total %.2f MB" % ((arg_b + out_b + (temp_b or 0)) / mb))
        lines.append("\n".join(plan))
        return "\n".join(lines)

