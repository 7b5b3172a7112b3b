"""ParallelTrainer: the training step of a Symbol on one device.

Counterpart of ``mxnet_tpu/parallel/trainer.py`` ``ParallelTrainer``
(l.111-786) on a one-device mesh: each step runs the forward (the graph
walk of ``make_graph_fn``, with the ``fused_linear``, ``flash_attention``
and, for conv nets, ``matmul_stats`` kernels on the card), the backward
(torch autograd, which reaches the kernels' backward through their
``autograd.Function``s), the gradient sum over microbatches, the
global-norm clip and the optimizer update. As the JAX package compiles
all of that into one program, the port runs it as one
``parallel.program.Program``: captured once as a CUDA graph on the card
and replayed at every step, run as the same function over the same
buffers on the CPU. The batch is copied into the program's input
buffers; the flat parameters, the optimizer state and the aux states are
updated in place and never rebound (``set_params`` copies into them, so
it builds no new program); the learning rate is a device scalar the host
sets before each run; the dropout generator is registered with the graph.
``multi_step`` runs the same program ``num_steps`` times over one copy of
the batch. No switch turns capture off.

Semantics kept from the JAX package:

* the loss heads define their own gradients and ignore the head
  cotangent, which is ones; their gradients are SUMS over the batch, so
  a string ``optimizer`` gets ``rescale_grad = 1/batch`` (l.209-212);
* parameters are f32 master copies; with ``compute_dtype`` they are cast
  inside the differentiated function, so their gradients come back in f32
  (l.406-430);
* index-valued inputs (token ids, labels: ``integer_semantic_inputs``)
  are never cast (l.323-328);
* ``grad_accum`` sums the microbatches' gradients in f32 and makes one
  update; ``clip_grad_norm`` clips the global norm of the RESCALED
  gradient (l.432-484);
* the aux states (BatchNorm's moving statistics) stay f32 across steps
  in any compute dtype (l.424-427); ``forward()`` is the eval path, where
  each conv -> BatchNorm chain runs as ``fused_conv_bn_act``. It runs on
  the f32 parameters and the batch as given, in any compute dtype
  (``_build_eval``, l.506-515), uncaptured;
* ``MXNET_PALLAS_CONVBN_TRAIN`` is read when the step program is built,
  as the JAX package reads it when it traces the step.

Meshes, sharding rules, ZeRO-1, FSDP, rematerialization, ``prefetch``
and ``fit`` belong to later slices of the port.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError, later_slice, torch_dtype
from ..context import resolve_device
from .. import optimizer as opt_mod
from ..initializer import Uniform
from ..ops.fusion import _convbn_train_enabled
from .graph import make_graph_fn, integer_semantic_inputs
from .optim import make_functional
from .program import Program

__all__ = ["ParallelTrainer"]

_LATER = {
    "mesh": "meshes and sharding (parallel/mesh.py, parallel/shard.py)",
    "rules": "meshes and sharding (parallel/mesh.py, parallel/shard.py)",
    "zero1": "ZeRO-1 optimizer-state sharding",
    "fsdp": "FSDP parameter sharding",
    "remat": "rematerialization (MXNET_BACKWARD_DO_MIRROR)",
}


def _later(what):
    return later_slice("ParallelTrainer", what)


def _as_tensor(v):
    """A host value (numpy array, torch tensor, or an array with
    ``asnumpy()`` such as the JAX package's NDArray) as a torch tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


class _Unflatten(torch.autograd.Function):
    """The flat parameter buffer -> one view per parameter; the backward
    concatenates the parameters' gradients (zeros for an unused one) into
    one flat gradient: one node and one kernel for all of them."""

    @staticmethod
    def forward(ctx, flat, shapes):
        numels = [int(np.prod(sh)) for sh in shapes]
        return tuple(p.view(sh) for p, sh in zip(flat.split(numels), shapes))

    @staticmethod
    def backward(ctx, *grads):
        # autograd materializes the gradient of an unused output as zeros
        return torch.cat([g.reshape(-1) for g in grads]), None


class ParallelTrainer:
    """Train a loss-headed Symbol on one device.

    Parameters
    ----------
    symbol : Symbol
        Loss-headed graph (e.g. a SoftmaxOutput head).
    input_shapes : dict name -> shape
        Shapes of the data/label inputs, batch first.
    optimizer : str or Optimizer
        A string is created with ``rescale_grad=1/batch`` (the loss
        gradients are batch sums), like FeedForward.fit.
    mesh, rules, remat, zero1, fsdp :
        The JAX package's parameters, in its order; any value but the
        default (or a false one) raises: sharding and rematerialization
        belong to a later slice.
    initializer : Initializer, default ``Uniform(0.01)``
    seed : int, optional
        Seeds the initializer's draws and the training-time draws
        (dropout); ``None`` draws a seed.
    optimizer_params : dict, optional
    compute_dtype : optional
        e.g. ``"bfloat16"``: the forward and backward run in it, the
        parameters and the optimizer state stay f32.
    grad_accum : int
        Split each batch into this many microbatches, run one after the
        other, and make one update on their summed gradients.
    clip_grad_norm : float, optional
        Clip the global gradient norm (over all parameters, after
        ``rescale_grad``) to this value before the update.
    device : optional, keyword-only (the port's own)
        ``None`` means ``cuda:0`` and raises without CUDA; pass ``"cpu"``
        to run the plain versions of the kernels on the host.
    """

    def __init__(self, symbol, input_shapes, optimizer="sgd", mesh=None,
                 rules=None, initializer=None, seed=None,
                 optimizer_params=None, compute_dtype=None, remat=None,
                 zero1=False, fsdp=False, grad_accum=1, clip_grad_norm=None,
                 *, device=None):
        for name, val in (("mesh", mesh), ("rules", rules),
                          ("zero1", zero1), ("fsdp", fsdp),
                          ("remat", remat)):
            if val:
                raise _later(_LATER[name])
        self.device = resolve_device(device)
        self.symbol = symbol
        self.compute_dtype = (None if compute_dtype is None
                              else torch_dtype(compute_dtype))
        self.input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self.arg_names = symbol.list_arguments()
        self.param_names = [n for n in self.arg_names
                            if n not in self.input_shapes]
        self.aux_names = symbol.list_auxiliary_states()
        arg_shapes, out_shapes, aux_shapes = \
            symbol.infer_shape(**self.input_shapes)
        if arg_shapes is None:
            raise MXNetError("ParallelTrainer: cannot infer shapes from %s"
                             % (self.input_shapes,))
        self.arg_shapes = dict(zip(self.arg_names, arg_shapes))
        self.out_shapes = out_shapes
        self.aux_shapes = aux_shapes

        batch_size = next(iter(self.input_shapes.values()))[0]
        self.global_batch = batch_size
        self.clip_grad_norm = (None if clip_grad_norm is None
                               else float(clip_grad_norm))
        if self.clip_grad_norm is not None and self.clip_grad_norm <= 0:
            raise MXNetError("clip_grad_norm must be positive, got %g"
                             % self.clip_grad_norm)
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1 or batch_size % self.grad_accum:
            raise MXNetError("grad_accum=%d must divide batch %d"
                             % (grad_accum, batch_size))
        if isinstance(optimizer, str):
            opt_kwargs = dict(optimizer_params or {})
            opt_kwargs.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt_mod.create(optimizer, **opt_kwargs)
        self.optimizer = optimizer
        self._opt_init, self._opt_update = make_functional(optimizer)

        self._graph_fn = make_graph_fn(symbol)
        # index-valued inputs (labels, embedding tokens) are exempt from
        # the compute_dtype cast: bf16 spaces integers 4 apart near 1000
        self._no_cast = (
            integer_semantic_inputs(symbol) & set(self.input_shapes)
            if self.compute_dtype is not None else set())
        self.params = None
        self.opt_state = None
        self.aux = None
        self._t = 0
        # the step program's learning rate, set by the host before each run
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._program = None
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        self._init_gen = torch.Generator().manual_seed(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._initializer = initializer if initializer is not None \
            else Uniform(0.01)

    # ------------------------------------------------------------------
    def _initial(self, name, shape, given):
        if given and name in given:
            val = _as_tensor(given[name])
            if tuple(val.shape) != tuple(shape):
                raise MXNetError("init_params: %s has shape %s, the symbol "
                                 "wants %s" % (name, tuple(val.shape),
                                               tuple(shape)))
            return val.to(self.device, torch.float32, copy=True)
        arr = torch.zeros(shape, dtype=torch.float32)
        self._initializer(name, arr, self._init_gen)
        return arr.to(self.device)

    def init_params(self, arg_params=None, aux_params=None):
        """Initialize (or load) the parameters as f32 tensors on the
        device, and the optimizer state. ``arg_params``/``aux_params``
        map names to numpy arrays, torch tensors or arrays with
        ``asnumpy()`` (e.g. the JAX trainer's ``get_params()``); names
        they lack are drawn by the initializer.

        The parameters live in ONE flat f32 buffer, and ``params`` maps
        each name to its view: a step casts the buffer to the compute
        dtype once, autograd returns one flat gradient, and the optimizer
        updates the buffer (and a flat state) in a few launches, where a
        tensor per parameter costs several host calls per parameter."""
        vals = [self._initial(n, self.arg_shapes[n], arg_params)
                for n in self.param_names]
        flat = torch.cat([v.reshape(-1) for v in vals]) if vals \
            else torch.zeros(0, device=self.device)
        aux = [self._initial(n, s, aux_params)
               for n, s in zip(self.aux_names, self.aux_shapes)]
        state = self._opt_init(flat)
        if self.params is None:
            self._flat, self.aux, self._flat_state = flat, aux, state
            self.params = self._views(self._flat)
            self.opt_state = self._views(self._flat_state) \
                if isinstance(self._flat_state, torch.Tensor) \
                else dict.fromkeys(self.param_names, self._flat_state)
        else:
            # into the buffers the step program reads and writes
            self._flat.copy_(flat)
            for a, v in zip(self.aux, aux):
                a.copy_(v)
            if isinstance(state, torch.Tensor):
                self._flat_state.copy_(state)
        self._t = 0
        return self

    def _views(self, flat):
        """{name: view of ``flat`` in the parameter's shape}."""
        shapes = [self.arg_shapes[n] for n in self.param_names]
        parts = flat.split([int(np.prod(sh)) for sh in shapes])
        return {n: p.view(sh) for n, p, sh in zip(self.param_names, parts,
                                                  shapes)}

    def set_params(self, arg_params, aux_params=None):
        return self.init_params(arg_params, aux_params)

    def get_params(self):
        """Host copies ``(arg_params, aux_params)`` as CPU f32 tensors."""
        arg = {n: v.detach().to("cpu", copy=True)
               for n, v in self.params.items()}
        aux = {n: v.detach().to("cpu", copy=True)
               for n, v in zip(self.aux_names, self.aux)}
        return arg, aux

    # ------------------------------------------------------------------
    def _cast(self, v):
        if self.compute_dtype is not None and v.is_floating_point():
            return v.to(self.compute_dtype)
        return v

    def _batch(self, batch, what):
        """The inputs on the device. Host arrays go through pinned memory
        and copy without blocking, so the host goes on queueing the step
        behind the copy instead of waiting for the card to drain."""
        out = {}
        for k in self.input_shapes:
            if k not in batch:
                raise MXNetError("%s: missing input %s" % (what, k))
            v = _as_tensor(batch[k])
            if self.device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory().to(self.device, non_blocking=True)
            out[k] = v.to(self.device)
        return out

    def _inputs(self, params, batch):
        """The graph's argument values: parameters as given, float inputs
        cast to the compute dtype, index-valued inputs as they came."""
        return [params[n] if n in params else
                (batch[n] if n in self._no_cast else self._cast(batch[n]))
                for n in self.arg_names]

    def _grads_of(self, batch, convbn_train):
        """(flat gradient, outs) for one (micro)batch: the forward with
        the flat parameter buffer as the leaf (cast to the compute dtype
        inside the differentiated function, so the gradient comes back
        f32), then the backward from head gradients of ones (the loss
        heads ignore them). The new aux states are copied into
        ``self.aux``."""
        leaf = self._flat.detach().requires_grad_(True)
        shapes = tuple(tuple(self.arg_shapes[n]) for n in self.param_names)
        pvals = dict(zip(self.param_names,
                         _Unflatten.apply(self._cast(leaf), shapes)))
        outs, new_aux = self._graph_fn(self._inputs(pvals, batch),
                                       list(self.aux), True, self._gen,
                                       convbn_train=convbn_train)
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
        grad = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        with torch.no_grad():
            for a, v in zip(self.aux, new_aux):
                a.copy_(v)
        return grad, [o.detach() for o in outs]

    def _step_fn(self, inputs, convbn_train):
        """One train step over the program's input buffers ``inputs``."""
        a = self.grad_accum
        if a == 1:
            grad, outs = self._grads_of(inputs, convbn_train)
        else:
            # microbatches: gradients SUM (the loss gradients are batch
            # sums, so the sum is the full batch's gradient); aux chains
            grad, outs_parts = None, []
            for i in range(a):
                g, outs = self._grads_of(
                    {k: v.chunk(a)[i] for k, v in inputs.items()},
                    convbn_train)
                outs_parts.append(outs)
                grad = g if grad is None else grad + g
            outs = [torch.cat(parts) for parts in zip(*outs_parts)]
        if self.clip_grad_norm is not None:
            # global norm of the rescaled gradient, on the device (no host
            # round trip); the scale is min(1, clip / norm)
            gnorm = torch.sqrt(grad.square().sum()) \
                * self.optimizer.rescale_grad
            grad = grad * torch.clamp(self.clip_grad_norm
                                      / torch.clamp(gnorm, min=1e-12),
                                      max=1.0)
        self._opt_update([self._flat], [grad], [self._flat_state], self._lr,
                         self._t)
        return outs

    def _step_program(self, batch, what):
        """The step program, loaded with ``batch``. Built at the first
        step, with input buffers of the first batch's dtypes (a later
        batch is converted into them) and the conv-BN train gate as it
        reads then."""
        missing = [k for k in self.input_shapes if k not in batch]
        if missing:
            raise MXNetError("%s: missing input %s" % (what, missing[0]))
        vals = {k: _as_tensor(batch[k]) for k in self.input_shapes}
        if self._program is None:
            inputs = {k: torch.empty(self.input_shapes[k], dtype=v.dtype,
                                     device=self.device)
                      for k, v in vals.items()}
            state = [self._flat_state] \
                if isinstance(self._flat_state, torch.Tensor) else []
            self._program = Program(
                functools.partial(self._step_fn, inputs,
                                  _convbn_train_enabled()),
                inputs, mutable=[self._flat] + state + list(self.aux),
                generators=[self._gen] if self.device.type == "cuda"
                else [], name="ParallelTrainer.step", device=self.device)
        self._program.load(**vals)
        return self._program

    def _next_lr(self):
        """Advance the step count and set the program's learning rate."""
        self._t += 1
        sched = self.optimizer.lr_scheduler
        self._lr.fill_(sched(self._t) if sched is not None
                       else self.optimizer.lr)

    def step(self, batch):
        """One train step. ``batch``: dict of arrays (numpy or torch)
        keyed by input name, in the trainer's input shapes. Returns the
        outputs: copies, which later steps leave as they are."""
        if self.params is None:
            self.init_params()
        prog = self._step_program(batch, "step")
        self._next_lr()
        return [o.clone() for o in prog.run()]

    def multi_step(self, batch, num_steps):
        """Run ``num_steps`` consecutive train steps on the SAME batch:
        the batch is copied once, then the step program runs
        ``num_steps`` times (replays of one graph on the card, whatever
        ``num_steps`` is). The step counter, the lr schedule and the
        dropout draws advance exactly as ``num_steps`` calls of
        :meth:`step` would. Returns nothing; the parameters advance in
        place (``get_params``)."""
        if self.params is None:
            self.init_params()
        prog = self._step_program(batch, "multi_step")
        for _ in range(int(num_steps)):
            self._next_lr()
            prog.run()

    @torch.no_grad()
    def forward(self, batch):
        """Inference forward (no aux update); returns the outputs. As the
        JAX package's ``_build_eval`` (l.506-515), it runs on the f32
        master parameters and the batch as given, with no cast to
        ``compute_dtype``: a bf16 trainer's ``forward()`` computes in
        f32."""
        if self.params is None:
            self.init_params()
        batch = self._batch(batch, "forward")
        vals = [self.params[n] if n in self.params else batch[n]
                for n in self.arg_names]
        outs, _ = self._graph_fn(vals, list(self.aux), False, self._gen)
        return outs

    def prefetch(self, batches, depth=2):
        raise _later("prefetch (the device-staged input stream)")

    def fit(self, *args, **kwargs):
        raise _later("fit (the epoch loop with metrics and callbacks)")
