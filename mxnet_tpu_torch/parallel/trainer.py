"""ParallelTrainer: the training step of a Symbol, on one device or over
a mesh.

Counterpart of ``mxnet_tpu/parallel/trainer.py`` ``ParallelTrainer``
(l.111-1092). On a one-rank mesh each step runs the forward (the graph
walk of ``make_graph_fn``, with the ``fused_linear``, ``flash_attention``
and, for conv nets, ``matmul_stats`` kernels on the card), the backward
(torch autograd, which reaches the kernels' backward through their
``autograd.Function``s), the gradient sum over microbatches, the
global-norm clip and the optimizer update (any optimizer of
``optimizer.py``, through ``parallel.optim.FlatOptState``). As the JAX
package compiles all of that into one program, the port runs it as one
``parallel.program.Program``: captured once as a CUDA graph on the card
and replayed at every step, run as the same function over the same
buffers on the CPU. The batch is copied into the program's input
buffers; the flat parameters, the optimizer state and the aux states are
updated in place and never rebound (``set_params`` and
``set_optimizer_states`` copy into them, so they build no new program);
the learning rate and the update count ``t`` are device scalars the host
sets before each run; the generator of dropout and SGLD's noise is
registered with the graph. ``multi_step`` runs the same program
``num_steps`` times over one copy of the batch. No switch turns capture
off.

Around the step: ``fit`` (the epoch loop over a ``DataIter`` with
metrics, on the host or accumulated on the device, callbacks and eval
data), ``prefetch`` and ``staged_batches`` (the batches copied to the
device ahead of their steps), ``get_``/``set_optimizer_states`` (the JAX
package's blob) and the sharded checkpoints of ``parallel.checkpoint``,
and the JAX package's telemetry: ``train.steps``, ``train.step_ms``,
``train.input_wait_ms``, ``train.device_wait_ms``, ``train.h2d_bytes``,
``train.compiles`` (a step program built), and the ``train.step`` and
``train.epoch`` spans.

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
  as the JAX package reads it when it traces the step;
* ``remat`` (default: ``MXNET_BACKWARD_DO_MIRROR=1``, l.163-169) runs the
  differentiated forward under ``torch.utils.checkpoint``, so the
  backward recomputes the activations (l.421-422).

On a mesh of more than one rank (``mesh``, ``rules``: a
``ShardingRules``; ``zero1``, ``fsdp``) the state is laid out one shard
per rank and the step is ``parallel.sharded.ShardedState.step``: one walk
per data-parallel coordinate over its rows of the batch, gradients summed
over the walks and reduce-scattered to the ranks' shards, each rank
updating what it stores; the numbers are the one-device step's, as
GSPMD's are. No chain is fused there (the JAX rule, l.317-322). The step
is still one ``Program``, captured on the card.

On a mesh whose ranks live in several processes (every process runs the
same script under ``tools/launch.py`` and builds the same mesh, e.g.
``build_mesh({"dp": -1})`` after ``distributed.initialize``), each
process holds its ranks alone, as a JAX process holds its addressable
shards: ``init_params`` takes the full values in every process (the
JAX convention; the default initializer draws the same values in every
process from the one seed, which rank 0 broadcasts when it is not
given); ``step`` and ``multi_step`` take this process's rows of the
global batch of ``input_shapes`` (JAX's ``_shard_batch``) and return
them; ``forward`` takes them too and returns the global batch's outputs;
``get_params``, ``get_optimizer_states`` and the checkpoints gather or
write across processes; ``fit(device_metric=True)`` sums its accumulator
over the processes, so every process reports the global batch's metric.
The step is then a ``ProgramChain``: the captured compute program, the
gradient sum over gloo in rank order (bitwise the one-process sum), the
captured update, with ZeRO-1's and FSDP's gathers as host stages too
(``parallel.sharded``); ``compile_counts`` counts each program built.
"""
from __future__ import annotations

import collections
import functools
import itertools
import logging
import os
import time

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from .. import metric as metric_mod
from .. import optimizer as opt_mod
from .. import telemetry as tele
from ..initializer import Uniform
from ..io import StagedStream
from ..ndarray import NDArray, _tensor_of
from ..ops.fusion import _convbn_train_enabled
from .collectives import Span, process_broadcast, process_sum
from .graph import make_graph_fn, integer_semantic_inputs, has_host_ops
from .mesh import build_mesh
from .optim import FlatOptState, make_functional
from .program import Program, ProgramChain
from .shard import P, ShardingRules
from .sharded import ShardedState, _Unflatten, backward_heads, remat_walk

__all__ = ["ParallelTrainer"]

_TM_STEPS = tele.counter("train.steps")
_TM_STEP_MS = tele.histogram("train.step_ms")          # the host's part
_TM_INPUT_MS = tele.histogram("train.input_wait_ms")   # blocked on input
_TM_DEVICE_MS = tele.histogram("train.device_wait_ms")  # blocked on device
_TM_H2D_BYTES = tele.counter("train.h2d_bytes")
_TM_COMPILES = tele.counter("train.compiles")

def _as_tensor(v):
    """A value as a torch tensor: a tensor as it is, the port's NDArray as
    its tensor on its own device (no host round trip), a numpy array or an
    array with ``asnumpy()`` (such as the JAX package's NDArray) as a host
    tensor."""
    if isinstance(v, (NDArray, torch.Tensor)):
        return _tensor_of(v).detach()
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


class _StagedBatches:
    """Depth-k staging of a DataIter for ``fit``: yields ``(data_batch,
    device_batch)``, batch i+1's copy to the device dispatched (pinned,
    non-blocking) before batch i is handed out; ends at the iterator's
    epoch end; ``reset()`` rewinds the iterator and drops staged
    batches. Over the inline ``io.StagedStream``."""

    def __init__(self, trainer, data, data_names, label_names, depth=2):
        def place(dbatch):
            batch = dict(zip(data_names, dbatch.data))
            batch.update(zip(label_names, dbatch.label))
            return dbatch, trainer._stage_batch(batch, "staged fit")

        self._stream = StagedStream(data, place=place, depth=depth)

    def reset(self):
        self._stream.reset()

    def __iter__(self):
        return self

    def __next__(self):
        # blocked on input: what the loop waits for the next staged batch
        # (the iterator's host work and the copy's dispatch)
        t0 = time.perf_counter()
        out = self._stream.next()
        dt = time.perf_counter() - t0
        _TM_INPUT_MS.observe(dt * 1e3)
        tele.trace_complete("io.input_wait", t0, dt, cat="io")
        return out


class ParallelTrainer:
    """Train a loss-headed Symbol on one device or over a mesh.

    Parameters
    ----------
    symbol : Symbol
        Loss-headed graph (e.g. a SoftmaxOutput head).
    input_shapes : dict name -> shape
        Shapes of the data/label inputs, batch first.
    optimizer : str or Optimizer
        A string is created with ``rescale_grad=1/batch`` (the loss
        gradients are batch sums), like FeedForward.fit.
    mesh : parallel.Mesh, optional
        Default: ``rules.mesh``, else one rank on ``device``. Its devices
        may repeat (``["cpu"] * 8``, ``[cuda:0] * 2``); its ranks may live
        in several processes (``Mesh.processes``).
    rules : ShardingRules, optional
        Default: ``ShardingRules(mesh)`` (the batch over ``dp``, the
        parameters replicated).
    zero1 : bool
        Store the optimizer state ``1/dp`` per rank (needs a ``dp`` axis).
    fsdp : bool
        Store every parameter that the rules leave replicated ``1/dp`` per
        rank, along its first dimension ``dp`` divides, gathered where it
        is used; the optimizer state follows (implies zero1).
    remat : bool, optional
        Recompute the activations in the backward
        (``torch.utils.checkpoint``); default ``MXNET_BACKWARD_DO_MIRROR``.
    optimizer_params : dict, optional
    initializer : Initializer, default ``Uniform(0.01)``
    seed : int, optional
        Seeds the initializer's draws and the training-time draws
        (dropout, SGLD's noise); ``None`` draws a seed.
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
        The device of a trainer without a mesh: ``None`` means ``cuda:0``
        and raises without CUDA; pass ``"cpu"`` to run the plain versions
        of the kernels on the host.
    """

    def __init__(self, symbol, input_shapes, optimizer="sgd", mesh=None,
                 rules=None, initializer=None, seed=None,
                 optimizer_params=None, compute_dtype=None, remat=None,
                 zero1=False, fsdp=False, grad_accum=1, clip_grad_norm=None,
                 *, device=None):
        if mesh is None:
            mesh = rules.mesh if rules is not None else \
                build_mesh({"dp": 1}, [resolve_device(device)])
        self.mesh = mesh
        self.rules = rules if rules is not None else ShardingRules(mesh)
        # this process's first device (the mesh's first, in one process)
        self.device = torch.device(mesh.local_devices()[0])
        if remat is None:
            remat = os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") == "1"
        self.remat = bool(remat)
        self.fsdp = bool(fsdp)
        self.zero1 = bool(zero1)
        if self.fsdp and "dp" not in mesh.shape:
            raise MXNetError("fsdp=True needs a 'dp' mesh axis")
        if self.zero1 and not self.fsdp and "dp" not in mesh.shape:
            raise MXNetError("zero1=True needs a 'dp' mesh axis")
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
        self._opt_init_fn, self._opt_update_fn = make_functional(optimizer)

        self._graph_fn = make_graph_fn(symbol)
        # index-valued inputs (labels, embedding tokens) are exempt from
        # the compute_dtype cast: bf16 spaces integers 4 apart near 1000
        self._no_cast = (
            integer_semantic_inputs(symbol) & set(self.input_shapes)
            if self.compute_dtype is not None else set())
        self.params = None
        self.opt_state = None
        self._state = None      # FlatOptState, made by init_params
        self.aux = None
        self._t = 0
        # the step program's learning rate and update count (f32, as the
        # JAX adapters read t), set by the host before each run
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._tdev = torch.zeros((), dtype=torch.float32, device=self.device)
        self._program = None
        self._compile_log = []
        self._h2d_batch_bytes = None
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
            if mesh.is_multiprocess:
                # one seed for every process: the initializer's draws and
                # the walks' generators are the one-process run's
                seed = int(process_broadcast(
                    torch.tensor([seed], dtype=torch.int64))[0])
        self._seed = seed
        self._init_gen = torch.Generator().manual_seed(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self._input_dtypes = None
        # more than one rank: the state is laid out per rank
        self._sharded = ShardedState(self) if mesh.size > 1 else None

    # ------------------------------------------------------------------
    def _initial(self, name, shape, given, device=None):
        device = self.device if device is None else device
        if given and name in given:
            val = _as_tensor(given[name])
            if tuple(val.shape) != tuple(shape):
                raise MXNetError("init_params: %s has shape %s, the symbol "
                                 "wants %s" % (name, tuple(val.shape),
                                               tuple(shape)))
            return val.to(device, torch.float32, copy=True)
        arr = torch.zeros(shape, dtype=torch.float32)
        self._initializer(name, arr, self._init_gen)
        return arr.to(device)

    def init_params(self, arg_params=None, aux_params=None):
        """Initialize (or load) the parameters as f32 tensors on the
        device, and the optimizer state. ``arg_params``/``aux_params``
        map names to numpy arrays, torch tensors or arrays with
        ``asnumpy()`` (e.g. the JAX trainer's ``get_params()``); names
        they lack are drawn by the initializer. The optimizer state starts
        afresh and the step count at 0.

        The parameters live in ONE flat f32 buffer, and ``params`` maps
        each name to its view: a step casts the buffer to the compute
        dtype once, autograd returns one flat gradient, and an elementwise
        optimizer updates the buffer (and its flat state buffers) in a few
        launches, where a tensor per parameter costs several host calls
        per parameter. ``opt_state`` maps each name to its state leaves in
        the JAX package's order.

        On a mesh of several ranks each rank stores its shards
        (``parallel.sharded``); ``params`` and ``aux`` are then rank 0's
        (views of its buffer: the whole of a parameter it holds whole),
        ``opt_state`` its leaves when it holds the whole of them, else
        None. ``get_params`` gathers the whole."""
        if self._sharded is not None:
            return self._init_sharded(arg_params, aux_params)
        vals = [self._initial(n, self.arg_shapes[n], arg_params)
                for n in self.param_names]
        flat = torch.cat([v.reshape(-1) for v in vals]) if vals \
            else torch.zeros(0, device=self.device)
        aux = [self._initial(n, s, aux_params)
               for n, s in zip(self.aux_names, self.aux_shapes)]
        if self.params is None:
            self._flat, self.aux = flat, aux
            self.params = self._views(self._flat)
            self._state = FlatOptState(
                self.optimizer, self.param_names,
                [self.arg_shapes[n] for n in self.param_names], self._flat)
            self.opt_state = self._state.by_name()
        else:
            # into the buffers the step program reads and writes
            self._flat.copy_(flat)
            for a, v in zip(self.aux, aux):
                a.copy_(v)
            self._state.reset(self._flat)
        self._t = 0
        return self

    def _init_sharded(self, arg_params, aux_params):
        sh = self._sharded
        vals = {n: self._initial(n, self.arg_shapes[n], arg_params, "cpu")
                for n in self.param_names}
        aux = [self._initial(n, s, aux_params, "cpu")
               for n, s in zip(self.aux_names, self.aux_shapes)]
        sh.init(vals, aux)
        r0 = sh.local[0]
        self.params = sh.rank_params[r0]
        self.aux = sh.aux[r0]
        self.opt_state = None if sh.per_weight or sh.zero1 \
            else sh.states[r0].by_name()
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
        """Host copies ``(arg_params, aux_params)`` as CPU f32 tensors,
        each parameter whole (gathered from the ranks' shards on a
        mesh)."""
        if self._sharded is not None:
            arg = self._sharded.whole_params()
        else:
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
        ``self.aux``. Under ``remat`` the forward runs checkpointed."""
        leaf = self._flat.detach().requires_grad_(True)
        shapes = tuple(tuple(self.arg_shapes[n]) for n in self.param_names)

        def fwd(flat):
            pvals = dict(zip(self.param_names,
                             _Unflatten.apply(self._cast(flat), shapes)))
            outs, new_aux = self._graph_fn(self._inputs(pvals, batch),
                                           list(self.aux), True, self._gen,
                                           convbn_train=convbn_train)
            return tuple(outs) + tuple(new_aux)

        res = remat_walk(fwd, [leaf]) if self.remat \
            else fwd(leaf)
        outs, new_aux = res[:len(self.out_shapes)], res[len(self.out_shapes):]
        backward_heads(outs)
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
        self._state.update(self._flat, grad, self._lr, self._tdev, self._gen)
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
            self._input_dtypes = {k: v.dtype for k, v in vals.items()}
            _TM_COMPILES.inc()
            tele.mark("train.compile", kind="step", shapes=",".join(
                "%s:%s" % (k, "x".join(map(str, v)))
                for k, v in sorted(self.input_shapes.items())))
            if self._sharded is not None and self._sharded.mp:
                self._program = self._chain()
            else:
                self._program = self._one_program(vals)
        if self._sharded is not None:
            vals = self._sharded.split_batch(vals)
        self._program.load(**vals)
        return self._program

    def _one_program(self, vals):
        """The step as one program (every rank in this process)."""
        if self._sharded is not None:
            sh = self._sharded
            inputs = sh.input_buffers()
            fn = functools.partial(sh.step, inputs, self._lr, self._tdev)
            mutable = sh.buffers()
            gens = sh.generators()
        else:
            inputs = {k: torch.empty(self.input_shapes[k], dtype=v.dtype,
                                     device=self.device)
                      for k, v in vals.items()}
            fn = functools.partial(self._step_fn, inputs,
                                   _convbn_train_enabled())
            mutable = [self._flat] + self._state.buffers() + list(self.aux)
            gens = [self._gen]
        return Program(
            fn, inputs, mutable=mutable,
            generators=gens if self.device.type == "cuda" else [],
            name="ParallelTrainer.step", device=self.device,
            stats="train_step", tag="step", log=self._compile_log,
            capture=not has_host_ops(self.symbol))

    def _chain(self):
        """The step across processes: the compute and update programs
        with the host collectives between them (``ShardedState.bind``)."""
        sh = self._sharded
        inputs = sh.input_buffers()
        cuda = self.device.type == "cuda"
        stages = []
        for piece in sh.bind(inputs, self._lr, self._tdev):
            if piece[0] == "host":
                stages.append(piece[1])
                continue
            _, part, fn, mutable, gens, capturable = piece
            stages.append(Program(
                fn, inputs if part == "compute" else None, mutable=mutable,
                generators=gens if cuda else [],
                name="ParallelTrainer.step.%s" % part, device=self.device,
                stats="train_step_%s" % part, tag="step.%s" % part,
                log=self._compile_log,
                capture=capturable and not has_host_ops(self.symbol)))
        return ProgramChain(stages, "ParallelTrainer.step")

    @property
    def compile_counts(self):
        """``{tag: builds}`` of the step's programs: ``{"step": 1}`` after
        any steps on one process; across processes ``{"step.compute": 1,
        "step.update": 1}`` (the collectives between them run on the
        host)."""
        return dict(collections.Counter(self._compile_log))

    def _next_lr(self):
        """Advance the step count and set the program's learning rate and
        update count."""
        self._t += 1
        sched = self.optimizer.lr_scheduler
        self._lr.fill_(sched(self._t) if sched is not None
                       else self.optimizer.lr)
        self._tdev.fill_(float(self._t))

    def step(self, batch):
        """One train step. ``batch``: dict of arrays (numpy or torch, on
        the host or the device) keyed by input name, in the trainer's
        input shapes. Returns the outputs: copies, which later steps leave
        as they are."""
        if self.params is None:
            self.init_params()
        t0 = time.perf_counter()
        prog = self._step_program(batch, "step")
        self._next_lr()
        outs = [o.clone() for o in prog.run()]
        dt = time.perf_counter() - t0
        _TM_STEPS.inc()
        _TM_STEP_MS.observe(dt * 1e3)
        tele.trace_complete("train.step", t0, dt)
        return outs

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
        f32. On a mesh across processes ``batch`` is this process's rows
        of the global batch, and the outputs are the global batch's,
        gathered from every process."""
        outs = self._local_forward(batch)
        if self._sharded is not None and self._sharded.mp:
            procs = Span(range(self._sharded.rspan.nprocs))
            outs = [torch.cat(procs.gather([o])) for o in outs]
        return outs

    @torch.no_grad()
    def _local_forward(self, batch):
        """The eval forward of ``batch``'s rows alone."""
        if self.params is None:
            self.init_params()
        batch = self._batch(batch, "forward")
        if self._sharded is not None:
            return self._sharded.forward(batch)
        vals = [self.params[n] if n in self.params else batch[n]
                for n in self.arg_names]
        outs, _ = self._graph_fn(vals, list(self.aux), False, self._gen)
        return outs


    # -- input staging ---------------------------------------------------
    def _stage_batch(self, batch, what):
        """The batch on the device (``_batch``: host arrays through
        pinned memory, copies that do not block the host), counted as
        ``train.h2d_bytes``."""
        out = self._batch(batch, what)
        if self._h2d_batch_bytes is None:
            self._h2d_batch_bytes = sum(v.numel() * v.element_size()
                                        for v in out.values())
        _TM_H2D_BYTES.inc(self._h2d_batch_bytes)
        return out

    def prefetch(self, batches, depth=2):
        """Yield the batches of ``batches`` (any iterable of host batch
        dicts) on the device, ``depth`` of them copied ahead, so a batch's
        copy is queued before the step that precedes it. Use as::

            for dev_batch in trainer.prefetch(host_batches):
                trainer.step(dev_batch)
        """
        it = iter(batches)

        def stage(n):
            return [self._stage_batch(b, "prefetch")
                    for b in itertools.islice(it, n)]

        queue = collections.deque(stage(max(1, int(depth))))
        while queue:
            ready = queue.popleft()
            queue.extend(stage(1))
            yield ready

    def staged_batches(self, data, data_names, label_names, depth=2):
        """Staging of a DataIter for a train loop: an iterator of
        ``(data_batch, device_batch)`` with batch i+1's copy dispatched
        before batch i is handed out (what :meth:`fit` iterates)."""
        return _StagedBatches(self, data, data_names, label_names,
                              depth=depth)

    # -- fit ---------------------------------------------------------------
    @staticmethod
    def _device_metric_kind(eval_metric):
        if isinstance(eval_metric, metric_mod.TopKAccuracy):
            return "topk", eval_metric.top_k
        if isinstance(eval_metric, metric_mod.Accuracy):
            return "acc", 1
        if isinstance(eval_metric, metric_mod.CrossEntropy):
            return "ce", 1
        if isinstance(eval_metric, metric_mod.Loss):
            return "loss", 1
        raise MXNetError("device_metric=True supports accuracy, top-k "
                         "accuracy, cross-entropy and loss; got %r"
                         % (eval_metric.name,))

    @staticmethod
    @torch.no_grad()
    def _device_metric_update(acc, kind, top_k, out, label):
        """Add one batch to the device accumulator ``acc`` = [sum, count]
        (f32): "acc" argmax matches, "topk" labels within the top-k
        scores, "ce" summed -log p[label] (the output must be
        probabilities), "loss" the outputs themselves (label unused,
        count = the output's size)."""
        if kind == "loss":
            acc[0] += out.float().sum()
            acc[1] += float(out.numel())
            return
        lab = label.long()
        if kind == "acc":
            hit = (out.argmax(dim=-1) == lab).float().sum()
        elif kind == "topk":
            if out.shape[-1] <= int(top_k):
                raise MXNetError(
                    "top-k accuracy with k=%d over %d classes is constant "
                    "1.0 — use a smaller top_k" % (int(top_k),
                                                   out.shape[-1]))
            idx = out.topk(int(top_k), dim=-1).indices
            hit = (idx == lab[..., None]).any(dim=-1).float().sum()
        else:  # "ce"
            prob = out.gather(-1, lab.reshape(out.shape[:-1] + (1,)))[..., 0]
            hit = -torch.log(prob.float().clamp_min(1e-30)).sum()
        acc[0] += hit
        acc[1] += float(lab.numel())

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            num_epoch=1, batch_end_callback=None, epoch_end_callback=None,
            logger=None, device_metric=False):
        """Epoch loop over a DataIter (``provide_data``/``provide_label``,
        ``reset``, iteration), FeedForward.fit's protocol on the step
        program: each batch staged to the device ahead of its step, the
        metric updated, ``batch_end_callback(BatchEndParam)`` called; at
        an epoch's end ``epoch_end_callback(epoch, symbol, arg_params,
        aux_params)`` and the eval pass over ``eval_data`` (``forward()``
        and the host metric). ``last_train_metric`` holds the last
        epoch's ``(name, value)``.

        ``device_metric=True`` (accuracy, top-k accuracy, cross-entropy,
        loss): the metric accumulates on the device, and the host reads it
        once an epoch, so no step waits for the host; batch-end callbacks
        see the metric object, whose value appears only at the epoch's
        end. Without it, the host reads every batch's outputs.

        On a mesh across processes ``train_data`` yields this process's
        rows of each global batch (an iterator over its part of the data,
        e.g. ``ImageRecordIter(num_parts=, part_index=)``); the device
        accumulator is summed over the processes at each epoch's end, so
        every process reports the global batch's metric, while the host
        metric and the eval pass see this process's rows."""
        from ..model import _epoch_end_callbacks, _train_epochs
        if logger is None:
            logger = logging
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        if device_metric:
            dm_kind, dm_k = self._device_metric_kind(eval_metric)
            acc = torch.zeros(2, dtype=torch.float32, device=self.device)
        data_names = [x[0] for x in train_data.provide_data]
        label_names = [x[0] for x in train_data.provide_label]
        self.last_train_metric = None
        staged = self.staged_batches(train_data, data_names, label_names)
        first = True

        def batches(epoch):
            staged.reset()
            if device_metric:
                acc.zero_()
            return staged

        def step(batch):
            nonlocal first
            dbatch, dev_batch = batch
            outs = self.step(dev_batch)
            if not device_metric:
                # the host blocks here until the step is done
                fw_t0 = time.perf_counter()
                host = [o.cpu() for o in outs]
                _TM_DEVICE_MS.observe((time.perf_counter() - fw_t0) * 1e3)
                eval_metric.update(dbatch.label, host)
                return
            label = None if dm_kind == "loss" else dev_batch[label_names[0]]
            self._device_metric_update(acc, dm_kind, dm_k, outs[0], label)
            if dm_kind == "ce" and first:
                # the accumulator takes the output for probabilities; a
                # logits output gives garbage. One host read of the first
                # row catches that
                row = float(outs[0][(0,) * (outs[0].dim() - 1)]
                            .double().sum())
                if not 0.9 <= row <= 1.1:
                    logger.warning(
                        "device_metric cross-entropy expects probability "
                        "outputs (rows summing to 1); the first output row "
                        "sums to %.4g - the reported CE will be meaningless "
                        "if the symbol emits raw logits.", row)
            first = False

        def epoch_end(epoch, seconds):
            if device_metric:
                # the epoch's one host read (its sum over the processes)
                msum, total = process_sum(acc).tolist()
                name, value = eval_metric.name, msum / max(total, 1.0)
            else:
                name, value = eval_metric.get()
            self.last_train_metric = (name, value)
            logger.info("Epoch[%d] Train-%s=%f time=%.3f", epoch, name,
                        value, seconds)
            if epoch_end_callback is not None:
                ap, xp = self.get_params()
                _epoch_end_callbacks(epoch_end_callback, epoch, self.symbol,
                                     ap, xp)

        def evaluate(dbatch):
            batch = dict(zip(data_names, dbatch.data))
            batch.update(zip(label_names, dbatch.label))
            eval_metric.update(dbatch.label, self._local_forward(batch))

        _train_epochs(0, num_epoch, batches, step, eval_metric, logger,
                      batch_end_callback=batch_end_callback,
                      epoch_end=epoch_end, eval_data=eval_data,
                      evaluate=evaluate, first_nbatch=0)
        return self

    # -- optimizer-state blobs ---------------------------------------------
    def get_optimizer_states(self):
        """A picklable host snapshot: ``{"step", "opt": {param: [numpy
        leaves in the JAX package's order]}, "torch_rng": the state of the
        generator of dropout and SGLD's noise}``. The JAX package's blob
        keeps its PRNG key under ``"rng"``; the port's generator state
        goes under a key of its own, which the JAX package does not
        read."""
        blob = {"step": int(self._t), "opt": {},
                "torch_rng": self._gen.get_state().numpy().copy()}
        for name, leaves in self._opt_leaves().items():
            blob["opt"][name] = [leaf.detach().cpu().numpy().copy()
                                 for leaf in leaves]
        return blob

    def _opt_leaves(self):
        """``{name: [leaf, ...]}``, each leaf whole."""
        if self._sharded is not None:
            return self._sharded.whole_opt_state()
        return self._state.by_name()

    def _load_opt(self, leaves, what):
        if self._sharded is not None:
            self._sharded.load_opt_state(leaves, what)
        else:
            self._state.load(leaves, what)

    def set_optimizer_states(self, blob):
        """Restore a :meth:`get_optimizer_states` snapshot, the port's or
        the JAX package's (whose ``"rng"`` key is not read), onto the
        trainer, initializing it first if it has no parameters yet. The
        leaves are copied into the state buffers the step program
        holds."""
        if self.params is None:
            self.init_params()
        self._load_opt(blob["opt"], "set_optimizer_states")
        self._t = int(blob["step"])
        if blob.get("torch_rng") is not None:
            self._gen.set_state(torch.from_numpy(
                np.asarray(blob["torch_rng"], dtype=np.uint8)))

    # -- sharded checkpoints ------------------------------------------------
    def save_sharded_checkpoint(self, prefix, step=None,
                                async_write=False):
        """Write the parameters, the optimizer state, the aux states and the
        generator's state (``rng/0``, which the JAX package does not read)
        as ``parallel.checkpoint`` files at ``prefix`` (step: the update
        count unless given). ``async_write=True`` takes the host snapshot
        now and writes on a thread; returns ``finalize()``, which joins
        the writer (a no-op when synchronous)."""
        from .checkpoint import Shards, save_sharded, flatten_train_state
        sh = self._sharded
        params = self.params if sh is None else \
            {n: Shards(sh.specs[n], sh.param_shards(n),
                       tuple(self.arg_shapes[n]))
             for n in self.param_names}
        if sh is not None and sh.mp:
            # each process its shards; what every rank holds whole, the
            # process of rank 0 alone
            def once(v):
                full = tuple((0, d) for d in v.shape)
                return Shards(P(), [(full, v)] if 0 in sh.local else [],
                              tuple(v.shape))

            opt = {n: [Shards(*leaf) for leaf in leaves]
                   for n, leaves in sh.opt_shards().items()}
            flat = flatten_train_state(params, opt, self.aux_names,
                                       [once(a) for a in self.aux])
            flat["rng/0"] = once(self._gen.get_state())
        else:
            flat = flatten_train_state(params, self._opt_leaves(),
                                       self.aux_names, self.aux)
            flat["rng/0"] = self._gen.get_state()
        return save_sharded(prefix, flat,
                            step=self._t if step is None else step,
                            async_write=async_write)

    def restore_sharded_checkpoint(self, prefix):
        """Restore the parameters, the optimizer state, the aux states and
        the step count from ``prefix`` (in place; a fresh trainer is
        initialized from the checkpoint)."""
        from .checkpoint import load_sharded, restore_opt_state
        flat, step, _ = load_sharded(prefix)
        self.init_params({n: flat[n] for n in self.param_names},
                         {n: flat["aux/%s" % n] for n in self.aux_names})
        whole = {n: torch.empty(self.arg_shapes[n], device="meta")
                 for n in self.param_names}
        self._load_opt(restore_opt_state(flat, whole, self._opt_init_fn),
                       "restore_sharded_checkpoint")
        if "rng/0" in flat:
            self._gen.set_state(flat["rng/0"])
        self._t = int(step)
        return self

    def resume_sharded_checkpoint(self, prefix):
        """Restore from ``prefix`` if a COMPLETE sharded checkpoint is
        there (``latest_step``), else leave the trainer as it is. Returns
        the restored step, or None."""
        from .checkpoint import latest_step
        step = latest_step(prefix)
        if step is None:
            return None
        self.restore_sharded_checkpoint(prefix)
        return step
