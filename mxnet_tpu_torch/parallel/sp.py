"""Sequence/context-parallel training: ring attention over a mesh.

Counterpart of ``mxnet_tpu/parallel/sp.py`` ``SequenceParallelTrainer``
(l.44-268). The sequence axis is sharded over the ``sp`` mesh axis (and
the batch over ``dp``), so each rank holds ``T/sp`` positions, and the only
traffic between ranks is the K/V ring inside
``MultiHeadAttention(impl="ring")`` or ``"ring_striped"``. The JAX package
runs the step under ``shard_map``; here a process drives every rank it
owns (``make_spmd_graph_fn``), and its part of the step is one autograd
graph:

* each rank's copy of the parameters is a leaf of its own (the flat f32
  buffer, detached: no copy on the buffer's device), and the step adds
  the ranks' gradients in rank order (``collectives.Span.sum``), the
  ``psum`` over ``("dp", "sp")`` of l.196-203;
* a sequence-sharded parameter (``pos_embed``, ``P("sp", None)``) is
  sliced per rank, so its rows get only their own ranks' gradients (the
  other ranks add exact zeros), the ``psum`` over ``dp`` alone;
* the optimizer updates the one f32 copy, on the first rank's device,
  its state laid out by ``parallel.optim.FlatOptState`` (any optimizer of
  ``optimizer.py``).

**Across processes** (a mesh whose ranks live in several processes,
``Mesh(..., processes=)`` or ``build_mesh`` after
``distributed.initialize``) each process runs its own ranks: their
generators, their slices of the global batch and the walk over them. A
ring whose ranks lie in several processes hops and deals through
``collectives.ring_hop`` and ``all_to_all`` over its ``Span``; the
gradient and the loss are summed over every process's ranks in rank
order, so every process holds the same parameters and optimizer state,
whole (the JAX package shards ``pos_embed`` over sp), and they equal the
one-process run's bit for bit. The step stays uncaptured.

Dropout draws from one ``torch.Generator`` per rank, seeded by its global
``(dp, sp)`` coordinates, the stand-in for the ``fold_in(dp, sp)``
streams, and SGLD's noise from one more: the draws are the port's own,
not JAX's. Sharded checkpoints (``parallel.checkpoint``) hold the
parameters, the optimizer state, the step and the generators' states,
keyed by global rank.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..base import MXNetError, later_slice
from .. import distributed
from .. import optimizer as opt_mod
from ..initializer import Uniform
from .collectives import Span
from .graph import make_spmd_graph_fn, spmd_rings
from .optim import FlatOptState
from .shard import P
from .trainer import _as_tensor, _Unflatten

__all__ = ["SequenceParallelTrainer"]


class SequenceParallelTrainer:
    """Train a sequence model with the sequence axis sharded over ``sp``.

    Parameters
    ----------
    symbol : Symbol
        Loss-headed LM graph whose attention ops use ``impl="ring"`` or
        ``"ring_striped"`` (e.g. ``models.get_transformer_lm(...,
        impl="ring_striped")``). Must have no auxiliary states.
    input_shapes : dict
        GLOBAL shapes: ``data`` [B, T] and the label [B, T]. B shards over
        ``dp``, T over ``sp``.
    mesh : Mesh with axes ``dp`` and ``sp`` (``parallel.build_mesh``); its
        devices may repeat (``[cuda:0] * 4`` runs a 4-rank ring on one
        card, ``["cpu"] * 8`` a dp=2 x sp=4 mesh on the host), and its
        ranks may live in several processes, as many in each.
    seq_param_rules : list[(regex, PartitionSpec)]
        Params sharded WITH the sequence (first match wins); default ships
        the learned positional embedding ``pos_embed`` as ``P('sp', None)``.
        Everything else is replicated.
    """

    def __init__(self, symbol, input_shapes, mesh, optimizer="sgd",
                 optimizer_params=None, initializer=None, seed=0,
                 seq_param_rules=None, label_name="softmax_label"):
        if "sp" not in mesh.shape or "dp" not in mesh.shape:
            raise MXNetError("SequenceParallelTrainer: mesh needs axes "
                             "'dp' and 'sp', got %s" % (dict(mesh.shape),))
        try:
            # the gradient's sum over every rank, and each ring
            self._rspan = Span([mesh.owner(r) for r in range(mesh.size)])
            spmd_rings(mesh, "sp")
        except MXNetError as e:
            raise later_slice("SequenceParallelTrainer", "a mesh whose "
                              "ranks of a collective are spread unevenly "
                              "over the processes (%r: %s)" % (mesh, e))
        if symbol.list_auxiliary_states():
            raise MXNetError("SequenceParallelTrainer: aux states are not "
                             "supported (as in the JAX package)")
        self.symbol = symbol
        self.mesh = mesh
        self.label_name = label_name
        self.input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self.arg_names = symbol.list_arguments()
        self.param_names = [n for n in self.arg_names
                            if n not in self.input_shapes]
        arg_shapes, _, _ = symbol.infer_shape(**{
            k: self._local_shape(k, v) for k, v in self.input_shapes.items()})
        if arg_shapes is None:
            raise MXNetError("SequenceParallelTrainer: shape inference "
                             "failed")
        # param shapes are inferred from LOCAL input shapes; params are
        # either replicated (shape == global) or sequence-sharded (their
        # global shape scales with sp — pos_embed rows)
        self._local_arg_shapes = dict(zip(self.arg_names, arg_shapes))

        if seq_param_rules is None:
            seq_param_rules = [(r"pos_embed$", P("sp", None))]
        self._seq_rules = [(re.compile(pat), spec)
                           for pat, spec in seq_param_rules]

        batch, seqlen = self.input_shapes["data"][:2]
        self.global_batch = batch
        self.seq_len = seqlen
        if isinstance(optimizer, str):
            # multi_output LM gradients sum over batch AND positions;
            # default to per-token normalization (overridable)
            opt_kwargs = dict(optimizer_params or {})
            opt_kwargs.setdefault("rescale_grad", 1.0 / (batch * seqlen))
            optimizer = opt_mod.create(optimizer, **opt_kwargs)
        self.optimizer = optimizer
        self._initializer = initializer or Uniform(0.05)
        self._init_gen = torch.Generator().manual_seed(seed)
        self._graph_fn = make_spmd_graph_fn(symbol, mesh)
        # every rank in row-major order of the mesh; this process walks
        # its own, in that order
        axes = mesh.axis_names
        self._ranks = [(mesh.devices[c], c[axes.index("dp")],
                        c[axes.index("sp")])
                       for c in np.ndindex(*mesh.devices.shape)]
        self._local = list(mesh.local_ranks)
        self.device = self._ranks[self._local[0]][0]
        self._gens = []
        for r in self._local:
            dev, dpi, spi = self._ranks[r]
            s = int(np.random.SeedSequence([seed, dpi, spi]).generate_state(
                1)[0])
            self._gens.append(torch.Generator(device=dev).manual_seed(s))
        # SGLD's noise: one draw for the one copy of the parameters
        self._opt_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = None
        self.opt_state = None
        self._state = None
        self._t = 0

    # -- sharding helpers ------------------------------------------------
    def _param_spec(self, name):
        for pat, spec in self._seq_rules:
            if pat.search(name):
                return spec
        return P()

    def _local_shape(self, name, global_shape):
        """Global [B, T] -> local [B/dp, T/sp] for inputs."""
        dp = self.mesh.shape["dp"]
        sp = self.mesh.shape["sp"]
        s = list(global_shape)
        if s[0] % dp or (len(s) > 1 and s[1] % sp):
            raise MXNetError("global shape %s not divisible by mesh %s"
                             % (global_shape, dict(self.mesh.shape)))
        s[0] //= dp
        if len(s) > 1:
            s[1] //= sp
        return tuple(s)

    def _global_param_shape(self, name):
        """Undo the sp factor for sequence-sharded params."""
        spec = self._param_spec(name)
        shape = list(self._local_arg_shapes[name])
        for i, ax in enumerate(spec):
            if ax == "sp":
                shape[i] *= self.mesh.shape["sp"]
        return tuple(shape)

    # -- state -----------------------------------------------------------
    def init_params(self, arg_params=None):
        """The parameters as one flat f32 buffer on the first rank's device
        (``params`` maps each name to its view), drawn by the initializer
        or taken from ``arg_params`` (numpy arrays, torch tensors or arrays
        with ``asnumpy()``), and the optimizer state."""
        vals = []
        for name in self.param_names:
            shape = self._global_param_shape(name)
            if arg_params and name in arg_params:
                val = _as_tensor(arg_params[name]).to(torch.float32)
                if tuple(val.shape) != shape:
                    raise MXNetError("param %s: shape %s != %s"
                                     % (name, tuple(val.shape), shape))
            else:
                val = torch.zeros(shape, dtype=torch.float32)
                self._initializer(name, val, self._init_gen)
            vals.append(val.reshape(-1))
        self._flat = torch.cat(vals).to(self.device)
        self.params = self._views(self._flat)
        self._state = FlatOptState(self.optimizer, self.param_names,
                                   self._shapes(), self._flat)
        self.opt_state = self._state.by_name()
        self._t = 0
        return self

    def _shapes(self):
        return tuple(self._global_param_shape(n) for n in self.param_names)

    def _views(self, flat):
        shapes = self._shapes()
        parts = flat.split([int(np.prod(sh)) for sh in shapes])
        return {n: p.view(sh) for n, p, sh in zip(self.param_names, parts,
                                                  shapes)}

    def _rank_value(self, name, val, dpi, spi):
        """Rank (dpi, spi)'s shard of a parameter: its rows along each
        dimension its spec shards."""
        coord = {"dp": dpi, "sp": spi}
        for i, ax in enumerate(self._param_spec(name)):
            if ax is not None:
                size = val.shape[i] // self.mesh.shape[ax]
                val = val.narrow(i, coord[ax] * size, size)
        return val

    # -- the sharded step ------------------------------------------------
    def step(self, batch):
        """One global train step. batch: dict with GLOBAL 'data' and label
        arrays (host or device), the same in every process. Returns the
        mean NLL per token over the global batch as a 0-d tensor on the
        first local rank's device (reading it waits for the step), the
        same in every process."""
        if self.params is None:
            self.init_params()
        data = _as_tensor(batch["data"])
        label = _as_tensor(batch[self.label_name])
        bl, tl = self._local_shape("data", self.input_shapes["data"])
        self._t += 1
        sched = self.optimizer.lr_scheduler
        lr = sched(self._t) if sched is not None else self.optimizer.lr
        leaves, rank_args, labels = [], [], []
        for r in self._local:
            dev, dpi, spi = self._ranks[r]
            # the rank's own leaf: its gradient is the rank's alone
            leaf = self._flat.detach().to(dev).requires_grad_(True)
            leaves.append(leaf)
            pvals = dict(zip(self.param_names,
                             _Unflatten.apply(leaf, self._shapes())))
            rows = slice(dpi * bl, (dpi + 1) * bl)
            cols = slice(spi * tl, (spi + 1) * tl)
            inputs = {"data": data[rows, cols].to(dev),
                      self.label_name: label[rows, cols].to(dev)}
            labels.append(inputs[self.label_name])
            rank_args.append([
                inputs[n] if n in inputs else
                self._rank_value(n, pvals[n], dpi, spi)
                for n in self.arg_names])
        outs, _ = self._graph_fn(rank_args, True, self._gens)
        flat_outs = [o for ro in outs for o in ro]
        torch.autograd.backward(flat_outs,
                                [torch.ones_like(o) for o in flat_outs])
        # the ranks' gradients added in rank order, over every process
        grad = self._rspan.sum([
            leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            for leaf in leaves])
        self._state.update(self._flat, grad, lr, float(self._t),
                           self._opt_gen)
        # global mean NLL per token (for logging): outs[i][0] is local
        # rank i's [B_l, V, T_l] multi_output softmax
        with torch.no_grad():
            nll = self._rspan.sum([
                (-torch.log(ro[0].gather(1, lab.long()[:, None, :])[:, 0]
                            + 1e-8).sum()).to(self.device)
                for ro, lab in zip(outs, labels)])
        return nll / float(self.global_batch * self.seq_len)

    def get_params(self):
        """Host copies of the parameters, CPU f32 tensors by name."""
        return {n: v.detach().to("cpu", copy=True)
                for n, v in self.params.items()}

    # -- sharded checkpoints --------------------------------------------
    def _generators(self):
        """``{global rank: generator}`` of this process's ranks, and SGLD's
        at the rank count."""
        out = dict(zip(self._local, self._gens))
        out[self.mesh.size] = self._opt_gen
        return out

    def save_sharded_checkpoint(self, prefix, step=None, async_write=False):
        """Write the parameters, the optimizer state and the generators'
        states (``rng/<global rank>``, SGLD's at the rank count) as
        ``parallel.checkpoint`` files at ``prefix`` (step: the update
        count unless given); across processes call it from every process:
        process 0 writes the parameters, the state and SGLD's generator,
        each process its ranks' generators, and every key reaches the
        manifest. ``async_write=True`` writes on a thread; returns
        ``finalize()``, which joins it."""
        from .checkpoint import save_sharded, flatten_train_state, Shards
        flat = flatten_train_state(self.params, self._state.by_name())
        gens = self._generators()
        if self.mesh.is_multiprocess:
            first = distributed.process_index() == 0
            flat = {k: Shards(P(), [(tuple((0, d) for d in v.shape), v)]
                              if first else [], tuple(v.shape))
                    for k, v in flat.items()}
            # the ranks' generators are of one device type: one width
            width = gens[self._local[0]].get_state().numel()
            for r in range(self.mesh.size + 1):
                g = gens.get(r) if r < self.mesh.size or first else None
                flat["rng/%d" % r] = Shards(
                    P(), [] if g is None else [(((0, width),),
                                                g.get_state())],
                    (width,), torch.uint8)
        else:
            flat.update({"rng/%d" % r: g.get_state()
                         for r, g in gens.items()})
        return save_sharded(prefix, flat,
                            step=self._t if step is None else step,
                            async_write=async_write)

    def restore_sharded_checkpoint(self, prefix):
        """Restore the parameters, the optimizer state, the step count and
        this process's generators from ``prefix`` (written by any number
        of processes); works on a fresh trainer."""
        from .checkpoint import load_sharded, restore_opt_state
        flat, step, _ = load_sharded(prefix)
        self.init_params({n: flat[n] for n in self.param_names})
        self._state.load(restore_opt_state(flat, self.params,
                                           self._state.init_fn),
                         "restore_sharded_checkpoint")
        for r, g in self._generators().items():
            if "rng/%d" % r in flat:
                g.set_state(flat["rng/%d" % r])
        self._t = int(step)
        return self
