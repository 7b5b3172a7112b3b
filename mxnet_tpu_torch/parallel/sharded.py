"""The training state and step of ``ParallelTrainer`` over a mesh of more
than one rank.

Counterpart of what GSPMD makes of the JAX package's ``ParallelTrainer``
step (``mxnet_tpu/parallel/trainer.py`` l.217-330, l.406-484): there the
arrays carry shardings and XLA partitions one program; here one process
holds a tensor per rank and the step says what moves. The numbers are
the one-device step's, as GSPMD's are:

* **Layout.** Every rank stores its shard of each parameter as the
  rules' spec says (``fsdp``: a replicated parameter is stored ``1/dp``
  per rank on its first dimension that ``dp`` divides), all of a rank's
  shards in one flat f32 buffer; its optimizer state follows that buffer
  (``zero1``: the rank's ``1/dp`` chunk of it, ``parallel.optim.
  FlatOptState``), its aux states are whole copies, and its inputs are
  its slice of the batch (``ShardingRules.data_spec``).
* **Walks.** The batch is split over the rules' ``data_axes``; each
  data-parallel coordinate runs the graph on its rows once, on the rank
  at index 0 of every other axis (the ranks of a ``tp``, ``ep`` or ``sp``
  group would compute the same thing, so they compute it once). The
  walks go in lockstep (``make_spmd_graph_fn``), so BatchNorm sees the
  global batch. A parameter a rank holds whole enters its walk as a view
  of the rank's flat buffer; a sharded one is all-gathered where the walk
  reaches it (the tensor-parallel rules store the shard and gather it
  at use: the products are not split per rank).
* **Gradients.** Each walk's gradients are summed over the walks with
  ``psum`` (in rank order), and each rank takes its shard of the sum:
  for a sharded parameter that is the reduce-scatter, and it adds in the
  same order as the replicated parameters' ``psum``, so zero1 and fsdp
  equal plain data parallelism bit for bit.
* **Update.** Each rank updates what it stores (``zero1``: its chunk of
  the flat buffer, then the chunks are all-gathered into every rank's
  buffer). AdaFactor's factored moments are not elementwise: its state
  leaves are stored as the JAX package shards them (dim 0 over ``dp``
  under zero1 when ``dp`` divides it; under fsdp a leaf of the
  parameter's shape follows the parameter), and each rank gathers the
  whole weight, gradient and leaves (across processes, from every
  process's shards), updates them and keeps its shards.

**Across processes** (a mesh whose ranks live in several processes,
``Mesh.local_ranks``; the multi-controller run of ``tools/launch.py``)
each process holds its own ranks alone and runs one walk a local
data-parallel coordinate; its inputs are its slice of the global batch
(JAX's ``make_array_from_process_local_data``). What crosses processes
goes over gloo (``collectives.Span``) between captured programs, never
inside one (a graph cannot hold a gloo call): ``gather_params`` (the
sharded parameters whole, before the walk), ``gather_rows`` (every
walk's rows, for ``grad_accum``'s global-row microbatches), the
compute program (the walks' forward and backward into one flat gradient
a walk: the rank layout, then each gathered parameter's whole gradient),
``reduce`` (the flat gradients summed over every process's walks in
rank order: bitwise ``psum``'s sum), ``gather_pw`` (a per-weight
optimizer's sharded parameters and state leaves from every process),
the update program, and ``gather_chunks`` (ZeRO-1's chunks). A training
BatchNorm sums its statistics over every process's walks inside the walk
(``BatchNorm.forward_global`` over the walks' span), so a walk holding
one cannot be captured and runs uncaptured. The walks' generators are
seeded by the global walk index, so a walk draws what it draws in one
process. Each rank's shards stay where they live; ``whole_params``,
``whole_opt_state`` and ``forward`` gather across processes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError, later_slice
from ..ops.registry import DrawTape
from .collectives import Span
from .graph import make_spmd_graph_fn
from .layout import Layout, spec_groups
from .mesh import Mesh
from .optim import FlatOptState
from .shard import P

__all__ = ["ShardedState", "remat_walk", "backward_heads"]


def backward_heads(outs):
    """The backward from head gradients of ones (the loss heads ignore
    them); a head outside autograd (``BlockGrad``) takes no part."""
    outs = [o for o in outs if o.requires_grad]
    if outs:
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])


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


def remat_walk(fn, leaves):
    """``fn(*leaves)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the backward recomputes the forward's activations instead of keeping
    them, the counterpart of the JAX package's ``jax.checkpoint`` over the
    differentiated forward. The forward's draws are kept on a
    ``DrawTape`` and handed back to the recompute, so it applies the
    masks the forward drew, also inside a captured step."""
    from torch.utils.checkpoint import checkpoint
    tape = DrawTape()
    recorded = []

    def run(*args):
        with (tape.replay() if recorded else tape.record()):
            out = fn(*args)
        recorded.append(True)
        return out

    return checkpoint(run, *leaves, use_reentrant=False,
                      preserve_rng_state=False)


class ShardedState:
    """Per-rank parameters, optimizer state, aux states and input buffers
    of a ``ParallelTrainer`` on ``trainer.mesh``, and its step."""

    def __init__(self, trainer):
        t = self.trainer = trainer
        mesh, rules = t.mesh, t.rules
        self.layout = L = Layout(mesh)
        self.devices = L.devices
        self.specs = {n: rules.param_sharding(n, t.arg_shapes[n]).spec
                      for n in t.param_names}
        self.dp = mesh.shape.get("dp", 1)
        if t.fsdp:
            for n in t.param_names:
                if spec_groups(self.specs[n], len(t.arg_shapes[n])):
                    continue  # a rule already shards it
                shape = t.arg_shapes[n]
                ax = next((i for i, d in enumerate(shape)
                           if d % self.dp == 0 and d >= self.dp), None)
                if ax is not None:
                    spec = [None] * len(shape)
                    spec[ax] = "dp"
                    self.specs[n] = P(*spec)
        self.data_specs = {k: rules.data_sharding(k, s).spec
                           for k, s in t.input_shapes.items()}
        # one walk a data-parallel coordinate, when every input's batch
        # splits over the data axes; else one walk on rank 0
        axes = tuple(rules.data_axes)
        if not axes or any(
                not spec_groups(sp, 1) or spec_groups(sp, 1)[0][1] != axes
                for sp in self.data_specs.values()):
            axes = ()
        self.walk_axes = axes
        zero = {a: 0 for a in L.axes if a not in axes}
        self.walk_ranks = [r for r in range(len(L))
                           if all(L.index(r, a) == 0 for a in zero)]
        self.walk_of = [self.walk_ranks.index(L.moved(r, zero))
                        for r in range(len(L))]
        nw = len(self.walk_ranks)
        if t.grad_accum > 1 and t.global_batch % (t.grad_accum * nw):
            raise MXNetError(
                "grad_accum=%d: a microbatch of %d rows does not split "
                "over %d data-parallel walks"
                % (t.grad_accum, t.global_batch // t.grad_accum, nw))
        # this process's ranks and walks (all of them in one process)
        self.mp = mesh.is_multiprocess
        self.local = list(mesh.local_ranks)
        mine = set(self.local)
        self.lwalks = [w for w, r in enumerate(self.walk_ranks) if r in mine]
        self.rspan = Span([mesh.owner(r) for r in range(len(L))])
        self.wspan = Span([mesh.owner(r) for r in self.walk_ranks])
        if self.mp:
            self._check_multiprocess(axes, mine)
        wdev = np.empty(len(self.lwalks), dtype=object)
        wdev[:] = [self.devices[self.walk_ranks[w]] for w in self.lwalks]
        if axes and not self.mp:
            wmesh = Mesh(wdev.reshape([mesh.shape[a] for a in axes]), axes)
        else:
            wmesh = Mesh(wdev, ("dp",))
        # fusion only on a one-rank mesh (the JAX rule, trainer.py
        # l.317-322): this walk never fuses unless MXNET_PALLAS_FUSION=1
        self.graph_fn = make_spmd_graph_fn(
            t.symbol, wmesh, allow_fusion=False,
            span=self.wspan if self.mp else None)
        # a training BatchNorm sums over the processes inside the walk
        self.cross_in_walk = self.mp and any(
            hasattr(n.spec, "forward_global") for n in t.symbol._topo()
            if not n.is_var)
        self.gathered = [n for n in t.param_names
                         if spec_groups(self.specs[n], len(t.arg_shapes[n]))]
        self.shard_shapes = {n: L.shard_shape(t.arg_shapes[n], self.specs[n])
                             for n in t.param_names}
        numel = sum(int(np.prod(s)) for s in self.shard_shapes.values())
        self.per_weight = getattr(t._opt_update_fn, "per_weight", False)
        if self.per_weight:
            self.leaf_specs = {n: self._leaf_specs(n, t._opt_init_fn(
                torch.empty(t.arg_shapes[n], device="meta")))
                for n in t.param_names}
        self.zero1 = t.zero1 and not t.fsdp and not self.per_weight \
            and self.dp > 1
        self.pad = (-numel) % self.dp if self.zero1 else 0
        self.flat_shapes = tuple(self.shard_shapes[n]
                                 for n in t.param_names)
        if self.pad:
            self.flat_shapes += ((self.pad,),)
        # a per-weight update reads other processes' shards
        self.pw_cross = self.mp and self.per_weight and any(
            spec_groups(sp, 8) for n in t.param_names
            for sp in [self.specs[n]] + self.leaf_specs[n])
        self._pw_bufs = None
        seed = t._seed
        # seeded by the GLOBAL walk index: walk w draws what it draws in
        # one process
        self.walk_gens = [
            torch.Generator(device=self.devices[self.walk_ranks[w]])
            .manual_seed(int(np.random.SeedSequence([seed, w])
                             .generate_state(1)[0]))
            for w in self.lwalks]
        # SGLD's noise: the same stream on every rank, so replicas of a
        # parameter get the same update
        self.opt_gens = [torch.Generator(device=d).manual_seed(seed)
                         if r in mine else None
                         for r, d in enumerate(self.devices)]
        self.flats = None
        self.whole = None     # the gathered parameters (several processes)
        self.xrows = None     # every walk's rows (grad_accum, ditto)
        self.gsum = None      # the summed flat gradient (ditto)
        self._outs = None

    def _check_multiprocess(self, axes, mine):
        """What a mesh across processes needs: the batch split over the
        data axes, every local rank's walk in this process, and this
        process's rows of each input one block of the global batch
        (``Layout.process_rows``)."""
        t, L = self.trainer, self.layout
        if not axes:
            raise later_slice("ParallelTrainer", "a mesh across processes "
                              "whose inputs do not split over the data "
                              "axes")
        if any(self.walk_ranks[self.walk_of[r]] not in mine
               for r in self.local):
            raise later_slice("ParallelTrainer", "a non-data mesh axis "
                              "across processes")
        self.row_lo = {}
        for k, shape in t.input_shapes.items():
            lo, hi = L.process_rows(shape, self.data_specs[k])
            self.row_lo[k] = lo
        self.local_batch = hi - lo

    # -- layout helpers ----------------------------------------------------
    def _views(self, flat):
        numels = [int(np.prod(s)) for s in self.flat_shapes]
        parts = flat.split(numels)
        return {n: p.view(s) for n, p, s in zip(self.trainer.param_names,
                                                 parts, self.flat_shapes)}

    def _leaf_specs(self, name, leaves):
        """The specs of AdaFactor's state leaves for ``name`` (the JAX
        package's ``leaf_sh``/``fsdp_leaf_sh``)."""
        t = self.trainer
        shape = tuple(t.arg_shapes[name])
        out = []
        for leaf in leaves:
            ls = tuple(leaf.shape)
            if ls == shape and (t.fsdp or not t.zero1):
                out.append(self.specs[name])
            elif (t.zero1 or t.fsdp) and ls and ls[0] % self.dp == 0:
                out.append(P("dp"))
            else:
                out.append(P())
        return out

    # -- state ---------------------------------------------------------------
    def init(self, values, aux_values):
        """Lay ``values`` (whole f32 tensors by name, on the host) and the
        aux values out over this process's ranks (None at another
        process's): allocate on the first call, copy into the live
        buffers after it (a captured step holds them)."""
        t, L = self.trainer, self.layout
        flats = [None] * len(L)
        aux = [None] * len(L)
        for r in self.local:
            dev = self.devices[r]
            parts = [L.shard(values[n], self.specs[n], r).reshape(-1)
                     for n in t.param_names]
            if self.pad:
                parts.append(torch.zeros(self.pad))
            flats[r] = torch.cat(parts).to(dev)
            aux[r] = [a.to(dev, copy=True) for a in aux_values]
        first = self.flats is None
        if first:
            self.flats, self.aux = flats, aux
            self.rank_params = [None if f is None else self._views(f)
                                for f in self.flats]
        else:
            for r in self.local:
                self.flats[r].copy_(flats[r])
                for d, v in zip(self.aux[r], aux[r]):
                    d.copy_(v)
        if self.per_weight:
            st = [None] * len(L)
            for r in self.local:
                per = {}
                for n in t.param_names:
                    leaves = t._opt_init_fn(values[n])
                    per[n] = [L.shard(v, s, r).to(self.devices[r], copy=True)
                              for v, s in zip(leaves, self.leaf_specs[n])]
                st[r] = per
            if first:
                self.pw_state = st
            else:
                for r in self.local:
                    for n in st[r]:
                        for d, v in zip(self.pw_state[r][n], st[r][n]):
                            d.copy_(v)
            return
        if first:
            self.states = [
                None if f is None else
                FlatOptState(t.optimizer, t.param_names,
                             [self.shard_shapes[n] for n in t.param_names],
                             f, shards=self.dp if self.zero1 else 1,
                             index=L.index(r, "dp") if self.zero1 else 0)
                for r, f in enumerate(self.flats)]
        else:
            for r in self.local:
                self.states[r].reset(self.flats[r])

    def buffers(self):
        """Everything the step updates in place."""
        out = [self.flats[r] for r in self.local]
        for r in self.local:
            if self.per_weight:
                for leaves in self.pw_state[r].values():
                    out.extend(leaves)
            else:
                out.extend(self.states[r].buffers())
        for r in self.local:
            out.extend(self.aux[r])
        return out

    def generators(self):
        return self.walk_gens + self.local_opt_gens()

    def local_opt_gens(self):
        return [self.opt_gens[r] for r in self.local]

    def input_buffers(self):
        """``{"name@rank": buffer}``: each local rank's slice of each
        input."""
        t, L = self.trainer, self.layout
        out = {}
        for k, shape in t.input_shapes.items():
            sh = L.shard_shape(shape, self.data_specs[k])
            for r in self.local:
                out["%s@%d" % (k, r)] = torch.empty(
                    sh, dtype=t._input_dtypes[k], device=self.devices[r])
        return out

    def split_batch(self, vals):
        """``{"name@rank": slice}`` of the batch ``vals``: the global
        batch, or across processes this process's slice of it."""
        if self.mp:
            for k, v in vals.items():
                if v.shape[0] != self.local_batch:
                    raise MXNetError(
                        "ParallelTrainer: input %r has %d rows; across %d "
                        "processes each passes its %d rows of the global "
                        "batch of %d" % (k, v.shape[0], self.rspan.nprocs,
                                         self.local_batch,
                                         self.trainer.global_batch))
        L, t = self.layout, self.trainer
        return {"%s@%d" % (k, r): L.shard(v, self.data_specs[k], r)
                if not self.mp else
                L.shard(v, self.data_specs[k], r, t.input_shapes[k],
                        self.row_lo[k])
                for k, v in vals.items() for r in self.local}

    # -- the step -------------------------------------------------------------
    def _walk_inputs(self, inputs, w):
        """Walk ``w``'s rows of every input, whole along the sequence (the
        shards of the ranks of its ``sp`` group gathered)."""
        t, L = self.trainer, self.layout
        rw = self.walk_ranks[w]
        return {k: L.assemble(lambda rr, k=k: inputs["%s@%d" % (k, rr)],
                              self.data_specs[k], rw, len(shape),
                              keep=self.walk_axes)
                for k, shape in t.input_shapes.items()}

    def _gather_param(self, name, i, record, cast):
        """Local walk ``i``'s whole value of the sharded parameter
        ``name``: an all-gather of the ranks' shards (across processes the
        one ``gather_params`` made before the walk), made a leaf of its
        own (its gradient is reduce-scattered by the step, in ``psum``'s
        order)."""
        leaf = record.get(name)
        if leaf is None:
            if self.mp:
                whole = self.whole[name]
            else:
                L = self.layout
                whole = L.assemble(lambda rr: self.rank_params[rr][name],
                                   self.specs[name],
                                   self.walk_ranks[self.lwalks[i]],
                                   len(self.trainer.arg_shapes[name]))
            leaf = record[name] = whole.detach().requires_grad_(True)
        return cast(leaf)

    def _walk_args(self, leaves, inputs, records, cast):
        t = self.trainer
        args = []
        for i, leaf in enumerate(leaves):
            views = dict(zip(t.param_names,
                             _Unflatten.apply(cast(leaf), self.flat_shapes)))
            rows = inputs[i]
            vals = []
            for n in t.arg_names:
                if n in rows:
                    vals.append(rows[n] if n in t._no_cast
                                else cast(rows[n]))
                elif n in self.gathered:
                    vals.append(functools.partial(
                        self._gather_param, n, i, records[i], cast))
                else:
                    vals.append(views[n])
            args.append(vals)
        return args

    def _grads(self, inputs):
        """One walk over ``inputs`` (per local walk, by name) and its
        backward: ``(A, B, outs)``, per local walk: the flat gradient of
        the rank layout (zeros where a parameter was gathered), the whole
        gradient of each gathered parameter, and the head outputs."""
        t = self.trainer
        wranks = [self.walk_ranks[w] for w in self.lwalks]
        nw = len(wranks)
        leaves = [self.flats[r].detach().requires_grad_(True)
                  for r in wranks]
        records = [dict() for _ in range(nw)]
        rank_aux = [list(self.aux[r]) for r in wranks]
        n_out = len(t.out_shapes)

        def walk(*ls):
            args = self._walk_args(ls, inputs, records, t._cast)
            outs, new_aux = self.graph_fn(args, True, self.walk_gens,
                                          rank_aux=rank_aux)
            return tuple(o for ro in outs for o in ro) \
                + tuple(a for ra in new_aux for a in ra)

        if t.remat:
            res = remat_walk(walk, leaves)
        else:
            res = walk(*leaves)
        flat_outs = list(res[:n_out * nw])
        backward_heads(flat_outs)
        na = len(t.aux_names)
        with torch.no_grad():
            for i, r in enumerate(wranks):
                for j, a in enumerate(self.aux[r]):
                    a.copy_(res[n_out * nw + i * na + j])
        A = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
             for leaf in leaves]
        B = {}
        for n in self.gathered:
            B[n] = []
            for i in range(nw):
                leaf = records[i].get(n)
                if leaf is None or leaf.grad is None:
                    B[n].append(torch.zeros(t.arg_shapes[n],
                                            device=self.devices[wranks[i]]))
                else:
                    B[n].append(leaf.grad)
        outs = [[o.detach() for o in flat_outs[i * n_out:(i + 1) * n_out]]
                for i in range(nw)]
        return A, B, outs

    def _accumulate(self, inputs):
        """The local walks' gradients summed over the ``grad_accum``
        microbatches: ``(A, B, outs_parts)``, ``outs_parts[i]`` the
        walks' outputs of microbatch ``i``."""
        t = self.trainer
        if t.grad_accum > 1:
            rows = self.xrows if self.mp else [
                self._walk_inputs(inputs, w)
                for w in range(len(self.walk_ranks))]
        else:
            rows = [self._walk_inputs(inputs, w) for w in self.lwalks]
        A = B = None
        outs_parts = []
        for i in range(t.grad_accum):
            part = self._microbatch(rows, i) if t.grad_accum > 1 else rows
            a, b, outs = self._grads(part)
            outs_parts.append(outs)
            if A is None:
                A, B = a, b
            else:
                A = [x + y for x, y in zip(A, a)]
                B = {n: [x + y for x, y in zip(B[n], b[n])] for n in B}
        return A, B, outs_parts

    def step(self, inputs, lr, tdev):
        """One train step over the input buffers ``inputs`` (every rank in
        this process); returns the head outputs of the global batch (on
        rank 0's device)."""
        nw = len(self.walk_ranks)
        A, B, outs_parts = self._accumulate(inputs)
        self._apply(self.wspan.sum(A),
                    {n: self.wspan.sum(v) for n, v in B.items()}, lr, tdev)
        if self.zero1:
            self.gather_chunks()
        dev0 = self.devices[0]
        # batch-major: microbatch i's rows, walk by walk within it (the
        # JAX reshape of [A, B/A] back to [B])
        parts = [outs[w] for outs in outs_parts for w in range(nw)]
        if len(parts) == 1:
            return parts[0]
        return [torch.cat([p[j].to(dev0) for p in parts])
                for j in range(len(parts[0]))]

    def _apply(self, A, B, lr, tdev):
        """Each local rank's update from the summed gradient: ``A`` the
        flat gradient of the rank layout, ``B`` each gathered parameter's
        whole gradient (on any device); the global-norm clip first. Then
        every local rank's aux states are its walk's."""
        t, L = self.trainer, self.layout
        scale = None
        if t.clip_grad_norm is not None:
            sq = A.square().sum()
            for n in self.gathered:
                sq = sq + B[n].square().sum()
            gnorm = torch.sqrt(sq) * t.optimizer.rescale_grad
            scale = torch.clamp(t.clip_grad_norm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = {}
        for r in self.local:
            dev = self.devices[r]
            g = A.to(dev)
            if self.gathered:
                g = g.clone()
                views = self._views(g)
                for n in self.gathered:
                    views[n].copy_(L.shard(B[n], self.specs[n], r))
            if scale is not None:
                g = g * scale.to(dev)
            grads[r] = g
        if self.per_weight:
            self._update_per_weight(grads, B, lr, tdev)
        else:
            for r in self.local:
                f = self.flats[r]
                self.states[r].update(f, grads[r], lr.to(f.device),
                                      tdev.to(f.device), self.opt_gens[r])
        with torch.no_grad():
            for r in self.local:
                src = self.walk_ranks[self.walk_of[r]]
                if src != r:
                    for d, v in zip(self.aux[r], self.aux[src]):
                        d.copy_(v)

    def _microbatch(self, rows, i):
        """Microbatch ``i`` of ``grad_accum`` A, per local walk: global
        rows ``[i*B/A, (i+1)*B/A)`` split over the walks as a whole batch
        is (the JAX trainer's reshape of the global batch to ``[A, B/A]``,
        ``mxnet_tpu/parallel/trainer.py`` l.442-443), so a BatchNorm
        sees the JAX microbatch. ``rows`` are every walk's rows. Walk
        ``w``'s piece is global chunk ``i*nw + w`` of size ``B/(A*nw)``,
        which lies in walk ``(i*nw + w) // A``'s rows."""
        a, nw = self.trainer.grad_accum, len(rows)
        out = []
        for w in self.lwalks:
            c = i * nw + w
            src = rows[c // a]
            dev = self.devices[self.walk_ranks[w]]
            out.append({k: v.chunk(a)[c % a].to(dev)
                        for k, v in src.items()})
        return out

    # -- the step across processes: programs and the host stages between
    def bind(self, inputs, lr, tdev):
        """The step's pieces across processes over the input buffers
        ``inputs`` (this process's ranks), in order: ``[(kind, fn)]``,
        kind "host" (gloo between the programs: takes the previous
        piece's result) or "program" (a function of no arguments that a
        ``Program`` captures) with the program's mutable state and
        generators."""
        self.inputs, self._lr, self._tdev = inputs, lr, tdev
        out = []
        if self.gathered:
            out.append(("host", self.gather_params))
        if self.trainer.grad_accum > 1:
            out.append(("host", self.gather_rows))
        out.append(("program", "compute", self.compute,
                    [a for r in self.local for a in self.aux[r]],
                    list(self.walk_gens), not self.cross_in_walk))
        out.append(("host", self.reduce))
        if self.pw_cross:
            out.append(("host", self.gather_pw))
        out.append(("program", "update", self.update, self.buffers(),
                    self.local_opt_gens(), True))
        if self.zero1:
            out.append(("host", self.gather_chunks))
        out.append(("host", lambda _: self._outs))
        return out

    @torch.no_grad()
    def gather_params(self, _=None):
        """Host stage: every gathered parameter whole, from every rank's
        shards (one all-gather of the ranks' flat buffers), into the
        buffers the walks read."""
        L, t = self.layout, self.trainer
        flats = self.rspan.gather([self.flats[r] for r in self.local])
        views = [self._views(f) for f in flats]
        rw = self.walk_ranks[self.lwalks[0]]
        fresh = self.whole is None
        if fresh:
            self.whole = {}
        for n in self.gathered:
            v = L.assemble(lambda rr, n=n: views[rr][n], self.specs[n], rw,
                           len(t.arg_shapes[n]))
            if fresh:
                self.whole[n] = v.clone()
            else:
                self.whole[n].copy_(v)

    @torch.no_grad()
    def gather_rows(self, _=None):
        """Host stage (``grad_accum``): every walk's rows of every input
        from every process, for the global-row microbatches."""
        rows = [self._walk_inputs(self.inputs, w) for w in self.lwalks]
        fresh = self.xrows is None
        if fresh:
            self.xrows = [dict() for _ in self.walk_ranks]
        for k in self.trainer.input_shapes:
            every = self.wspan.gather([r[k] for r in rows])
            for w, v in enumerate(every):
                if fresh:
                    self.xrows[w][k] = v.clone()
                else:
                    self.xrows[w][k].copy_(v)

    def compute(self):
        """The compute program: the local walks' forward and backward.
        Returns the outputs (microbatch by microbatch, walk by walk) and
        one flat gradient a local walk: the rank layout's, then each
        gathered parameter's whole gradient."""
        A, B, outs_parts = self._accumulate(self.inputs)
        packed = [torch.cat([a] + [B[n][i].reshape(-1)
                                   for n in self.gathered])
                  if self.gathered else a for i, a in enumerate(A)]
        return tuple(o for outs in outs_parts for ro in outs for o in ro) \
            + tuple(packed)

    @torch.no_grad()
    def reduce(self, res):
        """Host stage: the walks' flat gradients summed over every
        process in rank order into the buffer the update reads; the
        step's outputs: this process's rows."""
        t = self.trainer
        n_out, nlw = len(t.out_shapes), len(self.lwalks)
        k = t.grad_accum * nlw * n_out
        total = self.wspan.sum(res[k:])
        if self.gsum is None:
            self.gsum = torch.empty_like(total)
        self.gsum.copy_(total)
        outs = [[list(res[(i * nlw + w) * n_out:(i * nlw + w + 1) * n_out])
                 for w in range(nlw)] for i in range(t.grad_accum)]
        if t.grad_accum == 1:
            self._outs = outs[0][0] if nlw == 1 else [
                torch.cat([o[j] for o in outs[0]]) for j in range(n_out)]
            return
        # microbatch i's global chunk i*nw + w came from walk w: gather
        # them all and keep this process's rows
        lo = self.row_lo[next(iter(t.input_shapes))]
        full = []
        for j in range(n_out):
            chunks = []
            for i in range(t.grad_accum):
                chunks.extend(self.wspan.gather([o[j] for o in outs[i]]))
            full.append(torch.cat(chunks).narrow(0, lo, self.local_batch))
        self._outs = full

    def update(self):
        """The update program: the clip and each local rank's update from
        the summed gradient."""
        nflat = self.flats[self.local[0]].numel()
        A = self.gsum.narrow(0, 0, nflat)
        B, off = {}, nflat
        for n in self.gathered:
            size = int(np.prod(self.trainer.arg_shapes[n]))
            B[n] = self.gsum.narrow(0, off, size).view(
                self.trainer.arg_shapes[n])
            off += size
        self._apply(A, B, self._lr, self._tdev)
        return ()

    @torch.no_grad()
    def gather_chunks(self, _=None):
        """ZeRO-1's all-gather (across processes a host stage): every
        local rank's buffer gets the chunks the other ranks of its ``dp``
        group updated, from every process."""
        L = self.layout
        chunks = self.rspan.gather(
            [self.flats[r].view(self.dp, -1)[L.index(r, "dp")]
             for r in self.local])
        for r in self.local:
            mine = self.flats[r].view(self.dp, -1)
            for d in range(self.dp):
                src = L.moved(r, {"dp": d})
                if src != r:
                    mine[d].copy_(chunks[src])

    @torch.no_grad()
    def gather_pw(self, _=None):
        """Host stage (a per-weight optimizer whose parameters or state
        leaves are sharded across processes, ``pw_cross``): every rank's
        parameter shards and state leaves, from every process (one
        all-gather of each local rank's flat buffer and leaves packed
        together), into the buffers the update reads (``pw_every``:
        ``(params[rr][name], leaves[rr][name])``)."""
        names = self.trainer.param_names
        every = self._every_rank([
            None if f is None else torch.cat(
                [f] + [x.reshape(-1) for n in names
                       for x in self.pw_state[r][n]])
            for r, f in enumerate(self.flats)])
        if self._pw_bufs is not None:
            for d, b in zip(self._pw_bufs, every):
                d.copy_(b)
            return
        self._pw_bufs = [b.clone() for b in every]
        mine = self.pw_state[self.local[0]]
        nflat = self.flats[self.local[0]].numel()
        params, leaves = [], []
        for b in self._pw_bufs:
            params.append(self._views(b[:nflat]))
            parts = iter(b[nflat:].split([x.numel() for n in names
                                          for x in mine[n]]))
            leaves.append({n: [next(parts).view(x.shape) for x in mine[n]]
                           for n in names})
        self.pw_every = (params, leaves)

    @torch.no_grad()
    def _update_per_weight(self, grads, B, lr, tdev):
        """AdaFactor and the other per-weight optimizers: every rank
        gathers the whole weight and state leaves first (across processes
        from what :meth:`gather_pw` gathered before the update), then
        updates and keeps its shards (gather before any write, so no rank
        reads a shard another has already updated)."""
        t, L = self.trainer, self.layout
        upd = t._opt_update_fn
        params, leaves = self.pw_every if self.pw_cross \
            else (self.rank_params, self.pw_state)
        work = {}
        for r in self.local:
            dev = self.devices[r]
            per = {}
            for n in t.param_names:
                nd = len(t.arg_shapes[n])
                w = L.assemble(lambda rr, n=n: params[rr][n],
                               self.specs[n], r, nd)
                specs = self.leaf_specs[n]
                full = [L.assemble(lambda rr, n=n, i=i: leaves[rr][n][i], s,
                                   r, nd)
                        for i, s in enumerate(specs)]
                if n in self.gathered:
                    g = B[n].to(dev)
                else:
                    g = self._views(grads[r])[n]
                per[n] = (w.clone(), g, [x.clone() for x in full], specs)
            work[r] = per
        for r, per in work.items():
            for n, (w, g, full, specs) in per.items():
                upd([w], [g], [tuple(full)], lr.to(w.device),
                    tdev.to(w.device), self.opt_gens[r])
                self.rank_params[r][n].copy_(L.shard(w, self.specs[n], r))
                for dst, x, s in zip(self.pw_state[r][n], full, specs):
                    dst.copy_(L.shard(x, s, r))

    # -- eval and gathers -----------------------------------------------------
    @torch.no_grad()
    def forward(self, batch):
        """The eval forward: each local walk on its rows of ``batch``
        (whole tensors on this process's first device: the global batch,
        or across processes this process's rows), the parameters gathered
        f32. Returns the outputs of ``batch``'s rows."""
        t, L = self.trainer, self.layout
        if self.mp and self.gathered:
            self.gather_params()
        wranks = [self.walk_ranks[w] for w in self.lwalks]
        nw = len(wranks)
        args = []
        for i, rw in enumerate(wranks):
            dev = self.devices[rw]
            vals = []
            for n in t.arg_names:
                if n in batch:
                    v = batch[n]
                    if self.walk_axes:
                        v = v.chunk(nw)[i]
                    vals.append(v.to(dev))
                elif self.mp and n in self.gathered:
                    vals.append(self.whole[n])
                else:
                    vals.append(L.assemble(
                        lambda rr, n=n: self.rank_params[rr][n],
                        self.specs[n], rw, len(t.arg_shapes[n])))
            args.append(vals)
        outs, _ = self.graph_fn(args, False, self.walk_gens,
                                rank_aux=[self.aux[r] for r in wranks])
        dev0 = self.devices[self.local[0]]
        return [torch.cat([o[j].to(dev0) for o in outs]) if nw > 1
                else outs[0][j] for j in range(len(outs[0]))]

    def _every_rank(self, bufs):
        """Every rank's tensor, given this process's (``bufs[r]`` for each
        local rank ``r``): from the other processes through one
        all-gather."""
        return self.rspan.gather([bufs[r] for r in self.local])

    def whole_params(self, device="cpu"):
        """Every parameter whole, gathered from the ranks' shards (from
        every process)."""
        t = self.trainer
        params = [self._views(f) for f in self._every_rank(self.flats)]
        return {n: self.layout.assemble(
                    lambda rr, n=n: params[rr][n], self.specs[n],
                    0, len(t.arg_shapes[n]), device=device).to(
                        device, copy=True)
                for n in t.param_names}

    def param_shards(self, name):
        """``[(slices, tensor)]``: each distinct shard of ``name`` once,
        of those this process holds (the replica of the lowest rank)."""
        shape = self.trainer.arg_shapes[name]
        mine = set(self.local)
        return [(sl, self.rank_params[r][name])
                for r, sl in self.layout.distinct(shape, self.specs[name])
                if r in mine]

    def _rank_leaf_views(self, r, units):
        """Rank r's state leaves by name, over its whole flat layout (the
        ``dp`` group's chunks gathered under zero1); ``units[i][rr]`` is
        rank rr's buffer of leaf ``i``."""
        s = self.states[self.local[0]]
        L = self.layout
        if not self.zero1:
            leaves = [u[r] for u in units]
        else:
            leaves = [torch.cat([u[L.moved(r, {"dp": d})].to(
                self.devices[self.local[0]]) for d in range(self.dp)])
                for u in units]
        per_leaf = [s.views(b) for b in leaves]
        return {n: tuple(v[i] for v in per_leaf)
                for i, n in enumerate(s.names)}

    def _leaf_units(self):
        """``units[i][rr]``: every rank's flat buffer of state leaf ``i``
        (from every process)."""
        nleaf = len(self.states[self.local[0]].units[0])
        return [self._every_rank([None if st is None else st.units[0][i]
                                  for st in self.states])
                for i in range(nleaf)]

    def whole_opt_state(self):
        """``{name: [whole leaf, ...]}`` on the host, in the JAX package's
        leaf order."""
        t, L = self.trainer, self.layout
        out = {}
        if self.per_weight:
            r0 = self.local[0]
            leaves = self.pw_state
            if self.pw_cross:
                self.gather_pw()
                leaves = self.pw_every[1]
            for n in t.param_names:
                specs = self.leaf_specs[n]
                out[n] = [L.assemble(lambda rr, n=n, i=i: leaves[rr][n][i],
                                     s, r0, len(t.arg_shapes[n]),
                                     device="cpu").to("cpu", copy=True)
                          for i, s in enumerate(specs)]
            return out
        units = self._leaf_units()
        views = {}
        for n in t.param_names:
            ranks = {r for r, _ in L.distinct(t.arg_shapes[n],
                                              self.specs[n])}
            for r in ranks:
                if r not in views:
                    views[r] = self._rank_leaf_views(r, units)
        for n in t.param_names:
            nleaf = len(views[0][n])
            out[n] = [L.assemble(lambda rr, n=n, i=i: views[rr][n][i],
                                 self.specs[n], 0, len(t.arg_shapes[n]),
                                 device="cpu").to("cpu", copy=True)
                      for i in range(nleaf)]
        return out

    @torch.no_grad()
    def load_opt_state(self, leaves_by_name, what):
        """Copy whole leaves (``{name: [leaf, ...]}``) into every local
        rank's state, as each rank stores it."""
        t, L = self.trainer, self.layout

        def tensor(v):
            return v.detach().cpu() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v))

        for n in t.param_names:
            if n not in leaves_by_name:
                raise MXNetError("%s: checkpoint state for %r is missing"
                                 % (what, n))
        if self.per_weight:
            for r in self.local:
                for n in t.param_names:
                    have = self.pw_state[r][n]
                    vals = leaves_by_name[n]
                    if len(vals) != len(have):
                        raise MXNetError(
                            "%s: checkpoint state for %r does not match "
                            "this trainer's optimizer (saved %d leaves, "
                            "need %d)" % (what, n, len(vals), len(have)))
                    for d, v, s in zip(have, vals, self.leaf_specs[n]):
                        d.copy_(L.shard(tensor(v), s, r))
            return
        nleaf = len(self.states[self.local[0]].units[0])
        for n in t.param_names:
            if len(leaves_by_name[n]) != nleaf:
                raise MXNetError(
                    "%s: checkpoint state for %r does not match this "
                    "trainer's optimizer (saved %d leaves, need %d)"
                    % (what, n, len(leaves_by_name[n]), nleaf))
        for r in self.local:
            s = self.states[r]
            for i, buf in enumerate(s.units[0]):
                parts = [L.shard(tensor(leaves_by_name[n][i]).float(),
                                 self.specs[n], r).reshape(-1)
                         for n in t.param_names]
                if self.pad:
                    parts.append(torch.zeros(self.pad))
                whole = torch.cat(parts)
                if self.zero1:
                    whole = whole.view(self.dp, -1)[s.index]
                buf.copy_(whole)

    def state_bytes(self, r):
        """Bytes of parameters and of optimizer state rank ``r`` stores."""
        pbytes = self.flats[r].numel() * 4
        if self.per_weight:
            sbytes = sum(x.numel() * x.element_size()
                         for v in self.pw_state[r].values() for x in v)
        else:
            sbytes = sum(b.numel() * b.element_size()
                         for b in self.states[r].buffers())
        return pbytes, sbytes

    def opt_shards(self):
        """``{name: [(spec, [(slices, tensor)], shape), ...]}``: each state
        leaf (``shape`` its global shape)
        as the shards this process writes to a checkpoint (each distinct
        shard once, the lowest rank's): a leaf that follows its parameter
        by the parameter's spec; a ZeRO-1 chunk holds no leaf's slice, so
        its leaves are gathered whole and written by the process of rank
        0, as are a per-weight optimizer's (whole on every rank)."""
        t, L = self.trainer, self.layout
        r0 = self.local[0]
        if self.zero1 or self.per_weight:
            whole = self.whole_opt_state()
            mine = 0 in self.local
            return {n: [(P(), [(tuple((0, d) for d in v.shape), v)]
                         if mine else [], tuple(v.shape)) for v in leaves]
                    for n, leaves in whole.items()}
        mine = set(self.local)
        views = {r: self.states[r].by_name() for r in self.local}
        out = {}
        for n in t.param_names:
            dist_ = [(r, sl) for r, sl in L.distinct(t.arg_shapes[n],
                                                     self.specs[n])
                     if r in mine]
            out[n] = [(self.specs[n], [(sl, views[r][n][i])
                                       for r, sl in dist_],
                       tuple(t.arg_shapes[n]))
                      for i in range(len(views[r0][n]))]
        return out
