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
  whole weight, gradient and leaves, updates them and keeps its shards.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError
from ..ops.registry import DrawTape
from .collectives import psum
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
        wdev = np.empty(len(self.walk_ranks), dtype=object)
        wdev[:] = [self.devices[r] for r in self.walk_ranks]
        if axes:
            wmesh = Mesh(wdev.reshape([mesh.shape[a] for a in axes]), axes)
        else:
            wmesh = Mesh(wdev, ("dp",))
        # fusion only on a one-rank mesh (the JAX rule, trainer.py
        # l.317-322): this walk never fuses unless MXNET_PALLAS_FUSION=1
        self.graph_fn = make_spmd_graph_fn(t.symbol, wmesh,
                                           allow_fusion=False)
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
        seed = t._seed
        self.walk_gens = [
            torch.Generator(device=self.devices[r]).manual_seed(
                int(np.random.SeedSequence([seed, w]).generate_state(1)[0]))
            for w, r in enumerate(self.walk_ranks)]
        # SGLD's noise: the same stream on every rank, so replicas of a
        # parameter get the same update
        self.opt_gens = [torch.Generator(device=d).manual_seed(seed)
                         for d in self.devices]
        self.flats = None

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
        aux values out over the ranks: allocate on the first call, copy
        into the live buffers after it (a captured step holds them)."""
        t, L = self.trainer, self.layout
        flats = []
        for r, dev in enumerate(self.devices):
            parts = [L.shard(values[n], self.specs[n], r).reshape(-1)
                     for n in t.param_names]
            if self.pad:
                parts.append(torch.zeros(self.pad))
            flats.append(torch.cat(parts).to(dev))
        aux = [[a.to(dev, copy=True) for a in aux_values]
               for dev in self.devices]
        first = self.flats is None
        if first:
            self.flats, self.aux = flats, aux
            self.rank_params = [self._views(f) for f in self.flats]
        else:
            for dst, src in zip(self.flats, flats):
                dst.copy_(src)
            for dsts, srcs in zip(self.aux, aux):
                for d, s in zip(dsts, srcs):
                    d.copy_(s)
        if self.per_weight:
            st = []
            for r in range(len(L)):
                per = {}
                for n in t.param_names:
                    leaves = t._opt_init_fn(values[n])
                    per[n] = [L.shard(v, s, r).to(self.devices[r], copy=True)
                              for v, s in zip(leaves, self.leaf_specs[n])]
                st.append(per)
            if first:
                self.pw_state = st
            else:
                for dst, src in zip(self.pw_state, st):
                    for n in dst:
                        for d, s in zip(dst[n], src[n]):
                            d.copy_(s)
            return
        if first:
            self.states = [
                FlatOptState(t.optimizer, t.param_names,
                             [self.shard_shapes[n] for n in t.param_names],
                             f, shards=self.dp if self.zero1 else 1,
                             index=L.index(r, "dp") if self.zero1 else 0)
                for r, f in enumerate(self.flats)]
        else:
            for s, f in zip(self.states, self.flats):
                s.reset(f)

    def buffers(self):
        """Everything the step updates in place."""
        out = list(self.flats)
        if self.per_weight:
            for per in self.pw_state:
                for leaves in per.values():
                    out.extend(leaves)
        else:
            for s in self.states:
                out.extend(s.buffers())
        for a in self.aux:
            out.extend(a)
        return out

    def generators(self):
        return self.walk_gens + self.opt_gens

    def input_buffers(self):
        """``{"name@rank": buffer}``: each rank's slice of each input."""
        t, L = self.trainer, self.layout
        out = {}
        for k, shape in t.input_shapes.items():
            sh = L.shard_shape(shape, self.data_specs[k])
            for r, dev in enumerate(self.devices):
                out["%s@%d" % (k, r)] = torch.empty(
                    sh, dtype=t._input_dtypes[k], device=dev)
        return out

    def split_batch(self, vals):
        """``{"name@rank": slice}`` of the global batch ``vals``."""
        L = self.layout
        return {"%s@%d" % (k, r): L.shard(v, self.data_specs[k], r)
                for k, v in vals.items() for r in range(len(L))}

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

    def _gather_param(self, name, w, record, cast):
        """Walk ``w``'s whole value of the sharded parameter ``name``: an
        all-gather of the ranks' shards, made a leaf of its own (its
        gradient is reduce-scattered by the step, in ``psum``'s order)."""
        leaf = record.get(name)
        if leaf is None:
            L = self.layout
            whole = L.assemble(lambda rr: self.rank_params[rr][name],
                               self.specs[name], self.walk_ranks[w],
                               len(self.trainer.arg_shapes[name]))
            leaf = record[name] = whole.detach().requires_grad_(True)
        return cast(leaf)

    def _walk_args(self, leaves, inputs, records, cast):
        t = self.trainer
        args = []
        for w, leaf in enumerate(leaves):
            views = dict(zip(t.param_names,
                             _Unflatten.apply(cast(leaf), self.flat_shapes)))
            rows = inputs[w]
            vals = []
            for n in t.arg_names:
                if n in rows:
                    vals.append(rows[n] if n in t._no_cast
                                else cast(rows[n]))
                elif n in self.gathered:
                    vals.append(functools.partial(
                        self._gather_param, n, w, records[w], cast))
                else:
                    vals.append(views[n])
            args.append(vals)
        return args

    def _grads(self, inputs):
        """One walk over ``inputs`` (per walk, by name) and its backward:
        ``(A, B, outs)``, per walk: the flat gradient of the rank layout
        (zeros where a parameter was gathered), the whole gradient of each
        gathered parameter, and the head outputs."""
        t = self.trainer
        nw = len(self.walk_ranks)
        leaves = [self.flats[r].detach().requires_grad_(True)
                  for r in self.walk_ranks]
        records = [dict() for _ in range(nw)]
        rank_aux = [list(self.aux[r]) for r in self.walk_ranks]
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
            for w, r in enumerate(self.walk_ranks):
                for i, a in enumerate(self.aux[r]):
                    a.copy_(res[n_out * nw + w * na + i])
        A = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
             for leaf in leaves]
        B = {}
        for n in self.gathered:
            B[n] = []
            for w in range(nw):
                leaf = records[w].get(n)
                if leaf is None or leaf.grad is None:
                    B[n].append(torch.zeros(
                        t.arg_shapes[n], device=self.devices[
                            self.walk_ranks[w]]))
                else:
                    B[n].append(leaf.grad)
        outs = [[o.detach() for o in flat_outs[w * n_out:(w + 1) * n_out]]
                for w in range(nw)]
        return A, B, outs

    def step(self, inputs, lr, tdev):
        """One train step over the input buffers ``inputs``; returns the
        head outputs of the global batch (on rank 0's device)."""
        t, L = self.trainer, self.layout
        nw = len(self.walk_ranks)
        rows = [self._walk_inputs(inputs, w) for w in range(nw)]
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
        if nw > 1:
            A = psum(A)
            B = {n: psum(v) for n, v in B.items()}
        scale = None
        if t.clip_grad_norm is not None:
            sq = A[0].square().sum()
            for n in self.gathered:
                sq = sq + B[n][0].square().sum()
            gnorm = torch.sqrt(sq) * t.optimizer.rescale_grad
            scale = torch.clamp(t.clip_grad_norm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = []
        for r, dev in enumerate(self.devices):
            w = self.walk_of[r]
            g = A[w].to(dev)
            if self.gathered:
                g = g.clone()
                views = self._views(g)
                for n in self.gathered:
                    views[n].copy_(L.shard(B[n][w], self.specs[n], r))
            if scale is not None:
                g = g * scale.to(dev)
            grads.append(g)
        if self.per_weight:
            self._update_per_weight(grads, B, lr, tdev)
        else:
            for r, (s, f, g) in enumerate(zip(self.states, self.flats,
                                              grads)):
                s.update(f, g, lr.to(f.device), tdev.to(f.device),
                         self.opt_gens[r])
            if self.zero1:
                self._gather_chunks()
        with torch.no_grad():
            for r in range(len(L)):
                src = self.walk_ranks[self.walk_of[r]]
                if src != r:
                    for d, s in zip(self.aux[r], self.aux[src]):
                        d.copy_(s)
        dev0 = self.devices[0]
        # batch-major: microbatch i's rows, walk by walk within it (the
        # JAX reshape of [A, B/A] back to [B])
        parts = [outs[w] for outs in outs_parts for w in range(nw)]
        if len(parts) == 1:
            return parts[0]
        return [torch.cat([p[j].to(dev0) for p in parts])
                for j in range(len(parts[0]))]

    def _microbatch(self, rows, i):
        """Microbatch ``i`` of ``grad_accum`` A, per walk: global rows
        ``[i*B/A, (i+1)*B/A)`` split over the walks as a whole batch is
        (the JAX trainer's reshape of the global batch to ``[A, B/A]``,
        ``mxnet_tpu/parallel/trainer.py`` l.442-443), so a BatchNorm
        sees the JAX microbatch. Walk ``w``'s piece is global chunk
        ``i*nw + w`` of size ``B/(A*nw)``, which lies in walk
        ``(i*nw + w) // A``'s rows."""
        a, nw = self.trainer.grad_accum, len(rows)
        out = []
        for w in range(nw):
            c = i * nw + w
            src = rows[c // a]
            dev = self.devices[self.walk_ranks[w]]
            out.append({k: v.chunk(a)[c % a].to(dev)
                        for k, v in src.items()})
        return out

    @torch.no_grad()
    def _gather_chunks(self):
        """ZeRO-1's all-gather: every rank's buffer gets the chunks the
        other ranks of its ``dp`` group updated."""
        L = self.layout
        for r, f in enumerate(self.flats):
            mine = f.view(self.dp, -1)
            for d in range(self.dp):
                src = L.moved(r, {"dp": d})
                if src != r:
                    mine[d].copy_(self.flats[src].view(self.dp, -1)[d])

    @torch.no_grad()
    def _update_per_weight(self, grads, B, lr, tdev):
        """AdaFactor and the other per-weight optimizers: every rank
        gathers the whole weight and state leaves first, then updates and
        keeps its shards (gather before any write, so no rank reads a
        shard another has already updated)."""
        t, L = self.trainer, self.layout
        upd = t._opt_update_fn
        work = []
        for r, dev in enumerate(self.devices):
            per = {}
            for n in t.param_names:
                nd = len(t.arg_shapes[n])
                w = L.assemble(lambda rr, n=n: self.rank_params[rr][n],
                               self.specs[n], r, nd)
                specs = self.leaf_specs[n]
                full = [L.assemble(lambda rr, n=n, i=i:
                                   self.pw_state[rr][n][i], s, r,
                                   len(t.arg_shapes[n]))
                        for i, s in enumerate(specs)]
                if n in self.gathered:
                    g = B[n][self.walk_of[r]].to(dev)
                else:
                    g = self._views(grads[r])[n]
                per[n] = (w.clone(), g, [x.clone() for x in full], specs)
            work.append(per)
        for r, per in enumerate(work):
            for n, (w, g, full, specs) in per.items():
                upd([w], [g], [tuple(full)], lr.to(w.device),
                    tdev.to(w.device), self.opt_gens[r])
                self.rank_params[r][n].copy_(L.shard(w, self.specs[n], r))
                for dst, x, s in zip(self.pw_state[r][n], full, specs):
                    dst.copy_(L.shard(x, s, r))

    # -- eval and gathers -----------------------------------------------------
    @torch.no_grad()
    def forward(self, batch):
        """The eval forward: each walk on its rows of ``batch`` (whole
        tensors on rank 0's device), the parameters gathered f32."""
        t, L = self.trainer, self.layout
        nw = len(self.walk_ranks)
        args = []
        for w, rw in enumerate(self.walk_ranks):
            dev = self.devices[rw]
            vals = []
            for n in t.arg_names:
                if n in batch:
                    v = batch[n]
                    if self.walk_axes:
                        v = v.chunk(nw)[w]
                    vals.append(v.to(dev))
                else:
                    vals.append(L.assemble(
                        lambda rr, n=n: self.rank_params[rr][n],
                        self.specs[n], rw, len(t.arg_shapes[n])))
            args.append(vals)
        outs, _ = self.graph_fn(args, False, self.walk_gens,
                                rank_aux=[self.aux[r]
                                          for r in self.walk_ranks])
        dev0 = self.devices[0]
        return [torch.cat([o[j].to(dev0) for o in outs]) if nw > 1
                else outs[0][j] for j in range(len(outs[0]))]

    def whole_params(self, device="cpu"):
        """Every parameter whole, gathered from the ranks' shards."""
        t = self.trainer
        return {n: self.layout.assemble(
                    lambda rr, n=n: self.rank_params[rr][n], self.specs[n],
                    0, len(t.arg_shapes[n]), device=device).to(
                        device, copy=True)
                for n in t.param_names}

    def param_shards(self, name):
        """``[(slices, tensor)]``: each distinct shard of ``name`` once."""
        shape = self.trainer.arg_shapes[name]
        return [(sl, self.rank_params[r][name])
                for r, sl in self.layout.distinct(shape, self.specs[name])]

    def _rank_leaf_views(self, r):
        """Rank r's state leaves by name, over its whole flat layout (the
        ``dp`` group's chunks gathered under zero1)."""
        s = self.states[r]
        if not self.zero1:
            return s.by_name()
        L = self.layout
        leaves = []
        for i in range(len(s.units[0])):
            parts = [self.states[L.moved(r, {"dp": d})].units[0][i]
                     .to(self.devices[r]) for d in range(self.dp)]
            leaves.append(torch.cat(parts))
        per_leaf = [s.views(b) for b in leaves]
        return {n: tuple(v[i] for v in per_leaf)
                for i, n in enumerate(s.names)}

    def whole_opt_state(self):
        """``{name: [whole leaf, ...]}`` on the host, in the JAX package's
        leaf order."""
        t, L = self.trainer, self.layout
        out = {}
        if self.per_weight:
            for n in t.param_names:
                specs = self.leaf_specs[n]
                out[n] = [L.assemble(lambda rr, n=n, i=i:
                                     self.pw_state[rr][n][i], s, 0,
                                     len(t.arg_shapes[n]), device="cpu")
                          .to("cpu", copy=True)
                          for i, s in enumerate(specs)]
            return out
        views = {}
        for n in t.param_names:
            ranks = {r for r, _ in L.distinct(t.arg_shapes[n],
                                              self.specs[n])}
            for r in ranks:
                if r not in views:
                    views[r] = self._rank_leaf_views(r)
        for n in t.param_names:
            nleaf = len(views[0][n])
            out[n] = [L.assemble(lambda rr, n=n, i=i: views[rr][n][i],
                                 self.specs[n], 0, len(t.arg_shapes[n]),
                                 device="cpu").to("cpu", copy=True)
                      for i in range(nleaf)]
        return out

    @torch.no_grad()
    def load_opt_state(self, leaves_by_name, what):
        """Copy whole leaves (``{name: [leaf, ...]}``) into every rank's
        state, as each rank stores it."""
        t, L = self.trainer, self.layout

        def tensor(v):
            return v.detach().cpu() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v))

        for n in t.param_names:
            if n not in leaves_by_name:
                raise MXNetError("%s: checkpoint state for %r is missing"
                                 % (what, n))
        if self.per_weight:
            for r in range(len(L)):
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
        nleaf = len(self.states[0].units[0])
        for n in t.param_names:
            if len(leaves_by_name[n]) != nleaf:
                raise MXNetError(
                    "%s: checkpoint state for %r does not match this "
                    "trainer's optimizer (saved %d leaves, need %d)"
                    % (what, n, len(leaves_by_name[n]), nleaf))
        for r, s in enumerate(self.states):
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
