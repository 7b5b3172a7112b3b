"""Pipeline parallelism over the ``pp`` mesh axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py`` (l.1-1040). The
reference's model parallelism is the ``ctx_group`` graph cut
(``graph_executor.cc:341-458``); the JAX package promotes it to an SPMD
GPipe schedule over a mesh, and so does the port:

* :func:`partition_stages` cuts a loss-headed Symbol into S stages from
  its ``ctx_group="stage<K>"`` tags and checks that the cut is a chain
  with one boundary activation of one shape between neighbours.
* :class:`PipelineTrainer` runs the stages on the ``pp`` ranks of a
  mesh (and the batch over ``dp`` replica groups, each with its own
  pipeline). JAX runs one ``lax.scan`` of ``M + S - 1`` ticks on every
  device and masks the fill and drain ticks; here the schedule is static
  on the host, so only the ``(stage, microbatch)`` pairs that exist run,
  each on its stage's rank, tick by tick, and the boundary moves to the
  next rank by ``ppermute``.
* ``schedule="gpipe"`` takes the gradients by autograd through the whole
  schedule (all M microbatches' activations live until the backward);
  ``schedule="1f1b"`` runs each tick's forward without keeping the graph
  and each stage's backward explicitly, recomputing the stage from its
  saved boundary input, with at most ``2S - 1`` microbatches in flight
  per stage (``max_in_flight`` records the most seen), whatever M is.

Parameter placement, as in the JAX package: ``"stage"`` packs each
stage's parameters into one f32 row of ``P_max`` elements that only that
stage's ranks hold (with its optimizer state: the whole row is one
"weight" to the optimizer, as in the JAX package), and parameters bigger
than ``pp_shard_min_size`` (default: half an average stage) are stored
``1/S`` per pp rank and all-gathered by the stage that uses them, their
gradient reduce-scattered back; ``"replicated"`` keeps every parameter on
every rank and sums the stages' gradients. The step is one
``parallel.program.Program``, captured on the card. Dropout draws come
from one generator per rank (the port's own streams, not JAX's); 1F1B's
recompute replays them.
"""
from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch

from ..base import MXNetError
from .. import optimizer as opt_mod
from ..initializer import Uniform
from .collectives import ppermute, psum
from .graph import has_host_ops
from .layout import Layout
from .optim import FlatOptState
from .program import Program
from ..ops.registry import DrawTape
from .sharded import backward_heads, remat_walk
from .trainer import _as_tensor

__all__ = ["pipeline_spmd", "partition_stages", "PipelineTrainer"]


def pipeline_spmd(stage_fn, stage_params, x_microbatches, axis_name="pp"):
    """GPipe over equal stages: ``stage_fn(params, x) -> y``, the same
    shape-preserving function on every stage, with ``stage_params[s]``
    (on pp rank s's device) the parameters of stage s.

    ``x_microbatches``: ``[M, mb, ...]``, read by stage 0. Returns one
    ``[M, mb, ...]`` tensor per rank: the last stage's outputs on the last
    rank, zeros on the others (``psum`` the list to give every rank the
    result), as the JAX helper returns inside its ``shard_map``. Only the
    ``(stage, microbatch)`` pairs that exist run; the boundary moves one
    rank a tick by ``ppermute``. ``axis_name`` is the JAX signature's: the
    stage list is the axis."""
    n = len(stage_params)
    devs = [p.device if isinstance(p, torch.Tensor)
            else x_microbatches.device for p in stage_params]
    M = x_microbatches.shape[0]
    outs = [None] * M
    state = [None] * n
    for t in range(M + n - 1):
        ys = []
        for s in range(n):
            m = t - s
            if 0 <= m < M:
                x = x_microbatches[m].to(devs[s]) if s == 0 else state[s]
                ys.append(stage_fn(stage_params[s], x))
            else:
                ys.append(None)
        if 0 <= t - (n - 1) < M:
            outs[t - (n - 1)] = ys[n - 1]
        state = _hop(ys, devs, 1)
    last = torch.stack(outs)
    return [last if s == n - 1 else torch.zeros_like(last).to(devs[s])
            for s in range(n)]


def _hop(vals, devs, shift):
    """Each stage's value to the rank ``shift`` stages on (``ppermute`` of
    the pairs that exist: a stage with no value sends nothing, and a stage
    nothing reaches gets None)."""
    n = len(vals)
    sent = [v if v is not None else torch.zeros(0, device=d)
            for v, d in zip(vals, devs)]
    moved = ppermute(sent, [(s, s + shift) for s in range(n)
                            if vals[s] is not None and 0 <= s + shift < n])
    return [moved[s] if 0 <= s - shift < n and vals[s - shift] is not None
            else None for s in range(n)]


def partition_stages(symbol, num_stages=None):
    """Cut a Symbol's topological order into stages from ``ctx_group``
    attrs: ``ctx_group="stageK"`` puts a node in stage K (the reference's
    ``AttrScope(ctx_group=...)``); an untagged op joins the highest stage
    of its inputs; a variable joins its (single) consumers' stage.
    Returns ``(stage_nodes, boundaries, stage_of)``, ``boundaries[s]``
    the ``(node, index)`` entry crossing from stage s to s + 1."""
    topo = symbol._topo()
    stage_of = {}
    for n in topo:
        if n.is_var:
            continue
        tag = n.attrs.get("ctx_group")
        if tag is not None:
            if not tag.startswith("stage"):
                raise MXNetError(
                    "pipeline: ctx_group %r is not 'stage<K>'" % tag)
            stage_of[id(n)] = int(tag[len("stage"):])
    if not stage_of:
        raise MXNetError(
            "pipeline: no ctx_group='stage<K>' attrs found — tag the "
            "symbol (e.g. models.get_transformer_lm(pipeline_stages=S), "
            "or AttrScope(ctx_group='stage0'), the reference's "
            "model-parallel mechanism)")
    for n in topo:
        if n.is_var or id(n) in stage_of:
            continue
        in_stages = [stage_of.get(id(inp), 0) for inp, _ in n.inputs
                     if not inp.is_var]
        stage_of[id(n)] = max(in_stages) if in_stages else 0
    for n in topo:
        if n.is_var:
            continue
        for inp, _ in n.inputs:
            if inp.is_var:
                s = stage_of[id(n)]
                prev = stage_of.get(id(inp))
                if prev is not None and prev != s:
                    raise MXNetError(
                        "pipeline: variable %s consumed by stages %d "
                        "and %d" % (inp.name, prev, s))
                stage_of[id(inp)] = s

    S = max(stage_of.values()) + 1
    if num_stages is not None and S != num_stages:
        raise MXNetError("pipeline: symbol has %d stages, mesh wants %d"
                         % (S, num_stages))
    stage_nodes = [[] for _ in range(S)]
    for n in topo:
        stage_nodes[stage_of[id(n)]].append(n)

    boundaries = [None] * (S - 1)
    for n in topo:
        if n.is_var:
            continue
        s = stage_of[id(n)]
        for inp, idx in n.inputs:
            ps = stage_of[id(inp)]
            if ps == s or inp.is_var:
                continue
            if ps > s:
                raise MXNetError("pipeline: backward edge stage %d -> %d"
                                 % (ps, s))
            if ps != s - 1:
                raise MXNetError(
                    "pipeline: edge skips stages (%d -> %d); ctx_group "
                    "cuts must form a chain" % (ps, s))
            entry = (inp, idx)
            if boundaries[ps] is None:
                boundaries[ps] = entry
            elif boundaries[ps] != entry:
                raise MXNetError(
                    "pipeline: stage %d has multiple boundary "
                    "activations; exactly one tensor may cross each "
                    "cut" % ps)
    for s, b in enumerate(boundaries):
        if b is None:
            raise MXNetError("pipeline: no edge from stage %d to %d"
                             % (s, s + 1))
    return stage_nodes, boundaries, stage_of


class PipelineTrainer:
    """Train a ``ctx_group``-staged Symbol over a ``pp`` mesh.

    Parameters
    ----------
    symbol : loss-headed Symbol with ``ctx_group='stage<K>'`` attrs (as
        many stages as the mesh's ``pp`` size); the data inputs feed
        stage 0, the label the last stage, which computes every head.
    input_shapes : dict of GLOBAL input shapes, batch first.
    mesh : Mesh with a ``pp`` axis and optionally ``dp`` (the batch over
        ``dp`` replica groups, each with its own pipeline; gradients
        summed over both). Its devices may repeat (``[cuda:0] * 4``).
    num_microbatches : each dp group's batch splits into M microbatches
        (default S); the GPipe bubble is (S-1)/(M+S-1).
    param_placement : "stage" (default) or "replicated".
    remat : checkpoint each stage's forward under GPipe (default
        ``MXNET_BACKWARD_DO_MIRROR``); inherent to 1F1B.
    pp_shard_min_size : "auto", an int, or None (no pp-sharded params).
    schedule : "gpipe" or "1f1b" (needs ``param_placement="stage"``).
    """

    def __init__(self, symbol, input_shapes, mesh, num_microbatches=None,
                 optimizer="sgd", optimizer_params=None, initializer=None,
                 seed=0, label_name="softmax_label",
                 param_placement="stage", remat=None,
                 pp_shard_min_size="auto", schedule="gpipe"):
        if "pp" not in mesh.shape:
            raise MXNetError("PipelineTrainer: mesh needs a 'pp' axis")
        extra = [a for a in mesh.axis_names if a not in ("dp", "pp")]
        if extra:
            raise MXNetError("PipelineTrainer: mesh axes %s besides dp and "
                             "pp are not supported" % (extra,))
        if param_placement not in ("stage", "replicated"):
            raise MXNetError("param_placement must be 'stage' or "
                             "'replicated', got %r" % (param_placement,))
        if schedule not in ("gpipe", "1f1b"):
            raise MXNetError("schedule must be 'gpipe' or '1f1b', got %r"
                             % (schedule,))
        if schedule == "1f1b" and param_placement != "stage":
            raise MXNetError("schedule='1f1b' requires "
                             "param_placement='stage' (the activation-"
                             "bounded schedule accumulates per-stage "
                             "row gradients)")
        self.schedule = schedule
        self.param_placement = param_placement
        if remat is None:
            remat = os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") == "1"
        elif remat and schedule == "1f1b":
            warnings.warn("PipelineTrainer: remat is inherent to "
                          "schedule='1f1b' (the backward re-runs each "
                          "stage from its saved input); the flag has "
                          "no additional effect")
        self.remat = bool(remat)
        if symbol.list_auxiliary_states():
            raise MXNetError("PipelineTrainer: aux states unsupported "
                             "under the SPMD schedule")
        self.symbol = symbol
        self.mesh = mesh
        self.layout = Layout(mesh)
        self.S = mesh.shape["pp"]
        self.dp = mesh.shape.get("dp", 1)
        self.label_name = label_name
        self.input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        batch = self.input_shapes["data"][0]
        self.M = num_microbatches or self.S
        if batch % (self.M * self.dp):
            raise MXNetError(
                "batch %d not divisible into %d microbatches x %d dp "
                "groups" % (batch, self.M, self.dp))
        self.mb = batch // (self.M * self.dp)
        self.global_batch = batch

        self.stage_nodes, self.boundaries, self.stage_of = \
            partition_stages(symbol, self.S)
        for h, _ in symbol._heads:
            if self.stage_of.get(id(h)) != self.S - 1:
                raise MXNetError(
                    "PipelineTrainer: head %r lives in stage %s, but "
                    "every output head must be computed by the LAST "
                    "stage (%d) — tag it (or what feeds it) with "
                    "ctx_group='stage%d'"
                    % (h.name, self.stage_of.get(id(h)), self.S - 1,
                       self.S - 1))

        self.arg_names = symbol.list_arguments()
        self.param_names = [n for n in self.arg_names
                            if n not in self.input_shapes]
        mb_shapes = {k: (self.mb,) + tuple(v[1:])
                     for k, v in self.input_shapes.items()}
        arg_shapes, out_shapes, _ = symbol.infer_shape(**mb_shapes)
        if arg_shapes is None:
            raise MXNetError("PipelineTrainer: shape inference failed")
        self.arg_shapes = dict(zip(self.arg_names, arg_shapes))
        self.out_shapes = [tuple(s) for s in out_shapes]
        self._mb_shapes = mb_shapes
        self._infer_boundary_meta()

        for n in symbol._topo():
            if not n.is_var or n.name not in self.input_shapes:
                continue
            s = self.stage_of.get(id(n), 0)
            if n.name == self.label_name:
                if s != self.S - 1:
                    raise MXNetError("pipeline: label %r consumed by "
                                     "stage %d, must be last stage"
                                     % (n.name, s))
            elif s != 0:
                raise MXNetError("pipeline: input %r consumed by stage "
                                 "%d, must be stage 0" % (n.name, s))

        # per-stage flat layout: stage s's params (topo order) packed into
        # one padded row of P_max; params bigger than half an average
        # stage are stored 1/S per pp rank and gathered at use
        all_params = []
        total = 0
        for n in symbol._topo():
            if not n.is_var or n.name not in self.param_names:
                continue
            shape = self.arg_shapes[n.name]
            size = int(np.prod(shape)) if shape else 1
            all_params.append((n, shape, size))
            total += size
        if pp_shard_min_size == "auto":
            pp_shard_min_size = max(1, total // (2 * self.S))
        self._flat_meta = [[] for _ in range(self.S)]
        self._big_meta = []  # (name, shape, size, padded, stage)
        sizes = [0] * self.S
        for n, shape, size in all_params:
            s = self.stage_of[id(n)]
            if (self.param_placement == "stage" and pp_shard_min_size
                    and size > pp_shard_min_size and self.S > 1):
                padded = -(-size // self.S) * self.S
                self._big_meta.append((n.name, shape, size, padded, s))
                continue
            self._flat_meta[s].append((n.name, shape, sizes[s], size))
            sizes[s] += size
        self._stage_sizes = sizes
        self._pmax = max(sizes + [1])
        #: per-stage parameter bytes (row-packed + pp-sharded)
        self.stage_param_bytes = [4 * sz for sz in sizes]
        for _, _, size, _, s in self._big_meta:
            self.stage_param_bytes[s] += 4 * size
        mean_sz = max(1.0, sum(sizes) / float(self.S))
        waste_bytes = 4.0 * (self._pmax - mean_sz)
        if (self.param_placement == "stage"
                and self._pmax / mean_sz > 1.5 and waste_bytes > 16384):
            warnings.warn(
                "PipelineTrainer: row-packed stage params are imbalanced "
                "(max %.0f vs mean %.0f elements; per-stage bytes %s): "
                "every device pays the max row. Re-cut the stages more "
                "evenly, or lower pp_shard_min_size so the heavy "
                "parameters take the pp-sharded path."
                % (self._pmax, mean_sz, self.stage_param_bytes))

        if isinstance(optimizer, str):
            okw = dict(optimizer_params or {})
            okw.setdefault("rescale_grad", 1.0 / batch)
            optimizer = opt_mod.create(optimizer, **okw)
        self.optimizer = optimizer
        self._initializer = initializer or Uniform(0.05)
        self._init_gen = torch.Generator().manual_seed(seed)
        L = self.layout
        self._rank = [[L.moved(0, dict({"pp": s},
                                       **({"dp": d} if "dp" in mesh.shape
                                          else {})))
                       for s in range(self.S)] for d in range(self.dp)]
        self.device = L.devices[self._rank[0][0]]
        self._gens = [torch.Generator(device=d).manual_seed(int(
            np.random.SeedSequence([seed, r]).generate_state(1)[0]))
            for r, d in enumerate(L.devices)]
        # SGLD's noise: one stream a stage, the same on its dp replicas
        self._opt_gens = [torch.Generator(device=d).manual_seed(int(
            np.random.SeedSequence([seed, 1 << 20, L.index(r, "pp")])
            .generate_state(1)[0])) for r, d in enumerate(L.devices)]
        # the step program's learning rate and update count, set by the
        # host before each run
        self._lr = torch.zeros((), device=self.device)
        self._tdev = torch.zeros((), device=self.device)
        self.params = None
        self.opt_state = None
        self._program = None
        self._t = 0
        #: the most boundary inputs a stage held at once in a 1F1B step
        self.max_in_flight = 0

    # ------------------------------------------------------------------
    def _infer_boundary_meta(self):
        """The boundary activations' shape at microbatch size, one for
        every cut."""
        from ..symbol import Symbol
        shapes = set()
        for node, idx in self.boundaries:
            sub = Symbol([(node, idx)])
            _, out, _ = sub.infer_shape(**{
                k: v for k, v in self._mb_shapes.items()
                if k in sub.list_arguments()})
            shapes.add(tuple(out[0]))
        if len(shapes) > 1:
            raise MXNetError(
                "pipeline: boundary activations differ in shape (%s); "
                "the SPMD schedule carries ONE uniform tensor between "
                "stages — cut at equal-shape points" % (sorted(shapes),))
        self._boundary_shape = shapes.pop() if shapes else ()

    def _init_value(self, name, arg_params):
        if arg_params and name in arg_params:
            val = _as_tensor(arg_params[name])
        else:
            val = torch.zeros(self.arg_shapes[name], dtype=torch.float32)
            self._initializer(name, val, self._init_gen)
        if val.dtype != torch.float32:
            if self.param_placement == "stage":
                raise MXNetError(
                    "param_placement='stage' packs f32 parameters; %r is "
                    "%s — use param_placement='replicated'"
                    % (name, val.dtype))
            val = val.float()
        return val.reshape(self.arg_shapes[name])

    def init_params(self, arg_params=None):
        """Initialize (or load) the parameters and the optimizer state.
        Under ``"stage"`` placement ``params`` is ``{"rows": [row per
        rank], "big": {name: [chunk per rank]}}`` and ``opt_state`` the
        matching ``FlatOptState``\\ s; under ``"replicated"`` ``params`` is
        a list per rank of ``{name: view}`` over one flat buffer."""
        L = self.layout
        vals = {n: self._init_value(n, arg_params) for n in self.param_names}
        if self.param_placement == "stage":
            rows = torch.zeros(self.S, self._pmax)
            for s, meta in enumerate(self._flat_meta):
                for name, shape, off, size in meta:
                    rows[s, off:off + size] = vals[name].reshape(-1)
            big = {}
            for name, shape, size, padded, _s in self._big_meta:
                flat = torch.zeros(padded)
                flat[:size] = vals[name].reshape(-1)
                big[name] = flat.view(self.S, padded // self.S)
            new_rows = [rows[L.index(r, "pp")].to(d, copy=True)
                        for r, d in enumerate(L.devices)]
            new_big = {n: [v[L.index(r, "pp")].to(d, copy=True)
                           for r, d in enumerate(L.devices)]
                       for n, v in big.items()}
            if self.params is None:
                self.params = {"rows": new_rows, "big": new_big}
                self.opt_state = {
                    "rows": [FlatOptState(self.optimizer, ["row"],
                                          [(self._pmax,)], r)
                             for r in new_rows],
                    "big": {n: [FlatOptState(self.optimizer, [n],
                                             [tuple(c.shape)], c)
                                for c in v]
                            for n, v in new_big.items()}}
            else:
                self._copy_state(new_rows, new_big)
        else:
            flat = torch.cat([vals[n].reshape(-1) for n in self.param_names])
            new = [flat.to(d, copy=True) for d in L.devices]
            if self.params is None:
                self._flats = new
                self.params = [self._views(f) for f in new]
                self.opt_state = [FlatOptState(
                    self.optimizer, self.param_names,
                    [self.arg_shapes[n] for n in self.param_names], f)
                    for f in new]
            else:
                for dst, src, st in zip(self._flats, new, self.opt_state):
                    dst.copy_(src)
                    st.reset(dst)
        self._t = 0
        return self

    @torch.no_grad()
    def _copy_state(self, rows, big):
        for dst, src, st in zip(self.params["rows"], rows,
                                self.opt_state["rows"]):
            dst.copy_(src)
            st.reset(dst)
        for n, chunks in big.items():
            for dst, src, st in zip(self.params["big"][n], chunks,
                                    self.opt_state["big"][n]):
                dst.copy_(src)
                st.reset(dst)

    def _views(self, flat):
        shapes = [self.arg_shapes[n] for n in self.param_names]
        parts = flat.split([int(np.prod(s)) for s in shapes])
        return {n: p.view(s) for n, p, s in zip(self.param_names, parts,
                                                 shapes)}

    # -- one stage on one microbatch --------------------------------------
    def _stage(self, s, x, inputs, params, gen, is_train=True):
        """Stage ``s``'s nodes on one microbatch: ``x`` the boundary from
        stage s-1 (None for stage 0), ``inputs`` the microbatch's inputs
        by name, ``params`` name -> value. Returns ``(boundary, outs)``:
        the boundary for stage s+1 (None on the last stage) and, on the
        last stage, the head outputs."""
        nodes = self.stage_nodes[s]
        env = {}
        if s:
            node, idx = self.boundaries[s - 1]
            env[(id(node), idx)] = x
        for n in nodes:
            if n.is_var:
                env[(id(n), 0)] = params[n.name] if n.name in params \
                    else inputs[n.name]
                continue
            ins = [env[(id(i), j)] for i, j in n.inputs]
            outs, _ = n.spec.forward(n.params, ins, [], is_train, gen)
            for j, o in enumerate(outs):
                env[(id(n), j)] = o
        if s == self.S - 1:
            return None, [env[(id(h), j)] for h, j in self.symbol._heads]
        node, idx = self.boundaries[s]
        return env[(id(node), idx)], None

    def _stage_params(self, s, row, big_full):
        """Stage ``s``'s parameters: views of its row (one ``split``, so
        the backward writes the row's gradient once, not a row-sized
        tensor for each parameter), plus the whole value of each
        pp-sharded parameter it owns."""
        meta = self._flat_meta[s]
        sizes = [size for _, _, _, size in meta]
        parts = row.split(sizes + [row.numel() - sum(sizes)])
        out = {name: p.view(shape)
               for (name, shape, _, _), p in zip(meta, parts)}
        for name, shape, size, _padded, owner in self._big_meta:
            if owner == s:
                out[name] = big_full[name][:size].view(shape)
        return out

    # -- the step -----------------------------------------------------------
    def _leaves(self):
        """Per dp group: the leaves the step differentiates (per stage rank
        a row leaf, or a flat leaf under "replicated") and the stage
        parameters built from them; the pp-sharded parameters are gathered
        over the group's ranks where their stage uses them."""
        L = self.layout
        groups = []
        for d in range(self.dp):
            ranks = self._rank[d]
            if self.param_placement == "stage":
                leaves = [self.params["rows"][r].detach().requires_grad_(
                    True) for r in ranks]
                big = {}
                for name, _shape, _size, _padded, owner in self._big_meta:
                    dev = L.devices[ranks[owner]]
                    whole = torch.cat([self.params["big"][name][r].to(dev)
                                       for r in ranks])
                    big[name] = whole.detach().requires_grad_(True)
                params = [self._stage_params(s, leaves[s], big)
                          for s in range(self.S)]
                groups.append((leaves, big, params))
            else:
                leaves = [self._flats[r].detach().requires_grad_(True)
                          for r in ranks]
                params = [self._views(lf) for lf in leaves]
                groups.append((leaves, {}, params))
        return groups

    def _gpipe(self, inputs, groups):
        """The GPipe schedule of every dp group, differentiated by
        autograd: returns the head outputs per group and microbatch."""
        S, M = self.S, self.M
        L = self.layout
        heads = []
        for d, (_leaves, _big, params) in enumerate(groups):
            ranks = self._rank[d]
            devs = [L.devices[r] for r in ranks]
            outs = [None] * M
            state = [None] * S
            for t in range(M + S - 1):
                ys = [None] * S
                for s in range(S):
                    m = t - s
                    if not 0 <= m < M:
                        continue
                    mbin = {k: v[m] for k, v in inputs[d][s].items()}
                    fn = functools.partial(self._stage, s, inputs=mbin,
                                           gen=self._gens[ranks[s]])
                    if self.remat:
                        names = sorted(params[s])
                        y, o = self._remat_stage(
                            fn, state[s], [params[s][n] for n in names],
                            names, s == S - 1)
                    else:
                        y, o = fn(state[s], params=params[s])
                    if s == S - 1:
                        outs[m] = o
                    ys[s] = y
                state = _hop(ys, devs, 1)
            heads.append(outs)
        flat = [o for g in heads for mb in g for o in mb]
        backward_heads(flat)
        return [[[o.detach() for o in mb] for mb in g] for g in heads]

    @staticmethod
    def _remat_stage(fn, x, pvals, names, last):
        """``fn`` (one stage on one microbatch) checkpointed: the backward
        recomputes the stage's activations from its boundary input."""
        leaves = ([x] if x is not None else []) + pvals

        def run(*args):
            xv, rest = (args[0], args[1:]) if x is not None else (None, args)
            y, o = fn(xv, params=dict(zip(names, rest)))
            return tuple(o) if last else (y,)

        res = remat_walk(run, leaves)
        return (None, list(res)) if last else (res[0], None)

    def _1f1b(self, inputs, groups):
        """The 1F1B schedule of every dp group. Tick t: stage s runs the
        forward of microbatch t - s without keeping its graph (saving the
        boundary input), then the backward of microbatch t - (2S-2-s):
        the stage again from its saved input, differentiated, with the
        cotangent stage s+1's backward sent back a tick before. Returns
        the head outputs per group and microbatch."""
        S, M = self.S, self.M
        L = self.layout
        heads = []
        for d, (leaves, big, params) in enumerate(groups):
            ranks = self._rank[d]
            devs = [L.devices[r] for r in ranks]
            gens = [self._gens[r] for r in ranks]
            saved = [dict() for _ in range(S)]
            tapes = [dict() for _ in range(S)]
            outs = [None] * M
            fwd_in = [None] * S
            bwd_in = [None] * S
            for t in range(M + 2 * S - 2):
                ys = [None] * S
                for s in range(S):
                    m = t - s
                    if not 0 <= m < M:
                        continue
                    saved[s][m] = fwd_in[s]
                    self.max_in_flight = max(self.max_in_flight,
                                             len(saved[s]))
                    tapes[s][m] = tape = DrawTape()
                    with torch.no_grad(), tape.record():
                        y, o = self._stage(
                            s, fwd_in[s],
                            {k: v[m] for k, v in inputs[d][s].items()},
                            params[s], gens[s])
                    if s == S - 1:
                        outs[m] = o
                    ys[s] = y
                fwd_in = _hop(ys, devs, 1)
                gs = [None] * S
                for s in range(S):
                    b = t - (2 * S - 2 - s)
                    if not 0 <= b < M:
                        continue
                    x = saved[s].pop(b)
                    xg = None if x is None else \
                        x.detach().requires_grad_(True)
                    # the stage's parameter views anew for each backward,
                    # and the draws its forward made
                    with tapes[s].pop(b).replay():
                        y, o = self._stage(
                            s, xg,
                            {k: v[b] for k, v in inputs[d][s].items()},
                            self._stage_params(s, leaves[s], big), gens[s])
                    if s == S - 1:
                        backward_heads(o)
                    else:
                        torch.autograd.backward([y], [bwd_in[s]])
                    if xg is not None:
                        gs[s] = xg.grad if xg.grad is not None \
                            else torch.zeros_like(xg)
                bwd_in = _hop(gs, devs, -1)
            heads.append(outs)
        return heads

    def _step_fn(self, inputs):
        """One train step over the input buffers (``inputs[d][s]``: dp
        group d's microbatched inputs on its stage-s rank)."""
        S = self.S
        L = self.layout
        groups = self._leaves()
        if self.schedule == "1f1b":
            heads = self._1f1b(inputs, groups)
        else:
            heads = self._gpipe(inputs, groups)
        lr, tdev = self._lr, self._tdev
        if self.param_placement == "stage":
            for s in range(S):
                rows = [g[0][s] for g in groups]
                grads = [lf.grad if lf.grad is not None
                         else torch.zeros_like(lf) for lf in rows]
                if self.dp > 1:
                    grads = psum(grads)
                for d, g in enumerate(grads):
                    r = self._rank[d][s]
                    self.opt_state["rows"][r].update(
                        self.params["rows"][r], g, lr.to(g.device),
                        tdev.to(g.device), self._opt_gens[r])
            for name, _shape, _size, padded, _o in self._big_meta:
                wholes = [g[1][name] for g in groups]
                wholes = [w.grad if w.grad is not None
                          else torch.zeros_like(w) for w in wholes]
                for s in range(S):
                    chunks = [w.view(S, -1)[s].to(
                        L.devices[self._rank[d][s]])
                        for d, w in enumerate(wholes)]
                    if self.dp > 1:
                        chunks = psum(chunks)
                    for d, g in enumerate(chunks):
                        r = self._rank[d][s]
                        self.opt_state["big"][name][r].update(
                            self.params["big"][name][r], g,
                            lr.to(g.device), tdev.to(g.device),
                            self._opt_gens[r])
        else:
            ranks = [r for grp in self._rank for r in grp]
            leaves = [lf for g in groups for lf in g[0]]
            grads = psum([lf.grad if lf.grad is not None
                          else torch.zeros_like(lf) for lf in leaves])
            for r, g in zip(ranks, grads):
                self.opt_state[r].update(self._flats[r], g,
                                         lr.to(g.device), tdev.to(g.device),
                                         self._opt_gens[r])
        dev0 = self.device
        nheads = len(self.out_shapes)
        return [torch.cat([heads[d][m][j].detach().to(dev0)
                           for m in range(self.M) for d in range(self.dp)])
                for j in range(nheads)]

    def _buffers(self):
        if self.param_placement == "stage":
            out = list(self.params["rows"])
            for v in self.params["big"].values():
                out.extend(v)
            for st in self.opt_state["rows"]:
                out.extend(st.buffers())
            for v in self.opt_state["big"].values():
                for st in v:
                    out.extend(st.buffers())
            return out
        out = list(self._flats)
        for st in self.opt_state:
            out.extend(st.buffers())
        return out

    def _step_program(self, batch):
        missing = [k for k in self.input_shapes if k not in batch]
        if missing:
            raise MXNetError("step: missing input %s" % missing[0])
        vals = {k: _as_tensor(batch[k]) for k in self.input_shapes}
        L = self.layout
        if self._program is None:
            ops = {}
            inputs = [[dict() for _ in range(self.S)]
                      for _ in range(self.dp)]
            for k, v in vals.items():
                # the label on the last stage's rank, the data on stage 0's
                s = self.S - 1 if k == self.label_name else 0
                for d in range(self.dp):
                    buf = torch.empty(
                        (self.M, self.mb) + tuple(v.shape[1:]),
                        dtype=v.dtype, device=L.devices[self._rank[d][s]])
                    ops["%s@%d" % (k, d)] = inputs[d][s][k] = buf
            self._program = Program(
                functools.partial(self._step_fn, inputs), ops,
                mutable=self._buffers(),
                generators=self._gens + self._opt_gens
                if self.device.type == "cuda" else [],
                name="PipelineTrainer.step", device=self.device,
                capture=not has_host_ops(self.symbol))
        # [B, ...] -> [M, dp*mb, ...]; dp group d takes columns d*mb...
        split = {}
        for k, v in vals.items():
            v = v.reshape((self.M, self.dp * self.mb) + tuple(v.shape[1:]))
            for d in range(self.dp):
                split["%s@%d" % (k, d)] = \
                    v[:, d * self.mb:(d + 1) * self.mb]
        self._program.load(**split)
        return self._program

    def step(self, batch):
        """One pipelined train step on a GLOBAL batch dict (arrays or
        tensors). Returns the head output ``[B, ...]`` (microbatches put
        back in batch order); a list when the symbol has several heads."""
        if self.params is None:
            self.init_params()
        prog = self._step_program(batch)
        self._t += 1
        sched = self.optimizer.lr_scheduler
        self._lr.fill_(sched(self._t) if sched is not None
                       else self.optimizer.lr)
        self._tdev.fill_(float(self._t))
        outs = [o.clone() for o in prog.run()]
        return outs[0] if len(outs) == 1 else outs

    def get_params(self):
        """Every parameter whole, as CPU f32 tensors by name."""
        if self.param_placement == "stage":
            out = {}
            ranks = self._rank[0]
            for s, meta in enumerate(self._flat_meta):
                row = self.params["rows"][ranks[s]].detach().cpu()
                for name, shape, off, size in meta:
                    out[name] = row[off:off + size].reshape(shape).clone()
            for name, shape, size, _padded, _s in self._big_meta:
                whole = torch.cat([self.params["big"][name][r].detach()
                                   .cpu() for r in ranks])
                out[name] = whole[:size].reshape(shape).clone()
            return out
        return {n: v.detach().to("cpu", copy=True)
                for n, v in self.params[0].items()}
