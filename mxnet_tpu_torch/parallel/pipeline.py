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
* ``schedule="gpipe"`` keeps every tick's graph (all M microbatches'
  activations live until the backward), then runs the backward stage by
  stage from the last, the cotangents hopping back a stage at a time;
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

Across processes (a mesh whose ranks live in several processes, as the
JAX package runs one SPMD program over a global mesh) each process runs
its own ranks, the hops between stages are sends and receives between
the processes (``collectives.Span.ppermute``) and the sums add in rank
order, so the step equals the one-process step bit for bit
(:class:`PipelineTrainer`).
"""
from __future__ import annotations

import collections
import functools
import os
import warnings

import numpy as np
import torch

from ..base import MXNetError, later_slice, torch_dtype
from .. import distributed
from .. import optimizer as opt_mod
from ..initializer import Uniform
from .collectives import Span, ppermute, process_broadcast
from .graph import has_host_ops
from .layout import Layout
from .optim import FlatOptState
from .program import Program, ProgramChain
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
        summed over both). Its devices may repeat (``[cuda:0] * 4``), and
        its ranks may live in several processes (see below).
    num_microbatches : each dp group's batch splits into M microbatches
        (default S); the GPipe bubble is (S-1)/(M+S-1).
    param_placement : "stage" (default) or "replicated".
    remat : checkpoint each stage's forward under GPipe (default
        ``MXNET_BACKWARD_DO_MIRROR``); inherent to 1F1B.
    pp_shard_min_size : "auto", an int, or None (no pp-sharded params).
    schedule : "gpipe" or "1f1b" (needs ``param_placement="stage"``).

    dp group ``d`` trains on rows ``[d * B / dp, (d + 1) * B / dp)`` of
    the global batch (the JAX package gives it columns ``d * mb`` of each
    microbatch instead: the same sum of every row's gradient, other
    bits), cut into its M microbatches in order.

    **Across processes** (a mesh whose ranks live in several processes,
    ``Mesh.local_ranks``) each process builds and runs only the ranks it
    owns, and every process calls :meth:`step` and :meth:`get_params`
    together. It passes :meth:`step` the rows of its dp groups (one block
    of the global batch: the whole batch at dp = 1); the data feeds its
    stage-0 ranks and the label its last-stage ranks. The boundary
    activations and their cotangents hop between the processes of
    neighbouring stages (``collectives.Span.ppermute``), the dp sums and
    the ``"replicated"`` sum add every rank's gradient in rank order
    across processes (``Span.sum``), a pp-sharded parameter is gathered
    from its pp ranks. The initializer and the dropout generators draw
    what they draw in one process (``seed=None``: process 0's seed), so
    the step equals the one-process step over the same mesh bit for bit.
    With the pp ranks of every group in one process the step is a
    ``ProgramChain`` (compute and update captured, the dp sums on the
    host between them); with a pp hop across processes every tick holds
    a gloo call, and the step runs uncaptured (``program.
    uncaptured_runs``). ``step`` returns the head outputs of the groups
    whose last stage the process owns, and None where it owns none: the
    ``[B, ...]`` probabilities are not shipped across processes.
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

        L = self.layout
        self._rank = [[L.moved(0, dict({"pp": s},
                                       **({"dp": d} if "dp" in mesh.shape
                                          else {})))
                       for s in range(self.S)] for d in range(self.dp)]
        self._local = set(mesh.local_ranks)
        #: this process's (dp group, stage) ranks, group by group, and its
        #: dp groups
        self._mine = [(d, s) for d in range(self.dp) for s in range(self.S)
                      if self._rank[d][s] in self._local]
        self._groups = sorted({d for d, _ in self._mine})
        if mesh.is_multiprocess:
            self._check_processes()
        owner = mesh.owner
        self._span = Span([owner(r) for r in range(len(L))])
        self._stage_spans = {s: Span([owner(self._rank[d][s])
                                      for d in range(self.dp)])
                             for s in {s for _, s in self._mine}}
        self._group_spans = {d: Span([owner(r) for r in self._rank[d]])
                             for d in self._groups} if self._big_meta else {}
        self._flat_order = [r for grp in self._rank for r in grp]
        self._flat_span = Span([owner(r) for r in self._flat_order])
        self._pp_cross = any(len({owner(r) for r in grp}) > 1
                             for grp in self._rank)
        g0 = self._groups[0]
        rows = batch // self.dp
        #: the global batch's rows this process passes to ``step``
        self.process_rows = (g0 * rows, (self._groups[-1] + 1) * rows)

        if isinstance(optimizer, str):
            okw = dict(optimizer_params or {})
            okw.setdefault("rescale_grad", 1.0 / batch)
            optimizer = opt_mod.create(optimizer, **okw)
        self.optimizer = optimizer
        self._initializer = initializer or Uniform(0.05)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
            if mesh.is_multiprocess:
                # every process draws the one-process run's weights
                seed = int(process_broadcast(
                    torch.tensor([seed], dtype=torch.int64))[0])
        self._seed = seed
        self._init_gen = torch.Generator().manual_seed(seed)
        self.device = L.devices[mesh.local_ranks[0]]
        # seeded by the GLOBAL rank: a rank draws what it draws in one
        # process
        self._gens = [torch.Generator(device=d).manual_seed(int(
            np.random.SeedSequence([seed, r]).generate_state(1)[0]))
            if r in self._local else None
            for r, d in enumerate(L.devices)]
        # SGLD's noise: one stream a stage, the same on its dp replicas
        self._opt_gens = [torch.Generator(device=d).manual_seed(int(
            np.random.SeedSequence([seed, 1 << 20, L.index(r, "pp")])
            .generate_state(1)[0])) if r in self._local else None
            for r, d in enumerate(L.devices)]
        # the step program's learning rate and update count, set by the
        # host before each run
        self._lr = torch.zeros((), device=self.device)
        self._tdev = torch.zeros((), device=self.device)
        self.params = None
        self.opt_state = None
        self._program = None
        self._compile_log = []
        self._gbuf = None     # the summed gradients (the chain's)
        self._outs = None
        self._t = 0
        #: the most boundary inputs a stage held at once in a 1F1B step
        self.max_in_flight = 0

    def _check_processes(self):
        """What a mesh across processes needs, else ``later_slice``
        naming the layout: this process's dp groups one block of the
        batch, and the members of each collective (every rank; a stage's
        dp ranks; a group's pp ranks, which gather a pp-sharded
        parameter) in one process or spread evenly over every process."""
        mesh, g = self.mesh, self._groups
        if g != list(range(g[0], g[-1] + 1)):
            raise later_slice("PipelineTrainer", "%r: a process whose dp "
                              "groups %s are not one block of the batch"
                              % (mesh, g))
        spans = [("every rank", range(mesh.size))]
        spans += [("stage %d's dp ranks" % s,
                   [self._rank[d][s] for d in range(self.dp)])
                  for s in range(self.S)]
        if self._big_meta:
            spans += [("dp group %d's pp ranks" % d, self._rank[d])
                      for d in range(self.dp)]
        nprocs = distributed.process_count()
        for what, ranks in spans:
            count = collections.Counter(mesh.owner(r) for r in ranks)
            if len(count) > 1 and (len(count) != nprocs
                                   or len(set(count.values())) > 1):
                raise later_slice(
                    "PipelineTrainer", "%r: %s in processes %s, neither "
                    "one process nor every process evenly"
                    % (mesh, what, dict(sorted(count.items()))))

    # ------------------------------------------------------------------
    def _infer_boundary_meta(self):
        """The boundary activations' shape at microbatch size, one for
        every cut, and their dtype (the parameters' f32)."""
        from ..symbol import Symbol
        shapes, dtypes = set(), set()
        for node, idx in self.boundaries:
            sub = Symbol([(node, idx)])
            _, out, _ = sub.infer_shape(**{
                k: v for k, v in self._mb_shapes.items()
                if k in sub.list_arguments()})
            shapes.add(tuple(out[0]))
            _, types, _ = sub.infer_type(**{
                k: "float32" for k in sub.list_arguments()
                if k not in self.input_shapes})
            dtypes.add(torch_dtype(types[0]) if types else torch.float32)
        if len(shapes) > 1 or len(dtypes) > 1:
            raise MXNetError(
                "pipeline: boundary activations differ in shape or dtype "
                "(%s, %s); the SPMD schedule carries ONE uniform tensor "
                "between stages — cut at equal-shape points"
                % (sorted(shapes), sorted(map(str, dtypes))))
        self._boundary_shape = shapes.pop() if shapes else ()
        self._boundary_dtype = dtypes.pop() if dtypes else torch.float32

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

    def _per_rank(self, fn):
        """``fn(rank, device)`` for this process's ranks, None at other
        processes' (lists stay indexed by global rank)."""
        return [fn(r, d) if r in self._local else None
                for r, d in enumerate(self.layout.devices)]

    def init_params(self, arg_params=None):
        """Initialize (or load) the parameters and the optimizer state.
        Under ``"stage"`` placement ``params`` is ``{"rows": [row per
        rank], "big": {name: [chunk per rank]}}`` and ``opt_state`` the
        matching ``FlatOptState``\\ s; under ``"replicated"`` ``params`` is
        a list per rank of ``{name: view}`` over one flat buffer. Each
        list is indexed by global rank, None at the ranks of other
        processes; every process draws every parameter and keeps its
        ranks' pieces."""
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
            new_rows = self._per_rank(
                lambda r, d: rows[L.index(r, "pp")].to(d, copy=True))
            new_big = {n: self._per_rank(
                lambda r, d, v=v: v[L.index(r, "pp")].to(d, copy=True))
                for n, v in big.items()}
            if self.params is None:
                self.params = {"rows": new_rows, "big": new_big}
                self.opt_state = {
                    "rows": [FlatOptState(self.optimizer, ["row"],
                                          [(self._pmax,)], r)
                             if r is not None else None for r in new_rows],
                    "big": {n: [FlatOptState(self.optimizer, [n],
                                             [tuple(c.shape)], c)
                                if c is not None else None for c in v]
                            for n, v in new_big.items()}}
            else:
                self._copy_state(new_rows, new_big)
        else:
            flat = torch.cat([vals[n].reshape(-1) for n in self.param_names])
            new = self._per_rank(lambda r, d: flat.to(d, copy=True))
            if self.params is None:
                self._flats = new
                self.params = [self._views(f) if f is not None else None
                               for f in new]
                self.opt_state = [FlatOptState(
                    self.optimizer, self.param_names,
                    [self.arg_shapes[n] for n in self.param_names], f)
                    if f is not None else None for f in new]
            else:
                for dst, src, st in zip(self._flats, new, self.opt_state):
                    if dst is not None:
                        dst.copy_(src)
                        st.reset(dst)
        self._t = 0
        return self

    @torch.no_grad()
    def _copy_state(self, rows, big):
        pairs = [(self.params["rows"], rows, self.opt_state["rows"])]
        pairs += [(self.params["big"][n], chunks, self.opt_state["big"][n])
                  for n, chunks in big.items()]
        for dsts, srcs, states in pairs:
            for dst, src, st in zip(dsts, srcs, states):
                if dst is not None:
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
    def _hop(self, vals, sends, shift, shape):
        """The values of the stages ``sends`` (``(group, stage)`` pairs,
        the schedule's, the same in every process) to the rank ``shift``
        stages on in their groups. ``vals``: by global rank, the values
        of this process's senders. Returns, by global rank, what this
        process's ranks received (None where nothing arrived)."""
        perm = [(self._rank[d][s], self._rank[d][s + shift])
                for d, s in sends]
        return self._span.ppermute(vals, perm, self.layout.devices,
                                   (shape, self._boundary_dtype))

    def _leaves(self):
        """Per dp group of this process (``{d: (leaves, big, params)}``):
        the leaves the step differentiates, by stage (a row leaf, or a
        flat leaf under "replicated"; None at another process's rank),
        and the stage parameters built from them; each pp-sharded
        parameter whole on the rank of the stage that uses it, gathered
        over the group's ranks (from other processes through its
        span)."""
        L = self.layout
        groups = {}
        for d in self._groups:
            ranks = self._rank[d]
            if self.param_placement == "stage":
                leaves = [self.params["rows"][r].detach().requires_grad_(
                    True) if r in self._local else None for r in ranks]
                big = {}
                for name, _shape, _size, _padded, owner in self._big_meta:
                    parts = self._group_spans[d].gather(
                        [self.params["big"][name][r] for r in ranks
                         if r in self._local])
                    if ranks[owner] in self._local:
                        dev = L.devices[ranks[owner]]
                        big[name] = torch.cat([p.to(dev) for p in parts]) \
                            .detach().requires_grad_(True)
                params = [self._stage_params(s, lf, big)
                          if lf is not None else None
                          for s, lf in enumerate(leaves)]
                groups[d] = (leaves, big, params)
            else:
                leaves = [self._flats[r].detach().requires_grad_(True)
                          if r in self._local else None for r in ranks]
                groups[d] = (leaves, {}, [self._views(lf)
                                          if lf is not None else None
                                          for lf in leaves])
        return groups

    def _gpipe(self, inputs, groups):
        """The GPipe schedule: every tick's forward with its graph kept,
        the boundary hopping to the next stage; then the backward stage
        by stage from the last (its heads, then each earlier stage's
        outputs against the cotangents the stage after it sent back, all
        M microbatches in one call: the same calls in one process and in
        several). Returns the head outputs of this process's last-stage
        groups, by group and microbatch."""
        S, M, n = self.S, self.M, len(self.layout)
        kept = {k: [] for k in self._mine}   # (x, y, outs) a microbatch
        state = [None] * n
        for t in range(M + S - 1):
            ys = [None] * n
            for d, s in self._mine:
                m = t - s
                if not 0 <= m < M:
                    continue
                r = self._rank[d][s]
                x = state[r]
                if x is not None:
                    x.requires_grad_(True)
                mbin = {k: v[m] for k, v in inputs[d][s].items()}
                fn = functools.partial(self._stage, s, inputs=mbin,
                                       gen=self._gens[r])
                params = groups[d][2][s]
                if self.remat:
                    names = sorted(params)
                    y, o = self._remat_stage(
                        fn, x, [params[k] for k in names], names,
                        s == S - 1)
                else:
                    y, o = fn(x, params=params)
                kept[(d, s)].append((x, y, o))
                if s < S - 1:
                    ys[r] = y.detach()
            state = self._hop(ys, [(d, s) for d in range(self.dp)
                                   for s in range(S - 1) if 0 <= t - s < M],
                              1, self._boundary_shape)
        cot = [None] * n
        for s in reversed(range(S)):
            gs = [None] * n
            for d, s2 in self._mine:
                if s2 != s:
                    continue
                r = self._rank[d][s]
                rec = kept[(d, s)]
                if s == S - 1:
                    backward_heads([o for _, _, outs in rec for o in outs])
                else:
                    torch.autograd.backward([y for _, y, _ in rec],
                                            list(cot[r].unbind(0)))
                if s:
                    gs[r] = torch.stack([
                        x.grad if x.grad is not None else torch.zeros_like(x)
                        for x, _, _ in rec])
            if s:
                cot = self._hop(gs, [(d, s) for d in range(self.dp)], -1,
                                (M,) + tuple(self._boundary_shape))
        return {d: [[o.detach() for o in outs] for _, _, outs in rec]
                for (d, s), rec in kept.items() if s == S - 1}

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
        """The 1F1B schedule. Tick t: stage s runs the forward of
        microbatch t - s without keeping its graph (saving the boundary
        input), then the backward of microbatch t - (2S-2-s): the stage
        again from its saved input, differentiated, with the cotangent
        stage s+1's backward sent back a tick before. Returns the head
        outputs of this process's last-stage groups, by group and
        microbatch."""
        S, M, n = self.S, self.M, len(self.layout)
        saved = {k: dict() for k in self._mine}
        tapes = {k: dict() for k in self._mine}
        heads = {d: [None] * M for d, s in self._mine if s == S - 1}
        fwd_in = [None] * n
        bwd_in = [None] * n
        for t in range(M + 2 * S - 2):
            ys = [None] * n
            for d, s in self._mine:
                m = t - s
                if not 0 <= m < M:
                    continue
                r = self._rank[d][s]
                saved[(d, s)][m] = fwd_in[r]
                self.max_in_flight = max(self.max_in_flight,
                                         len(saved[(d, s)]))
                tapes[(d, s)][m] = tape = DrawTape()
                with torch.no_grad(), tape.record():
                    y, o = self._stage(
                        s, fwd_in[r],
                        {k: v[m] for k, v in inputs[d][s].items()},
                        groups[d][2][s], self._gens[r])
                if s == S - 1:
                    heads[d][m] = o
                ys[r] = y
            fwd_in = self._hop(ys, [(d, s) for d in range(self.dp)
                                    for s in range(S - 1) if 0 <= t - s < M],
                               1, self._boundary_shape)
            gs = [None] * n
            for d, s in self._mine:
                b = t - (2 * S - 2 - s)
                if not 0 <= b < M:
                    continue
                r = self._rank[d][s]
                leaves, big, _ = groups[d]
                x = saved[(d, s)].pop(b)
                xg = None if x is None else \
                    x.detach().requires_grad_(True)
                # the stage's parameter views anew for each backward,
                # and the draws its forward made
                with tapes[(d, s)].pop(b).replay():
                    y, o = self._stage(
                        s, xg, {k: v[b] for k, v in inputs[d][s].items()},
                        self._stage_params(s, leaves[s], big), self._gens[r])
                if s == S - 1:
                    backward_heads(o)
                else:
                    torch.autograd.backward([y], [bwd_in[r]])
                if xg is not None:
                    gs[r] = xg.grad if xg.grad is not None \
                        else torch.zeros_like(xg)
            bwd_in = self._hop(gs, [(d, s) for d in range(self.dp)
                                    for s in range(1, S)
                                    if 0 <= t - (2 * S - 2 - s) < M],
                               -1, self._boundary_shape)
        return heads

    def _compute(self, inputs):
        """The forward and backward of this process's ranks: (the head
        outputs of its last-stage groups, each head's rows group by group
        and microbatch by microbatch on ``self.device``; the gradients by
        the rank that updates with them, before the dp sum:
        ``("row", r)``, ``("big", name, r)`` (chunk s of the group's whole
        gradient, moved from the rank of the stage that uses the
        parameter to pp rank s's) or ``("flat", r)``)."""
        groups = self._leaves()
        run = self._1f1b if self.schedule == "1f1b" else self._gpipe
        heads = run(inputs, groups)
        outs = [torch.cat([heads[d][m][j].detach().to(self.device)
                           for d in sorted(heads) for m in range(self.M)])
                for j in range(len(self.out_shapes))] if heads else []

        def grad(t):
            return t.grad if t.grad is not None else torch.zeros_like(t)

        kind = "row" if self.param_placement == "stage" else "flat"
        grads = {(kind, self._rank[d][s]): grad(groups[d][0][s])
                 for d, s in self._mine}
        for name, _shape, _size, padded, owner in self._big_meta:
            for s in range(self.S):
                vals = [None] * len(self.layout)
                for d in self._groups:
                    if self._rank[d][owner] in self._local:
                        vals[self._rank[d][owner]] = grad(
                            groups[d][1][name]).view(self.S, -1)[s]
                got = self._span.ppermute(
                    vals, [(self._rank[d][owner], self._rank[d][s])
                           for d in range(self.dp)],
                    self.layout.devices, ((padded // self.S,), torch.float32))
                for d, s2 in self._mine:
                    if s2 == s:
                        grads[("big", name, self._rank[d][s])] = \
                            got[self._rank[d][s]]
        return outs, grads

    def _reduce(self, grads):
        """The gradient each of this process's ranks updates with, by
        ``grads``'s keys: every stage's rows and pp-shard chunks summed
        over its dp ranks, or under "replicated" every rank's flat
        gradient summed, in rank order across processes (``Span.sum``:
        the one-process ``psum``'s bits)."""
        devs = self.layout.devices
        if self.param_placement != "stage":
            total = self._flat_span.sum([grads[("flat", r)]
                                         for r in self._flat_order
                                         if r in self._local])
            return {k: total.to(devs[k[1]]) for k in grads}
        sums = {}
        prefixes = [("row",)] + [("big", m[0]) for m in self._big_meta]
        for s in sorted(self._stage_spans):
            ranks = [self._rank[d][s] for d in range(self.dp)]
            for prefix in prefixes:
                keys = [prefix + (r,) for r in ranks if r in self._local]
                total = self._stage_spans[s].sum([grads[k] for k in keys])
                for k in keys:
                    sums[k] = total.to(devs[k[-1]])
        return sums

    def _apply(self, sums):
        """Each of this process's ranks' update from its summed
        gradient."""
        lr, tdev = self._lr, self._tdev
        for key, g in sums.items():
            r = key[-1]
            if key[0] == "flat":
                st, p = self.opt_state[r], self._flats[r]
            elif key[0] == "row":
                st, p = self.opt_state["rows"][r], self.params["rows"][r]
            else:
                st = self.opt_state["big"][key[1]][r]
                p = self.params["big"][key[1]][r]
            st.update(p, g, lr.to(g.device), tdev.to(g.device),
                      self._opt_gens[r])

    def _step_fn(self, inputs):
        """One train step over the input buffers (``inputs[d][s]``: dp
        group d's microbatched inputs on its stage-s rank)."""
        outs, grads = self._compute(inputs)
        self._apply(self._reduce(grads))
        return outs

    def _buffers(self):
        if self.param_placement == "stage":
            out = list(self.params["rows"])
            for v in self.params["big"].values():
                out.extend(v)
            for st in self.opt_state["rows"]:
                out.extend(st.buffers() if st is not None else [])
            for v in self.opt_state["big"].values():
                for st in v:
                    out.extend(st.buffers() if st is not None else [])
        else:
            out = list(self._flats)
            for st in self.opt_state:
                out.extend(st.buffers() if st is not None else [])
        return [t for t in out if t is not None]

    def _build(self, inputs, ops):
        """The step: one program in one process, captured on the card;
        across processes with every group's pp ranks in one process a
        ``ProgramChain`` (the compute and the update captured, the dp sums
        on the host between them); with a pp hop across processes one
        program run uncaptured (each tick holds a gloo call)."""
        cuda = self.device.type == "cuda"
        capture = not has_host_ops(self.symbol)
        gens = [g for g in self._gens if g is not None]
        opt_gens = [g for g in self._opt_gens if g is not None]
        kw = dict(device=self.device, log=self._compile_log)
        if not self.mesh.is_multiprocess or self._pp_cross:
            return Program(
                functools.partial(self._step_fn, inputs), ops,
                mutable=self._buffers(),
                generators=gens + opt_gens if cuda else [],
                name="PipelineTrainer.step", tag="step",
                capture=capture and not self._pp_cross, **kw)
        nout = len(self.out_shapes) if any(
            s == self.S - 1 for _, s in self._mine) else 0

        def compute():
            outs, grads = self._compute(inputs)
            self._gkeys = list(grads)
            return tuple(outs) + tuple(grads.values())

        @torch.no_grad()
        def reduce(res):
            sums = self._reduce(dict(zip(self._gkeys, res[nout:])))
            if self._gbuf is None:
                self._gbuf = {k: v.clone() for k, v in sums.items()}
            else:
                for k, v in sums.items():
                    self._gbuf[k].copy_(v)
            self._outs = res[:nout]

        def update():
            self._apply(self._gbuf)
            return ()

        return ProgramChain([
            Program(compute, ops, generators=gens if cuda else [],
                    name="PipelineTrainer.step.compute",
                    tag="step.compute", capture=capture, **kw),
            reduce,
            Program(update, mutable=self._buffers(),
                    generators=opt_gens if cuda else [],
                    name="PipelineTrainer.step.update", tag="step.update",
                    capture=capture, **kw),
            lambda _: self._outs], "PipelineTrainer.step")

    @property
    def compile_counts(self):
        """``{tag: builds}`` of the step's programs: ``{"step": 1}``, or
        ``{"step.compute": 1, "step.update": 1}`` for the chain."""
        return dict(collections.Counter(self._compile_log))

    def _step_program(self, batch):
        missing = [k for k in self.input_shapes if k not in batch]
        if missing:
            raise MXNetError("step: missing input %s" % missing[0])
        vals = {k: _as_tensor(batch[k]) for k in self.input_shapes}
        lo, hi = self.process_rows
        for k, v in vals.items():
            if v.shape[0] != hi - lo:
                raise MXNetError(
                    "step: input %r has %d rows; this process passes rows "
                    "[%d, %d) of the global batch of %d (its dp groups')"
                    % (k, v.shape[0], lo, hi, self.global_batch))
        L = self.layout
        if self._program is None:
            ops = {}
            inputs = {d: [dict() for _ in range(self.S)]
                      for d in self._groups}
            for k, v in vals.items():
                # the label on the last stage's rank, the data on stage 0's
                s = self.S - 1 if k == self.label_name else 0
                for d in self._groups:
                    if self._rank[d][s] not in self._local:
                        continue
                    buf = torch.empty(
                        (self.M, self.mb) + tuple(v.shape[1:]),
                        dtype=v.dtype, device=L.devices[self._rank[d][s]])
                    ops["%s@%d" % (k, d)] = inputs[d][s][k] = buf
            self._program = self._build(inputs, ops)
        # [rows, ...] -> [groups, M, mb, ...]: group d's rows, microbatch
        # by microbatch
        split = {}
        for key in self._program.operands:
            k, d = key.rsplit("@", 1)
            v = vals[k]
            split[key] = v.reshape((len(self._groups), self.M, self.mb)
                                   + tuple(v.shape[1:]))[
                                       int(d) - self._groups[0]]
        self._program.load(**split)
        return self._program

    def step(self, batch):
        """One pipelined train step on a batch dict (arrays or tensors):
        the GLOBAL batch in one process, else this process's rows of it
        (``process_rows``). Returns the head output (microbatches put back
        in batch order; a list when the symbol has several heads) of the
        rows whose last stage this process runs, None where it runs no
        last stage."""
        if self.params is None:
            self.init_params()
        prog = self._step_program(batch)
        self._t += 1
        sched = self.optimizer.lr_scheduler
        self._lr.fill_(sched(self._t) if sched is not None
                       else self.optimizer.lr)
        self._tdev.fill_(float(self._t))
        outs = [o.clone() for o in prog.run()]
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else outs

    def get_params(self):
        """Every parameter whole, as CPU f32 tensors by name. On a mesh
        across processes the stages' rows and the pp shards are gathered
        from every process (as the JAX package does at
        ``process_count() > 1``), so every process calls it together."""
        local = self.mesh.local_ranks
        if self.param_placement == "stage":
            out = {}
            ranks = self._rank[0]
            rows = self._span.gather([self.params["rows"][r] for r in local])
            for s, meta in enumerate(self._flat_meta):
                row = rows[ranks[s]].detach().cpu()
                for name, shape, off, size in meta:
                    out[name] = row[off:off + size].reshape(shape).clone()
            for name, shape, size, _padded, _s in self._big_meta:
                chunks = self._span.gather([self.params["big"][name][r]
                                            for r in local])
                whole = torch.cat([chunks[r].detach().cpu() for r in ranks])
                out[name] = whole[:size].reshape(shape).clone()
            return out
        return {n: v.detach().to("cpu", copy=True)
                for n, v in self.params[local[0]].items()}
