"""The port's sharding rules, collectives and ``ParallelTrainer`` over a
mesh against the JAX package's on its 8 virtual CPU devices.

The port's meshes are ``["cpu"] * 8``: one process holds every rank's
shard. Each test mirrors an oracle of ``tests/test_parallel.py`` (named
after it) on the same inputs, made from a numpy seed: the port's trainer
on the mesh against the JAX package's trainer on the same mesh (or its
one-device step, as the JAX test holds it), parameters after the same
steps at the JAX tests' tolerance, rtol 2e-4 / atol 2e-5 (tighter where
the JAX test is: 2e-5 / 2e-6 for zero1 and fsdp, 1e-6 / 1e-7 for a
checkpoint round trip; AdaFactor sharded at the JAX test's 2e-3). Within
the port, zero1 and fsdp equal plain data parallelism bit for bit (the
reduce-scatter sums in ``psum``'s rank order), and the tests read each
rank's stored bytes: 1/dp of the state (zero1), and of the parameters
(fsdp), plus the stated padding. The meshes across processes are held
here as process 1 of 2 (``distributed``'s process index, count and
global device list stood in for, and the exchange between processes):
each rank's process and this process's ranks, and the rank-order sum
bitwise the one-process ``psum`` (``tests/test_torch_multiproc.py``
runs real processes).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import P as JP
from mxnet_tpu.parallel.compat import shard_map
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.models.transformer import tp_rules as jax_tp_rules

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.parallel import P, collectives as coll
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.models.transformer import ep_rules, tp_rules

TOL = dict(rtol=2e-4, atol=2e-5)
CPU8 = ["cpu"] * 8


def _mlp(pkg):
    s = pkg.symbol
    data = s.Variable("data")
    fc1 = s.FullyConnected(data=data, name="fc1", num_hidden=32)
    act = s.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = s.FullyConnected(data=act, name="fc2", num_hidden=10)
    return s.SoftmaxOutput(data=fc2, name="softmax")


def _mlp_problem(seed=0, n=16, d=64):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(n, d).astype(np.float32),
            "softmax_label": rng.randint(0, 10, (n,)).astype(np.float32)}


def _init(sym, shapes, seed, scale=0.07):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-scale, scale, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _port(sym, shapes, init, batch, steps, mesh_axes=None, **kw):
    if mesh_axes is not None:
        kw["mesh"] = par.build_mesh(mesh_axes, CPU8)
    elif "mesh" not in kw and "rules" not in kw:
        kw["device"] = "cpu"
    tr = par.ParallelTrainer(sym, {k: v.shape for k, v in batch.items()},
                             **kw)
    tr.init_params({k: v.copy() for k, v in init.items()})
    for _ in range(steps):
        tr.step(batch)
    return tr


def _jax(sym, init, batch, steps, mesh_axes=None, **kw):
    mesh = jpar.build_mesh(mesh_axes) if mesh_axes is not None \
        else jpar.data_parallel_mesh(1)
    kw.setdefault("mesh", mesh)
    tr = jpar.ParallelTrainer(sym, {k: v.shape for k, v in batch.items()},
                              **kw)
    tr.init_params({k: jmx.nd.array(v.copy()) for k, v in init.items()})
    for _ in range(steps):
        tr.step(batch)
    got, _ = tr.get_params()
    return {k: v.asnumpy() for k, v in got.items()}


def _close(got, want, **tol):
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n]), want[n], err_msg=n,
                                   **(tol or TOL))


def _params(tr):
    return {k: v.numpy() for k, v in tr.get_params()[0].items()}


# -- rules and collectives ----------------------------------------------------

def test_sharding_rules_fallback():
    mesh = par.build_mesh({"dp": 4, "tp": 2}, CPU8)
    rules = par.ShardingRules(mesh, param_rules=[
        (r"fc\d+_weight$", P("tp", None))])
    jrules = jpar.ShardingRules(jpar.build_mesh({"dp": 4, "tp": 2}),
                                param_rules=[(r"fc\d+_weight$",
                                              JP("tp", None))])
    for name, shape in (("fc1_weight", (32, 784)), ("fc1_weight", (33, 784)),
                        ("fc1_bias", (32,))):
        assert tuple(rules.param_spec(name, shape)) == \
            tuple(jrules.param_spec(name, shape)), (name, shape)
    assert rules.param_spec("fc1_weight", (32, 784)) == P("tp")
    for shape in ((64, 784), (6, 784)):
        assert tuple(rules.data_spec("data", shape)) == \
            tuple(jrules.data_spec("data", shape))
    assert rules.data_axes == ("dp",) and rules.seq_axes == ()
    seq = par.ShardingRules(par.build_mesh({"dp": 2, "sp": 4}, CPU8),
                            seq_axes=("sp", "nope"))
    assert seq.seq_axes == ("sp",)
    assert seq.data_spec("data", (4, 16)) == P("dp", "sp")
    assert seq.data_spec("data", (4, 6)) == P("dp")
    # a tuple of axes splits over their product; an axis the mesh lacks
    # is dropped
    both = par.ShardingRules(mesh, param_rules=[(r"w$", P(("dp", "tp")))])
    assert both.param_spec("w", (16, 3)) == P(("dp", "tp"))
    assert both.param_spec("w", (12, 3)) == P()
    assert par.ShardingRules(mesh, param_rules=[
        (r"w$", P("ep", "tp"))]).param_spec("w", (4, 4)) == P(None, "tp")
    sh = rules.param_sharding("fc1_weight", (32, 784))
    assert sh.mesh is mesh and sh.spec == P("tp")
    assert rules.replicated().spec == P()


def test_collectives_exact_values():
    """psum of rank+1 over 8 ranks is 36, as in JAX; pmean, pmax and
    axis_index against JAX's under shard_map; pmean and pmax differentiate
    by autograd."""
    n = 8
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3) % 5
    mesh = jpar.build_mesh({"dp": n})

    def f(xs):
        r = jax.lax.axis_index("dp").astype(jnp.float32) + 1.0
        return (jpar.collectives.psum(r, "dp")[None],
                jpar.collectives.pmean(xs, "dp"),
                jpar.collectives.pmax(xs, "dp"),
                jpar.collectives.axis_index("dp")[None])

    jsum, jmean, jmax, jidx = shard_map(
        f, mesh=mesh, in_specs=JP("dp"),
        out_specs=(JP("dp"), JP("dp"), JP("dp"), JP("dp")),
        check_vma=False)(jnp.asarray(x))
    idx = coll.axis_index([torch.zeros(())] * n)
    assert [int(i) for i in idx] == list(np.asarray(jidx))
    assert all(i.dtype == torch.int32 for i in idx)
    got = coll.psum([i.float() + 1.0 for i in idx])
    assert [float(g) for g in got] == [36.0] * n == list(np.asarray(jsum))
    xs = [torch.from_numpy(x[i:i + 1]).requires_grad_(True)
          for i in range(n)]
    mean, top = coll.pmean(xs), coll.pmax(xs)
    np.testing.assert_allclose(torch.cat(mean).detach().numpy(),
                               np.asarray(jmean), rtol=1e-6)
    np.testing.assert_array_equal(torch.cat(top).detach().numpy(),
                                  np.asarray(jmax))
    sum(m.sum() for m in mean).backward()
    for xi in xs:
        np.testing.assert_allclose(xi.grad.numpy(), np.ones((1, 3)))
    ys = [torch.tensor([float(i), 3.0 - i]).requires_grad_(True)
          for i in range(3)]
    sum(t.sum() for t in coll.pmax(ys)).backward()
    # the max of each column reaches only its rank, once per rank output
    assert ys[2].grad.tolist() == [3.0, 0.0]
    assert ys[0].grad.tolist() == [0.0, 3.0]


# -- meshes and sums across processes ----------------------------------------

def _as_process(monkeypatch, index, count, devices=None, owners=None):
    """This process as process ``index`` of ``count``, with the global
    device list ``devices`` owned by ``owners`` (what
    ``distributed.initialize`` gathers at the join)."""
    from mxnet_tpu_torch import distributed as D
    monkeypatch.setattr(D, "process_index", lambda: index)
    monkeypatch.setattr(D, "process_count", lambda: count)
    if devices is not None:
        monkeypatch.setattr(D, "devices", lambda: [torch.device(d)
                                                   for d in devices])
        monkeypatch.setattr(D, "device_processes", lambda: list(owners))


def test_mesh_across_processes(monkeypatch):
    """A mesh over a process-spanning device list records each rank's
    process and this process's ranks; without ``devices=`` it spans every
    process's devices (the global ``jax.devices()``), a device repeating
    across processes; with ``devices=`` alone it is this process's."""
    m = par.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
                 ("dp", "tp"), processes=[[0, 0], [1, 1]])
    assert m.local_ranks == [0, 1] and m.is_multiprocess
    assert [m.owner(r) for r in range(4)] == [0, 0, 1, 1]
    assert m.local_devices() == [torch.device("cpu")] * 2
    assert not par.build_mesh({"dp": 2}, CPU8[:2]).is_multiprocess
    _as_process(monkeypatch, 1, 2, CPU8[:4], [0, 0, 1, 1])
    m = par.build_mesh({"dp": -1})
    assert m.shape == {"dp": 4} and m.local_ranks == [2, 3]
    assert m.processes.tolist() == [0, 0, 1, 1]
    m = par.build_mesh({"dp": 2, "tp": -1})
    assert m.shape == {"dp": 2, "tp": 2} and m.local_ranks == [2, 3]
    assert par.data_parallel_mesh().local_ranks == [2, 3]
    assert par.build_mesh({"dp": 2}, CPU8[:2]).local_ranks == [0, 1]
    # DevicePrefetchIter(mesh=) places on the device of this process's
    # ranks
    from mxnet_tpu_torch import io as tio
    m = par.build_mesh({"dp": -1})
    assert tio._prefetch_device(None, m, "dp") == torch.device("cpu")
    with pytest.raises(mx.base.MXNetError, match="owns no rank"):
        par.Mesh(CPU8[:2], ("dp",), processes=[0, 0])


def _seeded_operands(n, size=4096, seed=11):
    """Operands whose magnitudes span 7 decades, so the order of a sum
    shows in its bits."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(size) * 10.0 ** rng.randint(
        -3, 4, size)).astype(np.float32)) for _ in range(n)]


def test_rank_order_sum_across_processes_equals_one_process(monkeypatch):
    """``Span.sum`` as process 0 of 2, process 1's operands arriving
    through a stand-in for the sends and receives between the processes,
    equals the one-process ``psum`` over the 4 ranks bit for bit (a sum
    in another order does not); the gather returns every member in rank
    order."""
    xs = _seeded_operands(4)
    want = coll.psum(xs)[0]
    assert not torch.equal(want, ((xs[3] + xs[2]) + xs[1]) + xs[0])
    _as_process(monkeypatch, 0, 2)
    sent = []

    def exchange(self, send, recv):
        sent.append(send.clone())
        recv[1].copy_(torch.cat(xs[2:]))

    monkeypatch.setattr(coll.Span, "_exchange", exchange)
    span = coll.Span([0, 0, 1, 1])
    assert span.cross and span.local == [0, 1]
    assert torch.equal(span.sum(xs[:2]), want)
    assert torch.equal(sent[0], torch.cat(xs[:2]))
    assert all(torch.equal(a, b) for a, b in zip(span.gather(xs[:2]), xs))
    with pytest.raises(mx.base.MXNetError, match="same number"):
        coll.Span([0, 1, 1])


def test_psum_ranked_backward_sums_in_rank_order():
    """``psum_ranked``: one output a rank, the ordered sum in the forward;
    each rank's input gets the ordered sum of every rank's output
    gradient."""
    xs = [x.requires_grad_(True) for x in _seeded_operands(4)]
    ys = coll.psum_ranked(xs)
    total = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert all(torch.equal(y, total) for y in ys)
    gs = _seeded_operands(4, seed=12)
    torch.autograd.backward(ys, gs)
    want = ((gs[0] + gs[1]) + gs[2]) + gs[3]
    assert all(torch.equal(x.grad, want) for x in xs)


def test_span_ppermute_moves_sends_and_receives(monkeypatch):
    """``Span.ppermute`` as process 0 of 2 over members owned [0, 0, 1,
    1]: a pair with both ends here moves, a local source sends to its
    destination's process in pieces of ``CHUNK_BYTES``, a local
    destination receives a tensor of the shape and dtype given; the sends
    are posted before the receives in ``perm``'s order, nothing is waited
    on before every piece is posted, and nothing arrives elsewhere."""
    import torch.distributed as dist
    _as_process(monkeypatch, 0, 2)
    monkeypatch.setattr(coll, "CHUNK_BYTES", 16)   # 4 floats a piece
    xs = _seeded_operands(4, size=10)
    events, waits = [], []

    class Req:
        def wait(self):
            waits.append(len(events))

    def isend(t, peer):
        events.append(("send", t.clone(), peer))
        return Req()

    incoming = iter(xs[3].split(4))

    def irecv(t, peer):
        t.copy_(next(incoming))
        events.append(("recv", t.numel(), peer))
        return Req()

    monkeypatch.setattr(dist, "isend", isend)
    monkeypatch.setattr(dist, "irecv", irecv)
    calls = coll._TM_CROSS_CALLS.value
    span = coll.Span([0, 0, 1, 1])
    out = span.ppermute([xs[0], xs[1], None, None],
                        [(0, 1), (1, 2), (3, 0)], ["cpu"] * 4,
                        ((2, 5), torch.float32))
    assert torch.equal(out[1], xs[0]) and out[2] is None and out[3] is None
    assert out[0].shape == (2, 5) and torch.equal(out[0].reshape(-1), xs[3])
    assert [e[0] for e in events] == ["send"] * 3 + ["recv"] * 3
    assert torch.equal(torch.cat([e[1] for e in events[:3]]), xs[1])
    assert {e[2] for e in events} == {1} and waits == [6] * 6
    assert coll._TM_CROSS_CALLS.value == calls + 1


def test_sequence_parallel_refuses_a_ring_spread_unevenly(monkeypatch):
    """Across processes the SP trainer takes any {dp, sp} mesh whose
    collectives hold as many ranks in every process; a ring of 3 ranks
    over 2 processes (2 + 1) is refused, naming the layout."""
    _as_process(monkeypatch, 0, 2)
    sym = get_transformer_lm(11, num_layers=1, embed_dim=16, num_heads=2,
                             impl="ring_striped")
    shapes = {"data": (2, 12), "softmax_label": (2, 12)}
    even = par.Mesh(np.array(["cpu"] * 2, dtype=object).reshape(1, 2),
                    ("dp", "sp"), processes=[[0, 1]])
    assert par.SequenceParallelTrainer(sym, shapes, even)._local == [0]
    mesh = par.Mesh(np.array(["cpu"] * 3, dtype=object).reshape(1, 3),
                    ("dp", "sp"), processes=[[0, 0, 1]])
    with pytest.raises(mx.base.MXNetError, match="SequenceParallelTrainer: "
                       "a mesh whose ranks of a collective are spread "
                       "unevenly .*processes \\[0, 1\\].* later slice"):
        par.SequenceParallelTrainer(sym, shapes, mesh)


class _FakeP2P:
    """``torch.distributed.isend``/``irecv`` stood in for: each send is
    recorded, each receive filled from ``incoming`` in order; ``waits``
    holds how many posts there were at each wait."""

    def __init__(self, monkeypatch, incoming):
        import torch.distributed as dist
        self.events, self.waits = [], []
        self.incoming = iter(incoming)
        fake = self

        class Req:
            def wait(self):
                fake.waits.append(len(fake.events))

        def isend(t, peer):
            fake.events.append(("send", t.clone(), peer))
            return Req()

        def irecv(t, peer):
            t.copy_(next(fake.incoming))
            fake.events.append(("recv", t.numel(), peer))
            return Req()

        monkeypatch.setattr(dist, "isend", isend)
        monkeypatch.setattr(dist, "irecv", irecv)

    def take(self):
        out, self.events, self.waits = (self.events, self.waits), [], []
        return out


def test_span_ring_hop_sends_k_and_v_at_once_and_reverses(monkeypatch):
    """``ring_hop`` over a ring owned [0, 0, 1, 1], as process 0 of 2: one
    node moves K and V of both local members; member 0 -> 1 stays here,
    member 1's K and V go to process 1 as ONE buffer and member 3's come
    back as one, every piece posted before any wait; the backward posts in
    the same order and is the reverse rotation (member 0's gradient goes
    to member 3's process, member 1 takes member 2's)."""
    _as_process(monkeypatch, 0, 2)
    k, v, g = (_seeded_operands(4, size=6, seed=s) for s in (1, 2, 3))
    gv = _seeded_operands(4, size=6, seed=4)
    ks = [x.clone().requires_grad_(True) for x in k[:2]]
    vs = [x.clone().requires_grad_(True) for x in v[:2]]
    # process 1 sends member 3's K and V, then (backward) member 2's
    # gradients, each pair as one buffer
    p2p = _FakeP2P(monkeypatch, [torch.cat([k[3], v[3]]),
                                 torch.cat([g[2], gv[2]])])
    span = coll.Span([0, 0, 1, 1])
    (ko, vo) = coll.ring_hop([ks, vs], span=span)
    assert torch.equal(ko[0], k[3]) and torch.equal(vo[0], v[3])
    assert torch.equal(ko[1], k[0]) and torch.equal(vo[1], v[0])
    (events, waits) = p2p.take()
    assert [(e[0], e[2]) for e in events] == [("send", 1), ("recv", 1)]
    assert torch.equal(events[0][1], torch.cat([k[1], v[1]]))
    assert events[1][1] == 12 and waits == [2, 2]
    assert ko[0].grad_fn is ko[1].grad_fn is vo[0].grad_fn
    torch.autograd.backward(ko + vo, g[:2] + gv[:2])
    (events, waits) = p2p.take()
    assert [(e[0], e[2]) for e in events] == [("send", 1), ("recv", 1)]
    assert torch.equal(events[0][1], torch.cat([g[0], gv[0]]))
    assert waits == [2, 2]
    assert torch.equal(ks[0].grad, g[1]) and torch.equal(vs[0].grad, gv[1])
    assert torch.equal(ks[1].grad, g[2]) and torch.equal(vs[1].grad, gv[2])
    # with no span: the one-process rotation
    assert torch.equal(coll.ring_hop([k], span=None)[0][1], k[0])


def test_span_all_to_all_pieces_and_inverse(monkeypatch):
    """The untiled ``all_to_all`` of the striped deal over members owned
    [0, 0, 1, 1], as process 0 of 2: one node; each local member's pieces
    for process 1's members go as one buffer (member-major), process 1's
    pieces for the local members come as one; the outputs and the input
    gradients equal the one-process ``all_to_all`` of all four members',
    and the backward is the inverse exchange, posted in the same order."""
    _as_process(monkeypatch, 0, 2)
    rng = np.random.RandomState(5)
    xs = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))
          for _ in range(4)]
    ws = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))
          for _ in range(4)]
    full = [x.clone().requires_grad_(True) for x in xs]
    want = coll.all_to_all(full, 0, 0)
    torch.autograd.backward(want, ws)
    # process 1: member i's pieces for members 0 and 1; then (backward)
    # the gradients of its outputs 2 and 3, pieces for members 0 and 1
    p2p = _FakeP2P(monkeypatch, [
        torch.cat([xs[i][j] for i in (2, 3) for j in (0, 1)]),
        torch.cat([ws[j][i] for j in (2, 3) for i in (0, 1)])])
    mine = [x.clone().requires_grad_(True) for x in xs[:2]]
    out = coll.all_to_all(mine, 0, 0, span=coll.Span([0, 0, 1, 1]))
    (events, waits) = p2p.take()
    assert [(e[0], e[2]) for e in events] == [("send", 1), ("recv", 1)]
    assert torch.equal(events[0][1], torch.cat(
        [xs[i][j] for i in (0, 1) for j in (2, 3)]))
    assert waits == [2, 2]
    assert all(torch.equal(o, w) for o, w in zip(out, want[:2]))
    torch.autograd.backward(out, ws[:2])
    (events, waits) = p2p.take()
    assert [(e[0], e[2]) for e in events] == [("send", 1), ("recv", 1)]
    assert torch.equal(events[0][1], torch.cat(
        [ws[j][i] for j in (0, 1) for i in (2, 3)]))
    assert all(torch.equal(m.grad, f.grad) for m, f in zip(mine, full))


def test_engine_refuses_a_mesh_across_processes():
    from mxnet_tpu_torch.serving.engine import InferenceEngine
    sym = get_transformer_lm(17, num_layers=1, embed_dim=32, num_heads=4)
    shapes, _, _ = sym.infer_shape(data=(2, 16), softmax_label=(2, 16))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    dec = par.Decoder(sym, params, max_len=16, device="cpu")
    mesh = par.Mesh(["cpu"] * 2, ("model",), processes=[0, 1])
    with pytest.raises(mx.base.MXNetError, match="InferenceEngine: serving "
                       "over a mesh across processes .* later slice"):
        InferenceEngine(dec, tp=2, mesh=mesh, slots=2,
                        prefill_buckets=(4, 8), prefix_cache_mb=0)


PIPE_REFUSED = {
    # process 0 owns dp groups 0 and 2 of 4
    "groups_not_one_block": ([[0, 0], [1, 1], [0, 0], [1, 1]],
                             r"dp groups \[0, 2\] are not one block"),
    # process 0 owns 6 ranks of 8, process 1 two
    "uneven_ranks": ([[0, 0], [0, 0], [0, 1], [0, 1]],
                     r"every rank in processes \{0: 6, 1: 2\}"),
}


@pytest.mark.parametrize("case", list(PIPE_REFUSED))
def test_pipeline_refuses_a_layout_across_processes_it_does_not_cover(
        monkeypatch, case):
    """A mesh across processes that the port's pipeline does not run
    raises ``later_slice`` naming the layout, before any state exists."""
    procs, match = PIPE_REFUSED[case]
    _as_process(monkeypatch, 0, 2)
    sym = get_transformer_lm(11, num_layers=2, embed_dim=16, num_heads=2,
                             impl="dense", pipeline_stages=2)
    mesh = par.Mesh(np.array(CPU8, dtype=object).reshape(4, 2),
                    ("dp", "pp"), processes=procs)
    with pytest.raises(mx.base.MXNetError, match="PipelineTrainer: Mesh.*"
                       + match + ".* later slice"):
        par.PipelineTrainer(sym, {"data": (8, 8), "softmax_label": (8, 8)},
                            mesh, num_microbatches=2)


# -- the data-parallel step ---------------------------------------------------

@pytest.mark.parametrize("mesh_axes", [{"dp": 8}, {"dp": 4, "tp": 2}],
                         ids=["dp8", "dp4_tp2"])
def test_fused_step_matches_executor(mesh_axes):
    batch = _mlp_problem()
    sym, jsym = _mlp(mx), _mlp(jmx)
    init = _init(sym, {k: v.shape for k, v in batch.items()}, 7)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    want = _jax(jsym, init, batch, 3, mesh_axes, optimizer="sgd",
                rules=jpar.ShardingRules(
                    jpar.build_mesh(mesh_axes), param_rules=[
                        (r"_weight$", JP("tp", None)),
                        (r"_bias$", JP("tp"))]),
                optimizer_params=opt)
    mesh = par.build_mesh(mesh_axes, CPU8)
    rules = par.ShardingRules(mesh, param_rules=[
        (r"_weight$", P("tp", None)), (r"_bias$", P("tp"))])
    tr = _port(sym, {k: v.shape for k, v in batch.items()}, init, batch, 3,
               rules=rules, optimizer="sgd", optimizer_params=opt)
    _close(_params(tr), want)
    sh = tr._sharded
    assert len(sh.walk_ranks) == mesh_axes["dp"]
    if "tp" in mesh_axes:
        # each tp rank stores half of fc1's rows
        assert tuple(sh.rank_params[1]["fc1_weight"].shape) == (16, 64)
        assert tuple(sh.rank_params[1]["fc2_bias"].shape) == (5,)


def test_batchnorm_global_stats_in_dp():
    data = mx.symbol.Variable("data")
    bn = mx.symbol.BatchNorm(data=data, name="bn")
    sym = mx.symbol.LinearRegressionOutput(
        data=bn, label=mx.symbol.Variable("label"), name="lro")
    rng = np.random.RandomState(0)
    x = rng.randn(16, 4).astype(np.float32) * 3 + 1
    lbl = np.zeros((16, 4), np.float32)
    tr = par.ParallelTrainer(sym, {"data": x.shape, "label": lbl.shape},
                             optimizer="sgd",
                             mesh=par.data_parallel_mesh(devices=CPU8))
    tr.init_params()
    out = tr.step({"data": x, "label": lbl})[0].numpy()
    expect = (x - x.mean(0)) / np.sqrt(x.var(0) + 1e-3)
    gamma = tr.params["bn_gamma"].numpy()
    np.testing.assert_allclose(out, expect * gamma[None, :], rtol=1e-3,
                               atol=1e-3)
    # the moving statistics: global-batch values, equal on every rank
    # and equal to the JAX trainer's
    jsym = jmx.symbol.LinearRegressionOutput(
        data=jmx.symbol.BatchNorm(data=jmx.symbol.Variable("data"),
                                  name="bn"),
        label=jmx.symbol.Variable("label"), name="lro")
    jtr = jpar.ParallelTrainer(jsym, {"data": x.shape, "label": lbl.shape},
                               optimizer="sgd",
                               mesh=jpar.data_parallel_mesh())
    jtr.init_params()
    jout = np.asarray(jtr.step({"data": x, "label": lbl})[0])
    np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-5)
    _, jaux = jtr.get_params()
    _, aux = tr.get_params()
    for n, v in jaux.items():
        np.testing.assert_allclose(aux[n].numpy(), v.asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    for r in range(8):
        for a, b in zip(tr._sharded.aux[r], tr._sharded.aux[0]):
            assert torch.equal(a, b)


def test_remat_step_matches_plain(monkeypatch):
    """remat (and its default, MXNET_BACKWARD_DO_MIRROR=1) changes no
    number: against plain, on one device and on a dp=2 mesh, and against
    the JAX trainer's remat step."""
    batch = _mlp_problem(n=8)
    shapes = {k: v.shape for k, v in batch.items()}
    sym = _mlp(mx)
    init = _init(sym, shapes, 5)
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    plain = _params(_port(sym, shapes, init, batch, 2, **opt))
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    tr = _port(sym, shapes, init, batch, 2, **opt)
    assert tr.remat
    _close(_params(tr), plain, rtol=1e-5, atol=1e-6)
    two = _port(sym, shapes, init, batch, 2,
                mesh=par.build_mesh({"dp": 2}, ["cpu"] * 2), **opt)
    assert two.remat
    _close(_params(two), plain, rtol=1e-5, atol=1e-6)
    want = _jax(_mlp(jmx), init, batch, 2, remat=True, **opt)
    _close(plain, want)


def test_moe_expert_parallel_matches_single_device():
    vocab, B, T, E = 10, 4, 8, 8
    rng = np.random.RandomState(0)
    batch = {"data": rng.randint(0, vocab, (B, T)).astype(np.float32),
             "softmax_label": rng.randint(0, vocab, (B, T)
                                          ).astype(np.float32)}
    shapes = {k: v.shape for k, v in batch.items()}
    kw = dict(num_layers=1, embed_dim=E, num_heads=2, impl="dense",
              num_experts=4)
    sym = get_transformer_lm(vocab, **kw)
    init = _init(sym, shapes, 5, scale=0.1)
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    want = _jax(jax_lm(vocab, **kw), init, batch, 2, **opt)
    mesh = par.build_mesh({"dp": 2, "ep": 4}, CPU8)
    tr = _port(sym, shapes, init, batch, 2,
               rules=par.ShardingRules(mesh, param_rules=ep_rules()), **opt)
    _close(_params(tr), want)
    # each ep rank stores one expert of each stack
    assert tr._sharded.rank_params[1]["layer0_expert_w1"].shape[0] == 1


def test_three_axis_dp_tp_sp_matches_dense():
    vocab, B, T, E = 12, 4, 16, 8
    rng = np.random.RandomState(5)
    batch = {"data": rng.randint(0, vocab, (B, T)).astype(np.float32),
             "softmax_label": rng.randint(0, vocab, (B, T)
                                          ).astype(np.float32)}
    shapes = {k: v.shape for k, v in batch.items()}
    kw = dict(num_layers=1, embed_dim=E, num_heads=2, impl="dense")
    sym = get_transformer_lm(vocab, **kw)
    init = _init(sym, shapes, 9, scale=0.1)
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.2, "momentum": 0.9})
    want = _jax(jax_lm(vocab, **kw), init, batch, 3, **opt)
    assert tp_rules() == [(pat, tuple(spec))
                          for pat, spec in jax_tp_rules()]
    mesh = par.build_mesh({"dp": 2, "tp": 2, "sp": 2}, CPU8)
    rules = par.ShardingRules(
        mesh, param_rules=tp_rules() + [(r"pos_embed$", P("sp", None))],
        data_axes=("dp",), seq_axes=("sp",))
    tr = _port(sym, shapes, init, batch, 3, rules=rules, **opt)
    sh = tr._sharded
    assert sh.data_specs["data"] == P("dp", "sp")
    # rank (0, 1, 1) stores half the QKV rows, half pos_embed's rows and
    # its [B/dp, T/sp] tile of the batch
    r = sh.layout.moved(0, {"tp": 1, "sp": 1})
    assert tuple(sh.rank_params[r]["layer0_qkv_weight"].shape) == (12, 8)
    assert tuple(sh.rank_params[r]["pos_embed"].shape) == (8, 8)
    _close(_params(tr), want)


# -- ZeRO-1 and FSDP --------------------------------------------------------

@pytest.fixture(scope="module")
def adam_runs():
    """The MLP after 3 Adam steps at dp=8: plain, zero1 and fsdp in the
    port, plain in the JAX package."""
    batch = _mlp_problem()
    shapes = {k: v.shape for k, v in batch.items()}
    sym = _mlp(mx)
    init = _init(sym, shapes, 7)
    opt = dict(optimizer="adam", optimizer_params={"learning_rate": 1e-2})
    runs = {kw: _port(sym, shapes, init, batch, 3, {"dp": 8},
                      **({kw: True} if kw else {}), **opt)
            for kw in ("", "zero1", "fsdp")}
    runs["jax"] = _jax(_mlp(jmx), init, batch, 3, {"dp": 8}, **opt)
    runs["batch"] = batch
    return runs


def test_zero1_optimizer_state_sharding(adam_runs):
    plain, z1 = adam_runs[""], adam_runs["zero1"]
    want, got = _params(plain), _params(z1)
    for n in want:
        assert np.array_equal(got[n], want[n]), n
    _close(got, adam_runs["jax"], rtol=2e-5, atol=2e-6)
    sh = z1._sharded
    numel = sum(int(np.prod(s)) for s in sh.shard_shapes.values())
    assert sh.pad == (-numel) % 8
    for r in range(8):
        pbytes, sbytes = sh.state_bytes(r)
        # the two Adam leaves, 1/8 of the padded buffer each
        assert sbytes * 8 == 2 * 4 * (numel + sh.pad), (r, sbytes)
        assert pbytes == 4 * (numel + sh.pad)
    assert z1.opt_state is None
    blob = z1.get_optimizer_states()
    want_blob = plain.get_optimizer_states()
    for n, leaves in want_blob["opt"].items():
        for a, b in zip(blob["opt"][n], leaves):
            assert np.array_equal(a, b), n


def test_fsdp_param_sharding_matches_dense(adam_runs):
    plain, fs = adam_runs[""], adam_runs["fsdp"]
    want, got = _params(plain), _params(fs)
    for n in want:
        assert np.array_equal(got[n], want[n]), n
    _close(got, adam_runs["jax"], rtol=2e-5, atol=2e-6)
    sh = fs._sharded
    assert sh.specs["fc1_weight"] == P("dp", None)
    assert sh.specs["fc2_bias"] == P()  # 10 does not split over 8
    pbytes, sbytes = sh.state_bytes(0)
    # every param but fc2_bias (10 floats, replicated) is 1/8 per rank;
    # the state follows the parameters
    assert pbytes == 4 * ((sum(int(np.prod(fs.arg_shapes[n]))
                               for n in fs.param_names) - 10) // 8 + 10)
    assert sbytes == 2 * pbytes
    out = fs.forward(adam_runs["batch"])
    assert tuple(out[0].shape) == (16, 10)
    np.testing.assert_allclose(out[0].numpy(),
                               plain.forward(adam_runs["batch"])[0].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_fsdp_all_none_spec_sharded_like_replicated():
    sym = _mlp(mx)
    shapes = {"data": (16, 64), "softmax_label": (16,)}
    mesh = par.build_mesh({"dp": 8}, CPU8)

    class AllNoneRules(par.ShardingRules):
        def param_sharding(self, name, shape):
            return par.NamedSharding(self.mesh, P(*([None] * len(shape))))

    tr = par.ParallelTrainer(sym, shapes, optimizer="sgd", mesh=mesh,
                             rules=AllNoneRules(mesh), fsdp=True,
                             optimizer_params={"learning_rate": 1e-2})
    for n in tr.param_names:
        if any(d % 8 == 0 and d >= 8 for d in tr.arg_shapes[n]):
            assert "dp" in tuple(tr._sharded.specs[n]), n
    tr.init_params()
    tr.step(_mlp_problem())
    w = tr._sharded.rank_params[0]["fc1_weight"]
    assert w.numel() * 8 == 32 * 64


def test_fused_step_adafactor():
    """AdaFactor (per-weight factored moments, so not elementwise): the
    port on one device against the JAX trainer at 2e-5, and under zero1
    and fsdp at dp=8 against it at the JAX test's 2e-3, its factored
    leaves stored as the JAX package shards them."""
    batch = _mlp_problem(13, n=8)
    shapes = {k: v.shape for k, v in batch.items()}
    sym = _mlp(mx)
    init = _init(sym, shapes, 5, scale=0.1)
    opt = dict(optimizer="adafactor", optimizer_params={"wd": 0.01})
    want = _jax(_mlp(jmx), init, batch, 3, **opt)
    one = _port(sym, shapes, init, batch, 3, **opt)
    _close(_params(one), want, rtol=2e-5, atol=2e-6)
    leaves = one.opt_state["fc1_weight"]
    assert sum(x.numel() for x in leaves) == 32 + 64
    for kw in ("zero1", "fsdp"):
        tr = _port(sym, shapes, init, batch, 3, {"dp": 8}, **{kw: True},
                   **opt)
        _close(_params(tr), want, rtol=2e-3, atol=2e-6)
        vr = tr._sharded.pw_state[0]["fc1_weight"][0]
        assert vr.numel() == 32 // 8, (kw, vr.shape)  # dim 0 over dp


def test_sharded_checkpoint_adafactor_fsdp(tmp_path):
    """An fsdp AdaFactor trainer writes its parameters as their shards
    (with their spec), a fresh trainer restores them and continues
    bit for bit, and the JAX package's load_sharded reads the files."""
    batch = _mlp_problem(3)
    shapes = {k: v.shape for k, v in batch.items()}
    sym = _mlp(mx)

    def make():
        return par.ParallelTrainer(
            sym, shapes, optimizer="adafactor",
            mesh=par.build_mesh({"dp": 8}, CPU8), fsdp=True,
            optimizer_params={"learning_rate": 0.02})

    tr = make()
    tr.init_params()
    for _ in range(2):
        tr.step(batch)
    prefix = str(tmp_path / "afck")
    tr.save_sharded_checkpoint(prefix)
    tr.step(batch)
    want = _params(tr)
    tr2 = make()
    tr2.restore_sharded_checkpoint(prefix)
    assert tr2._t == 2
    for a, b in zip(tr._sharded.pw_state[0]["fc1_weight"],
                    tr2._sharded.pw_state[0]["fc1_weight"]):
        assert a.shape == b.shape and a.dtype == b.dtype
    tr2.step(batch)
    _close(_params(tr2), want, rtol=1e-6, atol=1e-7)
    import json
    with open(prefix + "-manifest.json") as f:
        manifest = json.load(f)
    assert manifest["params"]["fc1_weight"]["spec"] == ["dp", None]
    flat, step, _ = jpar.load_sharded(prefix, jpar.build_mesh({"dp": 8}))
    assert step == 2
    again = make()
    again.restore_sharded_checkpoint(prefix)
    for n, v in again.get_params()[0].items():
        np.testing.assert_array_equal(np.asarray(flat[n]), v.numpy())


def _bn_convnet(pkg):
    s = pkg.symbol
    x = s.Convolution(data=s.Variable("data"), name="conv", kernel=(3, 3),
                      num_filter=4, pad=(1, 1))
    x = s.BatchNorm(data=x, name="bn")
    x = s.Activation(data=x, name="relu", act_type="relu")
    x = s.Pooling(data=x, name="pool", kernel=(2, 2), stride=(2, 2),
                  pool_type="max")
    x = s.FullyConnected(data=s.Flatten(data=x, name="flat"), name="fc",
                         num_hidden=5)
    return s.SoftmaxOutput(data=x, name="softmax")


@pytest.mark.parametrize("dp", [2, 4])
def test_grad_accum_on_mesh_splits_global_batch(dp):
    """grad_accum=2 on a dp mesh: microbatch i is the global rows
    [i*B/2, (i+1)*B/2), split over the walks, as the JAX trainer reshapes
    the global batch, so a BatchNorm's statistics, gradients and moving
    averages follow the JAX package's after one and after two steps."""
    rng = np.random.RandomState(3)
    # rows differ by half: a split by walk would see other statistics
    x = rng.randn(16, 3, 6, 6).astype(np.float32)
    x[8:] = x[8:] * 3.0 + 2.0
    batch = {"data": x, "softmax_label":
             rng.randint(0, 5, (16,)).astype(np.float32)}
    shapes = {k: v.shape for k, v in batch.items()}
    sym = _bn_convnet(mx)
    init = _init(sym, shapes, 4, scale=0.3)
    opt = dict(optimizer="sgd", grad_accum=2,
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    tr = par.ParallelTrainer(sym, shapes, mesh=par.build_mesh(
        {"dp": dp}, ["cpu"] * dp), **opt)
    tr.init_params({k: v.copy() for k, v in init.items()})
    jtr = jpar.ParallelTrainer(_bn_convnet(jmx), shapes,
                               mesh=jpar.build_mesh({"dp": dp}), **opt)
    jtr.init_params({k: jmx.nd.array(v.copy()) for k, v in init.items()})
    for step in range(2):
        out = tr.step(batch)[0].numpy()
        jout = np.asarray(jtr.step(batch)[0])
        np.testing.assert_allclose(out, jout, **TOL)
        args, aux = tr.get_params()
        jargs, jaux = jtr.get_params()
        for n, v in jargs.items():
            want = v.asnumpy()
            err = np.linalg.norm(args[n].numpy() - want)
            assert err <= TOL["rtol"] * np.linalg.norm(want) \
                + TOL["atol"], (step, n, err)
        for n, v in jaux.items():
            np.testing.assert_allclose(aux[n].numpy(), v.asnumpy(),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg="%d %s" % (step, n))


@pytest.mark.parametrize("mesh_axes", [None, {"dp": 2}])
def test_remat_with_dropout_equals_plain_bitwise(mesh_axes):
    """remat over a graph that draws: the recompute takes the forward's
    draws (``DrawTape``), so two steps equal two plain steps bit for bit,
    on one device and on a dp=2 mesh."""
    vocab = 13
    rng = np.random.RandomState(6)
    batch = {"data": rng.randint(0, vocab, (4, 8)).astype(np.float32),
             "softmax_label": rng.randint(0, vocab, (4, 8)
                                          ).astype(np.float32)}
    shapes = {k: v.shape for k, v in batch.items()}
    sym = get_transformer_lm(vocab, num_layers=1, embed_dim=16,
                             num_heads=2, impl="dense", dropout=0.3)
    init = _init(sym, shapes, 2)
    kw = {} if mesh_axes is None else dict(
        mesh=par.build_mesh(mesh_axes, ["cpu"] * 2))
    got = [_params(_port(sym, shapes, init, batch, 2, remat=r, seed=7,
                         optimizer="sgd", **kw)) for r in (False, True)]
    for n, v in got[0].items():
        assert np.array_equal(got[1][n], v), n
