"""The PyTorch port's training slice against the JAX package's.

Ops (``MultiHeadAttention``'s full-sequence forward through flash and
dense attention, ``SoftmaxOutput``'s loss gradient), the graph
(``FusionPlan``'s chains, ``integer_semantic_inputs``), the optimizer,
schedulers and initializer, and the slice as a whole: a 2-layer LM with
weights carried across from one numpy seed takes the same SGD-momentum
steps in ``mxnet_tpu.parallel.ParallelTrainer`` (one-device mesh, the
Pallas ``flash_attention`` and — with ``MXNET_PALLAS_FUSION=1`` —
``fused_linear`` kernels under the interpreter) and in the port's
``ParallelTrainer`` on the CPU (the plain versions of its CUDA kernels).

Tolerances (f32 on both sides; the two sum in other orders): ops at
rtol/atol 1e-5; the trained parameters after 3 steps at rtol 2e-4, atol
2e-5, the tolerance ``tests/test_parallel.py`` holds its trainers to.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jax_lrs
from mxnet_tpu import optimizer as jax_opt
from mxnet_tpu import parallel as jax_par
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.ops import registry as jax_reg
from mxnet_tpu.ops.fusion import FusionPlan as JaxFusionPlan
from mxnet_tpu.parallel.graph import integer_semantic_inputs as jax_isi

from mxnet_tpu_torch import initializer as T_init
from mxnet_tpu_torch import lr_scheduler as T_lrs
from mxnet_tpu_torch import optimizer as T_opt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.model import params_from_numpy
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.ops import fusion
from mxnet_tpu_torch.ops import registry as reg
from mxnet_tpu_torch.parallel import (ParallelTrainer, integer_semantic_inputs,
                                      make_graph_fn)

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# -- ops --------------------------------------------------------------------

MHA_CASES = [  # (impl, num_kv_heads, rope, window, causal)
    ("flash", 0, False, 0, True),
    ("flash", 2, True, 0, True),
    ("flash", 2, False, 5, True),
    ("flash", 0, False, 0, False),
    ("dense", 0, False, 0, True),
    ("dense", 2, True, 5, True),
    ("dense", 0, False, 0, False),
]


@pytest.mark.parametrize("impl,kv,rope,window,causal", MHA_CASES)
def test_multihead_attention_matches_jax(impl, kv, rope, window, causal):
    """The op's forward and the gradients of sum(out * g) with respect to
    the data and all four weights."""
    b, t, e, h = 2, 24, 32, 4
    kvh = kv or h
    f = e + 2 * kvh * (e // h)
    rng = np.random.RandomState(len(impl) + 3 * kv + window)
    ins = [rng.randn(b, t, e).astype(np.float32),
           (rng.randn(f, e) / np.sqrt(e)).astype(np.float32),
           rng.randn(f).astype(np.float32) * 0.1,
           (rng.randn(e, e) / np.sqrt(e)).astype(np.float32),
           rng.randn(e).astype(np.float32) * 0.1]
    g = rng.randn(b, t, e).astype(np.float32)
    kw = dict(num_heads=h, num_kv_heads=kv, impl=impl, rope=rope,
              window=window, causal=causal)
    jspec = jax_reg.get("MultiHeadAttention")
    jp = jspec.parse_params(kw)

    def jax_loss(*xs):
        out = jspec.forward(jp, list(xs), [], False, None)[0][0]
        return jnp.sum(out * g), out

    (_, out_j), grads_j = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(
        *[jnp.asarray(a) for a in ins])
    spec = reg.get("MultiHeadAttention")
    tins = [_t(a, True) for a in ins]
    out_t = spec.forward(spec.parse_params(kw), tins, [], False, None)[0][0]
    (out_t * _t(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    for i, (a, gj) in enumerate(zip(tins, grads_j)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj),
                                   err_msg="input %d" % i, **TOL)


def test_multihead_attention_ring_impls_raise():
    """The ring impls need the ranks of a mesh axis: outside
    SequenceParallelTrainer's walk they raise; blockwise runs on one
    device."""
    spec = reg.get("MultiHeadAttention")
    x = torch.zeros(1, 4, 8)
    ins = [x, torch.zeros(24, 8), torch.zeros(24), torch.zeros(8, 8),
           torch.zeros(8)]
    for impl in ("ring", "ring_striped"):
        with pytest.raises(MXNetError, match="ring.*SequenceParallelTrainer"):
            spec.forward(spec.parse_params(dict(num_heads=2, impl=impl)),
                         ins, [], False, None)
    out = spec.forward(spec.parse_params(dict(num_heads=2, impl="blockwise")),
                       ins, [], False, None)[0][0]
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_multihead_attention_dropout_uses_the_generator():
    spec = reg.get("MultiHeadAttention")
    p = spec.parse_params(dict(num_heads=2, dropout=0.5))
    rng = np.random.RandomState(0)
    ins = [_t(rng.randn(1, 6, 8).astype(np.float32)),
           _t(rng.randn(24, 8).astype(np.float32)), torch.zeros(24),
           _t(rng.randn(8, 8).astype(np.float32)), torch.zeros(8)]
    outs = [spec.forward(p, ins, [], True,
                         torch.Generator().manual_seed(s))[0][0]
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    assert (outs[0] == 0).any()
    evaluated = spec.forward(p, ins, [], False, None)[0][0]
    kept = outs[0] != 0
    np.testing.assert_allclose(outs[0][kept].numpy(),
                               (evaluated * 2)[kept].numpy(), **TOL)


SOFTMAX_CASES = [  # (multi_output, use_ignore, grad_scale)
    (True, False, 1.0),
    (True, True, 1.0),
    (False, False, 0.5),
    (False, True, 2.0),
]


@pytest.mark.parametrize("multi,use_ignore,scale", SOFTMAX_CASES)
def test_softmax_output_matches_jax(multi, use_ignore, scale):
    """Softmax forward; the data gradient (p - onehot) * grad_scale,
    masked at ignore_label, whatever the head gradient (here random)."""
    rng = np.random.RandomState(int(multi) + 2 * int(use_ignore))
    shape, lshape = ((3, 7, 5), (3, 5)) if multi else ((6, 7), (6,))
    data = rng.randn(*shape).astype(np.float32)
    label = rng.randint(0, 7, lshape).astype(np.float32)
    label.flat[1] = 2.0  # the ignored class appears
    head = rng.randn(*shape).astype(np.float32)
    kw = dict(multi_output=multi, use_ignore=use_ignore, grad_scale=scale,
              ignore_label=2)
    jspec = jax_reg.get("SoftmaxOutput")
    jp = jspec.parse_params(kw)
    out_j, vjp = jax.vjp(
        lambda d: jspec.forward(jp, [d, jnp.asarray(label)], [], True,
                                None)[0][0], jnp.asarray(data))
    (grad_j,) = vjp(jnp.asarray(head))
    spec = reg.get("SoftmaxOutput")
    d = _t(data, True)
    out_t = spec.forward(spec.parse_params(kw), [d, _t(label)], [], True,
                         None)[0][0]
    out_t.backward(_t(head))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(grad_j), **TOL)


def test_lm_graph_ops_differentiate_like_jax():
    """The rest of the LM graph's ops (Embedding, PositionalEmbedding,
    _Plus, SwapAxis, Reshape, BlockGrad): gradients of one walk of a
    small graph through them, against jax.grad of the JAX walk."""
    import mxnet_tpu_torch.symbol as S
    rng = np.random.RandomState(0)
    V, E, B, T = 11, 6, 2, 5

    def build(sym):
        data = sym.Variable("data")
        x = sym.Embedding(data=data, input_dim=V, output_dim=E, name="emb")
        x = sym.PositionalEmbedding(data=x, pos=sym.Variable("pos_embed"),
                                    name="pos")
        x = x + sym.BlockGrad(x, name="bg")
        x = sym.SwapAxis(x, dim1=1, dim2=2, name="sw")
        return sym.Reshape(x, shape=(-1, T), name="rs")

    tsym = build(S)
    jsym = build(mx.sym)
    tokens = rng.randint(0, V, (B, T)).astype(np.int32)
    weights = {"emb_weight": rng.randn(V, E).astype(np.float32),
               "pos_embed": rng.randn(T, E).astype(np.float32)}
    g = rng.randn(B * E, T).astype(np.float32)
    names = jsym.list_arguments()
    assert names == tsym.list_arguments()
    jfn = jax_par.make_graph_fn(jsym)

    def jloss(w):
        vals = [jnp.asarray(tokens) if n == "data" else w[n] for n in names]
        return jnp.sum(jfn(vals, [], True, jax.random.PRNGKey(0))[0][0] * g)

    gj = jax.grad(jloss)({k: jnp.asarray(v) for k, v in weights.items()})
    tw = {k: _t(v, True) for k, v in weights.items()}
    vals = [_t(tokens) if n == "data" else tw[n] for n in names]
    out = make_graph_fn(tsym)(vals, [], True, None)[0][0]
    (out * _t(g)).sum().backward()
    for k in weights:
        np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(gj[k]),
                                   err_msg=k, **TOL)


# -- the graph --------------------------------------------------------------

@pytest.mark.parametrize("layout", ["reference", "flat"])
def test_fusion_plan_and_integer_inputs_match_jax(layout):
    kw = dict(num_layers=3, embed_dim=16, num_heads=2, loss_layout=layout)
    tsym, jsym = get_transformer_lm(50, **kw), jax_lm(50, **kw)
    tp = fusion.FusionPlan(tsym._topo(), tsym._heads)
    jp = JaxFusionPlan(jsym._topo(), jsym._heads)

    def chains(plan, topo):
        by_id = {id(n): n for n in topo}
        return sorted((kind, tuple(n.name for n in nodes))
                      for last, (kind, nodes) in plan.chains.items()
                      if by_id[last] is nodes[-1])

    got = chains(tp, tsym._topo())
    assert got == chains(jp, jsym._topo())
    assert [c[1] for c in got] == [("layer%d_ffn1" % i, "layer%d_ffn_relu" % i)
                                   for i in range(3)]
    assert integer_semantic_inputs(tsym) == jax_isi(jsym) \
        == {"data", "softmax_label"}


def test_fusion_skips_a_head_and_a_shared_output():
    """An fc whose output is a head, or feeds two consumers, is not fused."""
    import mxnet_tpu_torch.symbol as S
    x = S.Variable("x")
    fc = S.FullyConnected(x, num_hidden=4, name="fc")
    a = S.Activation(fc, act_type="relu", name="a")
    two = S.Activation(fc, act_type="tanh", name="b") + a
    plan = fusion.FusionPlan(two._topo(), two._heads)
    assert not plan.chains
    grp = S.Symbol(a._heads + fc._heads)
    assert not fusion.FusionPlan(grp._topo(), grp._heads).chains


# -- optimizer, schedulers, initializer --------------------------------------

@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.1, momentum=0.9),
    dict(learning_rate=0.05, momentum=0.0, wd=0.01),
    dict(learning_rate=0.1, momentum=0.9, wd=0.001, clip_gradient=0.3,
         rescale_grad=0.5),
])
def test_sgd_update_matches_jax(kw):
    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 4).astype(np.float32)
    jo, to = jax_opt.create("sgd", **kw), T_opt.create("sgd", **kw)
    jw, tw = mx.nd.array(w0), _t(w0)
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for _ in range(3):
        g = rng.randn(5, 4).astype(np.float32)
        jo.update(0, jw, mx.nd.array(g), js)
        to.update(0, tw, _t(g), ts)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), **TOL)
    assert isinstance(T_opt.create("ccsgd"), T_opt.SGD)
    with pytest.raises(ValueError):
        T_opt.create("lamb")


def test_lr_schedulers_match_jax():
    pairs = [(T_lrs.FactorScheduler(3, 0.5), jax_lrs.FactorScheduler(3, 0.5)),
             (T_lrs.MultiFactorScheduler([2, 5, 9], 0.1),
              jax_lrs.MultiFactorScheduler([2, 5, 9], 0.1))]
    for ts, js in pairs:
        ts.base_lr = js.base_lr = 0.2
        assert [ts(i) for i in range(1, 14)] == [js(i) for i in range(1, 14)]


def test_initializer_name_dispatch():
    gen = torch.Generator().manual_seed(0)
    init = T_init.Uniform(0.05)
    fills = {"fc_bias": 0.0, "ln_gamma": 1.0, "ln_beta": 0.0,
             "bn_moving_mean": 0.0, "bn_moving_var": 1.0}
    for name, val in fills.items():
        t = torch.full((3, 4), 7.0)
        init(name, t, gen)
        assert torch.all(t == val), name
    for name in ("fc_weight", "pos_embed", "moe_expert_w1"):
        t = torch.zeros(4, 5, 6)
        init(name, t, gen)
        assert t.abs().max() <= 0.05 and t.std() > 0.01, name
    with pytest.raises(ValueError):
        init("mystery", torch.zeros(2), gen)
    a, b = torch.zeros(3, 3), torch.zeros(3, 3)
    T_init.Normal(0.1)("w_weight", a, torch.Generator().manual_seed(4))
    T_init.Normal(0.1)("w_weight", b, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.std() > 0.01
    x = torch.zeros(64, 32)
    T_init.Xavier()("fc_weight", x, gen)
    assert x.abs().max() <= np.sqrt(3.0 / 48) and x.abs().max() > 0.2


# -- the slice as a whole ----------------------------------------------------

VOCAB, B, T = 64, 2, 32
LM = dict(num_layers=2, embed_dim=32, num_heads=4)
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _setup(lm_kw, seed=0):
    jsym = jax_lm(VOCAB, **lm_kw)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    arg_shapes, _, _ = jsym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    init = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(jsym.list_arguments(), arg_shapes)
            if n not in shapes}
    rs = np.random.RandomState(seed + 1)
    batches = [{"data": rs.randint(0, VOCAB, (B, T)).astype(np.int32),
                "softmax_label": rs.randint(0, VOCAB, (B, T)).astype(np.int32)}
               for _ in range(3)]
    return jsym, shapes, init, batches


def _jax_trained(lm_kw, trainer_kw=None):
    """3 steps of the JAX trainer, fused_linear enabled on the CPU."""
    jsym, shapes, init, batches = _setup(lm_kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_PALLAS_FUSION", "1")
        tr = jax_par.ParallelTrainer(
            jsym, shapes, optimizer="sgd", mesh=jax_par.data_parallel_mesh(1),
            optimizer_params=dict(SGD), **(trainer_kw or {}))
        tr.init_params({k: mx.nd.array(v) for k, v in init.items()})
        for bt in batches:
            tr.step(bt)
        got, _ = tr.get_params()
    return {k: v.asnumpy() for k, v in got.items()}


def _port_trained(lm_kw, trainer_kw=None, **kw):
    _, shapes, init, batches = _setup(lm_kw)
    sym = get_transformer_lm(VOCAB, **lm_kw)
    tr = ParallelTrainer(sym, shapes, optimizer="sgd",
                         optimizer_params=dict(SGD), device="cpu",
                         **(trainer_kw or {}), **kw)
    # the weights go across as params_from_numpy places them
    tr.init_params(params_from_numpy(init, "cpu", symbol=sym,
                                     input_shapes=shapes))
    losses = []
    for bt in batches:
        p = tr.step(bt)[0].float()
        lab = torch.as_tensor(bt["softmax_label"]).long()
        losses.append(-torch.log(p.gather(1, lab[:, None, :])).mean().item())
    got, _ = tr.get_params()
    return {k: v.numpy() for k, v in got.items()}, losses, init


@pytest.fixture(scope="module")
def jax_base():
    return _jax_trained(LM)


def _assert_params(got, want, init):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **PARAM_TOL)
        assert not np.allclose(got[n], init[n]) or n.endswith("_beta"), n


def test_trainer_matches_jax_f32(jax_base):
    got, losses, init = _port_trained(LM)
    _assert_params(got, jax_base, init)


def test_trainer_matches_jax_gqa_rope_window():
    lm_kw = dict(LM, num_kv_heads=2, pos_encoding="rope", window=9)
    got, _, init = _port_trained(lm_kw)
    _assert_params(got, _jax_trained(lm_kw), init)


def test_trainer_matches_jax_grad_accum_and_clip():
    tkw = dict(grad_accum=2, clip_grad_norm=0.5)
    got, _, init = _port_trained(LM, tkw)
    _assert_params(got, _jax_trained(LM, tkw), init)


def test_trainer_bf16_loss_falls():
    """bf16 compute, f32 master weights: the loss on a repeated batch
    falls, the parameters stay f32, and the token ids are not cast."""
    _, shapes, init, batches = _setup(LM)
    tr = ParallelTrainer(get_transformer_lm(VOCAB, **LM), shapes,
                         optimizer_params={"learning_rate": 0.03,
                                           "momentum": 0.9},
                         compute_dtype="bfloat16", device="cpu", seed=3)
    assert tr._no_cast == {"data", "softmax_label"}
    tr.init_params()
    lab = torch.as_tensor(batches[0]["softmax_label"]).long()
    losses = []
    for _ in range(6):
        p = tr.step(batches[0])[0]
        assert p.dtype == torch.bfloat16
        losses.append(-torch.log(p.float().gather(1, lab[:, None, :])
                                 ).mean().item())
    assert losses[-1] < losses[0] - 0.05, losses
    assert all(v.dtype == torch.float32 for v in tr.params.values())


def test_trainer_forward_and_set_params(jax_base):
    _, shapes, init, batches = _setup(LM)
    tr = ParallelTrainer(get_transformer_lm(VOCAB, **LM), shapes,
                         device="cpu")
    tr.set_params({k: torch.from_numpy(v) for k, v in jax_base.items()})
    out = tr.forward(batches[0])[0]
    assert out.shape == (B, VOCAB, T)
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, rtol=1e-5)
    got, _ = tr.get_params()
    got["embed_weight"] += 1.0  # a copy: the trainer keeps its own
    assert not np.allclose(tr.params["embed_weight"].numpy(),
                           got["embed_weight"].numpy())


def test_trainer_default_init_is_seeded():
    _, shapes, _, batches = _setup(LM)
    sym = get_transformer_lm(VOCAB, **LM)
    a, b = (ParallelTrainer(sym, shapes, device="cpu", seed=7).init_params()
            for _ in range(2))
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    w = a.params["layer0_ffn1_weight"]
    assert w.abs().max() <= 0.01 and w.std() > 0.001  # Uniform(0.01)
    assert torch.all(a.params["layer0_ffn1_bias"] == 0)


def test_trainer_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is cuda:0")
    _, shapes, _, _ = _setup(LM)
    with pytest.raises(MXNetError, match="CUDA"):
        ParallelTrainer(get_transformer_lm(VOCAB, **LM), shapes)


def test_trainer_later_slices_raise():
    """The mesh parameters, which raised "later slice" before the port had
    them: zero1 and fsdp need a ``dp`` axis (the JAX errors); a two-rank
    mesh, its rules, zero1, fsdp and remat each take one step equal to the
    one-device step."""
    from mxnet_tpu_torch.parallel import ShardingRules, build_mesh
    _, shapes, init, batches = _setup(LM)
    sym = get_transformer_lm(VOCAB, **LM)
    for kw in (dict(zero1=True), dict(fsdp=True)):
        with pytest.raises(MXNetError, match="needs a 'dp' mesh axis"):
            ParallelTrainer(sym, shapes, device="cpu",
                            mesh=build_mesh({"tp": 1}, ["cpu"]), **kw)

    def one_step(**kw):
        tr = ParallelTrainer(sym, shapes, optimizer="sgd",
                             optimizer_params=dict(SGD), **kw)
        tr.init_params({k: v.copy() for k, v in init.items()})
        tr.step(batches[0])
        return tr.get_params()[0]

    want = one_step(device="cpu")
    mesh = build_mesh({"dp": 2}, ["cpu"] * 2)
    for kw in (dict(mesh=mesh), dict(rules=ShardingRules(mesh)),
               dict(mesh=mesh, zero1=True), dict(mesh=mesh, fsdp=True),
               dict(device="cpu", remat=True)):
        got = one_step(**kw)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], err_msg=n,
                                       **PARAM_TOL)
    with pytest.raises(MXNetError):
        ParallelTrainer(sym, shapes, device="cpu", grad_accum=3)
