"""The PyTorch port's conv-net ops, kernels and fusion against the JAX
package's.

Inputs come from a numpy seed and go through the JAX function and its
counterpart in the port on the CPU, where the port's kernel wrappers take
their plain versions:

* ops: ``Convolution`` (groups, dilation, stride, bias), ``Pooling``
  (max/avg/sum, pad, ceil-mode edge windows, global), ``BatchNorm`` (train
  and eval, every ``MXNET_BN_STATS`` mode, its hand-derived backward with
  the mean/var cotangents), ``Flatten``, ``SpaceToDepth``, ``Crop``:
  forward and gradients at rtol/atol 1e-5 (f32 on both sides, sums in
  other orders);
* kernels: ``matmul_stats`` (y, s1, s2 and its gradient) and
  ``fused_conv_bn_act`` against the Pallas kernels under the interpreter,
  at ``tests/test_fusion.py``'s tolerances (rtol/atol 1e-4 for the sums
  and gradients, 1e-5 for y);
* fusion: the conv -> BatchNorm [-> relu] chains of ``FusionPlan`` through
  the port's ``eval_graph`` against the JAX walk with
  ``MXNET_PALLAS_FUSION=1``, with ``MXNET_PALLAS_CONVBN_TRAIN`` set and
  unset: outputs, every gradient and the BatchNorm aux updates, at
  ``test_fusion.py``'s tolerances (outputs and aux rtol 1e-4 atol 1e-5,
  gradients rtol 1e-3 atol 1e-4), and the chain gating.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import nn as jax_nn
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops import registry as jax_reg
from mxnet_tpu.ops.fusion import FusionPlan as JaxFusionPlan
from mxnet_tpu.ops.fusion import eval_graph as jax_eval_graph

import mxnet_tpu_torch.symbol as S
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops import nn as T_nn
from mxnet_tpu_torch.ops import registry as reg
from mxnet_tpu_torch.ops.fusion import FusionPlan, eval_graph

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _op_vs_jax(op, kw, ins, aux=(), is_train=False, grad_inputs=()):
    """The op's forward and aux in both packages; with ``grad_inputs``
    also the gradients of sum(out * g) with respect to those inputs."""
    rng = np.random.RandomState(17)
    jspec, tspec = jax_reg.get(op), reg.get(op)
    jp, tp = jspec.parse_params(kw), tspec.parse_params(kw)
    jaux = [jnp.asarray(a) for a in aux]

    def jfwd(*xs):
        outs, new_aux = jspec.forward(jp, list(xs), jaux, is_train,
                                      jax.random.PRNGKey(0))
        return outs[0], new_aux

    out_j, aux_j = jfwd(*[jnp.asarray(a) for a in ins])
    tins = [_t(a, i in grad_inputs) for i, a in enumerate(ins)]
    outs_t, aux_t = tspec.forward(tp, tins, [_t(a) for a in aux], is_train,
                                  None)
    assert tuple(outs_t[0].shape) == out_j.shape
    np.testing.assert_allclose(outs_t[0].detach().numpy(),
                               np.asarray(out_j), **TOL)
    for a, b in zip(aux_t, aux_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    if grad_inputs:
        g = rng.randn(*out_j.shape).astype(np.float32)
        grads_j = jax.grad(
            lambda *xs: jnp.sum(jfwd(*xs)[0] * g),
            argnums=tuple(grad_inputs))(*[jnp.asarray(a) for a in ins])
        (outs_t[0] * _t(g)).sum().backward()
        for i, gj in zip(grad_inputs, grads_j):
            # an input the op does not use (fix_gamma's gamma) gets none
            got = tins[i].grad
            got = np.zeros(gj.shape, np.float32) if got is None \
                else got.numpy()
            np.testing.assert_allclose(got, np.asarray(gj),
                                       err_msg="input %d" % i, **TOL)


# -- ops --------------------------------------------------------------------

CONV_CASES = [  # (kernel, stride, pad, dilate, groups, bias)
    ((3, 3), (1, 1), (1, 1), (1, 1), 1, True),
    ((3, 2), (2, 1), (1, 2), (2, 1), 2, True),
    ((1, 1), (2, 2), (0, 0), (1, 1), 1, False),
    ((7, 7), (2, 2), (3, 3), (1, 1), 1, False),
    ((3, 3), (1, 1), (2, 2), (2, 2), 3, False),
]


@pytest.mark.parametrize("kernel,stride,pad,dilate,groups,bias", CONV_CASES)
def test_convolution_matches_jax(kernel, stride, pad, dilate, groups, bias):
    rng = np.random.RandomState(sum(kernel) + 3 * groups)
    c, nf = 6, 12
    x = rng.randn(2, c, 13, 11).astype(np.float32)
    w = (rng.randn(nf, c // groups, *kernel) * 0.3).astype(np.float32)
    ins = [x, w] + ([rng.randn(nf).astype(np.float32)] if bias else [])
    kw = dict(kernel=kernel, num_filter=nf, stride=stride, pad=pad,
              dilate=dilate, num_group=groups, no_bias=not bias)
    _op_vs_jax("Convolution", kw, ins, grad_inputs=tuple(range(len(ins))))
    shapes = dict(data=x.shape)
    got = S.Convolution(S.Variable("data"), name="c", **kw).infer_shape(
        **shapes)
    want = mx.symbol.Convolution(mx.symbol.Variable("data"), name="c",
                                 **kw).infer_shape(**shapes)
    assert got == tuple(want)


POOL_CASES = [  # (pool_type, kernel, stride, pad, global_pool, hw)
    ("max", (3, 3), (2, 2), (0, 0), False, (112, 112)),  # ResNet's stem pool
    ("max", (3, 3), (2, 2), (1, 1), False, (9, 11)),
    ("avg", (3, 2), (2, 3), (1, 1), False, (9, 11)),     # ceil-mode edges
    ("sum", (2, 2), (2, 2), (1, 0), False, (9, 11)),
    ("avg", (4, 4), (1, 1), (0, 0), False, (4, 4)),
    ("avg", (1, 1), (1, 1), (0, 0), True, (7, 5)),
    ("max", (1, 1), (1, 1), (0, 0), True, (7, 5)),
]


@pytest.mark.parametrize("kind,kernel,stride,pad,glob,hw", POOL_CASES)
def test_pooling_matches_jax(kind, kernel, stride, pad, glob, hw):
    x = np.random.RandomState(len(kind) + sum(kernel)).randn(
        2, 3, *hw).astype(np.float32)
    kw = dict(pool_type=kind, kernel=kernel, stride=stride, pad=pad,
              global_pool=glob)
    _op_vs_jax("Pooling", kw, [x], grad_inputs=(0,))
    got = S.Pooling(S.Variable("data"), name="p", **kw).infer_shape(
        data=x.shape)
    want = mx.symbol.Pooling(mx.symbol.Variable("data"), name="p",
                             **kw).infer_shape(data=x.shape)
    assert got == tuple(want)


def _bn_inputs(seed, shape=(4, 6, 5, 3)):
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = (rng.randn(*shape) * 2 + rng.randn(1, c, *([1] * (len(shape) - 2)))
         ).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    aux = [rng.randn(c).astype(np.float32),
           (rng.rand(c) + 0.5).astype(np.float32)]
    return x, gamma, beta, aux


@pytest.mark.parametrize("mode", ["auto", "centered", "welford",
                                  "onepass_unsafe"])
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_matches_jax(mode, is_train, fix_gamma, monkeypatch):
    monkeypatch.setenv("MXNET_BN_STATS", mode)
    x, gamma, beta, aux = _bn_inputs(len(mode) + 2 * is_train + fix_gamma)
    _op_vs_jax("BatchNorm", dict(fix_gamma=fix_gamma, eps=1e-3,
                                 momentum=0.9), [x, gamma, beta], aux,
               is_train, grad_inputs=(0, 1, 2))


@pytest.mark.parametrize("mode", ["auto", "centered", "welford"])
@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (8, 5)])
def test_batchnorm_train_backward_with_stat_cotangents(mode, shape,
                                                       monkeypatch):
    """The autograd.Function against the JAX custom VJP, with cotangents
    on all three outputs (out, mean, var): the g_mean/g_var terms."""
    monkeypatch.setenv("MXNET_BN_STATS", mode)
    x, gamma, beta, _ = _bn_inputs(3 + len(shape), shape)
    rng = np.random.RandomState(4)
    co = rng.randn(*shape).astype(np.float32)
    c1, c2 = rng.randn(2, shape[1]).astype(np.float32)

    def jloss(*a):
        out, mean, var = jax_nn._bn_train(*a, 2e-5)
        return jnp.sum(out * co) + jnp.sum(mean * c1) + jnp.sum(var * c2)

    ja = [jnp.asarray(v) for v in (x, gamma, beta)]
    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*ja)
    ta = [_t(v, True) for v in (x, gamma, beta)]
    out, mean, var = T_nn._BNTrain.apply(*ta, 2e-5)
    lt = (out * _t(co)).sum() + (mean * _t(c1)).sum() + (var * _t(c2)).sum()
    lt.backward()
    # a sum of ~100 terms of either sign: an absolute tolerance
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5, atol=1e-4)
    for a, b, what in zip(ta, gj, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=what, **TOL)


def test_bn_stats_mode_rejects_a_typo(monkeypatch):
    monkeypatch.setenv("MXNET_BN_STATS", "centred")
    with pytest.raises(MXNetError, match="MXNET_BN_STATS"):
        T_nn._BN_STATS_MODE()


@pytest.mark.parametrize("op,kw,shapes", [
    ("Flatten", {}, [(2, 3, 4, 5)]),
    ("SpaceToDepth", dict(block_size=2), [(2, 3, 8, 6)]),
    ("SpaceToDepth", dict(block_size=3), [(1, 2, 6, 9)]),
    ("Crop", dict(h_w=(5, 4), offset=(1, 2)), [(2, 3, 9, 7)]),
    ("Crop", dict(h_w=(5, 4), center_crop=True), [(2, 3, 9, 7)]),
    ("Crop", dict(num_args=2), [(2, 3, 9, 7), (2, 1, 6, 3)]),
])
def test_structural_ops_match_jax(op, kw, shapes):
    rng = np.random.RandomState(len(op))
    ins = [rng.randn(*s).astype(np.float32) for s in shapes]
    _op_vs_jax(op, kw, ins, grad_inputs=(0,))


# -- kernels: plain versions against the Pallas kernels ------------------------

@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (130, 70, 36)])
def test_matmul_stats_matches_pallas(m, k, n):
    """y, s1, s2, and the gradient with cotangents on all three (the
    statistics' cotangents fold into the output's)."""
    rng = np.random.RandomState(0)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)      # JAX's [K, N]
    co = rng.randn(m, n).astype(np.float32)
    c1, c2 = rng.randn(2, n).astype(np.float32)

    def jloss(x_, w_):
        y_, a_, b_ = pk.matmul_stats(x_, w_, interpret=True)
        return jnp.sum(y_ * co) + jnp.sum(a_ * c1) + jnp.sum(b_ * c2), \
            (y_, a_, b_)

    (_, want), gj = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w.T.copy(), True)  # the port's [N, K]
    got = K.matmul_stats(tx, tw)
    for a, b, what, tol in zip(got, want, ("y", "s1", "s2"),
                               (TOL, dict(rtol=1e-4, atol=1e-4),
                                dict(rtol=1e-4, atol=1e-4))):
        assert a.dtype == (torch.float32)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=what, **tol)
    ((got[0] * _t(co)).sum() + (got[1] * _t(c1)).sum()
     + (got[2] * _t(c2)).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gj[0]),
                               rtol=1e-4, atol=1e-4, err_msg="dx")
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(gj[1]),
                               rtol=1e-4, atol=1e-4, err_msg="dw")


def test_matmul_stats_plain_takes_sums_before_the_cast():
    """bf16 y, f32 statistics of the f32 product (not of the rounded y)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(50, 24).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(8, 24).astype(np.float32)).bfloat16()
    y, s1, s2 = K.matmul_stats_fwd(x, w)
    acc = x.double() @ w.double().t()
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    torch.testing.assert_close(s1.double(), acc.sum(0), rtol=1e-6,
                               atol=1e-4)
    torch.testing.assert_close(s2.double(), acc.square().sum(0), rtol=1e-6,
                               atol=1e-4)
    assert not torch.equal(s2, y.float().square().sum(0))


CBA_CASES = [  # (kernel, stride, pad, dilate, act)
    ((3, 3), (1, 1), (1, 1), (1, 1), "relu"),
    ((7, 7), (2, 2), (3, 3), (1, 1), "relu"),
    ((1, 1), (1, 1), (0, 0), (1, 1), "linear"),
    ((1, 1), (2, 2), (0, 0), (1, 1), "linear"),
    ((3, 3), (1, 1), (2, 2), (2, 2), "relu"),
    ((3, 2), (2, 1), (1, 2), (2, 1), "linear"),
]


@pytest.mark.parametrize("kernel,stride,pad,dilate,act", CBA_CASES)
def test_fused_conv_bn_act_matches_pallas(kernel, stride, pad, dilate, act):
    rng = np.random.RandomState(sum(kernel) + sum(stride))
    c, nf = 5, 9
    x = rng.randn(2, c, 12, 10).astype(np.float32)
    w = (rng.randn(nf, c, *kernel) * 0.3).astype(np.float32)
    scale = (rng.rand(nf) + 0.5).astype(np.float32)
    bias = rng.randn(nf).astype(np.float32)
    kw = dict(stride=stride, pad=pad, dilate=dilate, act=act)
    want = pk.fused_conv_bn_act(*map(jnp.asarray, (x, w, scale, bias)),
                                interpret=True, **kw)
    got = K.fused_conv_bn_act(*map(_t, (x, w, scale, bias)), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the card's path: the patches and the weight in their column order
    # through the GEMM's plain version give the same function, from an
    # NCHW and from a channels-last x
    for xt in (_t(x), _t(x).contiguous(memory_format=torch.channels_last)):
        xm, wm, oh, ow = K._im2col(xt, _t(w), stride, pad, dilate)
        via = K.fused_linear_plain(xm, wm, _t(bias), act, _t(scale))
        via = via.reshape(2, oh, ow, nf).permute(0, 3, 1, 2)
        np.testing.assert_allclose(via.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_fused_conv_bn_act_refuses_gradients():
    x = torch.zeros(1, 2, 4, 4, requires_grad=True)
    with pytest.raises(MXNetError, match="inference"):
        K.fused_conv_bn_act(x, torch.zeros(3, 2, 1, 1), torch.ones(3),
                            torch.zeros(3))


# -- fusion: the conv chains through the graph walk ----------------------------

def _convnet(sym):
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, name="c1", kernel=(3, 3), num_filter=8,
                         pad=(1, 1))
    b1 = sym.BatchNorm(data=c1, name="bn1")
    a1 = sym.Activation(data=b1, name="r1", act_type="relu")
    c2 = sym.Convolution(data=a1, name="c2", kernel=(3, 3), num_filter=8,
                         stride=(2, 2), pad=(1, 1))
    b2 = sym.BatchNorm(data=c2, name="bn2")
    p = sym.Pooling(data=b2, name="pool", kernel=(4, 4), pool_type="avg",
                    global_pool=True)
    fc = sym.FullyConnected(data=sym.Flatten(data=p), name="fc",
                            num_hidden=10)
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _bottleneck_net(sym, with_relu=True, with_bias=False):
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, name="p1", kernel=(1, 1), num_filter=16,
                         no_bias=not with_bias)
    b1 = sym.BatchNorm(data=c1, name="pbn1", fix_gamma=False)
    net = sym.Activation(data=b1, name="pr1", act_type="relu") \
        if with_relu else b1
    c2 = sym.Convolution(data=net, name="p2", kernel=(1, 1), num_filter=8,
                         no_bias=True)
    b2 = sym.BatchNorm(data=c2, name="pbn2")
    p = sym.Pooling(data=b2, name="pool", kernel=(4, 4), pool_type="avg",
                    global_pool=True)
    fc = sym.FullyConnected(data=sym.Flatten(data=p), name="fc",
                            num_hidden=10)
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _graph_inputs(jsym, shapes, seed):
    """Arguments as test_fusion.py makes them (uniform +-0.5), labels as
    class ids, and nonzero moving statistics."""
    arg_shapes, _, aux_shapes = jsym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(jsym.list_arguments(), arg_shapes)}
    args["softmax_label"] = rng.randint(0, 10, shapes["softmax_label"]
                                        ).astype(np.float32)
    aux = [np.random.RandomState(5).rand(*s).astype(np.float32) + 0.5
           for s in aux_shapes]
    return args, aux


def _jax_walk(jsym, args, aux, is_train):
    """The JAX walk with its plan: outputs, gradients of the parameters
    (the loss head's own, from head cotangents of ones) and new aux."""
    topo, heads = jsym._topo(), jsym._heads
    plan = JaxFusionPlan(topo, heads)
    names = jsym.list_arguments()
    params = [n for n in names if n not in ("data", "softmax_label")]

    def f(pv):
        vals = [pv[n] if n in pv else jnp.asarray(args[n]) for n in names]
        outs, new_aux, _ = jax_eval_graph(
            topo, heads, vals, [jnp.asarray(a) for a in aux], is_train,
            jax.random.PRNGKey(0), plan=plan)
        return outs, new_aux

    pv = {n: jnp.asarray(args[n]) for n in params}
    if not is_train:
        outs, new_aux = f(pv)
        return outs, {}, new_aux
    (outs, new_aux), vjp = jax.vjp(f, pv)
    (grads,) = vjp((outs, [jnp.zeros_like(a) for a in new_aux]))
    return outs, grads, new_aux


def _port_walk(tsym, args, aux, is_train):
    topo, heads = tsym._topo(), tsym._heads
    names = tsym.list_arguments()
    vals = [_t(args[n], is_train and n not in ("data", "softmax_label"))
            for n in names]
    outs, new_aux, _ = eval_graph(topo, heads, vals, [_t(a) for a in aux],
                                  is_train, None,
                                  plan=FusionPlan(topo, heads))
    grads = {}
    if is_train:
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
        grads = {n: v.grad for n, v in zip(names, vals)
                 if v.requires_grad}
    return outs, grads, new_aux


def _compare_walks(build, shapes, seed, is_train, counts):
    jsym, tsym = build(mx.symbol), build(S)
    args, aux = _graph_inputs(jsym, shapes, seed)
    o1, g1, a1 = _port_walk(tsym, args, aux, is_train)
    o2, g2, a2 = _jax_walk(jsym, args, aux, is_train)
    assert K.launch_counts() == counts   # the CPU runs no kernel
    for a, b in zip(o1, o2):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    assert set(g1) == set(g2)
    for n in g2:
        got = g1[n].numpy() if g1[n] is not None else np.zeros_like(g2[n])
        np.testing.assert_allclose(got, np.asarray(g2[n]), rtol=1e-3,
                                   atol=1e-4, err_msg=n)
    for a, b in zip(a1, a2):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("convbn", ["1", None])
def test_convnet_chains_match_jax(is_train, convbn, monkeypatch):
    """3x3 chains: eval folds the moving statistics; training runs the
    unfused ops whatever the gate (the chains are not pointwise)."""
    monkeypatch.setenv("MXNET_PALLAS_FUSION", "1")
    if convbn:
        monkeypatch.setenv("MXNET_PALLAS_CONVBN_TRAIN", convbn)
    else:
        monkeypatch.delenv("MXNET_PALLAS_CONVBN_TRAIN", raising=False)
    counts = K.launch_counts()
    _compare_walks(_convnet, {"data": (4, 3, 16, 16),
                              "softmax_label": (4,)}, 1 + is_train,
                   is_train, counts)


@pytest.mark.parametrize("with_relu,with_bias",
                         [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("convbn", ["1", None])
@pytest.mark.parametrize("is_train", [True, False])
def test_bottleneck_chains_match_jax(with_relu, with_bias, convbn, is_train,
                                     monkeypatch):
    """1x1 chains: with the gate on, the training chain runs through
    matmul_stats on both sides (outputs, every gradient, the moving
    statistics with the absorbed conv bias); without it, the unfused
    ops; on eval the fold."""
    monkeypatch.setenv("MXNET_PALLAS_FUSION", "1")
    monkeypatch.setenv("MXNET_BN_STATS", "auto")
    if convbn:
        monkeypatch.setenv("MXNET_PALLAS_CONVBN_TRAIN", convbn)
    else:
        monkeypatch.delenv("MXNET_PALLAS_CONVBN_TRAIN", raising=False)
    counts = K.launch_counts()
    _compare_walks(lambda s: _bottleneck_net(s, with_relu, with_bias),
                   {"data": (4, 6, 8, 8), "softmax_label": (4,)}, 3,
                   is_train, counts)


def test_fusion_plan_conv_chains_match_jax():
    for build in (_convnet, lambda s: _bottleneck_net(s, False, True)):
        tsym, jsym = build(S), build(mx.symbol)

        def chains(plan, topo):
            by_id = {id(n): n for n in topo}
            return sorted((kind, tuple(n.name for n in nodes))
                          for last, (kind, nodes) in plan.chains.items()
                          if by_id[last] is nodes[-1])
        tp = FusionPlan(tsym._topo(), tsym._heads)
        jp = JaxFusionPlan(jsym._topo(), jsym._heads)
        assert chains(tp, tsym._topo()) == chains(jp, jsym._topo())
        assert {n.name: tp.aux_off[id(n)] for n in tsym._topo()
                if not n.is_var} == {n.name: jp.aux_off[id(n)]
                                     for n in jsym._topo() if not n.is_var}
    sym = _convnet(S)
    kinds = sorted(k for k, _ in FusionPlan(sym._topo(),
                                            sym._heads).chains.values())
    assert kinds == ["conv_bn", "conv_bn_relu"]


def test_fusion_plan_skips_grouped_convs_and_shared_outputs():
    x = S.Variable("data")
    g = S.Convolution(x, kernel=(1, 1), num_filter=4, num_group=2, name="g")
    gb = S.BatchNorm(g, name="gbn")
    c = S.Convolution(gb, kernel=(1, 1), num_filter=4, name="c")
    cb = S.BatchNorm(c, name="cbn")
    out = cb + c                           # c has two consumers
    assert not FusionPlan(out._topo(), out._heads).chains


def test_convbn_train_gating(monkeypatch):
    """test_fusion.py:203-226 against the port's plan: the train chain is
    off for non-pointwise convs, under the exact statistics modes, and
    unless MXNET_PALLAS_CONVBN_TRAIN=1; eval is always on."""
    monkeypatch.delenv("MXNET_BN_STATS", raising=False)
    monkeypatch.delenv("MXNET_PALLAS_CONVBN_TRAIN", raising=False)
    sym = _convnet(S)
    plan = FusionPlan(sym._topo(), sym._heads)
    monkeypatch.setenv("MXNET_PALLAS_CONVBN_TRAIN", "1")
    for kind, nodes in plan.chains.values():
        if kind.startswith("conv_bn"):
            assert not plan._active(kind, nodes, True)
            assert plan._active(kind, nodes, False)
    monkeypatch.delenv("MXNET_PALLAS_CONVBN_TRAIN")

    sym2 = _bottleneck_net(S)
    plan2 = FusionPlan(sym2._topo(), sym2._heads)
    entry = next(v for v in plan2.chains.values()
                 if v[0].startswith("conv_bn"))
    assert not plan2._active(entry[0], entry[1], True)   # off by default
    monkeypatch.setenv("MXNET_PALLAS_CONVBN_TRAIN", "0")
    assert not plan2._active(entry[0], entry[1], True)
    monkeypatch.setenv("MXNET_PALLAS_CONVBN_TRAIN", "1")
    assert plan2._active(entry[0], entry[1], True)
    for mode in ("centered", "welford"):
        monkeypatch.setenv("MXNET_BN_STATS", mode)
        assert not plan2._active(entry[0], entry[1], True)
        assert plan2._active(entry[0], entry[1], False)
    monkeypatch.setenv("MXNET_BN_STATS", "auto")
    assert plan2._active(entry[0], entry[1], True)


def test_onepass_unsafe_keeps_the_train_chain_off(monkeypatch):
    """MXNET_BN_STATS=onepass_unsafe, the JAX package's alias of "auto":
    BatchNorm's training statistics are those of "auto", but the train
    conv+BN chain is off even with the gate set, in both packages."""
    from mxnet_tpu.ops.fusion import _convbn_train_enabled as jax_enabled
    from mxnet_tpu_torch.ops.fusion import _convbn_train_enabled
    monkeypatch.setenv("MXNET_PALLAS_CONVBN_TRAIN", "1")
    x, gamma, beta, _ = _bn_inputs(11)
    outs = {}
    for mode in ("auto", "onepass_unsafe"):
        monkeypatch.setenv("MXNET_BN_STATS", mode)
        assert _convbn_train_enabled() == jax_enabled() == (mode == "auto")
        outs[mode] = T_nn._BNTrain.apply(*map(_t, (x, gamma, beta)), 1e-3)
    for a, b in zip(outs["auto"], outs["onepass_unsafe"]):
        assert torch.equal(a, b)
    sym = _bottleneck_net(S)
    plan = FusionPlan(sym._topo(), sym._heads)
    kind, nodes = next(v for v in plan.chains.values()
                       if v[0].startswith("conv_bn"))
    assert not plan._active(kind, nodes, True)
    assert plan._active(kind, nodes, False)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("kernel,stride,pad,dilate,act", CBA_CASES)
def test_im2col_matches_unfold(kernel, stride, pad, dilate, act,
                               channels_last):
    """The card path's patches (one strided gather) equal F.unfold's, in
    the (c, kh, kw) column order of ``w.reshape(O, -1)`` for an NCHW x and
    in (kh, kw, c) order, with the weight permuted to match, for a
    channels-last x (a fused conv's output)."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 5, 12, 10).astype(np.float32))
    w = torch.from_numpy(rng.randn(9, 5, *kernel).astype(np.float32))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    xm, wm, oh, ow = K._im2col(x, w, stride, pad, dilate)
    cols = torch.nn.functional.unfold(x, kernel, dilation=dilate,
                                      padding=pad, stride=stride)
    assert cols.shape[2] == oh * ow
    assert xm.is_contiguous() and wm.is_contiguous()
    cols = cols.transpose(1, 2).reshape(2, oh * ow, 5, *kernel)
    wcols = w
    if channels_last:    # for a 1x1 kernel both orders are one
        cols, wcols = cols.permute(0, 1, 3, 4, 2), w.permute(0, 2, 3, 1)
    assert torch.equal(xm, cols.reshape(xm.shape))
    assert torch.equal(wm, wcols.reshape(wm.shape))
