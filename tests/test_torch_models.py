"""The port's model zoo against the JAX package's.

Every ``get_symbol`` name (and VGG's other depths, FCN's variants and
the unrolled LSTM) builds the same graph in both packages: the same
``tojson()`` (node names included, the automatic ones too), arguments,
aux states and inferred shapes, so one ``prefix-symbol.json`` +
``.params`` pair loads in either. Small members run forward and backward
through ``simple_bind`` on the CPU from the same numpy weights: outputs
and aux states within 1e-5, gradients by per-tensor norm within 2e-2 for
graphs with a ReLU (a unit within an ulp of the kink flips its
derivative between two correct implementations) and elementwise within
1e-5 for the LSTM. A checkpoint the JAX ``FeedForward.save`` wrote loads
in the port's ``FeedForward.load`` and predicts the same probabilities.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models as jmodels
from mxnet_tpu.name import NameManager as JaxNames

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.models as tmodels
from mxnet_tpu_torch.name import NameManager

TOL = dict(rtol=1e-5, atol=1e-5)
NORM_REL = 2e-2

LSTM = dict(num_lstm_layer=1, seq_len=3, input_size=11, num_hidden=6,
            num_embed=5, num_label=11)

# (name, kwargs, data shape, other input shapes)
BUILDS = [
    ("mlp", {}, (2, 784), {}),
    ("lenet", {}, (2, 1, 28, 28), {}),
    ("alexnet", {}, (1, 3, 224, 224), {}),
    ("vgg", {}, (1, 3, 224, 224), {}),
    ("vgg", {"num_layers": 11}, (1, 3, 64, 64), {}),
    ("vgg", {"num_layers": 13}, (1, 3, 64, 64), {}),
    ("vgg", {"num_layers": 19}, (1, 3, 64, 64), {}),
    ("resnet", {}, (1, 3, 224, 224), {}),
    ("resnet-28-small", {}, (2, 3, 28, 28), {}),
    ("inception-bn-28-small", {}, (2, 3, 28, 28), {}),
    ("inception-bn", {}, (1, 3, 224, 224), {}),
    ("inception-v3", {}, (1, 3, 299, 299), {}),
    ("googlenet", {}, (1, 3, 224, 224), {}),
    ("fcn-xs", {}, (1, 3, 64, 64), {}),
    ("fcn-xs", {"variant": "16s"}, (1, 3, 64, 64), {}),
    ("fcn-xs", {"variant": "8s"}, (1, 3, 64, 64), {}),
    ("lstm_unroll", LSTM, (2, 3), {"l0_init_c": (2, 6), "l0_init_h": (2, 6)}),
]


def _build(models, names, name, kw):
    with names():
        if name == "lstm_unroll":
            return models.lstm_unroll(**kw)
        return models.get_symbol(name, **kw)


@pytest.mark.parametrize("i", range(len(BUILDS)),
                         ids=["%s-%d" % (b[0], i) for i, b in enumerate(BUILDS)])
def test_graph_matches_jax(i):
    name, kw, dshape, extra = BUILDS[i]
    t = _build(tmodels, NameManager, name, kw)
    j = _build(jmodels, JaxNames, name, kw)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    got = t.infer_shape(data=dshape, **extra)
    want = j.infer_shape(data=dshape, **extra)
    assert got == want and None not in got[0]


def test_get_symbol_registry():
    assert sorted(tmodels._REGISTRY) == sorted(jmodels._REGISTRY)
    assert len(tmodels._REGISTRY) == 11
    assert tmodels.LSTMState._fields == jmodels.LSTMState._fields
    assert tmodels.LSTMParam._fields == jmodels.LSTMParam._fields
    with pytest.raises(ValueError, match="unknown network"):
        tmodels.get_symbol("inception-bn-full")
    assert tmodels.get_symbol("resnet", num_classes=10, num_layers=18) \
        .infer_shape(data=(1, 3, 64, 64))[1] == [(1, 10)]


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _weights(exe, rng, labels):
    """Seeded values for every argument and aux state: fan-in scaled
    weights, gammas and moving variances in [0.5, 1.5], class ids for the
    labels (``labels``: name -> classes)."""
    args, aux = {}, {}
    for n, a in exe.arg_dict.items():
        if n in labels:
            args[n] = rng.randint(0, labels[n], a.shape).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            fan = np.prod(a.shape[1:]) if a.ndim > 1 else 1
            args[n] = (rng.randn(*a.shape) / np.sqrt(fan)).astype(np.float32)
    for n, a in exe.aux_dict.items():
        lo = 0.5 if n.endswith("var") else -0.1
        aux[n] = rng.uniform(lo, lo + 1.0, a.shape).astype(np.float32)
    return args, aux


def _pair(name, kw, shapes, labels, seed):
    t_sym = _build(tmodels, NameManager, name, kw)
    j_sym = _build(jmodels, JaxNames, name, kw)
    t_exe = t_sym.simple_bind(mx.cpu(), **shapes)
    j_exe = j_sym.simple_bind(jmx.cpu(), **shapes)
    args, aux = _weights(t_exe, np.random.RandomState(seed), labels)
    for exe in (t_exe, j_exe):
        for n, v in args.items():
            exe.arg_dict[n][:] = v
        for n, v in aux.items():
            exe.aux_dict[n][:] = v
    return t_exe, j_exe


def _close_by_norm(got, want, what):
    err = np.linalg.norm(got.astype(np.float64) - want)
    assert err <= NORM_REL * np.linalg.norm(want) + 1e-7, (what, err)


# (name, kwargs, input shapes, labels: name -> classes, relu)
RUNS = [
    ("mlp", {}, {"data": (2, 784), "softmax_label": (2,)},
     {"softmax_label": 10}, True),
    ("lenet", {}, {"data": (2, 1, 28, 28), "softmax_label": (2,)},
     {"softmax_label": 10}, False),
    ("inception-bn-28-small", {}, {"data": (2, 3, 28, 28),
                                   "softmax_label": (2,)},
     {"softmax_label": 10}, True),
    ("lstm_unroll", LSTM, dict(
        {"data": (2, 3), "l0_init_c": (2, 6), "l0_init_h": (2, 6)},
        **{"t%d_label" % t: (2,) for t in range(3)}),
     dict({"data": 11}, **{"t%d_label" % t: 11 for t in range(3)}), False),
]


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[r[0] for r in RUNS])
def test_forward_backward_matches_jax(i):
    name, kw, shapes, labels, relu = RUNS[i]
    t_exe, j_exe = _pair(name, kw, shapes, labels, seed=i)
    for exe in (t_exe, j_exe):
        exe.forward(is_train=True)
        exe.backward()
    assert len(t_exe.outputs) == len(j_exe.outputs)
    for got, want in zip(t_exe.outputs, j_exe.outputs):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    for n in t_exe.aux_dict:
        np.testing.assert_allclose(t_exe.aux_dict[n].asnumpy(),
                                   j_exe.aux_dict[n].asnumpy(), err_msg=n,
                                   **TOL)
    for n, g in t_exe.grad_dict.items():
        want = j_exe.grad_dict[n].asnumpy()
        if relu:
            _close_by_norm(g.asnumpy(), want, n)
        else:
            np.testing.assert_allclose(g.asnumpy(), want, err_msg=n, **TOL)
    # the eval forward (conv -> BatchNorm -> relu chains fused)
    for exe in (t_exe, j_exe):
        exe.forward(is_train=False)
    for got, want in zip(t_exe.outputs, j_exe.outputs):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    if name == "lstm_unroll":
        for o in t_exe.outputs:
            np.testing.assert_allclose(o.asnumpy().sum(axis=1), 1.0,
                                       rtol=1e-5)


def test_jax_checkpoint_loads_and_predicts_in_the_port(tmp_path):
    shapes = {"data": (4, 3, 28, 28), "softmax_label": (4,)}
    t_exe, _ = _pair("inception-bn-28-small", {}, shapes,
                     {"softmax_label": 10}, seed=9)
    args = {n: a.asnumpy() for n, a in t_exe.arg_dict.items()
            if n not in shapes}
    aux = {n: a.asnumpy() for n, a in t_exe.aux_dict.items()}
    with JaxNames():
        j_sym = jmodels.get_inception_bn_small()
    j_model = jmx.model.FeedForward(
        j_sym, ctx=jmx.cpu(), numpy_batch_size=4,
        arg_params={n: jmx.nd.array(v) for n, v in args.items()},
        aux_params={n: jmx.nd.array(v) for n, v in aux.items()})
    prefix = str(tmp_path / "inception-small")
    j_model.save(prefix, 3)
    x = np.random.RandomState(4).rand(8, 3, 28, 28).astype(np.float32)
    want = j_model.predict(x)
    t_model = mx.model.FeedForward.load(prefix, 3, ctx=mx.cpu(),
                                        numpy_batch_size=4)
    assert t_model.symbol.tojson() == j_sym.tojson()
    got = t_model.predict(x)
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got, want, **TOL)
