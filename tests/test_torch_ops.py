"""The port's operators against the JAX package's, one by one.

Each case parses the same parameters in both registries, runs the
inference forward on the same seeded numpy inputs (and aux states) and
compares: shape inference and the JSON form of the parameters must be
equal, outputs within 1e-6 in f32 (the elementwise ops and gathers are
exact; the LayerNorm, FullyConnected, conv and window sums may round in
another order). The two registries hold the same operators.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

# op, params, input shapes (an int tuple, or ("idx", shape, high) for ids)
CASES = [
    ("_Plus", {}, [(3, 4), (3, 4)]),
    ("_Minus", {}, [(3, 4), (3, 4)]),
    ("_Mul", {}, [(3, 4), (3, 4)]),
    ("_Div", {}, [(3, 4), (3, 4)]),
    ("_PlusScalar", {"scalar": 2.5}, [(2, 5)]),
    ("_MinusScalar", {"scalar": 2.5}, [(2, 5)]),
    ("_RMinusScalar", {"scalar": 2.5}, [(2, 5)]),
    ("_MulScalar", {"scalar": -1.5}, [(2, 5)]),
    ("_DivScalar", {"scalar": 4.0}, [(2, 5)]),
    ("_RDivScalar", {"scalar": 3.0}, [(2, 5)]),
    ("ElementWiseSum", {"num_args": 3}, [(2, 3), (2, 3), (2, 3)]),
    ("Reshape", {"shape": (-1, 6)}, [(2, 3, 4)]),
    ("Reshape", {"shape": (0, -1)}, [(2, 3, 4)]),
    ("Reshape", {"target_shape": (12,)}, [(2, 3, 4)]),
    ("SwapAxis", {"dim1": 1, "dim2": 2}, [(2, 3, 4)]),
    ("Cast", {"dtype": "float16"}, [(3, 3)]),
    ("BlockGrad", {}, [(4,)]),
    ("FullyConnected", {"num_hidden": 5}, [(2, 3, 4), (5, 12), (5,)]),
    ("FullyConnected", {"num_hidden": 5, "flatten": False},
     [(2, 3, 4), (5, 4), (5,)]),
    ("FullyConnected", {"num_hidden": 3, "no_bias": True}, [(4, 6), (3, 6)]),
    ("Activation", {"act_type": "relu"}, [(3, 4)]),
    ("Activation", {"act_type": "sigmoid"}, [(3, 4)]),
    ("Activation", {"act_type": "tanh"}, [(3, 4)]),
    ("Activation", {"act_type": "softrelu"}, [(3, 4)]),
    ("LeakyReLU", {"act_type": "leaky", "slope": 0.1}, [(3, 4)]),
    ("LeakyReLU", {"act_type": "elu", "slope": 0.3}, [(3, 4)]),
    ("LeakyReLU", {"act_type": "prelu"}, [(2, 3, 4), (3,)]),
    ("LeakyReLU", {"act_type": "rrelu"}, [(3, 4)]),
    ("Dropout", {"p": 0.3}, [(3, 4)]),
    ("Embedding", {"input_dim": 10, "output_dim": 4},
     [("idx", (2, 3), 10), (10, 4)]),
    ("LayerNorm", {"eps": 1e-5}, [(2, 3, 8), (8,), (8,)]),
    ("PositionalEmbedding", {}, [(2, 5, 4), (5, 4)]),
    # the rest of the registry: binary, scalar and unary ops
    ("_Power", {}, [("pos", (3, 4)), (3, 4)]),
    ("_Maximum", {}, [(3, 4), (3, 4)]),
    ("_Minimum", {}, [(3, 4), (3, 4)]),
    ("_PowerScalar", {"scalar": 2.0}, [(2, 5)]),
    ("_PowerScalar", {"scalar": 0.5}, [("pos", (2, 5))]),
    ("_RPowerScalar", {"scalar": 2.5}, [(2, 5)]),
    ("_MaximumScalar", {"scalar": 0.7}, [(2, 5)]),
    ("_MinimumScalar", {"scalar": -0.7}, [(2, 5)]),
    ("abs", {}, [(3, 4)]),
    ("sign", {}, [(3, 4)]),
    ("round", {}, [(3, 4)]),
    ("ceil", {}, [(3, 4)]),
    ("floor", {}, [(3, 4)]),
    ("square", {}, [(3, 4)]),
    ("sqrt", {}, [("pos", (3, 4))]),
    ("rsqrt", {}, [("pos", (3, 4))]),
    ("exp", {}, [(3, 4)]),
    ("log", {}, [("pos", (3, 4))]),
    ("cos", {}, [(3, 4)]),
    ("sin", {}, [(3, 4)]),
    # structure
    ("Concat", {"num_args": 3}, [(2, 3, 4), (2, 5, 4), (2, 1, 4)]),
    ("Concat", {"num_args": 2, "dim": 0}, [(2, 3), (4, 3)]),
    ("SliceChannel", {"num_outputs": 3}, [(2, 6, 4)]),
    ("SliceChannel", {"num_outputs": 4, "axis": 1, "squeeze_axis": True},
     [(2, 4, 3)]),
    # nn
    ("Deconvolution", {"kernel": (3, 3), "num_filter": 4},
     [(2, 3, 5, 5), (3, 4, 3, 3)]),
    ("Deconvolution", {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
                       "num_filter": 4, "num_group": 2, "no_bias": False},
     [(2, 4, 5, 6), (4, 2, 4, 4), (4,)]),
    ("Deconvolution", {"kernel": (2, 3), "stride": (3, 2), "num_filter": 3},
     [(1, 2, 4, 3), (2, 3, 2, 3)]),
    ("LRN", {"nsize": 5}, [(2, 7, 3, 3)]),
    ("LRN", {"nsize": 4, "alpha": 0.01, "beta": 0.5, "knorm": 1.0},
     [(2, 6, 3, 3)]),
    ("UpSampling", {"scale": 2}, [(2, 3, 4, 4)]),
    ("UpSampling", {"scale": 2, "num_args": 2}, [(2, 3, 4, 4), (2, 2, 2, 2)]),
    ("UpSampling", {"scale": 3, "num_args": 2, "multi_input_mode": "sum"},
     [(1, 2, 2, 3), (1, 2, 2, 3)]),
    ("UpSampling", {"scale": 2, "sample_type": "bilinear", "num_filter": 3},
     [(2, 3, 4, 4), (3, 1, 4, 4)]),
    ("SoftmaxActivation", {}, [(3, 5)]),
    ("SoftmaxActivation", {"mode": "channel"}, [(2, 4, 3, 3)]),
    # loss
    ("LinearRegressionOutput", {}, [(4, 3), (4, 3)]),
    ("LogisticRegressionOutput", {}, [(5, 1), (5,)]),
    ("MAERegressionOutput", {"grad_scale": 2.0}, [(4, 3), (4, 3)]),
    ("IdentityAttachKLSparseReg", {"penalty": 0.01}, [(4, 6)]),
]


def _shape(s):
    return s[1] if s and s[0] in ("idx", "pos") else s


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for s in shapes:
        if s and s[0] == "idx":
            out.append(rng.randint(0, s[2], s[1]).astype(np.int32))
        elif s and s[0] == "pos":
            out.append((rng.rand(*s[1]) + 0.5).astype(np.float32))
        else:
            out.append((rng.rand(*s) + 0.5).astype(np.float32)
                       * rng.choice([-1.0, 1.0], s).astype(np.float32))
    return out


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_op_matches_jax(i):
    name, kw, shapes = CASES[i]
    jspec, tspec = jreg.get(name), treg.get(name)
    jp, tp = jspec.parse_params(dict(kw)), tspec.parse_params(dict(kw))
    assert tspec.param_str(tp) == jspec.param_str(jp)
    assert tspec.arguments(tp) == jspec.arguments(jp)
    in_shapes = [_shape(s) for s in shapes]
    ji, jo, ja = jspec.infer_shape(jp, list(in_shapes))
    ti, to, ta = tspec.infer_shape(tp, list(in_shapes))
    assert [tuple(s) for s in ti] == [tuple(s) for s in ji]
    assert [tuple(s) for s in to] == [tuple(s) for s in jo]
    assert [tuple(s) for s in ta] == [tuple(s) for s in ja]
    xs = _inputs(shapes, i)
    aux = [np.random.RandomState(i).rand(*s).astype(np.float32) for s in ja]
    jout, _ = jspec.forward(jp, [jnp.asarray(x) for x in xs],
                            [jnp.asarray(a) for a in aux], False, None)
    tout, _ = tspec.forward(tp, [torch.from_numpy(x) for x in xs],
                            [torch.from_numpy(a) for a in aux], False, None)
    assert len(tout) == len(jout) == len(to)
    for j, t in zip(jout, tout):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape == tuple(to[0])
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6)


def test_dropout_and_rrelu_draw_from_the_generator():
    x = torch.ones(64, 64)
    drop, rrelu = treg.get("Dropout"), treg.get("LeakyReLU")
    p = drop.parse_params({"p": 0.5})
    a, _ = drop.forward(p, [x], [], True, torch.Generator().manual_seed(1))
    b, _ = drop.forward(p, [x], [], True, torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0])
    kept = (a[0] != 0).float().mean().item()
    assert 0.4 < kept < 0.6 and set(a[0].unique().tolist()) <= {0.0, 2.0}
    rp = rrelu.parse_params({"act_type": "rrelu"})
    y, _ = rrelu.forward(rp, [-x], [], True, torch.Generator().manual_seed(2))
    assert ((y[0] <= -0.125) & (y[0] >= -0.334)).all()


def test_registry_rejects():
    assert set(treg.REGISTRY) == set(jreg.REGISTRY)
    with pytest.raises(MXNetError):
        treg.get("NoSuchOperator")
    with pytest.raises(MXNetError):
        treg.get("FullyConnected").parse_params({"num_hiden": 3})
    with pytest.raises(MXNetError):
        treg.get("FullyConnected").parse_params({})
    with pytest.raises(MXNetError):
        treg.get("Reshape").infer_shape(
            treg.get("Reshape").parse_params({"shape": (5, -1)}), [(2, 3)])
    with pytest.raises(MXNetError):
        treg.get("Activation").forward({"act_type": "gelu"},
                                       [torch.ones(2)], [], False, None)
