"""The port's LM operators against the JAX package's, one by one.

Each case parses the same parameters in both registries, runs the
inference forward on the same seeded numpy inputs and compares: shape
inference and the JSON form of the parameters must be equal, outputs
within 1e-6 in f32 (the elementwise ops and gathers are exact; the
LayerNorm and FullyConnected sums may round in another order).
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
]


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for s in shapes:
        if s and s[0] == "idx":
            out.append(rng.randint(0, s[2], s[1]).astype(np.int32))
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
    in_shapes = [s[1] if s and s[0] == "idx" else s for s in shapes]
    ji, jo, _ = jspec.infer_shape(jp, list(in_shapes))
    ti, to, _ = tspec.infer_shape(tp, list(in_shapes))
    assert [tuple(s) for s in ti] == [tuple(s) for s in ji]
    assert [tuple(s) for s in to] == [tuple(s) for s in jo]
    xs = _inputs(shapes, i)
    jout, _ = jspec.forward(jp, [jnp.asarray(x) for x in xs], [], False,
                            None)
    tout, _ = tspec.forward(tp, [torch.from_numpy(x) for x in xs], [],
                            False, None)
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
    with pytest.raises(MXNetError):
        treg.get("Deconvolution")
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
