"""``ParallelTrainer.forward()`` keeps the JAX package's contract: the
eval forward runs on the f32 master parameters and the batch as given,
with no cast to ``compute_dtype`` (``mxnet_tpu/parallel/trainer.py``
``_build_eval``, l.506-515). A bf16 trainer's ``forward()`` therefore
returns what the JAX bf16 trainer's returns, in f32: checked on a small
LM and on a small conv net whose first BatchNorm sits outside any conv
chain and feeds a conv (a bf16 forward handed that conv f32 activations
and bf16 weights). Tolerance: f32 on both sides, sums in other orders,
rtol 1e-4 / atol 1e-6 of the probabilities (the ResNet forward test's).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jax_par
from mxnet_tpu.models import get_transformer_lm as jax_lm

from mxnet_tpu_torch import symbol as T_sym
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.parallel import ParallelTrainer

TOL = dict(rtol=1e-4, atol=1e-6)


def _conv_net(S):
    """BatchNorm of the input (no conv before it: no chain), then a
    conv -> BatchNorm -> relu chain, pooling and a classifier."""
    x = S.BatchNorm(data=S.Variable("data"), name="bn0")
    x = S.Convolution(data=x, num_filter=8, kernel=(3, 3), pad=(1, 1),
                      name="conv1")
    x = S.BatchNorm(data=x, name="bn1")
    x = S.Activation(data=x, act_type="relu", name="relu1")
    x = S.Pooling(data=x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool1")
    x = S.FullyConnected(data=S.Flatten(data=x), num_hidden=10, name="fc")
    return S.SoftmaxOutput(data=x, name="softmax")


def _params(symbol, shapes, seed):
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * (np.sqrt(2.0 / np.prod(s[1:]))
                                 if n.endswith("_weight") else 0.1)
                + n.endswith("_gamma")).astype(np.float32)
            for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else 0.1 * rng.randn(*s)).astype(np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _jax_forward(jsym, shapes, args, aux, batch):
    tr = jax_par.ParallelTrainer(jsym, shapes, compute_dtype="bfloat16",
                                 mesh=jax_par.data_parallel_mesh(1))
    tr.init_params({k: mx.nd.array(v) for k, v in args.items()},
                   {k: mx.nd.array(v) for k, v in aux.items()})
    return np.asarray(tr.forward(batch)[0])


def _port_forward(symbol, shapes, args, aux, batch):
    tr = ParallelTrainer(symbol, shapes, compute_dtype="bfloat16",
                         device="cpu")
    tr.init_params(args, aux)
    return tr.forward(batch)[0]


@pytest.mark.parametrize("net", ["lm", "conv"])
def test_bf16_trainer_forward_is_jax_f32_forward(net):
    rng = np.random.RandomState(4)
    if net == "lm":
        shapes = {"data": (2, 16), "softmax_label": (2, 16)}
        kw = dict(num_layers=2, embed_dim=32, num_heads=4)
        jsym, symbol = jax_lm(40, **kw), get_transformer_lm(40, **kw)
        batch = {"data": rng.randint(0, 40, (2, 16)).astype(np.int32),
                 "softmax_label": rng.randint(0, 40, (2, 16)).astype(
                     np.int32)}
    else:
        shapes = {"data": (2, 3, 8, 8), "softmax_label": (2,)}
        jsym, symbol = _conv_net(mx.symbol), _conv_net(T_sym)
        batch = {"data": rng.rand(2, 3, 8, 8).astype(np.float32),
                 "softmax_label": rng.randint(0, 10, (2,)).astype(
                     np.float32)}
    args, aux = _params(jsym, shapes, 5)
    want = _jax_forward(jsym, shapes, args, aux, batch)
    got = _port_forward(symbol, shapes, args, aux, batch)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_trainer_steps_in_bf16_and_forwards_in_f32():
    """The step keeps its in-graph cast (bf16 outputs, f32 gradients into
    the f32 parameters) while forward() stays f32, and the parameters are
    the same tensors for both."""
    rng = np.random.RandomState(6)
    shapes = {"data": (2, 3, 8, 8), "softmax_label": (2,)}
    symbol = _conv_net(T_sym)
    args, aux = _params(symbol, shapes, 7)
    tr = ParallelTrainer(symbol, shapes, compute_dtype="bfloat16",
                         device="cpu")
    tr.init_params(args, aux)
    batch = {"data": rng.rand(2, 3, 8, 8).astype(np.float32),
             "softmax_label": np.array([1, 2], np.float32)}
    assert tr.step(batch)[0].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in tr.params.values())
    out = tr.forward(batch)[0]
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.sum(dim=1).numpy(), 1.0, rtol=1e-5)
