"""The gradients of the port's operators against the JAX package's.

Each case builds one operator over free variables in both packages,
``simple_bind``s it on the CPU, writes the same seeded numpy inputs,
runs ``forward(is_train=True)`` and ``backward`` with the same seeded
head gradients, and compares the outputs, the aux states and every
input gradient elementwise within 1e-5 (f32). The inputs of some cases
pin an edge where PyTorch's and JAX's derivatives could part: ``abs`` at
0, a max or min against a scalar at a tie, a power at base 0 (and a
negative base under a fractional exponent: NaN in both), ``round`` at
the halves, an even LRN window, a SliceChannel split with its axis
squeezed, the regression outputs ignoring the head gradient and the KL
regulariser's ``moving_avg`` and gradient.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _normal(shape, rng):
    return rng.randn(*shape).astype(np.float32)


def _pos(shape, rng):
    return (rng.rand(*shape) + 0.5).astype(np.float32)


def _with(values):
    """Seeded normal values with ``values`` written over the first ones."""
    def make(shape, rng):
        x = _normal(shape, rng).reshape(-1)
        x[:len(values)] = values
        return x.reshape(shape)
    return make


def _ids(high):
    def make(shape, rng):
        return rng.randint(0, high, shape).astype(np.float32)
    return make


# op, params, {input name: (shape, maker)}; the inputs in argument order
CASES = [
    ("_Plus", {}, {"lhs": ((3, 4), _normal), "rhs": ((3, 4), _normal)}),
    ("_Power", {}, {"lhs": ((3, 4), _with([0.0, 0.0, -2.0, -1.5])),
                    "rhs": ((3, 4), _with([2.0, 3.0, 0.5, 2.0]))}),
    ("_Maximum", {}, {"lhs": ((3, 4), _with([1.0, -2.0])),
                      "rhs": ((3, 4), _with([1.0, -2.0]))}),
    ("_Minimum", {}, {"lhs": ((3, 4), _with([0.5])),
                      "rhs": ((3, 4), _with([0.5]))}),
    ("_PowerScalar", {"scalar": 2.0},
     {"data": ((2, 5), _with([0.0, -1.0]))}),
    ("_PowerScalar", {"scalar": 0.5},
     {"data": ((2, 5), _with([-1.0, 4.0]))}),
    ("_RPowerScalar", {"scalar": 2.5}, {"data": ((2, 5), _normal)}),
    ("_RPowerScalar", {"scalar": 0.0}, {"data": ((2, 5), _pos)}),
    ("_MaximumScalar", {"scalar": 0.25},
     {"data": ((2, 5), _with([0.25, 0.25, -0.25]))}),
    ("_MinimumScalar", {"scalar": -0.5},
     {"data": ((2, 5), _with([-0.5, 0.5]))}),
    ("abs", {}, {"data": ((3, 4), _with([0.0, -0.0, 1.0, -1.0]))}),
    ("sign", {}, {"data": ((3, 4), _with([0.0]))}),
    ("round", {}, {"data": ((3, 4), _with(
        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997]))}),
    ("ceil", {}, {"data": ((3, 4), _with([1.0, -1.0]))}),
    ("floor", {}, {"data": ((3, 4), _with([1.0, -1.0]))}),
    ("square", {}, {"data": ((3, 4), _normal)}),
    ("sqrt", {}, {"data": ((3, 4), _pos)}),
    ("rsqrt", {}, {"data": ((3, 4), _pos)}),
    ("exp", {}, {"data": ((3, 4), _normal)}),
    ("log", {}, {"data": ((3, 4), _pos)}),
    ("cos", {}, {"data": ((3, 4), _normal)}),
    ("sin", {}, {"data": ((3, 4), _normal)}),
    ("Concat", {"num_args": 3}, {"arg0": ((2, 3, 4), _normal),
                                 "arg1": ((2, 5, 4), _normal),
                                 "arg2": ((2, 1, 4), _normal)}),
    ("SliceChannel", {"num_outputs": 3}, {"data": ((2, 6, 4), _normal)}),
    ("SliceChannel", {"num_outputs": 4, "axis": 1, "squeeze_axis": True},
     {"data": ((2, 4, 3), _normal)}),
    ("Deconvolution", {"kernel": (3, 3), "num_filter": 4},
     {"data": ((2, 3, 5, 5), _normal), "weight": ((3, 4, 3, 3), _normal)}),
    ("Deconvolution", {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
                       "num_filter": 4, "num_group": 2, "no_bias": False},
     {"data": ((2, 4, 5, 6), _normal), "weight": ((4, 2, 4, 4), _normal),
      "bias": ((4,), _normal)}),
    ("LRN", {"nsize": 5}, {"data": ((2, 7, 3, 3), _normal)}),
    ("LRN", {"nsize": 4, "alpha": 0.01, "beta": 0.5, "knorm": 1.0},
     {"data": ((2, 6, 3, 3), _normal)}),
    ("UpSampling", {"scale": 2, "num_args": 2},
     {"arg0": ((2, 3, 4, 4), _normal), "arg1": ((2, 2, 2, 2), _normal)}),
    ("UpSampling", {"scale": 3, "num_args": 2, "multi_input_mode": "sum"},
     {"arg0": ((1, 2, 2, 3), _normal), "arg1": ((1, 2, 2, 3), _normal)}),
    ("UpSampling", {"scale": 2, "sample_type": "bilinear", "num_filter": 3},
     {"data": ((2, 3, 4, 4), _normal), "weight": ((3, 1, 4, 4), _normal)}),
    ("SoftmaxActivation", {}, {"data": ((3, 5), _normal)}),
    ("SoftmaxActivation", {"mode": "channel"},
     {"data": ((2, 4, 3, 3), _normal)}),
    ("LinearRegressionOutput", {}, {"data": ((4, 3), _normal),
                                    "label": ((4, 3), _normal)}),
    ("LogisticRegressionOutput", {"grad_scale": 0.5},
     {"data": ((5, 1), _normal), "label": ((5,), _ids(2))}),
    ("MAERegressionOutput", {"grad_scale": 2.0},
     {"data": ((4, 3), _with([0.0])), "label": ((4, 3), _with([0.0]))}),
    ("IdentityAttachKLSparseReg", {"penalty": 0.01, "momentum": 0.8},
     {"data": ((4, 6), _pos)}),
    ("IdentityAttachKLSparseReg", {"sparseness_target": 0.3},
     {"data": ((3, 4, 2, 2), _pos)}),
]

HEAD_IGNORED = ("LinearRegressionOutput", "LogisticRegressionOutput",
                "MAERegressionOutput")


def _bind(pkg, op, kw, inputs, values, aux=None):
    args = [pkg.sym.Variable(n) for n in inputs]
    net = getattr(pkg.sym, op)(*args, name="op", **kw)
    assert net.list_arguments() == list(inputs)
    exe = net.simple_bind(pkg.cpu(), **{n: s for n, (s, _) in
                                        inputs.items()})
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    for n, v in (aux or {}).items():
        exe.aux_dict[n][:] = v
    return net, exe


def _run(exe, pkg, heads):
    exe.forward(is_train=True)
    outs = [o.asnumpy() for o in exe.outputs]
    exe.backward([pkg.nd.array(h) for h in heads])
    return outs, {n: g.asnumpy() for n, g in exe.grad_dict.items()}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_grad_matches_jax(i):
    op, kw, inputs = CASES[i]
    rng = np.random.RandomState(100 + i)
    values = {n: make(shape, rng) for n, (shape, make) in inputs.items()}
    t_net, t_exe = _bind(mx, op, kw, inputs, values)
    aux = {n: rng.rand(*a.shape).astype(np.float32)
           for n, a in t_exe.aux_dict.items()}
    for n in aux:
        t_exe.aux_dict[n][:] = aux[n]
    j_net, j_exe = _bind(jmx, op, kw, inputs, values, aux)
    assert t_net.tojson() == j_net.tojson()
    heads = [rng.randn(*o.shape).astype(np.float32) for o in t_exe.outputs]
    t_outs, t_grads = _run(t_exe, mx, heads)
    j_outs, j_grads = _run(j_exe, jmx, heads)
    assert len(t_outs) == len(j_outs)
    for got, want in zip(t_outs, j_outs):
        np.testing.assert_allclose(got, want, **TOL)
    assert sorted(t_grads) == sorted(j_grads) == sorted(inputs)
    for n in inputs:
        np.testing.assert_allclose(t_grads[n], j_grads[n], err_msg=n, **TOL)
    for n in aux:
        np.testing.assert_allclose(t_exe.aux_dict[n].asnumpy(),
                                   j_exe.aux_dict[n].asnumpy(), err_msg=n,
                                   **TOL)
    if op in HEAD_IGNORED:
        # a loss layer's gradient does not see the head gradient
        _, ones = _run(t_exe, mx, [np.ones_like(h) for h in heads])
        np.testing.assert_array_equal(ones["data"], t_grads["data"])
        assert not t_grads["label"].any()


def test_round_is_half_to_even_with_zero_gradient():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    _, exe = _bind(mx, "round", {}, {"data": (x.shape, None)}, {"data": x})
    outs, grads = _run(exe, mx, [np.ones_like(x)])
    np.testing.assert_array_equal(outs[0], [0, 2, 2, -0, -2, 4])
    assert not grads["data"].any()


def test_abs_and_scalar_ties_take_jax_derivatives():
    x = np.array([0.0, 2.0, -2.0, 0.25], np.float32)
    _, exe = _bind(mx, "abs", {}, {"data": (x.shape, None)}, {"data": x})
    np.testing.assert_array_equal(
        _run(exe, mx, [np.ones_like(x)])[1]["data"], [1, 1, -1, 1])
    for op, want in (("_MaximumScalar", [0, 1, 0, 0.5]),
                     ("_MinimumScalar", [1, 0, 1, 0.5])):
        _, exe = _bind(mx, op, {"scalar": 0.25}, {"data": (x.shape, None)},
                       {"data": x})
        np.testing.assert_array_equal(
            _run(exe, mx, [np.ones_like(x)])[1]["data"], want)


def test_kl_regulariser_moving_avg_and_batch_gradient():
    """moving_avg moves only in training, and the gradient's KL term comes
    from the batch's mean activation, not the moving average."""
    x = np.array([[0.2, 0.9], [0.4, 0.7]], np.float32)
    kw = {"sparseness_target": 0.1, "penalty": 0.5, "momentum": 0.9}
    _, exe = _bind(mx, "IdentityAttachKLSparseReg", kw,
                   {"data": (x.shape, None)}, {"data": x})
    exe.aux_dict["op_moving_avg"][:] = np.array([0.5, 0.5], np.float32)
    exe.forward(is_train=False)
    np.testing.assert_array_equal(exe.aux_dict["op_moving_avg"].asnumpy(),
                                  [0.5, 0.5])
    exe.forward(is_train=True)
    rho_hat = x.mean(axis=0)
    np.testing.assert_allclose(exe.aux_dict["op_moving_avg"].asnumpy(),
                               0.9 * 0.5 + 0.1 * rho_hat, **TOL)
    exe.backward([mx.nd.array(np.zeros_like(x))])
    kl = 0.5 * (-0.1 / rho_hat + 0.9 / (1 - rho_hat))
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(),
                               np.broadcast_to(kl, x.shape), **TOL)


def test_bilinear_upsampling_follows_the_reference_beyond_scale_2():
    """The JAX package pads the bilinear kernel as ``(s + 1) // 2 - 1 +
    (k - 1) // 2`` (nn.py l.711-724), which gives ``s * H`` rows only at
    scale 2 (4H - 4 at scale 4, while shape inference says 4H). The port
    keeps that forward value for value."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    import torch
    kw = {"scale": 4, "sample_type": "bilinear"}
    rng = np.random.RandomState(7)
    x = rng.randn(1, 2, 3, 3).astype(np.float32)
    w = rng.randn(2, 1, 8, 8).astype(np.float32)
    jspec, tspec = jreg.get("UpSampling"), treg.get("UpSampling")
    jout = jspec.forward(jspec.parse_params(dict(kw)),
                         [jnp.asarray(x), jnp.asarray(w)], [], False,
                         None)[0][0]
    tout = tspec.forward(tspec.parse_params(dict(kw)),
                         [torch.from_numpy(x), torch.from_numpy(w)], [],
                         False, None)[0][0]
    assert tuple(tout.shape) == jout.shape == (1, 2, 8, 8)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
