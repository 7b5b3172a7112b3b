"""The port's Executor (``Symbol.bind``/``simple_bind``) and the rest of
the Symbol surface against the JAX package's, on the CPU.

The cases of ``tests/test_executor.py`` (binary ops, ``reshape``'s shared
memory, bucketing groups sharing parameters), ``grad_req``
write/add/null, ``backward`` twice and after an inference forward, a
2-layer LM (``impl="flash"``: the plain version of the kernel here) and a
small ResNet with BatchNorm through ``simple_bind`` against the JAX
Executor on the same arrays, gradient mirroring, the monitor, and
``infer_type``/``Group``/``attr_dict``/``debug_str``/composition/pickle.

Tolerances (f32 on both sides): outputs and aux states 1e-5; gradients
of graphs with a ReLU by per-tensor norm at 2e-2 (a unit whose
pre-activation sits within an ulp of the kink flips its derivative
between two correct implementations), other gradients 1e-5.
"""
import copy
import logging
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import get_resnet_cifar as jax_resnet_cifar
from mxnet_tpu.models import get_transformer_lm as jax_lm

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor_manager import DataParallelExecutorManager
from mxnet_tpu_torch.models import get_resnet_cifar, get_transformer_lm

TOL = dict(rtol=1e-5, atol=1e-5)
NORM_REL = 2e-2


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _close_by_norm(got, want, what):
    err = np.linalg.norm(got.astype(np.float64) - want)
    assert err <= NORM_REL * np.linalg.norm(want) + 1e-7, (what, err)


def _bind_pair(uf, shape, rng):
    lhs = rng.uniform(-10, 10, shape).astype(np.float32)
    rhs = rng.uniform(1, 10, shape).astype(np.float32)
    out = []
    for pkg in (mx, jmx):
        s = uf(pkg.sym.Variable("lhs"), pkg.sym.Variable("rhs"))
        assert s.list_arguments() == ["lhs", "rhs"]
        args = [pkg.nd.array(lhs), pkg.nd.array(rhs)]
        grads = [pkg.nd.empty(shape), pkg.nd.empty(shape)]
        exe = s.bind(pkg.cpu(), args=args, args_grad=grads)
        exe_dict = s.bind(pkg.cpu(), args={"rhs": args[1], "lhs": args[0]},
                          args_grad={"lhs": pkg.nd.empty(shape),
                                     "rhs": pkg.nd.empty(shape)})
        exe.forward(is_train=True)
        exe_dict.forward()
        exe.backward([pkg.nd.array(np.ones(shape, np.float32))])
        out.append((exe.outputs[0].asnumpy(),
                    exe_dict.outputs[0].asnumpy(),
                    [g.asnumpy() for g in grads]))
    return lhs, rhs, out


BINDS = {
    "add": (lambda x, y: x + y, lambda g, x, y: (g, g)),
    "sub": (lambda x, y: x - y, lambda g, x, y: (g, -g)),
    "mul": (lambda x, y: x * y, lambda g, x, y: (y * g, x * g)),
    "div": (lambda x, y: x / y, lambda g, x, y: (g / y, -x * g / y ** 2)),
}


@pytest.mark.parametrize("op", sorted(BINDS))
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_bind_binops_match_numpy_and_jax(op, dim):
    """tests/test_executor.py::test_bind."""
    uf, gf = BINDS[op]
    rng = np.random.RandomState(dim)
    shape = tuple(rng.randint(1, 8, size=dim))
    lhs, rhs, ((out, out_d, grads), (jout, _, jgrads)) = \
        _bind_pair(uf, shape, rng)
    np.testing.assert_allclose(out, uf(lhs, rhs), rtol=1e-6)
    np.testing.assert_array_equal(out, out_d)
    np.testing.assert_allclose(out, jout, rtol=1e-6)
    for g, jg, want in zip(grads, jgrads, gf(np.ones(shape), lhs, rhs)):
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-7)


def test_reshape_shares_memory():
    """tests/test_executor.py::test_reshape."""
    x = mx.sym.Variable("x")
    y = mx.sym.FullyConnected(x, num_hidden=4)
    exe = y.simple_bind(mx.cpu(), x=(5, 4))
    exe.arg_arrays[0][:] = 1
    exe.arg_arrays[1][:] = mx.nd.ones((4, 4))
    exe.arg_arrays[2][:] = 0
    new_exe = exe.reshape(x=(3, 4))
    new_exe.forward(is_train=False)
    assert np.all(new_exe.outputs[0].asnumpy() == 4)
    assert np.all(exe.outputs[0].asnumpy()[:3] == 4)  # shared memory
    assert new_exe.arg_arrays[1] is exe.arg_arrays[1]
    exe.forward(is_train=False)
    assert np.all(exe.outputs[0].asnumpy() == 4)
    with pytest.raises(MXNetError, match="allow_up_sizing"):
        exe.reshape(x=(9, 4))


def _mlp(pkg, hidden=8, k=3):
    s = pkg.sym
    data = s.Variable("data")
    fc1 = s.FullyConnected(data=data, name="fc1", num_hidden=hidden)
    act = s.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = s.FullyConnected(data=act, name="fc2", num_hidden=k)
    return s.SoftmaxOutput(data=fc2, name="softmax")


def _mlp_exe(grad_req, seed=0):
    net = _mlp(mx)
    exe = net.simple_bind(mx.cpu(), grad_req=grad_req, data=(4, 5),
                          softmax_label=(4,))
    rng = np.random.RandomState(seed)
    for name, arr in exe.arg_dict.items():
        arr[:] = rng.uniform(-1, 1, arr.shape)
    exe.arg_dict["softmax_label"][:] = np.array([0, 2, 1, 2])
    return exe


def test_grad_req_write_add_null_and_backward_twice():
    exe = _mlp_exe("write")
    exe.forward(is_train=True)
    exe.backward()
    first = {k: v.asnumpy() for k, v in exe.grad_dict.items()}
    exe.backward()
    for k, v in exe.grad_dict.items():
        np.testing.assert_array_equal(v.asnumpy(), first[k], err_msg=k)
    assert np.abs(first["fc1_weight"]).sum() > 0
    assert not first["softmax_label"].any()

    add = _mlp_exe("add")
    for arr in add.grad_arrays:
        arr[:] = 1.0
    add.forward(is_train=True)
    add.backward()
    add.backward()
    for k, v in add.grad_dict.items():
        np.testing.assert_allclose(v.asnumpy(), 1.0 + 2 * first[k],
                                   rtol=1e-6, err_msg=k)

    null = _mlp_exe("null")
    assert all(g is None for g in null.grad_arrays)
    null.forward(is_train=True)
    null.backward()

    mixed = _mlp_exe({"fc2_weight": "write", "fc1_bias": "add"})
    assert mixed._grad_req == ["null", "null", "add", "write", "null",
                               "null"]
    mixed.grad_dict["fc1_bias"][:] = 0.5
    mixed.forward(is_train=True)
    mixed.backward()
    np.testing.assert_allclose(mixed.grad_dict["fc1_bias"].asnumpy(),
                               0.5 + first["fc1_bias"], rtol=1e-6)
    np.testing.assert_array_equal(mixed.grad_dict["fc2_weight"].asnumpy(),
                                  first["fc2_weight"])


def test_forward_reads_the_current_arrays():
    exe = _mlp_exe("write")
    exe.forward(is_train=True)
    a = exe.outputs[0].asnumpy()
    exe.arg_dict["data"][:] = 0.0
    exe.forward(is_train=True, softmax_label=mx.nd.array([1, 1, 1, 1]))
    assert not np.allclose(a, exe.outputs[0].asnumpy())
    assert exe.arg_dict["softmax_label"].asnumpy().tolist() == [1] * 4
    with pytest.raises(MXNetError, match="unknown argument"):
        exe.forward(bogus=1)


def _lm_pair(seed=0):
    kw = dict(num_layers=2, embed_dim=16, num_heads=2, impl="flash")
    t_sym, j_sym = get_transformer_lm(29, **kw), jax_lm(29, **kw)
    shapes = {"data": (2, 16), "softmax_label": (2, 16)}
    t_exe = t_sym.simple_bind(mx.cpu(), **shapes)
    j_exe = j_sym.simple_bind(jmx.cpu(), **shapes)
    rng = np.random.RandomState(seed)
    for name, arr in t_exe.arg_dict.items():
        if name in shapes:
            val = rng.randint(0, 29, arr.shape).astype(np.float32)
        else:
            val = (0.3 * rng.randn(*arr.shape)).astype(np.float32)
        arr[:] = val
        j_exe.arg_dict[name][:] = val
    return t_exe, j_exe


def _compare_executors(t_exe, j_exe, relu):
    t_exe.forward(is_train=True)
    j_exe.forward(is_train=True)
    for got, want in zip(t_exe.outputs, j_exe.outputs):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    for name in t_exe.aux_dict:
        np.testing.assert_allclose(t_exe.aux_dict[name].asnumpy(),
                                   j_exe.aux_dict[name].asnumpy(),
                                   err_msg=name, **TOL)
    t_exe.backward()
    j_exe.backward()
    for name, g in t_exe.grad_dict.items():
        want = j_exe.grad_dict[name].asnumpy()
        if relu:
            _close_by_norm(g.asnumpy(), want, name)
        else:
            np.testing.assert_allclose(g.asnumpy(), want, err_msg=name,
                                       **TOL)


def test_lm_simple_bind_matches_jax_executor():
    t_exe, j_exe = _lm_pair()
    _compare_executors(t_exe, j_exe, relu=True)
    # eval forward too
    t_exe.forward(is_train=False)
    j_exe.forward(is_train=False)
    np.testing.assert_allclose(t_exe.outputs[0].asnumpy(),
                               j_exe.outputs[0].asnumpy(), **TOL)


def _resnet_pair(seed=1):
    t_sym = get_resnet_cifar(num_classes=5, n=1, image_hw=8)
    j_sym = jax_resnet_cifar(num_classes=5, n=1, image_hw=8)
    shapes = {"data": (4, 3, 8, 8), "softmax_label": (4,)}
    t_exe = t_sym.simple_bind(mx.cpu(), **shapes)
    j_exe = j_sym.simple_bind(jmx.cpu(), **shapes)
    rng = np.random.RandomState(seed)
    for name, arr in t_exe.arg_dict.items():
        if name == "softmax_label":
            val = rng.randint(0, 5, arr.shape).astype(np.float32)
        elif name.endswith("gamma"):
            val = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
        else:
            fan = np.prod(arr.shape[1:]) if arr.ndim > 1 else 1
            val = (rng.randn(*arr.shape) / np.sqrt(fan)).astype(np.float32)
        arr[:] = val
        j_exe.arg_dict[name][:] = val
    for name, arr in t_exe.aux_dict.items():
        val = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
        arr[:] = val
        j_exe.aux_dict[name][:] = val
    return t_exe, j_exe


def test_resnet_with_batchnorm_matches_jax_executor():
    t_exe, j_exe = _resnet_pair()
    before = {k: v.asnumpy() for k, v in t_exe.aux_dict.items()}
    _compare_executors(t_exe, j_exe, relu=True)
    assert any(not np.array_equal(before[k], v.asnumpy())
               for k, v in t_exe.aux_dict.items())
    # the eval forward folds the moving statistics (fused_conv_bn_act)
    t_exe.forward(is_train=False)
    j_exe.forward(is_train=False)
    np.testing.assert_allclose(t_exe.outputs[0].asnumpy(),
                               j_exe.outputs[0].asnumpy(), **TOL)


def test_backward_after_inference_forward_keeps_aux():
    """JAX executor.py:227-238: the train walk is recomputed for its
    residuals, and its aux updates are dropped."""
    t_exe, _ = _resnet_pair()
    t_exe.forward(is_train=False)
    aux = {k: v.asnumpy() for k, v in t_exe.aux_dict.items()}
    t_exe.backward()
    for k, v in t_exe.aux_dict.items():
        np.testing.assert_array_equal(v.asnumpy(), aux[k], err_msg=k)
    after_eval = {k: v.asnumpy() for k, v in t_exe.grad_dict.items()}
    t_exe.forward(is_train=True)
    t_exe.backward()
    for k, v in t_exe.grad_dict.items():
        np.testing.assert_allclose(v.asnumpy(), after_eval[k], err_msg=k,
                                   **TOL)
    fresh, _ = _resnet_pair()
    with pytest.raises(MXNetError, match="forward first"):
        fresh.backward()


@pytest.mark.parametrize("build", ["lm", "resnet"])
def test_mirror_gives_the_same_gradients(build, monkeypatch):
    make = _lm_pair if build == "lm" else _resnet_pair
    grads = []
    for mirror in ("0", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        exe, _ = make()
        exe.forward(is_train=True)
        exe.backward()
        grads.append({k: v.asnumpy() for k, v in exe.grad_dict.items()})
        grads[-1]["out"] = exe.outputs[0].asnumpy()
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k], grads[0][k], err_msg=k,
                                   **TOL)


def test_monitor_names_and_values_match_jax():
    rng = np.random.RandomState(3)
    vals = {}
    seen = []
    for pkg in (mx, jmx):
        exe = _mlp(pkg).simple_bind(pkg.cpu(), data=(4, 5),
                                    softmax_label=(4,))
        for name, arr in exe.arg_dict.items():
            if name not in vals:
                vals[name] = rng.uniform(-1, 1, arr.shape).astype("f")
            arr[:] = vals[name]
        got = []
        exe.set_monitor_callback(lambda n, a: got.append((n, a.asnumpy())))
        exe.forward(is_train=True)
        seen.append(got)
    (port, jax_) = seen
    assert [n for n, _ in port] == [n for n, _ in jax_]
    assert [n for n, _ in port] == ["fc1_output", "relu1_output",
                                    "fc2_output", "softmax_output"]
    for (n, a), (_, b) in zip(port, jax_):
        np.testing.assert_allclose(a, b, err_msg=n, **TOL)


def test_monitor_object_reports_every_node():
    exe = _mlp_exe("write")
    mon = mx.Monitor(1, pattern=".*")
    mon.install(exe)
    mon.tic()
    exe.forward(is_train=True)
    rows = mon.toc()
    names = [n for _, n, _ in rows]
    assert names[:4] == ["fc1_output", "relu1_output", "fc2_output",
                         "softmax_output"]
    assert set(exe._arg_names) <= set(names)
    # stat: norm / sqrt(size)
    fc1 = exe.arg_dict["fc1_weight"].asnumpy()
    want = np.linalg.norm(fc1) / np.sqrt(fc1.size)
    got = dict((n, v) for _, n, v in rows)["fc1_weight"]
    assert abs(float(got) - want) < 1e-5
    exe.forward(is_train=True)  # not armed: no extra walk
    assert mon.toc() == []


def _attr_net(pkg):
    s = pkg.sym
    with pkg.AttrScope(ctx_group="stage1"):
        data = s.Variable("data", attr={"mood": "calm"})
        fc = s.FullyConnected(data=data, name="fc", num_hidden=3)
    act = s.Activation(data=fc, name="act", act_type="tanh")
    cast = s.Cast(act, dtype="float16", name="cast")
    return s.Group([act, cast, fc])


def test_symbol_surface_matches_jax():
    t, j = _attr_net(mx), _attr_net(jmx)
    assert t.list_outputs() == j.list_outputs()
    assert t.list_arguments() == j.list_arguments()
    assert t.attr_dict() == j.attr_dict()
    assert t[1].attr("ctx_group") == j[1].attr("ctx_group")
    assert t.debug_str() == j.debug_str()
    assert t.infer_type(data="float32") == j.infer_type(data="float32")
    assert t.infer_type() == j.infer_type() == (None, None, None)
    assert t.tojson() == j.tojson()
    assert [s.name for s in t] == [s.name for s in j]
    t[0]._set_attr(lr_mult="2")
    assert t.attr_dict()["act"]["lr_mult"] == "2"
    with pytest.raises(MXNetError):
        t._set_attr(x=1)


def test_composition_copy_and_pickle():
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=data, name="fc", num_hidden=3)
    other = mx.sym.Activation(data=mx.sym.Variable("x"), act_type="relu",
                              name="pre")
    composed = net(data=other, name="fc_c")
    assert composed.list_arguments() == ["x", "fc_weight", "fc_bias"]
    assert composed.name == "fc_c" and net.name == "fc"
    assert net(other).list_arguments()[0] == "x"
    for clone in (copy.copy(net), copy.deepcopy(net),
                  pickle.loads(pickle.dumps(net))):
        assert clone.tojson() == net.tojson() and clone is not net
    with pytest.raises(MXNetError):
        net()
    # the power and max/min operators build the JAX package's nodes
    jnet = jmx.sym.FullyConnected(data=jmx.sym.Variable("data"), name="fc",
                                  num_hidden=3)
    for build in (lambda m, n: n ** 2, lambda m, n: n ** n,
                  lambda m, n: m.sym.pow(n, n), lambda m, n: m.sym.pow(3, n),
                  lambda m, n: m.sym.maximum(n, n),
                  lambda m, n: m.sym.minimum(n, 0.5),
                  lambda m, n: m.sym.maximum(1.5, n)):
        with mx.NameManager(), jmx.name.NameManager():
            assert build(mx, net).tojson() == build(jmx, jnet).tojson()
    assert mx.sym.maximum(2, 3) == 3 and mx.sym.minimum(2, 3) == 2
    with pytest.raises(MXNetError, match="args_grad"):
        net.grad(["data"])


def test_debug_str_reports_memory():
    exe = _mlp_exe("write")
    text = exe.debug_str()
    lines = text.splitlines()
    graph = _mlp(jmx).debug_str().splitlines()
    assert lines[:len(graph)] == graph
    assert "argument" in text and lines[-1].startswith("Total")
    arg_bytes = sum(a.size * 4 for a in exe.arg_arrays)
    assert "%.2f MB" % (arg_bytes / 2.0 ** 20) in text


def test_bucketing_executor_groups_share_params():
    """tests/test_executor.py: one executor group per bucket key with a
    different input shape, all sharing the parameter arrays (a
    sum-of-embeddings classifier built of ported ops)."""
    vocab, embed, classes, batch = 12, 6, 8, 4

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        emb = mx.sym.Embedding(data=data, name="embed", input_dim=vocab,
                               output_dim=embed)
        grid = mx.sym.Reshape(emb, shape=(batch, 1, seq_len, embed))
        bag = mx.sym.Pooling(grid, kernel=(seq_len, 1), pool_type="sum",
                             name="bag")
        fc = mx.sym.FullyConnected(data=mx.sym.Flatten(bag), name="fc",
                                   num_hidden=classes)
        return mx.sym.SoftmaxOutput(data=fc, name="softmax")

    class _Batch:
        def __init__(self, key):
            rng = np.random.RandomState(key)
            self.bucket_key = key
            self.tokens = rng.randint(0, vocab, (batch, key))
            self.data = [mx.nd.array(self.tokens.astype(np.float32))]
            self.label = [mx.nd.array(
                rng.randint(0, classes, (batch,)).astype(np.float32))]
            self.pad = 0
            self.provide_data = [("data", (batch, key))]
            self.provide_label = [("softmax_label", (batch,))]

    class _Iter:
        batch_size = batch
        default_bucket_key = 3
        provide_data = [("data", (batch, 3))]
        provide_label = [("softmax_label", (batch,))]

    sym = sym_gen(3)
    arg_names = sym.list_arguments()
    param_names = [n for n in arg_names
                   if n not in ("data", "softmax_label")]
    mgr = DataParallelExecutorManager(
        sym, [mx.cpu()], _Iter(), arg_names, param_names,
        sym.list_auxiliary_states(), logger=logging, sym_gen=sym_gen)
    rng = np.random.RandomState(0)
    shapes = dict(zip(arg_names, sym.infer_shape(data=(4, 3))[0]))
    arg_params = {n: mx.nd.array(rng.uniform(-0.5, 0.5, shapes[n])
                                 .astype("f")) for n in param_names}
    mgr.set_params(arg_params, {})
    W = arg_params["embed_weight"].asnumpy()
    fcw = arg_params["fc_weight"].asnumpy()
    fcb = arg_params["fc_bias"].asnumpy()
    for key in (3, 5, 7):
        b = _Batch(key)
        mgr.load_data_batch(b)
        mgr.forward(is_train=True)
        mgr.backward()
        got = mgr.curr_execgrp.train_execs[0].outputs[0].asnumpy()
        logits = W[b.tokens].sum(axis=1) @ fcw.T + fcb
        e = np.exp(logits - logits.max(1, keepdims=True))
        np.testing.assert_allclose(got, e / e.sum(1, keepdims=True),
                                   rtol=1e-4, atol=1e-5, err_msg=str(key))
    assert len(mgr.execgrp_bucket) == 3
    exec7 = mgr.execgrp_bucket[7].train_execs[0]
    exec3 = mgr.execgrp_bucket[3].train_execs[0]
    exec7.arg_dict["fc_weight"][:] = 0.0
    exec7.arg_dict["fc_bias"][:] = 0.0
    np.testing.assert_array_equal(exec3.arg_dict["fc_weight"].asnumpy(), 0)
    mgr.load_data_batch(_Batch(3))
    mgr.forward(is_train=False)
    np.testing.assert_allclose(
        mgr.curr_execgrp.train_execs[0].outputs[0].asnumpy(),
        1.0 / classes, atol=1e-6)
    with pytest.raises(NotImplementedError):
        mgr.install_monitor(mx.Monitor(1))


def test_bind_checks_shapes_and_allocates_aux():
    net = get_resnet_cifar(num_classes=5, n=1, image_hw=8)
    shapes, _, aux_shapes = net.infer_shape(data=(2, 3, 8, 8),
                                            softmax_label=(2,))
    args = [mx.nd.zeros(s) for s in shapes]
    exe = net.bind(mx.cpu(), args)
    assert [a.shape for a in exe.aux_arrays] == [tuple(s)
                                                 for s in aux_shapes]
    assert all(g is None for g in exe.grad_arrays)
    args[0] = mx.nd.zeros((2, 3, 9, 9))
    with pytest.raises(MXNetError):
        net.bind(mx.cpu(), args)
    with pytest.raises(MXNetError, match="expected"):
        net.bind(mx.cpu(), args[:2])
    exe.copy_params_from({"stem_conv_weight": np.ones(shapes[1], "f")},
                         allow_extra_params=True)
    assert exe.arg_dict["stem_conv_weight"].asnumpy().min() == 1
    with pytest.raises(MXNetError, match="unknown arg"):
        exe.copy_params_from({"nope": mx.nd.zeros((1,))})


def test_executor_outputs_follow_infer_type():
    data = mx.sym.Variable("data")
    net = mx.sym.Cast(mx.sym.FullyConnected(data, num_hidden=2, name="f"),
                      dtype="float16")
    exe = net.simple_bind(mx.cpu(), data=(3, 4))
    assert exe.outputs[0].dtype == np.float16
    exe.forward()
    assert exe.outputs[0].asnumpy().dtype == np.float16
    assert torch.is_tensor(exe.outputs[0]._tensor)
