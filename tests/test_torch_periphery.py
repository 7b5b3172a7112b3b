"""The port's periphery against the JAX package on the CPU, at small
sizes: ``Predictor`` (full, partial out, integer inputs; 1e-5), the
visualization text (byte-equal), ``misc``, the custom operators
(``NumpyOp``, ``TorchModuleOp``; forward and backward within 1e-5),
``serving.quant.weight_nbytes`` (equal), the profiler (trace, step
stats, ``compiled_stats``, the program-cost registry and a 1-layer LM's
program flops against the hand count, exact), ``torch`` interop, and
``Rtc`` (its generated source; it raises on the CPU).
"""
import io
import json
import os
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import misc as jmisc
from mxnet_tpu import predict as jpredict
from mxnet_tpu import visualization as jviz
from mxnet_tpu.models import get_symbol as jget_symbol
from mxnet_tpu.serving import quant as jquant

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import misc as tmisc
from mxnet_tpu_torch import predict as tpredict
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch import visualization as tviz
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_symbol as tget_symbol
from mxnet_tpu_torch.serving import quant as tquant

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _convnet(pkg):
    s = pkg.symbol
    net = s.Variable("data")
    net = s.Convolution(data=net, num_filter=8, kernel=(3, 3), pad=(1, 1),
                        name="conv1")
    net = s.BatchNorm(data=net, name="bn1")
    net = s.Activation(data=net, act_type="relu", name="relu1")
    net = s.Pooling(data=net, pool_type="max", kernel=(2, 2),
                    stride=(2, 2), name="pool1")
    net = s.Flatten(data=net, name="flat")
    net = s.FullyConnected(data=net, num_hidden=5, name="fc1")
    return s.SoftmaxOutput(data=net, name="softmax")


def _save_convnet(tmp_path, b=4):
    """A small conv net's checkpoint written by the JAX package (both
    packages read the format): symbol JSON and params."""
    sym = _convnet(jmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(b, 3, 8, 8))
    rs = np.random.RandomState(0)
    args = {n: jmx.nd.array((0.3 * rs.randn(*s)).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: jmx.nd.array((np.abs(rs.randn(*s)) + 0.5).astype(np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    prefix = str(tmp_path / "net")
    jmx.model.save_checkpoint(prefix, 1, sym, args, aux)
    return prefix, rs.randn(b, 3, 8, 8).astype(np.float32)


def test_predictor_matches_jax(tmp_path):
    prefix, x = _save_convnet(tmp_path)
    sym_file, params = prefix + "-symbol.json", prefix + "-0001.params"
    shapes = {"data": x.shape}
    want = jpredict.Predictor(sym_file, params, shapes)
    got = tpredict.Predictor(sym_file, params, shapes, dev_type="cpu")
    assert got.num_outputs == want.num_outputs == 1
    np.testing.assert_allclose(got.forward(data=x).get_output(0),
                               want.forward(data=x).get_output(0), **TOL)
    # the bytes of the params file and a loaded dict give the same
    with open(params, "rb") as f:
        blob = f.read()
    for data in (blob, mx.nd.load(params)):
        again = tpredict.Predictor(open(sym_file).read(), data, shapes,
                                   dev_type=1)
        np.testing.assert_array_equal(again.forward(data=x).get_output(0),
                                      got.get_output(0))


def test_predictor_partial_out_matches_jax(tmp_path):
    prefix, x = _save_convnet(tmp_path)
    args = (prefix + "-symbol.json", prefix + "-0001.params",
            {"data": x.shape})
    want = jpredict.Predictor(*args, output_names=["relu1", "fc1_output"])
    got = tpredict.Predictor(*args, dev_type="cpu",
                             output_names=["relu1", "fc1_output"])
    got.forward(data=x)
    want.forward(data=x)
    assert got.get_output(0).shape == (4, 8, 8, 8)
    for i in range(2):
        np.testing.assert_allclose(got.get_output(i), want.get_output(i),
                                   **TOL)
    with pytest.raises(MXNetError, match="unknown output"):
        tpredict.Predictor(*args, dev_type="cpu", output_names=["nope"])


def test_predictor_integer_inputs_match_jax(tmp_path):
    """Token ids into an Embedding keep their integer dtype (ids above
    2^24 would not survive an f32 cast)."""
    def net(pkg):
        s = pkg.symbol
        e = s.Embedding(data=s.Variable("data"), input_dim=50, output_dim=6,
                        name="emb")
        return s.FullyConnected(data=s.Flatten(data=e), num_hidden=3,
                                name="fc")
    sym = net(jmx)
    rs = np.random.RandomState(1)
    arg_shapes, _, _ = sym.infer_shape(data=(2, 5))
    args = {n: jmx.nd.array(rs.randn(*s).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes) if n != "data"}
    prefix = str(tmp_path / "emb")
    jmx.model.save_checkpoint(prefix, 1, sym, args, {})
    ids = rs.randint(0, 50, (2, 5)).astype(np.int32)
    a = (prefix + "-symbol.json", prefix + "-0001.params", {"data": (2, 5)})
    got = tpredict.Predictor(*a, dev_type="cpu")
    assert "data" in got._integer_inputs
    np.testing.assert_allclose(
        got.forward(data=ids).get_output(0),
        jpredict.Predictor(*a).forward(data=ids).get_output(0), **TOL)


def test_predictor_default_is_the_card():
    with pytest.raises(MXNetError, match="CUDA"):
        tpredict._predict_device("gpu", 0)
    assert tpredict._predict_device(1, 0).type == "cpu"
    with pytest.raises(MXNetError, match="dev_type"):
        tpredict._predict_device("tpu", 0)


@pytest.mark.parametrize("name,kw,shape", [
    ("resnet", {"num_classes": 1000, "num_layers": 50},
     (1, 3, 224, 224)),
    ("inception-bn", {"num_classes": 1000}, (1, 3, 224, 224))])
def test_visualization_text_is_jax_byte_for_byte(name, kw, shape):
    # fresh name counters: the unnamed nodes' names do not depend on what
    # other tests built before
    with mx.NameManager():
        got = tget_symbol(name, **kw)
    with jmx.NameManager():
        want = jget_symbol(name, **kw)
    assert tviz.network_dot(got, title=name) == \
        jviz.network_dot(want, title=name)
    assert tviz.network_dot(got, shape={"data": shape}) == \
        jviz.network_dot(want, shape={"data": shape})
    assert getattr(tviz.plot_network(got), "source", None) == \
        getattr(jviz.plot_network(want), "source", None)
    outs = []
    for viz, s in ((tviz, got), (jviz, want)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            total = viz.print_summary(s, shape={"data": shape})
        outs.append((buf.getvalue(), total))
    assert outs[0] == outs[1]
    assert mx.viz is tviz


def test_misc_factor_scheduler_matches_jax():
    got, want = tmisc.FactorScheduler(3, 0.5), jmisc.FactorScheduler(3, 0.5)
    got.base_lr = want.base_lr = 0.2
    assert [got(i) for i in range(12)] == [want(i) for i in range(12)]
    for pkg in (tmisc, jmisc):
        with pytest.raises(ValueError):
            pkg.FactorScheduler(0)
        with pytest.raises(ValueError):
            pkg.FactorScheduler(2, factor=1.5)
        with pytest.raises(NotImplementedError):
            pkg.LearningRateScheduler()(1)


def _numpy_softmax(pkg):
    class Softmax(pkg.operator.NumpyOp):
        def __init__(self):
            super().__init__(False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            y = np.exp(x - x.max(axis=1, keepdims=True))
            out_data[0][:] = y / y.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            label = in_data[1].astype(int)
            dx = out_data[0].copy()
            dx[np.arange(label.shape[0]), label] -= 1.0
            in_grad[0][:] = dx
    return Softmax()


def _bind_run(pkg, sym, vals, out_grads=None):
    exe = sym.simple_bind(pkg.cpu(), **{k: v.shape for k, v in vals.items()})
    for k, v in vals.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward([pkg.nd.array(g) for g in out_grads] if out_grads else None)
    return ([o.asnumpy() for o in exe.outputs],
            {k: g.asnumpy() for k, g in exe.grad_dict.items()
             if g is not None})


def test_numpy_op_forward_backward_match_jax():
    rs = np.random.RandomState(2)
    vals = {"data": rs.randn(6, 4).astype(np.float32),
            "fc_weight": rs.randn(3, 4).astype(np.float32),
            "fc_bias": rs.randn(3).astype(np.float32),
            "sm_label": np.array([0, 2, 1, 1, 0, 2], np.float32)}
    res = []
    for pkg in (mx, jmx):
        s = pkg.symbol
        fc = s.FullyConnected(data=s.Variable("data"), num_hidden=3,
                              name="fc")
        net = _numpy_softmax(pkg)(data=fc, name="sm")
        res.append(_bind_run(pkg, net, vals))
    (go, gg), (wo, wg) = res
    np.testing.assert_allclose(go[0], wo[0], **TOL)
    for k in ("data", "fc_weight", "fc_bias"):
        np.testing.assert_allclose(gg[k], wg[k], err_msg=k, **TOL)
    # a host op makes the graph uncaptured
    from mxnet_tpu_torch.parallel.graph import has_host_ops
    s = mx.symbol
    fc = s.FullyConnected(data=s.Variable("data"), num_hidden=3, name="fc")
    assert has_host_ops(_numpy_softmax(mx)(data=fc, name="sm"))
    assert not has_host_ops(fc)


def _numpy_identity(pkg):
    class Identity(pkg.operator.NumpyOp):
        def __init__(self):
            super().__init__(False)

        def infer_shape(self, in_shape):
            return [in_shape[0]], [in_shape[0]]

        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0]

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0]
    return Identity()


def test_serving_refuses_a_graph_with_a_host_op():
    """The serving engine never holds a host op: the Decoder it serves
    refuses an LM with one by name at its build, before any program
    exists (no capture is tried), as the JAX package's Decoder does."""
    from mxnet_tpu.parallel.decode import Decoder as JDecoder
    from mxnet_tpu_torch.parallel.decode import Decoder
    from mxnet_tpu_torch.parallel.graph import has_host_ops
    msgs = []
    for pkg, dec, kw in ((mx, Decoder, {"device": "cpu"}),
                         (jmx, JDecoder, {})):
        s = pkg.symbol
        net = s.Embedding(data=s.Variable("data"), input_dim=11,
                          output_dim=8, name="embed")
        net = _numpy_identity(pkg)(data=net, name="host_id")
        net = s.FullyConnected(data=net, num_hidden=11, name="head")
        if pkg is mx:
            assert has_host_ops(net)
        with pytest.raises(Exception, match="host_id") as err:
            dec(net, {}, 16, **kw)
        msgs.append(str(err.value))
    assert all("not known to be position-wise" in m for m in msgs), msgs


def test_torch_module_op_forward_backward_match_jax():
    torch.manual_seed(4)
    lin = torch.nn.Linear(4, 3)
    rs = np.random.RandomState(4)
    x = rs.randn(5, 4).astype(np.float32)
    head = rs.randn(5, 3).astype(np.float32)
    res = []
    for pkg in (mx, jmx):
        op = pkg.th.TorchModuleOp(lin)
        net = op(data=pkg.symbol.Variable("data"), name="lin")
        res.append(_bind_run(pkg, net, {"data": x}, [head]))
    (go, gg), (wo, wg) = res
    np.testing.assert_allclose(go[0], wo[0], **TOL)
    np.testing.assert_allclose(gg["data"], wg["data"], **TOL)
    want = torch.nn.functional.linear(torch.from_numpy(x), lin.weight,
                                      lin.bias)
    np.testing.assert_allclose(go[0], want.detach().numpy(), **TOL)
    np.testing.assert_allclose(gg["data"],
                               head @ lin.weight.detach().numpy(), **TOL)
    assert lin.weight.grad is None  # the module's parameters are frozen


def test_torch_interop_copies():
    a = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    t = mx.th.to_torch(a)
    t += 1
    np.testing.assert_array_equal(a.asnumpy(),
                                  np.arange(6).reshape(2, 3))  # a copy
    assert t.device == a._tensor.device
    b = mx.th.from_torch(t)
    t += 1
    np.testing.assert_array_equal(b.asnumpy(),
                                  np.arange(6).reshape(2, 3) + 1)
    outs = mx.th.th_function(lambda t: torch.split(t, 1), a)
    assert [o.shape for o in outs] == [(1, 3), (1, 3)]
    j = jmx.th.to_torch(jmx.nd.array(a.asnumpy()))
    np.testing.assert_array_equal(mx.th.to_torch(a).numpy(), j.numpy())


def _quant_params(pkg, rs):
    w = rs.randn(16, 32).astype(np.float32)
    e = rs.randn(10, 32).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    if pkg is tquant:
        params = {k: torch.from_numpy(v) for k, v in
                  (("w", w), ("emb", e), ("b", b))}
    else:
        import jax.numpy as jnp
        params = {k: jnp.asarray(v) for k, v in
                  (("w", w), ("emb", e), ("b", b))}
    return params


@pytest.mark.parametrize("bits,group", [(8, None), (4, 16)])
def test_weight_nbytes_equal_jax(bits, group):
    got = _quant_params(tquant, np.random.RandomState(6))
    want = _quant_params(jquant, np.random.RandomState(6))
    assert tquant.weight_nbytes(got) == jquant.weight_nbytes(want)
    qg = tquant.quantize_params(got, ["w"], bits=bits, group=group,
                                row_quant=["emb"])
    qw = jquant.quantize_params(want, ["w"], bits=bits, group=group,
                                row_quant=["emb"])
    assert tquant.weight_nbytes(qg) == jquant.weight_nbytes(qw)
    assert tquant.weight_nbytes(qg) < tquant.weight_nbytes(got)


def test_profiler_trace_names_the_scope(tmp_path):
    profiler.start(str(tmp_path))
    with profiler.scope("periphery-scope"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = profiler.stop()
    assert profiler.stop() is None
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "periphery-scope" in names
    with pytest.raises(ValueError):
        profiler._state["dir"] = None
        profiler.start()


def test_profiler_step_stats_and_chain():
    profiler.reset_step_stats()
    assert profiler.get_step_stats()["count"] == 0
    for _ in range(4):
        with profiler.record_step():
            pass
    st = profiler.get_step_stats()
    assert st["count"] == 4 and set(st) == {"count", "mean_ms", "p50_ms",
                                             "p99_ms", "total_s"}
    dt, spread = profiler.benchmark_chain(lambda s: s * 1.0001,
                                          torch.ones(256), steps=3, reps=2)
    assert dt > 0 and spread >= 0
    snap = pickle_loads(profiler.device_memory_profile())
    assert set(snap) >= {"segments", "device_traces"}
    assert profiler.device_memory() == {}  # no card touched here


def pickle_loads(b):
    import pickle
    return pickle.loads(b)


def test_compiled_stats_of_an_executor():
    s = mx.symbol
    fc = s.FullyConnected(data=s.Variable("data"), num_hidden=7, name="fc")
    exe = fc.simple_bind(mx.cpu(), data=(5, 11))
    st = profiler.compiled_stats(exe)
    assert set(st) == {"flops", "bytes_accessed", "argument_size_in_bytes",
                       "output_size_in_bytes"}
    assert st["flops"] == 2 * 5 * 11 * 7
    assert st["argument_size_in_bytes"] == 4 * (5 * 11 + 7 * 11 + 7)
    assert st["output_size_in_bytes"] == 4 * 5 * 7
    assert st["bytes_accessed"] > st["output_size_in_bytes"]
    st = profiler.compiled_stats(lambda: torch.ones(3, 4) @ torch.ones(4, 5))
    assert st["flops"] == 2 * 3 * 4 * 5
    assert not profiler.collecting()


def test_register_program_and_collect():
    a = torch.ones(8, 16)

    def fn(x):
        return x @ x.t()

    profiler.register_program("periphery_eager", fn, (a,))
    assert "periphery_eager" in profiler.registered_programs()
    assert mx.telemetry.gauge("program.periphery_eager.flops").value \
        == 2 * 8 * 16 * 8
    profiler.register_program("periphery_lazy", fn, (a,), eager=False)
    out = profiler.collect_program_stats()
    assert out["periphery_lazy"]["flops"] == 2 * 8 * 16 * 8
    assert "periphery_lazy" not in profiler.collect_program_stats()


def test_lm_decode_program_flops_equal_the_hand_count():
    """A 1-layer LM's decode program, counted at its first run: every
    product of the round (q/k/v/o projections, the FFN, the LM head) is
    2 * slots * weights, and the paged read 4 * slots * heads * rows *
    head_dim, where the plain read on the CPU takes the rows up to the
    furthest slot's position (the prompt's 3 and the token decoded: 4;
    the kernel's count on the card takes every cached row)."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel.decode import Decoder
    from mxnet_tpu_torch.serving import InferenceEngine
    V, E, H, L, S = 29, 16, 2, 32, 3
    sym = get_transformer_lm(V, num_layers=1, embed_dim=E, num_heads=H)
    shapes = {"data": (1, L), "softmax_label": (1, L)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(0)
    params = {n: (0.2 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in shapes}
    dec = Decoder(sym, params, L, device="cpu")
    eng = InferenceEngine(dec, slots=S, prefill_buckets=(8,),
                          prefix_cache_mb=0, prefill_chunk=0)
    eng.serve_forever([([1, 2, 3], {"max_tokens": 3})])
    got = mx.telemetry.gauge("program.serving_decode.flops").value
    mats = sum(int(np.prod(v.shape)) for k, v in params.items()
               if k.endswith("weight") and len(v.shape) == 2
               and "embed" not in k)
    want = 2 * S * mats + 4 * S * H * 4 * (E // H)
    assert got == want, (got, want, sorted(params))
    assert mx.telemetry.gauge(
        "program.serving_decode.bytes_accessed").value > 0
    assert "serving_decode" in profiler.registered_programs()
    eng.close()


def test_rtc_source_and_cpu_refusal():
    x = mx.nd.ones((4, 3))
    y = mx.nd.zeros((4, 3))
    k = rtc.Rtc("axpy", [("x", x)], [("y", y)],
                "y[threadIdx.x] += 2.0f * x[threadIdx.x];")
    assert k.source == (
        '\nextern "C" __global__ void axpy(const float* x,float* y) {\n'
        "const int x_ndim = 2;\nconst int x_dims[] = {4,3};\n"
        "const int y_ndim = 2;\nconst int y_dims[] = {4,3};\n"
        "y[threadIdx.x] += 2.0f * x[threadIdx.x];\n}\n")
    with pytest.raises(MXNetError, match="runs on the card"):
        k.push([x], [y], (1, 1, 1), (12, 1, 1))
    with pytest.raises(MXNetError, match="takes 1 inputs"):
        k.push([x, x], [y], (1, 1, 1), (12, 1, 1))
    assert rtc.LAUNCHES.get("axpy", 0) == 0
    assert not hasattr(rtc, "PallasOp")
