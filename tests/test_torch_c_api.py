"""The port's two native C ABIs on the CPU: ``capi.build`` compiles
``libmxnet_tpu_torch_predict.so`` and ``libmxnet_tpu_torch_capi.so`` with
``g++`` (cached under ``build/capi/``), and the example clients against
them. The port's C predict client runs with dev_type 1 (the host) and is
held to the JAX package's ``Predictor`` on the same files (1e-5; the
client prints 9 significant digits); the C training program reaches
accuracy > 0.9 through the graph ABI alone; ``MXDataIter`` over an
iterator handle the C ABI created yields ``CSVIter``'s batches exactly.
Each subprocess has its own timeout.
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import predict as jpredict

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import capi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env.pop("MXNET_TPU_PREDICT_NUMPY", None)
    return env


@pytest.fixture(scope="module")
def built():
    return {name: capi.build_example(name) for name in capi.EXAMPLES}


def _convnet_checkpoint(tmp_path, b=4):
    s = jmx.symbol
    net = s.Convolution(data=s.Variable("data"), num_filter=8,
                        kernel=(3, 3), pad=(1, 1), name="conv1")
    net = s.BatchNorm(data=net, name="bn1")
    net = s.Activation(data=net, act_type="relu", name="relu1")
    net = s.FullyConnected(data=s.Flatten(data=net, name="flat"),
                           num_hidden=5, name="fc1")
    sym = s.SoftmaxOutput(data=net, name="softmax")
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(b, 3, 6, 6))
    rs = np.random.RandomState(8)
    args = {n: jmx.nd.array((0.3 * rs.randn(*sh)).astype(np.float32))
            for n, sh in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: jmx.nd.array((np.abs(rs.randn(*sh)) + 0.5).astype(np.float32))
           for n, sh in zip(sym.list_auxiliary_states(), aux_shapes)}
    prefix = str(tmp_path / "net")
    jmx.model.save_checkpoint(prefix, 1, sym, args, aux)
    return prefix, rs.randn(b, 3, 6, 6).astype(np.float32)


def test_libraries_build_once_into_build_capi(built):
    for name, (out_name, _) in capi.LIBRARIES.items():
        path = capi.build(name)
        assert path.startswith(os.path.join(ROOT, "build", "capi"))
        assert os.path.basename(path) == out_name
        assert capi.build(name) == path  # cached by the sources' hash
    from mxnet_tpu_torch import libinfo
    assert libinfo.find_lib_path()[0] == capi.build("graph")
    assert libinfo.get_lib() is not None


@pytest.mark.parametrize("numpy_path", [False, True],
                         ids=["port", "amalgamation"])
def test_c_predict_client_matches_jax_predictor(built, tmp_path,
                                                numpy_path):
    """The client over the port's Predictor, and over the numpy-only
    amalgamation interpreter (``MXNET_TPU_PREDICT_NUMPY=1``)."""
    prefix, x = _convnet_checkpoint(tmp_path)
    want = jpredict.Predictor(prefix + "-symbol.json",
                              prefix + "-0001.params", {"data": x.shape})
    want = want.forward(data=x).get_output(0)
    r = subprocess.run(
        [built["predict_example"], prefix + "-symbol.json",
         prefix + "-0001.params", "1", "0"] + [str(d) for d in x.shape],
        input=x.astype("<f4").tobytes(), capture_output=True,
        env=dict(_env(), **({"MXNET_TPU_PREDICT_NUMPY": "1"}
                            if numpy_path else {})),
        timeout=180, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    got = np.array(r.stdout.split(), dtype=np.float32).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert b"forward_ms" in r.stderr


def test_c_predict_partial_out_in_process(built, tmp_path):
    """MXTPredCreatePartialOut through ctypes in this process (the
    library finds the interpreter already up and only takes the GIL)."""
    prefix, x = _convnet_checkpoint(tmp_path)
    lib = ctypes.CDLL(capi.build("predict"))
    lib.MXTPredGetLastError.restype = ctypes.c_char_p
    sym_json = open(prefix + "-symbol.json").read().encode()
    params = open(prefix + "-0001.params", "rb").read()
    u = ctypes.c_uint
    keys = (ctypes.c_char_p * 1)(b"data")
    indptr = (u * 2)(0, 4)
    shape = (u * 4)(*x.shape)
    outs = (ctypes.c_char_p * 1)(b"relu1")
    h = ctypes.c_void_p()
    assert lib.MXTPredCreatePartialOut(
        sym_json, params, len(params), 1, 0, 1, keys, indptr, shape, 1,
        outs, ctypes.byref(h)) == 0, lib.MXTPredGetLastError()
    data = np.ascontiguousarray(x, np.float32)
    assert lib.MXTPredSetInput(h, b"data", data.ctypes.data_as(
        ctypes.c_void_p), u(data.size)) == 0
    assert lib.MXTPredForward(h) == 0, lib.MXTPredGetLastError()
    pshape, ndim = ctypes.POINTER(u)(), u()
    assert lib.MXTPredGetOutputShape(h, 0, ctypes.byref(pshape),
                                     ctypes.byref(ndim)) == 0
    oshape = tuple(pshape[i] for i in range(ndim.value))
    assert oshape == (4, 8, 6, 6)
    out = np.empty(oshape, np.float32)
    assert lib.MXTPredGetOutput(h, 0, out.ctypes.data_as(ctypes.c_void_p),
                                u(out.size)) == 0
    want = jpredict.Predictor(prefix + "-symbol.json",
                              prefix + "-0001.params", {"data": x.shape},
                              output_names=["relu1"])
    np.testing.assert_allclose(out, want.forward(data=x).get_output(0),
                               rtol=1e-5, atol=1e-5)
    assert lib.MXTPredFree(h) == 0


def test_c_training_program_reaches_090(built, tmp_path):
    r = subprocess.run([built["train_c"], "1", "0"], capture_output=True,
                       text=True, env=dict(_env(), TMPDIR=str(tmp_path)),
                       timeout=240, cwd=str(tmp_path))
    assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    assert "C-ABI training OK" in r.stdout
    acc = float(r.stdout.split("accuracy")[-1])
    assert acc > 0.9


def test_capi_example(built, tmp_path):
    r = subprocess.run([built["capi_example"], "1"], capture_output=True,
                       text=True, env=_env(), timeout=180,
                       cwd=str(tmp_path))
    assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    assert "capi_example OK" in r.stdout


def test_mxdataiter_over_a_c_created_csv_handle(built, tmp_path):
    rs = np.random.RandomState(9)
    x = rs.randn(23, 5).astype(np.float32)
    y = rs.randint(0, 3, 23).astype(np.float32)
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, x, delimiter=",", fmt="%.7g")
    np.savetxt(lpath, y, delimiter=",", fmt="%d")
    lib = ctypes.CDLL(capi.build("graph"))
    lib.MXTApiGetLastError.restype = ctypes.c_char_p
    n = ctypes.c_uint()
    creators = ctypes.POINTER(ctypes.c_void_p)()
    assert lib.MXTListDataIters(ctypes.byref(n), ctypes.byref(creators)) \
        == 0
    csv = None
    for i in range(n.value):
        name, desc = ctypes.c_char_p(), ctypes.c_char_p()
        na = ctypes.c_uint()
        an, at, ad = (ctypes.POINTER(ctypes.c_char_p)() for _ in range(3))
        assert lib.MXTDataIterGetIterInfo(
            ctypes.c_void_p(creators[i]), ctypes.byref(name),
            ctypes.byref(desc), ctypes.byref(na), ctypes.byref(an),
            ctypes.byref(at), ctypes.byref(ad)) == 0
        if name.value == b"CSVIter":
            csv = creators[i]
    assert csv is not None
    keys = [b"data_csv", b"data_shape", b"label_csv", b"batch_size"]
    vals = [dpath.encode(), b"(5,)", lpath.encode(), b"4"]
    h = ctypes.c_void_p()
    assert lib.MXTDataIterCreateIter(
        ctypes.c_void_p(csv), 4, (ctypes.c_char_p * 4)(*keys),
        (ctypes.c_char_p * 4)(*vals), ctypes.byref(h)) == 0, \
        lib.MXTApiGetLastError()
    got = mx.io.MXDataIter(h.value)
    want = mx.io.CSVIter(data_csv=dpath, data_shape=(5,), label_csv=lpath,
                         batch_size=4)
    assert got.batch_size == 4
    nb = 0
    for bg, bw in zip(got, want):
        np.testing.assert_array_equal(bg.data[0].asnumpy(),
                                      bw.data[0].asnumpy())
        np.testing.assert_array_equal(bg.label[0].asnumpy(),
                                      bw.label[0].asnumpy())
        assert bg.pad == bw.pad
        nb += 1
    assert nb == 6
