"""The port's imperative NDArray and ``mx.random`` against the JAX
package's: the cases of ``tests/test_ndarray.py`` and
``tests/test_random.py`` run in both packages from the same numpy inputs,
on the CPU. Arithmetic is held at rtol 1e-6 (f32) and exactly for
integers, ``dot`` and ``norm`` at 1e-5; ``.params`` files written by one
package load in the other, byte-identical both ways. Sampled values
cannot match JAX's key splits, so the draws are held by reproducibility
and moments.
"""
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

ALL_TYPES = [np.float32, np.float64, np.float16, np.uint8, np.int32]
REAL_TYPES = [np.float32, np.float64, np.float16]


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _tol(dtype):
    if np.dtype(dtype).kind in "iu":
        return dict(rtol=0, atol=0)
    if dtype == np.float16:
        return dict(rtol=1e-3, atol=1e-3)
    return dict(rtol=1e-6, atol=1e-6)


def _pair(npy, dtype=None):
    return mx.nd.array(npy, dtype=dtype), jmx.nd.array(npy, dtype=dtype)


def _same(port, jax_arr, **tol):
    got, want = port.asnumpy(), jax_arr.asnumpy()
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), **tol)


BINOPS = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
          "mul": lambda x, y: x * y, "div": lambda x, y: x / y}


# the reference divides real types only
BINOP_CASES = [(op, t) for op in sorted(BINOPS) for t in ALL_TYPES
               if op != "div" or t in REAL_TYPES]


@pytest.mark.parametrize("op,dtype", BINOP_CASES,
                         ids=["%s-%s" % (op, np.dtype(t).name)
                              for op, t in BINOP_CASES])
def test_elementwise_binops_match_jax(op, dtype):
    rng = np.random.RandomState(0)
    for dim in (1, 2, 3):
        shape = tuple(rng.randint(1, 9, size=dim))
        a = rng.uniform(-10, 10, shape).astype(dtype)
        b = rng.uniform(-10, 10, shape).astype(dtype)
        (pa, ja), (pb, jb) = _pair(a, dtype), _pair(b, dtype)
        _same(BINOPS[op](pa, pb), BINOPS[op](ja, jb), **_tol(dtype))
        # scalars, reflected forms
        _same(BINOPS[op](pa, 3), BINOPS[op](ja, 3), **_tol(dtype))
        _same(BINOPS[op](2, pb), BINOPS[op](2, jb), **_tol(dtype))


UNARY = ["sqrt", "rsqrt", "square", "exp", "log", "sign", "cos", "sin",
         "ceil", "floor", "round", "abs", "negative"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_functions_match_jax(name):
    rng = np.random.RandomState(1)
    lo = 0.1 if name in ("sqrt", "rsqrt", "log") else -10
    x = rng.uniform(lo, 10, (7, 5)).astype(np.float32)
    px, jx = _pair(x)
    _same(getattr(mx.nd, name)(px), getattr(jmx.nd, name)(jx),
          rtol=1e-6, atol=1e-6)
    out = mx.nd.zeros((7, 5))
    assert getattr(mx.nd, name)(px, out=out) is out
    _same(out, getattr(jmx.nd, name)(jx), rtol=1e-6, atol=1e-6)


def test_reductions_and_layout_functions_match_jax():
    rng = np.random.RandomState(2)
    x = rng.uniform(-10, 10, (6, 4, 3)).astype(np.float32)
    px, jx = _pair(x)
    for name in ("sum", "max", "min"):
        _same(getattr(mx.nd, name)(px), getattr(jmx.nd, name)(jx),
              rtol=1e-6, atol=1e-5)
    _same(mx.nd.norm(px), jmx.nd.norm(jx), rtol=1e-5)
    _same(mx.nd.transpose(px), jmx.nd.transpose(jx))
    _same(mx.nd.transpose(px, (1, 0, 2)), jmx.nd.transpose(jx, (1, 0, 2)))
    _same(px.T, jx.T)
    _same(mx.nd.argmax_channel(px), jmx.nd.argmax_channel(jx))
    _same(mx.nd.maximum(px, 1.5), jmx.nd.maximum(jx, 1.5))
    _same(mx.nd.minimum(px, px * 0.5), jmx.nd.minimum(jx, jx * 0.5))
    _same(mx.nd.clip(px, -2, 2), jmx.nd.clip(jx, -2, 2))
    _same(mx.nd.concatenate([px, px * 2]),
          jmx.nd.concatenate([jx, jx * 2]))
    _same(mx.nd.concatenate([px, px], axis=1),
          jmx.nd.concatenate([jx, jx], axis=1))
    _same(px ** 2, jx ** 2, rtol=1e-6)


def test_dot_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.uniform(-3, 3, (3, 4)).astype(np.float32)
    b = rng.uniform(-3, 3, (4, 5)).astype(np.float32)
    (pa, ja), (pb, jb) = _pair(a), _pair(b)
    _same(mx.nd.dot(pa, pb), jmx.nd.dot(ja, jb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mx.nd.dot(pa, pb).asnumpy(), a @ b,
                               rtol=1e-5, atol=1e-5)


def test_negate_is_not_in_place():
    npy = np.random.RandomState(4).uniform(-10, 10, (2, 3, 4))
    arr, jarr = _pair(npy)
    _same(-arr, -jarr)
    np.testing.assert_array_equal(arr.asnumpy(), npy)


def test_choose_fill_and_onehot_match_jax():
    shape = (100, 20)
    npy = np.arange(np.prod(shape)).reshape(shape)
    arr, jarr = _pair(npy)
    rng = np.random.RandomState(5)
    for _ in range(3):
        idx = rng.randint(shape[1], size=shape[0])
        val = rng.randint(shape[1], size=shape[0])
        (pi, ji), (pv, jv) = _pair(idx), _pair(val)
        _same(mx.nd.choose_element_0index(arr, pi),
              jmx.nd.choose_element_0index(jarr, ji))
        _same(mx.nd.fill_element_0index(arr, pv, pi),
              jmx.nd.fill_element_0index(jarr, jv, ji))
        pout, jout = _pair(np.zeros(shape, np.float32))
        mx.nd.onehot_encode(pi, out=pout)
        jmx.nd.onehot_encode(ji, out=jout)
        _same(pout, jout)


def test_scalar_and_in_place_arithmetic_match_jax():
    results = []
    for nd in (mx.nd, jmx.nd):
        c, d = nd.empty((10, 10)), nd.empty((10, 10))
        c[:] = 0.5
        d[:] = 1.0
        d -= c * 2 / 3 * 6.0
        c += 0.5
        e = -c + 2
        e *= 3
        e /= 4
        results.append((c.asnumpy(), d.asnumpy(), e.asnumpy()))
    for got, want in zip(*results):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.sum(results[0][0]) == 100 and np.sum(results[0][1]) == -100


def test_copy_astype_and_context():
    c = mx.nd.array(np.random.RandomState(6).uniform(-10, 10, (10, 10)))
    d = c.copyto(mx.Context("cpu", 0))
    np.testing.assert_array_equal(c.asnumpy(), d.asnumpy())
    d[:] = 0
    assert c.asnumpy().any()  # a copy, not a view
    assert c.as_in_context(mx.cpu()) is c
    e = c.copyto(mx.cpu(1))
    assert e.context == mx.cpu(1) and e.context != c.context
    assert c.astype(np.int32).dtype == np.int32
    assert c.astype("bfloat16").dtype == torch.bfloat16
    assert mx.nd.array([3.5]).asscalar() == 3.5
    with pytest.raises(MXNetError):
        c.asscalar()
    with pytest.raises(MXNetError):
        c.copyto(mx.nd.zeros((3, 3)))


def test_slice_and_reshape_are_views():
    """tests/test_ndarray.py::test_ndarray_slice_view_mutation: slices and
    reshapes share storage, and every write reaches the parent."""
    for nd in (mx.nd, jmx.nd):
        A = nd.zeros((6, 4))
        v = A[2:4]
        v[:] = 7.0
        out = A.asnumpy()
        np.testing.assert_array_equal(out[2:4], np.full((2, 4), 7.0))
        np.testing.assert_array_equal(out[:2], np.zeros((2, 4)))
        r = A.reshape((4, 6))
        r[:] = 1.0
        np.testing.assert_array_equal(A.asnumpy(), np.ones((6, 4)))
        row = A[1]
        row += 2.0
        A[5] = np.arange(4)
        B = A.slice(3, 6)
        B[1:2] = 9.0
        assert A.asnumpy()[1].tolist() == [3.0] * 4
        assert A.asnumpy()[5].tolist() == [0.0, 1.0, 2.0, 3.0]
        assert A.asnumpy()[4].tolist() == [9.0] * 4
    a = mx.nd.zeros((4, 2))
    assert a[1:3]._tensor.data_ptr() == a._tensor.data_ptr() \
        + 2 * a._tensor.element_size()
    with pytest.raises(MXNetError):
        a[::2]
    with pytest.raises(MXNetError):
        a.reshape((3, 3))


def test_pickle_round_trips_every_dtype():
    rng = np.random.RandomState(7)
    for dtype in ALL_TYPES + ["bfloat16"]:
        a = mx.nd.array(rng.uniform(0, 10, (3, 4)), dtype=dtype)
        b = pickle.loads(pickle.dumps(a))
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(b._tensor, a._tensor)
    ro = mx.nd.ones((2,))
    ro.writable = False
    assert not pickle.loads(pickle.dumps(ro)).writable
    with pytest.raises(MXNetError, match="read-only"):
        ro[:] = 0


def test_bfloat16_asnumpy_widens_to_float32():
    """The card's machine has no ml_dtypes: a bf16 array's asnumpy() is
    its values widened to float32, which is exact."""
    vals = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    a = mx.nd.array(vals, dtype="bfloat16")
    assert a.dtype == torch.bfloat16
    got = a.asnumpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vals.bfloat16().float().numpy())


def _random_arrays(seed, n=6):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-10, 10, tuple(rng.randint(1, 6, size=d)))
            .astype(np.float32) for d in rng.randint(1, 5, size=n)]


def test_save_load_within_the_port(tmp_path):
    fname = str(tmp_path / "l.params")
    data = [mx.nd.array(a) for a in _random_arrays(8)]
    mx.nd.save(fname, data)
    back = mx.nd.load(fname)
    assert all(isinstance(b, mx.nd.NDArray) and b.context == mx.cpu()
               for b in back)
    for x, y in zip(data, back):
        np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
    dmap = {"ndarray xx %s" % i: x for i, x in enumerate(data)}
    mx.nd.save(fname, dmap)
    back = mx.nd.load(fname)
    assert sorted(back) == sorted(dmap)
    with open(fname, "rb") as f:
        buf = mx.nd.load_buffer(f.read())
    for k, x in dmap.items():
        np.testing.assert_array_equal(x.asnumpy(), back[k].asnumpy())
        np.testing.assert_array_equal(x.asnumpy(), buf[k].asnumpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_params_files_cross_byte_identical(tmp_path, writer):
    arrays = {"w%d" % i: a for i, a in enumerate(_random_arrays(9))}
    arrays["i"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    arrays["h"] = np.linspace(-1, 1, 5).astype(np.float16)
    pt, pj = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    mx.nd.save(pt, {k: mx.nd.array(v) for k, v in arrays.items()})
    jmx.nd.save(pj, {k: jmx.nd.array(v) for k, v in arrays.items()})
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    src = pt if writer == "port" else pj
    port, jax_ = mx.nd.load(src), jmx.nd.load(src)
    for k, v in arrays.items():
        assert port[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port[k].asnumpy(), v)
        np.testing.assert_array_equal(jax_[k].asnumpy(), v)


def test_reference_format_layout(tmp_path):
    fname = str(tmp_path / "fmt.bin")
    mx.nd.save(fname, {"w": mx.nd.array(np.arange(6, dtype=np.float32)
                                        .reshape(2, 3))})
    with open(fname, "rb") as f:
        raw = f.read()
    assert struct.unpack("<QQQ", raw[:24]) == (0x112, 0, 1)
    assert struct.unpack("<III", raw[24:36]) == (2, 2, 3)
    assert struct.unpack("<iii", raw[36:48]) == (1, 0, 0)
    np.testing.assert_array_equal(
        np.frombuffer(raw[48:72], dtype=np.float32), np.arange(6))
    assert struct.unpack("<QQ", raw[72:88]) == (1, 1) and raw[88:89] == b"w"


def test_random_reproducible_with_seed_and_moments():
    """tests/test_random.py: one seed gives one stream; the moments are
    the distributions'."""
    a, b, mu, sigma, shape = -10, 10, 10, 2, (100, 100)
    draws = []
    for _ in range(2):
        mx.random.seed(128)
        draws.append((mx.random.normal(mu, sigma, shape).asnumpy(),
                      mx.random.uniform(a, b, shape).asnumpy()))
    for x, y in zip(*draws):
        np.testing.assert_array_equal(x, y)
    normal, uniform = draws[0]
    assert abs(normal.mean() - mu) < 0.1 and abs(normal.std() - sigma) < 0.1
    assert abs(uniform.mean() - (a + b) / 2) < 0.1
    assert uniform.min() >= a and uniform.max() < b
    out = mx.nd.zeros((50, 4))
    assert mx.random.uniform(0, 1, out=out) is out
    assert out.asnumpy().std() > 0
    mx.random.seed(5)
    x = mx.random.normal(0, 1, (8,)).asnumpy()
    assert not np.array_equal(x, mx.random.normal(0, 1, (8,)).asnumpy())
    with pytest.raises(ValueError):
        mx.random.seed(1.5)


def test_default_context_is_the_card_and_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a host without CUDA")
    with mx.gpu(0):
        assert mx.current_context() == mx.gpu(0)
        with pytest.raises(MXNetError, match="CUDA"):
            mx.nd.zeros((2,))
    with pytest.raises(MXNetError, match="CUDA"):
        mx.nd.ones((2,), ctx=mx.gpu())
    with pytest.raises(MXNetError, match="CUDA"):
        mx.random.uniform(0, 1, (2,), ctx=mx.gpu(0))


def test_default_context_outside_any_block():
    """A fresh interpreter's current context is the card, gpu(0)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch as mx; "
         "print(mx.current_context())"], cwd=root, capture_output=True,
        text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "gpu(0)", out.stderr


def test_imdecode_is_a_later_slice():
    """``imdecode`` (a later slice before the IO layer was ported) decodes
    as the JAX package's does: the same [1, 3, H, W] float32 values, with
    ``clip_rect``, ``mean`` and ``out``."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".png", img)
    blob = buf.tobytes()
    want = jmx.nd.imdecode(blob).asnumpy()
    got = mx.nd.imdecode(blob)
    assert got.shape == (1, 3, 12, 10)
    np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(got.asnumpy()[0].transpose(1, 2, 0),
                                  img[:, :, ::-1].astype(np.float32))
    mean = rng.uniform(0, 50, (3, 6, 4)).astype(np.float32)
    want = jmx.nd.imdecode(blob, clip_rect=(2, 3, 6, 9),
                              mean=jmx.nd.array(mean)).asnumpy()
    out = mx.nd.zeros((1, 3, 6, 4))
    got = mx.nd.imdecode(blob, clip_rect=(2, 3, 6, 9), out=out,
                         mean=mx.nd.array(mean))
    assert got is out
    np.testing.assert_allclose(out.asnumpy(), want, rtol=0, atol=1e-5)
