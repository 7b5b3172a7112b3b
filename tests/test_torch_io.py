"""The port's iterators and URI streams against the JAX package's on the
CPU: ``ResizeIter``, ``PrefetchingIter`` (with the roll_over state),
``MNISTIter``, ``CSVIter``, ``StagedStream(thread=True)`` and
``stream.open_stream`` with the files the port routes through it
(``nd.save``/``load``, ``Symbol.save``/``load``, the checkpoint
helpers). Batches are compared value for value on the same seeded
inputs."""
import gzip
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu import model as jmodel
from mxnet_tpu import stream as jstream
from mxnet_tpu.base import MXNetError as JaxMXNetError

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import stream as tstream
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _host_context():
    with mx.cpu():
        yield


def _batches(it, epochs=1):
    out = []
    for _ in range(epochs):
        out.append([([d.asnumpy().copy() for d in b.data],
                     [lab.asnumpy().copy() for lab in b.label], b.pad or 0)
                    for b in it])
        it.reset()
    return out


def _same(got, want):
    assert [len(e) for e in got] == [len(e) for e in want]
    for eg, ew in zip(got, want):
        for (dg, lg, pg), (dw, lw, pw) in zip(eg, ew):
            assert pg == pw
            for a, b in zip(dg + lg, dw + lw):
                np.testing.assert_array_equal(a, np.asarray(b, a.dtype))


def _data(n=50, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 4)).astype(np.float32),
            (np.arange(n) % 10).astype(np.float32))


@pytest.mark.parametrize("size,reset_internal", [(3, True), (7, True),
                                                 (4, False)])
def test_resize_iter_follows_jax(size, reset_internal):
    data, label = _data()
    got = _batches(tio.ResizeIter(tio.NDArrayIter(data, label, 16), size,
                                  reset_internal), 3)
    want = _batches(jio.ResizeIter(jio.NDArrayIter(data, label, 16), size,
                                   reset_internal), 3)
    _same(got, want)
    assert all(len(e) == size for e in got)


def test_prefetching_iter_follows_jax():
    """Two sources under renames; the epoch boundary and reset."""
    data, label = _data(100)
    it = tio.PrefetchingIter(
        [tio.NDArrayIter(data, label, 20),
         tio.NDArrayIter(data * 2, label, 20, data_name="x",
                         label_name="y")],
        rename_data=[{"data": "a"}, {"x": "b"}],
        rename_label=[{"softmax_label": "la"}, {"y": "lb"}])
    jt = jio.PrefetchingIter(
        [jio.NDArrayIter(data, label, 20),
         jio.NDArrayIter(data * 2, label, 20, data_name="x",
                         label_name="y")],
        rename_data=[{"data": "a"}, {"x": "b"}],
        rename_label=[{"softmax_label": "la"}, {"y": "lb"}])
    assert it.provide_data == [(n, tuple(s)) for n, s in jt.provide_data]
    assert it.provide_label == [(n, tuple(s)) for n, s in jt.provide_label]
    assert it.batch_size == 20
    _same(_batches(it, 2), _batches(jt, 2))


def test_prefetching_iter_preserves_rollover_state():
    """The pipeline thread touches the wrapped iterator no more after an
    epoch's end: a roll_over cursor stays where the direct iterator's
    does, epoch after epoch."""
    data = np.arange(5, dtype=np.float32)
    direct = tio.NDArrayIter(data.copy(), batch_size=4,
                             last_batch_handle="roll_over")
    pref = tio.PrefetchingIter(tio.NDArrayIter(
        data.copy(), batch_size=4, last_batch_handle="roll_over"))
    jax_pref = jio.PrefetchingIter(jio.NDArrayIter(
        data.copy(), batch_size=4, last_batch_handle="roll_over"))
    got = _batches(pref, 3)
    _same(got, _batches(direct, 3))
    _same(got, _batches(jax_pref, 3))


def test_prefetching_iter_surfaces_a_failure():
    class Broken(tio.NDArrayIter):
        def iter_next(self):
            raise RuntimeError("boom")

    it = tio.PrefetchingIter(Broken(np.zeros((8, 2), np.float32),
                                    np.zeros(8), 4))
    with pytest.raises(MXNetError, match="boom"):
        next(iter(it))


def _write_mnist(tmp_path, n=200, gz=True):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    ext = ".gz" if gz else ""
    img_path = str(tmp_path / ("train-images-idx3-ubyte" + ext))
    lbl_path = str(tmp_path / ("train-labels-idx1-ubyte" + ext))
    opener = gzip.open if gz else open
    with opener(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(images.tobytes())
    with opener(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return img_path, lbl_path


MNIST = {"default": dict(), "flat": dict(flat=True, shuffle=False),
         "parts": dict(num_parts=3, part_index=2, seed=4),
         "input_shape": dict(input_shape=(784,), shuffle=False)}


@pytest.mark.parametrize("case", sorted(MNIST))
def test_mnist_iter_follows_jax(tmp_path, case):
    img, lbl = _write_mnist(tmp_path, gz=case != "flat")
    kw = dict(batch_size=32, **MNIST[case])
    it = tio.MNISTIter(img, lbl, **kw)
    jt = jio.MNISTIter(img, lbl, **kw)
    assert it.provide_data == [(n, tuple(s)) for n, s in jt.provide_data]
    _same(_batches(it, 2), _batches(jt, 2))


def test_mnist_iter_rejects_a_bad_file(tmp_path):
    img, lbl = _write_mnist(tmp_path)
    with pytest.raises(MXNetError, match="bad MNIST"):
        tio.MNISTIter(lbl, img)


@pytest.mark.parametrize("round_batch,label", [(True, True), (False, True),
                                               (True, False)])
def test_csv_iter_follows_jax(tmp_path, round_batch, label):
    rng = np.random.RandomState(1)
    data = rng.uniform(0, 1, (23, 6)).astype(np.float32)
    dpath = str(tmp_path / "d.csv")
    np.savetxt(dpath, data, delimiter=",")
    kw = dict(data_shape=(2, 3), batch_size=5, round_batch=round_batch)
    if label:
        lpath = str(tmp_path / "l.csv")
        np.savetxt(lpath, rng.randint(0, 3, 23), delimiter=",")
        kw["label_csv"] = lpath
    _same(_batches(tio.CSVIter(dpath, **kw), 2),
          _batches(jio.CSVIter(dpath, **kw), 2))


class _Src:
    """A source of 0..n-1 that counts its pulls and can fail at one."""

    def __init__(self, n=5, fail_at=None):
        self.n, self.i, self.fail_at = n, 0, fail_at
        self.pulls = 0
        self.threads = set()

    def next(self):
        self.threads.add(threading.current_thread().name)
        if self.i >= self.n:
            raise StopIteration
        if self.i == self.fail_at:
            raise RuntimeError("source broke at %d" % self.i)
        self.i += 1
        self.pulls += 1
        return self.i - 1

    def reset(self):
        self.i = 0


def test_staged_stream_threaded_follows_jax():
    """``thread=True``: pulls and placement on the pipeline thread,
    ``depth`` items ahead, StopIteration until ``reset()``, a failure as
    ``MXNetError``; the same items as the JAX package's stream."""
    src = _Src()
    s = tio.StagedStream(src, place=lambda x: x * 10, depth=3, thread=True)
    jsrc = _Src()
    js = jio.StagedStream(jsrc, place=lambda x: x * 10, depth=3,
                          thread=True)
    assert s.next() == 0
    deadline = time.time() + 5
    while src.pulls < 4 and time.time() < deadline:
        time.sleep(0.01)
    assert src.pulls == 4  # item 0 handed out, 1..3 staged behind it
    assert threading.current_thread().name not in src.threads
    assert s.staged() == 0  # the threaded pipeline keeps its own count
    assert [x for x in s] == [10, 20, 30, 40]
    assert list(s) == []    # latched until reset
    s.reset()
    js.next()
    js.reset()
    assert list(s) == list(js) == [0, 10, 20, 30, 40]
    with pytest.raises(MXNetError, match="inline mode only"):
        s.prune(lambda x: True)
    s.close()
    js.close()
    bad = tio.StagedStream(_Src(fail_at=2), depth=2, thread=True)
    assert bad.next() == 0 and bad.next() == 1
    with pytest.raises(MXNetError, match="source broke at 2"):
        bad.next()
    bad.close()


# -- URI streams ---------------------------------------------------------------------

def test_open_stream_local_and_file_uri(tmp_path):
    path = str(tmp_path / "f.bin")
    with tstream.open_stream(path, "wb") as f:
        f.write(b"abc")
    with tstream.open_stream("file://" + path, "rb") as f:
        assert f.read() == b"abc"
    with jstream.open_stream("file://" + path, "rb") as f:
        assert f.read() == b"abc"
    assert tstream.is_uri("s3://b/k") and tstream.is_uri("file:///x")
    assert not tstream.is_uri(path)


def _no_s3_client():
    """The remote-URI tests run only where boto3 is absent: with it, a
    write would reach the network."""
    try:
        import boto3  # noqa: F401
    except ImportError:
        return
    pytest.skip("boto3 is installed: an S3 write would reach the network")


def test_open_stream_remote_without_client_raises():
    """Without boto3 an ``s3://`` URI raises, as in the JAX package, and
    writes no local file named after it; remote streams take only
    'r'/'w'; a malformed HDFS URI raises before any connection."""
    _no_s3_client()
    for mod, err in ((tstream, MXNetError), (jstream, JaxMXNetError)):
        with pytest.raises(err, match="boto3"):
            mod.open_stream("s3://bucket/key", "wb")
        with pytest.raises(err, match="only 'r'/'w'"):
            mod.open_stream("hdfs://host/path", "ab")
        with pytest.raises(err, match="only 'r'/'w'"):
            mod.open_stream("s3://bucket/key", "r+")
        with pytest.raises(err, match="must be str"):
            mod.open_stream(7)
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        with pytest.raises(MXNetError, match="pyarrow"):
            tstream.open_stream("hdfs://host/path", "rb")
    else:
        with pytest.raises(MXNetError, match="no path"):
            tstream.open_stream("hdfs://host", "rb")


def test_files_route_through_streams(tmp_path, monkeypatch):
    """``nd.save``/``load``, ``Symbol.save``/``load`` and the checkpoint
    helpers open their files through ``open_stream``: ``file://`` URIs
    work, and both packages read what the port wrote."""
    opened = []
    real = tstream.open_stream

    def spy(path, mode="rb"):
        opened.append((os.fspath(path), mode))
        return real(path, mode)

    monkeypatch.setattr(tstream, "open_stream", spy)
    monkeypatch.setattr(tmodel, "open_stream", spy)
    uri = "file://" + str(tmp_path / "a.params")
    mx.nd.save(uri, {"w": np.arange(6, dtype=np.float32).reshape(2, 3)})
    np.testing.assert_array_equal(mx.nd.load(uri)["w"].asnumpy(),
                                  jmx.nd.load(uri)["w"].asnumpy())
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    suri = "file://" + str(tmp_path / "s.json")
    sym.save(suri)
    assert mx.sym.load(suri).tojson() == sym.tojson()
    prefix = "file://" + str(tmp_path / "ck")
    tmodel.save_checkpoint(prefix, 1, sym,
                           {"fc_weight": np.ones((3, 4), np.float32)}, {},
                           optimizer_states={"step": 2})
    _, args, _ = tmodel.load_checkpoint(prefix, 1)
    assert args["fc_weight"].shape == (3, 4)
    assert tmodel.load_optimizer_states(prefix, 1) == {"step": 2}
    assert jmodel.load_optimizer_states(prefix, 1) == {"step": 2}
    _, jargs, _ = jmodel.load_checkpoint(prefix, 1)
    np.testing.assert_array_equal(jargs["fc_weight"].asnumpy(),
                                  np.ones((3, 4), np.float32))
    modes = {m for _, m in opened}
    assert {"wb", "rb", "w", "r"} <= modes
    assert any(p.endswith("ck-0001.states.tmp") for p, _ in opened)


def test_checkpoint_to_a_remote_uri_raises_without_a_client(tmp_path):
    _no_s3_client()
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(MXNetError, match="boto3"):
            tmodel.save_checkpoint("s3://bucket/m", 0, sym, {}, {})
        assert not os.path.exists("s3:")
        assert tmodel.load_optimizer_states("s3://bucket/m", 0) is None
        assert tmodel.latest_checkpoint("s3://bucket/m") is None
    finally:
        os.chdir(cwd)


def test_mxdataiter_is_a_later_slice():
    """MXDataIter over a C-ABI iterator handle (``c_api_impl``) yields
    the batches of the iterator behind it, as the JAX package's over its
    own handle; the handle's table entry goes with the iterator."""
    from mxnet_tpu import c_api_impl as jimpl
    from mxnet_tpu_torch import c_api_impl as timpl
    rs = np.random.RandomState(3)
    x = rs.randn(10, 4).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    got = tio.MXDataIter(timpl._put(tio.NDArrayIter(x, y, batch_size=4)))
    want = jio.MXDataIter(jimpl._put(jio.NDArrayIter(x, y, batch_size=4)))
    assert got.batch_size == want.batch_size == 4
    for _ in range(2):
        got.reset()
        want.reset()
        for bg, bw in zip(got, want):
            np.testing.assert_array_equal(bg.data[0].asnumpy(),
                                          bw.data[0].asnumpy())
            np.testing.assert_array_equal(bg.label[0].asnumpy(),
                                          bw.label[0].asnumpy())
            assert bg.pad == bw.pad
    assert [b.pad for b in got] == []  # exhausted until reset
    hid = got.handle
    del got
    assert hid not in timpl._TABLE


def test_io_names_follow_jax():
    for name in jio.__all__:
        assert hasattr(tio, name), name
    assert set(tio.__all__) == set(jio.__all__)
    for name in ("recordio", "ImageRecordIter", "DeviceAugmentIter",
                 "DevicePrefetchIter"):
        assert hasattr(jmx, name) and hasattr(mx, name), name
    assert callable(mx.io.ImageRecordIter)
    assert torch.is_tensor(mx.nd.array([1.0])._tensor)
