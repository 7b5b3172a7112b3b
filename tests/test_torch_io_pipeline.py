"""The port's decode pool, device prefetcher and device augmentation on
the CPU, and training fed from records against the JAX package.

The pool (``ImageRecordIter(num_workers=N)``) is held byte for byte
against the port's serial engine for 0, 1 and 3 workers, in process and
thread mode, and its lifecycle as the JAX package's tests hold the JAX
pool (``tests/test_io_pipeline.py``): reset mid-epoch, shards and
padding, slot reuse, a crash that raises instead of hanging, no stray
process after ``close()``, and no decode on the consumer. Here
``DevicePrefetchIter`` and ``DeviceAugmentIter`` run on ``"cpu"``; on
the card the same code copies through pinned memory on a side stream
(``chip_smoke.py`` phase 7d). One ``ParallelTrainer.fit`` step of a small
conv net fed from records is held against the JAX trainer fed from the
JAX iterator, parameters by per-tensor norm within 2e-2.
"""
import gc
import os
import signal
import time
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.image_io as jax_iio
from mxnet_tpu import parallel as jpar

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image_io as tiio
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.image_io import ImageRecordIter


@pytest.fixture(autouse=True)
def _host_context():
    with mx.cpu():
        yield


def _make_rec(tmp_path, n=21, hw=28, name="imgs.rec", write_idx=False):
    """n seeded RAW0 records whose mean encodes their label."""
    path = str(tmp_path / name)
    idx_path = str(tmp_path / (name + ".idx"))
    w = (recordio.MXIndexedRecordIO(idx_path, path, "w") if write_idx
         else recordio.MXRecordIO(path, "w"))
    rng = np.random.RandomState(0)
    for i in range(n):
        label = i % 10
        img = (label * 20 + 10 + rng.randint(0, 3, (hw, hw, 3))
               ).astype(np.uint8)
        payload = recordio.pack_img((0, float(label), i, 0), img,
                                    img_fmt=".raw")
        if write_idx:
            w.write_idx(i, payload)
        else:
            w.write(payload)
    w.close()
    return (path, idx_path) if write_idx else path


def _epochs(it, n):
    out = []
    for _ in range(n):
        out.append([(b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                     b.pad or 0) for b in it])
        it.reset()
    return out


@pytest.mark.parametrize("mode,workers", [("process", 0), ("process", 1),
                                          ("process", 3), ("thread", 1),
                                          ("thread", 3)])
def test_pool_byte_identical_to_serial(tmp_path, mode, workers):
    """Epochs of ``num_workers=N`` equal the serial engine's byte for
    byte under a fixed seed (order, crop and mirror draws, padding), and
    successive epochs reshuffle."""
    path = _make_rec(tmp_path)
    kw = dict(batch_size=8, shuffle=True, seed=5, rand_crop=True,
              rand_mirror=True)
    ser = ImageRecordIter(path, (3, 24, 24), num_workers=0, **kw)
    want = _epochs(ser, 2)
    assert not np.array_equal(want[0][0][1], want[1][0][1])
    pool = ImageRecordIter(path, (3, 24, 24), num_workers=workers,
                           worker_mode=mode, **kw)
    got = _epochs(pool, 2)
    pool.close()
    for ew, eg in zip(want, got):
        assert len(ew) == len(eg) == 3
        for (d1, l1, p1), (d2, l2, p2) in zip(ew, eg):
            assert p1 == p2
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_array_equal(d1, d2)


def test_pool_reset_mid_epoch(tmp_path):
    path = _make_rec(tmp_path)
    it = ImageRecordIter(path, (3, 24, 24), batch_size=8, shuffle=True,
                         seed=1, num_workers=2)
    ser = ImageRecordIter(path, (3, 24, 24), batch_size=8, shuffle=True,
                          seed=1)
    assert it.iter_next() and ser.iter_next()
    it.reset()
    ser.reset()
    got = [b.label[0].asnumpy().copy() for b in it]
    want = [b.label[0].asnumpy().copy() for b in ser]
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    it.close()


def test_pool_sharding_and_pad(tmp_path):
    path = _make_rec(tmp_path, n=20)
    seen = []
    for part in range(2):
        it = ImageRecordIter(path, (3, 24, 24), batch_size=4, num_parts=2,
                             part_index=part, num_workers=2)
        for b in it:
            seen.extend(b.label[0].asnumpy()[:4 - (b.pad or 0)])
        it.close()
    assert len(seen) == 20
    it = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=2)
    assert [b.pad for b in it] == [0, 0, 4]
    it.close()


def test_pool_takes_the_idx_sidecar(tmp_path):
    path, idx = _make_rec(tmp_path, n=16, write_idx=True)
    a = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=2,
                        path_imgidx=idx)
    b = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=2)
    for ba, bb in zip(a, b):
        np.testing.assert_array_equal(ba.data[0].asnumpy(),
                                      bb.data[0].asnumpy())
    a.close()
    b.close()


def test_batches_survive_slot_reuse(tmp_path):
    """A batch is copied out of the pool's slot: holding every batch of an
    epoch while the slot ring wraps leaves each its own values."""
    path = _make_rec(tmp_path, n=37)
    it = ImageRecordIter(path, (3, 24, 24), batch_size=8, shuffle=True,
                         seed=4, num_workers=1, queue_depth=1)
    held, snaps = [], []
    for b in it:
        held.append((b.data[0], b.label[0]))
        snaps.append((b.data[0].asnumpy().copy(),
                      b.label[0].asnumpy().copy()))
    for (d, lab), (sd, sl) in zip(held, snaps):
        np.testing.assert_array_equal(d.asnumpy(), sd)
        np.testing.assert_array_equal(lab.asnumpy(), sl)
    it.close()


def test_worker_crash_raises_not_hangs(tmp_path):
    path = str(tmp_path / "bad.rec")
    w = recordio.MXRecordIO(path, "w")
    img = np.full((24, 24, 3), 100, np.uint8)
    for i in range(6):
        w.write(recordio.pack_img((0, 1.0, i, 0), img, img_fmt=".raw"))
    w.write(recordio.pack((0, 1.0, 6, 0), b"RAW0\x00"))  # truncated
    w.close()
    it = ImageRecordIter(path, (3, 24, 24), batch_size=4, num_workers=2)
    t0 = time.time()
    with pytest.raises(MXNetError, match="decode worker"):
        for _ in it:
            pass
    assert time.time() - t0 < 30


def test_worker_hard_kill_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_IO_WORKER_TIMEOUT", "30")
    path = _make_rec(tmp_path)
    it = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=2)
    assert it.iter_next()
    os.kill(it._py._workers[1].pid, signal.SIGKILL)
    with pytest.raises(MXNetError, match="died"):
        for _ in range(4):
            while it.iter_next():
                pass
            it.reset()


def test_pool_close_leaves_no_strays(tmp_path):
    path = _make_rec(tmp_path)
    it = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=3)
    assert it.iter_next()
    workers = list(it._py._workers)
    assert all(w.is_alive() for w in workers)
    it.close()
    deadline = time.time() + 5
    while any(w.is_alive() for w in workers) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(w.is_alive() for w in workers)
    it.close()
    with pytest.raises(MXNetError, match="closed"):
        it.reset()


def _poisoned_load(*a, **k):
    raise AssertionError("decode ran on the consumer")


def test_decode_happens_in_workers_not_consumer(tmp_path, monkeypatch):
    """With the engine's record decode poisoned in the consumer after the
    pool forked, the pool still serves whole epochs; the serial engine
    under the same poison fails, which checks the poison."""
    path = _make_rec(tmp_path)
    it = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=2,
                         shuffle=True, seed=3)
    monkeypatch.setattr(tiio._PyEngine, "_load", _poisoned_load)
    assert sum(1 for _ in it) == 3
    it.reset()
    assert sum(1 for _ in it) == 3
    it.close()
    with pytest.raises(AssertionError, match="consumer"):
        next(iter(ImageRecordIter(path, (3, 24, 24), batch_size=8)))


# -- device prefetch and augmentation --------------------------------------------

def test_device_prefetch_iter_contents_and_depth():
    data = np.arange(100, dtype=np.float32).reshape(100, 1)
    pulls = []

    class Spy(mx.io.NDArrayIter):
        def iter_next(self):
            got = super().iter_next()
            if got:
                pulls.append(self.cursor)
            return got

    base = Spy(data.copy(), np.arange(100, dtype=np.float32), batch_size=16)
    pref = mx.DevicePrefetchIter(base, depth=2, sharding="cpu")
    first = next(iter(pref))
    assert isinstance(first.data[0]._tensor, torch.Tensor)
    deadline = time.time() + 5
    while len(pulls) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(pulls) >= 3
    rest = list(pref)
    ref = list(mx.io.NDArrayIter(data.copy(),
                                 np.arange(100, dtype=np.float32),
                                 batch_size=16))
    np.testing.assert_array_equal(
        np.concatenate([b.data[0].asnumpy() for b in [first] + rest]),
        np.concatenate([b.data[0].asnumpy() for b in ref]))
    assert ([first] + rest)[-1].pad == ref[-1].pad == 12
    pref.reset()
    assert len(list(pref)) == len(ref)
    pref.close()


def test_device_prefetch_iter_places_for_the_mesh():
    """``mesh=``: the batch lands on the device of the mesh's ranks (the
    trainer's program gives each dp rank its rows); a mesh without the
    data axis raises."""
    mesh = par.build_mesh({"dp": 4}, ["cpu"] * 4)
    base = mx.io.NDArrayIter(np.arange(64, dtype=np.float32).reshape(32, 2),
                             np.arange(32, dtype=np.float32), batch_size=16)
    pref = mx.DevicePrefetchIter(base, depth=2, mesh=mesh)
    b = next(iter(pref))
    assert b.data[0]._tensor.device.type == "cpu"
    np.testing.assert_array_equal(
        b.data[0].asnumpy(), np.arange(32, dtype=np.float32).reshape(16, 2))
    pref.close()
    with pytest.raises(MXNetError, match="no axis"):
        mx.DevicePrefetchIter(base, mesh=mesh, data_axis="tp")


def test_device_prefetch_iter_is_collectable():
    base = mx.io.NDArrayIter(np.zeros((16, 2), np.float32), np.zeros(16), 8)
    pref = mx.DevicePrefetchIter(base, depth=2, sharding="cpu")
    next(iter(pref))
    worker = pref._worker
    ref = weakref.ref(pref)
    del pref
    gc.collect()
    assert ref() is None
    worker.join(timeout=5)
    assert not worker.is_alive()


def test_device_prefetch_iter_surfaces_errors():
    class Broken(mx.io.NDArrayIter):
        def iter_next(self):
            raise RuntimeError("boom")

    pref = mx.DevicePrefetchIter(
        Broken(np.zeros((8, 2), np.float32), np.zeros(8), 4),
        sharding="cpu")
    with pytest.raises(MXNetError, match="boom"):
        next(iter(pref))

    class FailsOnSecond(mx.io.NDArrayIter):
        calls = 0

        def iter_next(self):
            FailsOnSecond.calls += 1
            if FailsOnSecond.calls >= 2:
                raise RuntimeError("staged boom")
            return super().iter_next()

    pref = mx.DevicePrefetchIter(
        FailsOnSecond(np.zeros((32, 2), np.float32), np.zeros(32), 4),
        depth=2, sharding="cpu")
    assert next(iter(pref)) is not None
    deadline = time.time() + 5
    while pref._worker._results.empty() and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(MXNetError, match="staged boom"):
        pref.reset()


def _host_crop(u8, y0, x0, h, w, flip, mean, scale):
    out = u8[y0:y0 + h, x0:x0 + w].astype(np.float32)
    if flip:
        out = out[:, ::-1]
    return ((out - np.asarray(mean, np.float32)) * np.float32(scale)
            ).transpose(2, 0, 1)


def test_device_augment_batch_without_draws_is_the_host_centre_crop():
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (4, 30, 28, 3)).astype(np.uint8)
    mean, scale = (10.0, 5.0, 2.0), 0.25
    got = tiio.device_augment_batch(torch.from_numpy(u8), crop_shape=(24, 20),
                                    mean=mean, scale=scale)
    want = np.stack([_host_crop(im, 3, 4, 24, 20, False, mean, scale)
                     for im in u8])
    np.testing.assert_array_equal(got.numpy(), want)
    full = tiio.device_augment_batch(torch.from_numpy(u8))
    np.testing.assert_array_equal(full.numpy(),
                                  u8.transpose(0, 3, 1, 2).astype(np.float32))
    with pytest.raises(MXNetError, match="Generator"):
        tiio.device_augment_batch(torch.from_numpy(u8), rand_crop=True)


def test_device_augment_batch_with_draws_by_construction():
    """The random crop and mirror at the offsets and flags drawn from the
    generator (rows, then columns, then flips) equal the host crop and
    mirror exactly."""
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    g = torch.Generator().manual_seed(11)
    got = tiio.device_augment_batch(torch.from_numpy(u8), key=g,
                                    crop_shape=(24, 24), rand_crop=True,
                                    rand_mirror=True, mean=(1.0, 2.0, 3.0),
                                    scale=0.5)
    again = torch.Generator().manual_seed(11)
    y0 = torch.randint(0, 9, (6,), generator=again)
    x0 = torch.randint(0, 9, (6,), generator=again)
    flip = torch.rand((6,), generator=again) < 0.5
    assert 0 < int(flip.sum()) < 6
    want = np.stack([_host_crop(u8[i], int(y0[i]), int(x0[i]), 24, 24,
                                bool(flip[i]), (1.0, 2.0, 3.0), 0.5)
                     for i in range(6)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_augment_iter_composes_with_the_pool_and_prefetch(tmp_path):
    """ImageRecordIter(device_augment, num_workers) -> DeviceAugmentIter ->
    DevicePrefetchIter without draws equals the host float pipeline, and
    with draws equals the host crop and mirror at the drawn offsets."""
    path = _make_rec(tmp_path, n=16, hw=32)
    mean = (10.0, 5.0, 2.0)
    kw = dict(batch_size=8, resize=28, mean_r=mean[0], mean_g=mean[1],
              mean_b=mean[2], scale=0.25)
    host = ImageRecordIter(path, (3, 24, 24), num_workers=2, **kw)
    base = ImageRecordIter(path, (3, 28, 28), device_augment=True,
                           num_workers=2, **kw)
    dev = mx.DeviceAugmentIter(base, crop_shape=(24, 24), rand_crop=False,
                               rand_mirror=False, mean=mean, scale=0.25,
                               device="cpu")
    pref = mx.DevicePrefetchIter(dev, depth=2, sharding="cpu")
    assert pref.provide_data[0][1] == (8, 3, 24, 24)
    for hb, db in zip(host, pref):
        np.testing.assert_array_equal(db.data[0].asnumpy(),
                                      hb.data[0].asnumpy())
        np.testing.assert_array_equal(db.label[0].asnumpy(),
                                      hb.label[0].asnumpy())
    pref.close()
    host.close()
    raw = ImageRecordIter(path, (3, 28, 28), device_augment=True,
                          batch_size=8, resize=28)
    u8 = [b.data[0].asnumpy().copy() for b in raw]
    raw.reset()
    aug = mx.DeviceAugmentIter(raw, crop_shape=(24, 24), seed=9,
                               device="cpu")
    g = torch.Generator().manual_seed(9)
    for batch, imgs in zip(aug, u8):
        y0 = torch.randint(0, 5, (8,), generator=g)
        x0 = torch.randint(0, 5, (8,), generator=g)
        flip = torch.rand((8,), generator=g) < 0.5
        want = np.stack([_host_crop(imgs[i], int(y0[i]), int(x0[i]), 24, 24,
                                    bool(flip[i]), (0, 0, 0), 1.0)
                         for i in range(8)])
        np.testing.assert_array_equal(batch.data[0].asnumpy(), want)
    with pytest.raises(MXNetError, match="device_augment=True"):
        mx.DeviceAugmentIter(host, device="cpu")
    with pytest.raises(MXNetError, match="exceeds"):
        mx.DeviceAugmentIter(raw, crop_shape=(40, 40), device="cpu")


# -- training from records -----------------------------------------------------------

def _convnet(pkg):
    s = pkg.symbol
    x = s.Convolution(data=s.Variable("data"), name="conv", kernel=(3, 3),
                      num_filter=4, stride=(2, 2))
    x = s.BatchNorm(data=x, name="bn")
    x = s.Activation(data=x, name="relu", act_type="relu")
    x = s.FullyConnected(data=s.Flatten(data=x, name="flat"), name="fc",
                         num_hidden=10)
    return s.SoftmaxOutput(data=x, name="softmax")


def test_fit_from_records_follows_jax(tmp_path, monkeypatch):
    """``ParallelTrainer.fit`` over the pool (through DevicePrefetchIter)
    against the JAX trainer over the JAX engine on the same records: one
    epoch of two steps, parameters by per-tensor norm within 2e-2. The
    consumer decodes nothing (its record decode is poisoned)."""
    monkeypatch.setattr(jax_iio, "get_lib", lambda: None)
    path = _make_rec(tmp_path, n=16, hw=20)
    kw = dict(batch_size=8, shuffle=True, seed=2, rand_crop=True,
              rand_mirror=True, mean_r=100.0, mean_g=100.0, mean_b=100.0,
              scale=1.0 / 64)
    shapes = {"data": (8, 3, 16, 16), "softmax_label": (8,)}
    sym = _convnet(mx)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(7)
    init = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    opt = dict(optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    it = ImageRecordIter(path, (3, 16, 16), num_workers=2, **kw)
    monkeypatch.setattr(tiio._PyEngine, "_load", _poisoned_load)
    tr = par.ParallelTrainer(sym, shapes, device="cpu", seed=0, **opt)
    tr.init_params({k: v.copy() for k, v in init.items()})
    tr.fit(mx.DevicePrefetchIter(it, sharding="cpu"), num_epoch=1)
    it.close()
    jit = jax_iio.ImageRecordIter(path, (3, 16, 16), **kw)
    jtr = jpar.ParallelTrainer(_convnet(jmx), shapes,
                               mesh=jpar.data_parallel_mesh(1), **opt)
    jtr.init_params({k: jmx.nd.array(v.copy()) for k, v in init.items()})
    jtr.fit(jit, num_epoch=1)
    got, _ = tr.get_params()
    want, _ = jtr.get_params()
    moved = 0
    for n, v in want.items():
        w, g = v.asnumpy(), got[n].numpy()
        if np.array_equal(w, init[n]):  # fix_gamma: BatchNorm's gamma
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        moved += 1
        err = np.linalg.norm(g - w)
        # a conv bias before BatchNorm moves by rounding only: f32 floor
        assert err <= 2e-2 * np.linalg.norm(w - init[n]) \
            + 1e-6 * np.linalg.norm(w), (n, err)
    assert moved >= 4


def test_placed_batches_are_not_copied_again():
    """A batch DevicePrefetchIter placed on the trainer's device enters
    the trainer as the same tensors: no host round trip, no second copy
    (the step program then copies it into its input buffers)."""
    data = np.arange(32, dtype=np.float32).reshape(8, 4)
    pref = mx.DevicePrefetchIter(mx.io.NDArrayIter(data, np.zeros(8), 4),
                                 sharding="cpu")
    tr = par.ParallelTrainer(
        mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=3), name="softmax"),
        {"data": (4, 4), "softmax_label": (4,)}, device="cpu")
    for b in pref:
        staged = tr._stage_batch({"data": b.data[0],
                                  "softmax_label": b.label[0]}, "test")
        assert staged["data"].data_ptr() == b.data[0]._tensor.data_ptr()
    pref.close()


def test_feedforward_fit_consumes_the_pool(tmp_path, monkeypatch):
    """``FeedForward.fit`` (the fused loop on host contexts) trains from
    ``ImageRecordIter(num_workers=2)`` with the consumer's decode
    poisoned, and ``score`` reads an eval iterator of records."""
    path = _make_rec(tmp_path)
    it = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=2,
                         shuffle=True, seed=1)
    val = ImageRecordIter(path, (3, 24, 24), batch_size=8, num_workers=1)
    monkeypatch.setenv("MXNET_FUSED_FIT", "1")
    monkeypatch.setattr(tiio._PyEngine, "_load", _poisoned_load)
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(mx.sym.Variable("data")), num_hidden=10),
        name="softmax")
    m = mx.model.FeedForward(symbol=net, ctx=[mx.cpu(0)], num_epoch=1,
                             learning_rate=0.01)
    m.fit(X=it, eval_data=val)
    acc = m.score(val)
    assert 0.0 <= acc <= 1.0
    it.close()
    val.close()
