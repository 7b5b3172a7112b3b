"""The port's RecordIO container, image records and ``ImageRecordIter``
against the JAX package's on the CPU.

Record files are byte-identical whichever package writes them, the JAX
package's native writer included (``mxnet_tpu/lib/libmxnet_tpu.so``,
built by ``tests/conftest.py``), and read back in either. The iterator is
held against the JAX package's Python engine (its ``get_lib`` patched to
``None``, as ``tests/test_recordio.py`` does) on the same seeded records:
byte-identical without resize, rotation or HSL (crop, mirror, shuffle,
shards, padding, scalar and image means, ``device_augment``); with them a
pixel may differ by 1 uint8 level (1/255 of ``scale`` after
normalisation), on at most 1% of the pixels. The port's pixel work is
also held against OpenCV (``cv2``) directly, at the same rule.
"""
import os
import struct

import numpy as np
import pytest

import mxnet_tpu.image_io as jax_iio
from mxnet_tpu import libinfo as jax_libinfo
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image_io as tiio
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError

cv2 = pytest.importorskip("cv2")

PAYLOADS = [b"hello", b"", b"x" * 1001, bytes(range(256)) * 9,
            struct.pack("<I", 0xced7230a),
            b"ab" + struct.pack("<I", 0xced7230a) + b"cd",
            b"abc" + struct.pack("<I", 0xced7230a) * 2 + b"z",
            struct.pack("<I", 0xced7230a) + b"1234567"
            + struct.pack("<I", 0xced7230a)]


@pytest.fixture
def jax_python_engine(monkeypatch):
    """The JAX package's Python engine (no native decoder)."""
    monkeypatch.setattr(jax_iio, "get_lib", lambda: None)


def _write(mod, path, payloads):
    w = mod.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()


def _read_all(mod, path):
    r = mod.MXRecordIO(path, "r")
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


@pytest.mark.parametrize("writer", ["port", "jax_native", "jax_python"])
def test_records_read_back_in_both_packages(tmp_path, writer):
    """A file of any writer reads back in both packages, and the port's
    writer gives the same bytes as the JAX package's native and Python
    writers (multi-part records with the magic inside included)."""
    path = str(tmp_path / "w.rec")
    if writer == "port":
        _write(trec, path, PAYLOADS)
    elif writer == "jax_native":
        assert jax_libinfo.get_lib() is not None
        _write(jrec, path, PAYLOADS)
    else:
        pw = jrec._PyWriter(path)
        for p in PAYLOADS:
            pw.write(p)
        pw.close()
    assert _read_all(trec, path) == PAYLOADS
    assert _read_all(jrec, path) == PAYLOADS
    mine = str(tmp_path / "port.rec")
    _write(trec, mine, PAYLOADS)
    with open(path, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()


def test_record_offsets_and_tell(tmp_path):
    path = str(tmp_path / "o.rec")
    _write(trec, path, PAYLOADS)
    want = jrec.list_record_offsets(path)
    assert trec.list_record_offsets(path) == want
    r = trec.MXRecordIO(path, "r")
    for off, p in zip(want, PAYLOADS):
        r.seek(off)
        assert r.read() == p
    r.close()
    w = trec.MXRecordIO(str(tmp_path / "t.rec"), "w")
    tells = []
    for p in PAYLOADS:
        tells.append(w.tell())
        w.write(p)
    w.close()
    assert tells == want


def test_indexed_records_and_sidecar(tmp_path):
    """The ``.idx`` sidecar: written by the port and read by the JAX
    package and back; ``list_record_offsets`` takes it when it fits and
    scans past a stale, malformed or truncated one."""
    path = str(tmp_path / "i.rec")
    idx = str(tmp_path / "i.idx")
    w = trec.MXIndexedRecordIO(idx, path, "w")
    for i in range(20):
        w.write_idx(i, b"rec%03d" % i)
    w.close()
    for mod in (trec, jrec):
        r = mod.MXIndexedRecordIO(idx, path, "r")
        assert r.keys == list(range(20))
        assert r.read_idx(13) == b"rec013" and r.read_idx(0) == b"rec000"
        r.close()
    offsets = trec.list_record_offsets(path)
    assert trec.list_record_offsets(path, idx) == offsets \
        == jrec.list_record_offsets(path, idx)
    for bad in ("0\t0\n1\t999999999\n", "0\t0\nkey\tgarbage\n",
                "0\t0\n512\n", "0\t0\n1\t%d\n" % (offsets[1] // 10)):
        with open(idx, "w") as f:
            f.write(bad)
        assert trec.list_record_offsets(path, idx) == offsets, bad


@pytest.mark.parametrize("label", [3.0, [1.0, 2.0, 3.0]])
def test_pack_unpack_follow_jax(label):
    header = (0, np.asarray(label, np.float32) if isinstance(label, list)
              else label, 7, 9)
    s = trec.pack(header, b"blob")
    assert s == jrec.pack(jrec.IRHeader(*header), b"blob")
    for mod in (trec, jrec):
        h, blob = mod.unpack(s)
        assert blob == b"blob" and h.id == 7 and h.id2 == 9
        np.testing.assert_array_equal(np.asarray(h.label, np.float32),
                                      np.asarray(label, np.float32))


@pytest.mark.parametrize("fmt,iscolor", [(".png", -1), (".png", 1),
                                         (".png", 0), (".jpg", -1),
                                         (".raw", -1), (".raw", 0),
                                         (".raw", 1)])
@pytest.mark.parametrize("gray", [False, True])
def test_pack_img_unpack_img_follow_jax(fmt, iscolor, gray):
    """``pack_img`` writes the JAX package's bytes (cv2 here) and
    ``unpack_img`` decodes both packages' records to the same pixels."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (21, 17) if gray else (21, 17, 3)
                      ).astype(np.uint8)
    header = (0, 2.0, 5, 0)
    s = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img(jrec.IRHeader(*header), img, quality=90,
                              img_fmt=fmt)
    (h, got), (jh, want) = (trec.unpack_img(s, iscolor),
                            jrec.unpack_img(s, iscolor))
    assert h.label == jh.label == 2.0
    np.testing.assert_array_equal(got, want)
    if fmt != ".jpg" and iscolor == -1:
        np.testing.assert_array_equal(got, img)  # lossless


def test_pillow_codec_and_no_codec(monkeypatch):
    """Without OpenCV the codec is Pillow's: a PNG record packs and decodes
    losslessly (colour and gray), a JPEG decodes at a 1/k DCT scale; with
    neither, JPEG/PNG raise ``MXNetError`` and RAW0 still works."""
    import sys
    from PIL import Image
    monkeypatch.setattr(trec, "_codec", lambda: ("pil", Image))
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (19, 23, 3)).astype(np.uint8)
    s = trec.pack_img((0, 1.0, 0, 0), img, img_fmt=".png")
    np.testing.assert_array_equal(trec.unpack_img(s)[1], img)
    np.testing.assert_array_equal(trec.unpack_img(s, 1)[1], img)
    big = np.kron(rng.randint(0, 256, (10, 10, 3)),
                  np.ones((16, 16, 1))).astype(np.uint8)
    _, blob = trec.unpack(trec.pack_img((0, 1.0, 0, 0), big, quality=95))
    small = tiio._decode_reduced(blob, 4, 1)
    assert small.shape == (40, 40, 3)
    want = cv2.resize(big, (40, 40), interpolation=cv2.INTER_AREA)
    assert np.abs(small.astype(int) - want).mean() < 8
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(MXNetError, match="OpenCV"):
        trec.unpack_img(s)
    with pytest.raises(MXNetError, match="OpenCV"):
        trec.pack_img((0, 1.0, 0, 0), img, img_fmt=".jpg")
    raw = trec.pack_img((0, 1.0, 0, 0), img, img_fmt=".raw")
    np.testing.assert_array_equal(trec.unpack_img(raw)[1], img)


def test_unpack_img_raises_on_garbage():
    with pytest.raises(MXNetError, match="decode failed"):
        trec.unpack_img(trec.pack((0, 1.0, 0, 0), b"\xff\xd8not-a-jpeg"))


# -- the pixel work against OpenCV ------------------------------------------------

def _within_one_level(got, want, frac=0.99):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= frac, (d == 0).mean()


@pytest.mark.parametrize("hw", [(37, 51), (23, 31), (300, 400), (24, 24)])
@pytest.mark.parametrize("chans", [3, 1])
def test_resize_follows_opencv(hw, chans):
    rng = np.random.RandomState(hw[0] + chans)
    h, w = hw
    img = rng.randint(0, 256, (h, w, chans) if chans == 3 else (h, w)
                      ).astype(np.uint8)
    for s in (6.9, 2.0, 0.5, 0.37, 1.0, 256 / min(h, w), 224 / min(h, w)):
        _within_one_level(tiio._resize(img, fx=s),
                          cv2.resize(img, None, fx=s, fy=s))
    for ds in ((w + 7, h + 5), (224, 224), (max(w // 2, 1), max(h // 2, 1))):
        _within_one_level(tiio._resize(img, ds), cv2.resize(img, ds))


def test_resize_window_is_the_crop_of_the_full_resize():
    """``_resize(window=)`` computes only a crop of the output, and reads a
    channel-reversed (RGB over BGR) view without copying it: the values
    are those of the full resize's crop."""
    rng = np.random.RandomState(8)
    bgr = rng.randint(0, 256, (301, 389, 3)).astype(np.uint8)
    rgb = bgr[:, :, ::-1]
    for fx in (256 / 301, 0.5, 1.0, 1.7):
        full = tiio._resize(np.ascontiguousarray(rgb), fx=fx)
        np.testing.assert_array_equal(tiio._resize(rgb, fx=fx), full)
        for y0, x0 in ((0, 0), (7, 11), (full.shape[0] - 224,
                                         full.shape[1] - 224)):
            got = tiio._resize(rgb, fx=fx, window=(y0, x0, 224, 224))
            np.testing.assert_array_equal(got,
                                          full[y0:y0 + 224, x0:x0 + 224])


@pytest.mark.parametrize("angle", [7.3, -15.0, 45.0, 90.0, 170.0])
def test_rotation_follows_opencv(angle):
    rng = np.random.RandomState(3)
    for h, w in ((24, 24), (30, 40)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, 1.0)
        np.testing.assert_array_equal(
            tiio._rotation_matrix(w / 2.0, h / 2.0, angle), m)
        _within_one_level(
            tiio._warp_affine_reflect(img, m, (w, h)),
            cv2.warpAffine(img, m, (w, h), borderMode=cv2.BORDER_REFLECT))


def test_hls_follows_opencv():
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    _within_one_level(tiio._rgb_to_hls(img),
                      cv2.cvtColor(img, cv2.COLOR_RGB2HLS), frac=0.999)
    hls = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    hls[..., 0] %= 180
    _within_one_level(tiio._hls_to_rgb(hls),
                      cv2.cvtColor(hls, cv2.COLOR_HLS2RGB), frac=0.999)


# -- ImageRecordIter against the JAX Python engine ----------------------------------

def _make_rec(tmp_path, n=21, sides=(28, 44), name="imgs.rec", fmt="mixed",
              gray=False):
    """n seeded records with sides in ``sides`` whose mean encodes the
    label; RAW0 and PNG payloads alternate under ``fmt="mixed"``."""
    path = str(tmp_path / name)
    w = trec.MXRecordIO(path, "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        h, wd = rng.randint(sides[0], sides[1] + 1, 2)
        label = i % 10
        shape = (h, wd) if gray else (h, wd, 3)
        img = (label * 20 + rng.randint(0, 40, shape)).astype(np.uint8)
        kind = (".raw" if i % 2 else ".png") if fmt == "mixed" else fmt
        w.write(trec.pack_img((0, float(label), i, 0), img, quality=95,
                              img_fmt=kind))
    w.close()
    return path


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([(b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                     b.pad or 0) for b in it])
        it.reset()
    if hasattr(it, "close"):
        it.close()
    return out


EXACT = {
    "plain": dict(),
    "crop_mirror_shuffle": dict(rand_crop=True, rand_mirror=True,
                                shuffle=True, seed=5),
    "shard": dict(num_parts=3, part_index=1, shuffle=True, seed=2),
    "no_round_batch": dict(round_batch=False),
    "means_scale": dict(mean_r=120.0, mean_g=110.0, mean_b=100.0,
                        scale=1.0 / 58),
    "device_augment": dict(device_augment=True, rand_crop=True,
                           rand_mirror=True),
    "label_width": dict(label_width=2, shuffle=True, seed=1),
}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_image_record_iter_byte_identical_to_jax(tmp_path, jax_python_engine,
                                                 case):
    path = _make_rec(tmp_path)
    kw = dict(batch_size=8, **EXACT[case])
    want = _epochs(jax_iio.ImageRecordIter(path, (3, 24, 24), **kw))
    got = _epochs(mx.ImageRecordIter(path, (3, 24, 24), **kw))
    assert [len(e) for e in got] == [len(e) for e in want]
    for ew, eg in zip(want, got):
        for (d1, l1, p1), (d2, l2, p2) in zip(ew, eg):
            assert p1 == p2 and d1.dtype == d2.dtype
            np.testing.assert_array_equal(l2, l1)
            np.testing.assert_array_equal(d2, d1)


def test_image_record_iter_gray_follows_jax(tmp_path, jax_python_engine):
    """One-channel data from colour and from gray records (RAW0 and PNG)."""
    for gray in (False, True):
        path = _make_rec(tmp_path, name="g%d.rec" % gray, gray=gray)
        kw = dict(batch_size=8, rand_crop=True, shuffle=True, seed=3)
        want = _epochs(jax_iio.ImageRecordIter(path, (1, 24, 24), **kw), 1)
        got = _epochs(mx.ImageRecordIter(path, (1, 24, 24), **kw), 1)
        for (d1, l1, _), (d2, l2, _) in zip(want[0], got[0]):
            np.testing.assert_array_equal(l2, l1)
            np.testing.assert_array_equal(d2, d1)


TOLERANT = {
    "resize": (dict(resize=30, rand_crop=True), 1.0),
    "resize_normalised": (dict(resize=27, mean_r=10.0, mean_g=20.0,
                               mean_b=30.0, scale=0.5), 0.5),
    "rotate": (dict(max_rotate_angle=25, rand_mirror=True), 1.0),
    "hsl": (dict(random_h=20, random_s=30, random_l=25, shuffle=True,
                 seed=4), 1.0),
    "all": (dict(resize=32, rand_crop=True, max_rotate_angle=10,
                 random_h=8, random_s=8, random_l=8), 1.0),
}


@pytest.mark.parametrize("case", sorted(TOLERANT))
def test_image_record_iter_within_one_level_of_jax(tmp_path,
                                                   jax_python_engine, case):
    kw, level = TOLERANT[case]
    path = _make_rec(tmp_path, sides=(20, 60))
    want = _epochs(jax_iio.ImageRecordIter(path, (3, 24, 24), batch_size=8,
                                           **kw), 1)
    got = _epochs(mx.ImageRecordIter(path, (3, 24, 24), batch_size=8, **kw),
                  1)
    d = np.concatenate([np.abs(g[0] - w[0]).ravel()
                        for g, w in zip(got[0], want[0])])
    assert d.max() <= level * (1 + 1e-6), d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mean_img_cache_read_by_the_other_package(tmp_path,
                                                  jax_python_engine, writer):
    """``mean_img``: computed once by one package (over all records, raw
    pixels), cached atomically, read back by the other, and the batches
    equal."""
    path = _make_rec(tmp_path)
    mean_path = str(tmp_path / "mean.bin")
    kw = dict(batch_size=8, mean_img=mean_path, scale=0.5, rand_crop=True,
              shuffle=True, seed=2)
    first, second = (mx.ImageRecordIter, jax_iio.ImageRecordIter) \
        if writer == "port" else (jax_iio.ImageRecordIter,
                                  mx.ImageRecordIter)
    a = _epochs(first(path, (3, 24, 24), **kw))
    assert os.path.exists(mean_path)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    b = _epochs(second(path, (3, 24, 24), **kw))
    for ea, eb in zip(a, b):
        for (d1, l1, _), (d2, l2, _) in zip(ea, eb):
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_allclose(d1, d2, rtol=0, atol=1e-6)
    want = jax_iio._PyEngine(path, (3, 24, 24), 8, 1, (0, 0, 0), 1.0, 0,
                             False, False, False, 0, 1, 0, True,
                             mean_img=mean_path).mean_arr
    got = tiio._PyEngine(path, (3, 24, 24), 8, 1, (0, 0, 0), 1.0, 0,
                         False, False, False, 0, 1, 0, True,
                         mean_img=mean_path).mean_arr
    np.testing.assert_array_equal(got, want)


def test_scaled_jpeg_decode_follows_jax(tmp_path, jax_python_engine):
    """JPEG records large enough for a reduced-DCT decode: the port takes
    the JAX package's reduction, and the batches match it."""
    path = str(tmp_path / "big.rec")
    w = trec.MXRecordIO(path, "w")
    rng = np.random.RandomState(2)
    for i in range(8):
        img = np.kron(rng.randint(0, 256, (25, 25, 3)),
                      np.ones((8, 8, 1))).astype(np.uint8)
        w.write(trec.pack_img((0, float(i), i, 0), img, quality=90))
    w.close()
    kw = dict(batch_size=4, resize=30)
    for scaled in (True, False):
        want = _epochs(jax_iio.ImageRecordIter(
            path, (3, 24, 24), scaled_decode=scaled, **kw), 1)
        got = _epochs(mx.ImageRecordIter(
            path, (3, 24, 24), scaled_decode=scaled, **kw), 1)
        for (d1, _, _), (d2, _, _) in zip(want[0], got[0]):
            assert np.abs(d1 - d2).max() <= 1.0
            assert (d1 == d2).mean() >= 0.99
    raw = trec.MXRecordIO(path, "r").read()
    _, blob = trec.unpack(raw)
    assert tiio._PyEngine._probe_size(blob) == \
        jax_iio._PyEngine._probe_size(blob) == (200, 200)


def test_iter_numpy_and_provides(tmp_path, jax_python_engine):
    path = _make_rec(tmp_path)
    it = mx.ImageRecordIter(path, (3, 24, 24), batch_size=8,
                            device_augment=True)
    jt = jax_iio.ImageRecordIter(path, (3, 24, 24), batch_size=8,
                                 device_augment=True)
    assert it.provide_data == jt.provide_data == [("data", (8, 24, 24, 3))]
    assert it.provide_label == jt.provide_label
    for (d, lab, pad), (jd, jl, jp) in zip(it.iter_numpy(), jt.iter_numpy()):
        assert pad == jp
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jl)
    assert mx.io.ImageRecordIter(path, (3, 24, 24), 4).batch_size == 4
    with pytest.raises(MXNetError, match="data_shape"):
        mx.ImageRecordIter(path, (24, 24), 4)
