"""ImageRecordIter: the packed-image training data pipeline.

Counterpart of ``mxnet_tpu/image_io.py`` (the reference's
``src/io/iter_image_recordio.cc`` with its augmenter, normalize, batch
and prefetch stages, and its ``mx.io.ImageRecordIter`` keywords). The
port has no native decoder: it always runs the JAX package's Python
engine (``_PyEngine``) or, with ``num_workers``, its pool of decode
workers (``_ParallelEngine``), and its epochs are the JAX engine's:

* the per-record draws come from ``_record_rng``, a splitmix64 stream
  keyed by (seed, epoch, position), so every crop, mirror, rotation and
  HSL draw equals the JAX package's bit for bit, and a batch is the same
  whichever worker decodes it;
* the pixel work is numpy written to OpenCV's definitions (``cv2`` is not
  needed): ``resize`` as INTER_LINEAR (pixel-centre sampling, 11-bit
  weights, the exact-half case as INTER_AREA), the rotation as
  ``warpAffine`` with BORDER_REFLECT (``fedcba|abcdefgh|hgfedcb``), and
  the HSL jitter through OpenCV's RGB <-> HLS (H in [0, 180)). Without
  resize, rotation or HSL an epoch is byte-identical to the JAX engine's;
  with them a pixel may differ by one level where the rounding differs;
* only the JPEG/PNG codec takes OpenCV or Pillow (``recordio._codec``);
  the lossless RAW0 payload needs neither.

The decode workers are forked from the constructor and run numpy only:
no torch op and no CUDA call, so a parent that already holds a CUDA
context forks safely, and they exist before any pipeline thread does.
``device_augment_batch`` and ``DeviceAugmentIter`` do the random crop,
mirror and normalization in plain PyTorch on the batch's device, drawing
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time as _time

import numpy as np
import torch

from . import ndarray as nd
from . import recordio as rec
from . import telemetry as tele
from .base import MXNetError
from .context import cpu, resolve_device
from .io import DataIter, _stage_tensor

# decode-pool metrics; the decode time of a batch is measured in the
# worker and rides its announcement back to the consumer
_TM_DECODE_MS = tele.histogram("io.decode_batch_ms")
_TM_POOL_WAIT_MS = tele.histogram("io.pool_wait_ms")
_TM_POOL_STARVED = tele.counter("io.pool_starved")
_TM_POOL_BATCHES = tele.counter("io.pool_batches")
_TM_POOL_QDEPTH = tele.gauge("io.pool_queue_depth")

__all__ = ["ImageRecordIter", "device_augment_batch",
           "DeviceAugmentIter"]


_U64 = (1 << 64) - 1


class _LightRNG:
    """The per-record RNG of the augmentation draws (splitmix64): numpy's
    ``randint`` convention (exclusive high) and ``uniform``. Both
    packages' engines draw from this stream, which is what the epochs'
    byte identity rests on."""

    __slots__ = ("_s",)

    def __init__(self, state):
        self._s = state & _U64

    def _next(self):
        self._s = (self._s + 0x9E3779B97F4A7C15) & _U64
        z = self._s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        return z ^ (z >> 31)

    def randint(self, low, high=None):
        if high is None:
            low, high = 0, low
        return low + self._next() % (high - low)

    def uniform(self, low, high):
        return low + (high - low) * (self._next() / float(1 << 64))


def _record_rng(seed, epoch, pos):
    """The draws of record ``pos`` of epoch ``epoch``: keyed by position,
    not a sequential stream, so they do not depend on which worker
    decodes the record."""
    return _LightRNG((seed & 0xffffffff) * 0x9E3779B97F4A7C15
                     + (epoch & 0xffffffff) * 0xBF58476D1CE4E5B9
                     + pos * 0x94D049BB133111EB)


# -- pixel work (OpenCV's definitions, numpy) --------------------------------------

def _linear_taps(n_src, n_dst, scale):
    """One axis of INTER_LINEAR: source index pairs and 11-bit weights.
    Pixel centres map as ``(d + 0.5) * scale - 0.5`` (in float32, as
    OpenCV); outside the image the indices clamp and the weights stay."""
    d = np.arange(n_dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return (np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1)


def _resize_half(src, h, w, H, W):
    """The exact halving (OpenCV takes INTER_AREA for it): each 2x2 block
    averaged, ``(sum + 2) >> 2``; a block cut by an odd edge averages the
    pixels inside, rounded half to even."""
    ys, xs = np.arange(H) * 2, np.arange(W) * 2
    y1, x1 = np.minimum(ys + 1, h - 1), np.minimum(xs + 1, w - 1)
    a = src.astype(np.int32)
    s = a[ys][:, xs] + a[ys][:, x1] + a[y1][:, xs] + a[y1][:, x1]
    full = ((ys + 1 < h)[:, None] & (xs + 1 < w)[None, :])[:, :, None]
    return np.where(full, (s + 2) >> 2,
                    np.rint(s / 4.0).astype(np.int32)).astype(np.uint8)


def _resize_shape(shape, dsize=None, fx=None):
    """(H, W, sx, sy): the output size of ``_resize`` and its scales."""
    h, w = shape[:2]
    if dsize is None:
        return (int(np.rint(h * fx)), int(np.rint(w * fx)), 1.0 / fx,
                1.0 / fx)
    W, H = dsize
    return H, W, w / W, h / H


def _resize(img, dsize=None, fx=None, window=None):
    """``cv2.resize(img, dsize)`` or ``cv2.resize(img, None, fx=fx,
    fy=fx)`` for uint8 HxW or HxWxC, INTER_LINEAR. ``window=(y0, x0, h,
    w)`` returns only that crop of the output (each output pixel depends
    on its own taps alone, so the crop's values are the same)."""
    h, w = img.shape[:2]
    H, W, sx, sy = _resize_shape(img.shape, dsize, fx)
    y0w, x0w, hw, ww = window if window is not None else (0, 0, H, W)
    if (W, H) == (w, h):
        # OpenCV copies; every caller copies later
        return img[y0w:y0w + hw, x0w:x0w + ww]
    src = img if img.ndim == 3 else img[:, :, None]
    c = src.shape[2]
    if sx == 2.0 and sy == 2.0:
        out = _resize_half(src, h, w, H, W)[y0w:y0w + hw, x0w:x0w + ww]
        return out if img.ndim == 3 else out[:, :, 0]
    x0, x1, a0, a1 = (t[x0w:x0w + ww] for t in _linear_taps(w, W, sx))
    y0, y1, b0, b1 = (t[y0w:y0w + hw] for t in _linear_taps(h, H, sy))
    # the channels interleaved in the columns; a channel-reversed view
    # (an RGB view of BGR pixels) is read through its base, not copied
    ch = np.arange(c)
    if c > 1 and src.strides[2] < 0 and src[:, :, ::-1].flags.c_contiguous:
        src, ch = src[:, :, ::-1], ch[::-1]
    flat = np.ascontiguousarray(src).reshape(h, w * c)
    # the horizontal pass over the source rows the output reads
    rows = np.unique(np.concatenate([y0, y1]))
    s = flat[rows].astype(np.int32)
    hor = np.take(s, (x0[:, None] * c + ch).ravel(), axis=1)
    hor *= np.repeat(a0, c)
    right = np.take(s, (x1[:, None] * c + ch).ravel(), axis=1)
    right *= np.repeat(a1, c)
    hor += right
    hor >>= 4
    # the vertical pass, rounded as OpenCV's vector code rounds it
    top = hor[np.searchsorted(rows, y0)]
    top *= b0[:, None]
    top >>= 16
    bot = hor[np.searchsorted(rows, y1)]
    bot *= b1[:, None]
    bot >>= 16
    top += bot
    top += 2
    top >>= 2
    np.clip(top, 0, 255, out=top)
    out = top.astype(np.uint8).reshape(hw, ww, c)
    return out if img.ndim == 3 else out[:, :, 0]


def _rotation_matrix(cx, cy, angle):
    """``cv2.getRotationMatrix2D((cx, cy), angle, 1.0)``."""
    a = angle * (np.pi / 180)
    al, be = np.cos(a), np.sin(a)
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]])


def _reflect(p, n):
    """BORDER_REFLECT indices: ``fedcba|abcdefgh|hgfedcb``."""
    if n == 1:
        return np.zeros_like(p)
    m = np.mod(p, 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m)


def _warp_affine_reflect(img, M, dsize):
    """``cv2.warpAffine(img, M, dsize, borderMode=BORDER_REFLECT)`` for
    uint8, bilinear: the inverse map in float32, the source sampled at
    each destination pixel, neighbours outside the image reflected."""
    W, H = dsize
    m = M.astype(np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    m = m.astype(np.float32)
    xs = np.arange(W, dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)
    X = m[0] * xs[None, :] + (m[1] * ys[:, None] + m[2])
    Y = m[3] * xs[None, :] + (m[4] * ys[:, None] + m[5])
    sx, sy = np.floor(X), np.floor(Y)
    fx, fy = (X - sx)[..., None], (Y - sy)[..., None]
    sx, sy = sx.astype(np.int64), sy.astype(np.int64)
    h, w = img.shape[:2]
    src = (img if img.ndim == 3 else img[:, :, None]).astype(np.float32)
    x0, x1 = _reflect(sx, w), _reflect(sx + 1, w)
    y0, y1 = _reflect(sy, h), _reflect(sy + 1, h)
    one = np.float32(1)
    v = ((src[y0, x0] * (one - fx) + src[y0, x1] * fx) * (one - fy)
         + (src[y1, x0] * (one - fx) + src[y1, x1] * fx) * fy)
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[:, :, 0]


_F = np.float32


def _rgb_to_hls(img):
    """``cv2.cvtColor(img, COLOR_RGB2HLS)`` for uint8 (float32 inside, H
    in [0, 180)), as OpenCV 5 rounds it."""
    x = img.astype(np.float32) * _F(1.0 / 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = vmax - vmin
    lum = (vmax + vmin) * _F(0.5)
    chroma = diff > np.finfo(np.float32).eps
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(lum < _F(0.5), diff / (vmax + vmin),
                     diff / (_F(2) - (vmax + vmin)))
        k = (_F(60) / diff).astype(np.float64)

        def fma(a, c):
            # OpenCV's vector code fuses the multiply and the add: one
            # rounding to float32
            return (a.astype(np.float64) * k + c).astype(np.float32)

        h = np.where(vmax == r, fma(g - b, 0.0),
                     np.where(vmax == g, fma(b - r, 120.0),
                              fma(r - g, 240.0)))
    h = np.where(h < 0, h + _F(360), h)
    h = np.where(chroma, h, _F(0))
    s = np.where(chroma, s, _F(0))
    out = np.stack([h * _F(0.5), lum * _F(255), s * _F(255)], -1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# OpenCV's HLS2RGB sector table: which of (p2, p1, falling, rising) each
# of b, g, r takes
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def _hls_to_rgb(hls):
    """``cv2.cvtColor(hls, COLOR_HLS2RGB)`` for uint8."""
    x = hls.astype(np.float32)
    lum = x[..., 1] * _F(1.0 / 255.0)
    s = x[..., 2] * _F(1.0 / 255.0)
    p2 = np.where(lum <= _F(0.5), lum * (_F(1) + s), lum + s - lum * s)
    p1 = _F(2) * lum - p2
    h = np.mod(x[..., 0] * _F(6.0 / 180.0), _F(6))
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    tab = np.stack([p2, p1, p1 + (p2 - p1) * (_F(1) - h),
                    p1 + (p2 - p1) * h], -1)
    idx = _SECTORS[np.clip(sector, 0, 5)]
    bgr = [np.take_along_axis(tab, idx[..., i:i + 1], -1)[..., 0]
           for i in range(3)]
    gray = s == 0
    rgb = np.stack([np.where(gray, lum, c) for c in bgr[::-1]], -1)
    return np.clip(np.rint(rgb * _F(255)), 0, 255).astype(np.uint8)


# -- the device stage ---------------------------------------------------------------

def device_augment_batch(data_u8, key=None, crop_shape=None,
                         rand_crop=False, rand_mirror=False,
                         mean=(0.0, 0.0, 0.0), scale=1.0):
    """The device-side augmentation of ``device_augment`` batches, in
    plain PyTorch on the batch's device: the ``[B, H, W, C]`` uint8 batch
    cropped (at random offsets, or centred) to ``crop_shape=(h, w)``,
    mirrored at random, normalized ``(x - mean) * scale`` per channel, and
    returned as the ``[B, C, h, w]`` float32 batch the host augmenter
    would have made. ``key`` is the ``torch.Generator`` (on the batch's
    device) of the draws, needed with ``rand_crop``/``rand_mirror``: the
    row offsets, then the column offsets, then the mirror flags, each a
    ``[B]`` draw (the JAX package takes a PRNG key)."""
    x = data_u8._tensor if isinstance(data_u8, nd.NDArray) else data_u8
    b, big_h, big_w, c = x.shape
    h, w = crop_shape if crop_shape is not None else (big_h, big_w)
    if (rand_crop or rand_mirror) and key is None:
        raise MXNetError("device_augment_batch: random augmentation "
                         "needs a torch.Generator (key=)")
    dev = x.device
    if rand_crop and (h < big_h or w < big_w):
        y0 = torch.randint(0, big_h - h + 1, (b,), generator=key,
                           device=dev)
        x0 = torch.randint(0, big_w - w + 1, (b,), generator=key,
                           device=dev)
        rows = y0[:, None] + torch.arange(h, device=dev)
        cols = x0[:, None] + torch.arange(w, device=dev)
        x = x[torch.arange(b, device=dev)[:, None, None], rows[:, :, None],
              cols[:, None, :]]
    elif h < big_h or w < big_w:
        y0 = (big_h - h) // 2
        x0 = (big_w - w) // 2
        x = x[:, y0:y0 + h, x0:x0 + w, :]
    if rand_mirror:
        flip = torch.rand((b,), generator=key, device=dev) < 0.5
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    xf = x.to(torch.float32)
    m = torch.tensor(list(mean), dtype=torch.float32, device=dev)[:c]
    xf = (xf - m) * torch.tensor(float(scale), dtype=torch.float32,
                                 device=dev)
    return xf.permute(0, 3, 1, 2).contiguous()


class ImageRecordIter(DataIter):
    """Iterate packed image records as normalized NCHW float batches.

    Parameters (the reference's keywords): path_imgrec, data_shape
    (c, h, w), batch_size, label_width, mean_r/g/b, scale, resize (the
    shorter edge), rand_crop, rand_mirror, shuffle, seed, num_parts,
    part_index, preprocess_threads, prefetch_buffer, round_batch,
    mean_img, max_rotate_angle, random_h/s/l.

    ``device_augment=True`` emits uint8 HWC batches at ``data_shape``
    (decode, resize and centre crop only; the random crop, mirror and
    normalization are ``device_augment_batch``'s). ``scaled_decode``
    lets a JPEG decode at 1/2, 1/4 or 1/8 scale when the target allows.
    ``num_workers=N`` (default ``MXNET_IO_NUM_WORKERS``, 0) decodes in N
    forked workers (``worker_mode="thread"`` for threads), each collating
    into shared memory with ``queue_depth`` batches buffered; an epoch is
    byte-identical to the serial engine's for any N, a worker crash
    raises instead of hanging, and ``close()`` reaps every worker.
    ``path_imgidx`` names the index sidecar (offsets without a scan).
    ``preprocess_threads`` and ``prefetch_buffer`` configure the JAX
    package's native engine, which the port does not have.

    The batches' arrays are NDArrays on ``cpu()``, copied out of the
    pool's reused slots; ``iter_numpy`` hands out the slots themselves.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, scale=1.0, resize=0,
                 rand_crop=False, rand_mirror=False, shuffle=False, seed=0,
                 num_parts=1, part_index=0, preprocess_threads=4,
                 prefetch_buffer=4, round_batch=True, data_name="data",
                 label_name="softmax_label", mean_img=None,
                 max_rotate_angle=0, random_h=0, random_s=0, random_l=0,
                 device_augment=False, scaled_decode=True,
                 num_workers=None, worker_mode=None, queue_depth=None,
                 path_imgidx=None):
        super().__init__()
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (channels, height, width)")
        self.batch_size = batch_size
        self._data_shape = tuple(data_shape)
        self._label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        self._pad = 0
        self._data = None
        self._label = None
        self._device_augment = bool(device_augment)
        if num_workers is None:
            num_workers = int(os.environ.get("MXNET_IO_NUM_WORKERS",
                                             "0") or 0)
        if worker_mode is None:
            worker_mode = os.environ.get("MXNET_IO_WORKER_MODE",
                                         "process")
        self._num_workers = int(num_workers)
        kwargs = dict(mean_img=mean_img, max_rotate_angle=max_rotate_angle,
                      random_h=random_h, random_s=random_s,
                      random_l=random_l, out_uint8=device_augment,
                      scaled_decode=scaled_decode, path_imgidx=path_imgidx)
        args = (path_imgrec, self._data_shape, batch_size, label_width,
                (mean_r, mean_g, mean_b), scale, resize,
                rand_crop and not device_augment,
                rand_mirror and not device_augment, shuffle, seed,
                num_parts, part_index, round_batch)
        if self._num_workers > 0:
            self._py = _ParallelEngine(
                *args, num_workers=self._num_workers,
                worker_mode=worker_mode, queue_depth=queue_depth, **kwargs)
        else:
            self._py = _PyEngine(*args, **kwargs)

    @property
    def provide_data(self):
        if self._device_augment:
            c, h, w = self._data_shape
            return [(self._data_name, (self.batch_size, h, w, c))]
        return [(self._data_name, (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [(self._label_name,
                 (self.batch_size,)
                 if self._label_width == 1
                 else (self.batch_size, self._label_width))]

    def reset(self):
        self._py.reset()

    def iter_next(self):
        got = self._py.next()
        if got is None:
            return False
        data, label, self._pad = got
        if self._label_width == 1:
            label = label.reshape(self.batch_size)
        # one copy out of the (possibly reused) slot: the batch outlives
        # the next iteration
        self._data = nd.NDArray(torch.from_numpy(np.array(data)), cpu())
        self._label = nd.NDArray(torch.from_numpy(np.array(label)), cpu())
        return True

    def iter_numpy(self):
        """Yield ``(data, label, pad)`` as numpy arrays without copying:
        the pool's slots are reused, so consume or copy each before the
        next."""
        while True:
            got = self._py.next()
            if got is None:
                return
            yield got

    def getdata(self):
        return [self._data]

    def getlabel(self):
        return [self._label]

    def getpad(self):
        return self._pad

    def close(self):
        """Shut the decode pool down (joined and reaped, no stray
        processes); idempotent, also run by ``__del__``."""
        py = getattr(self, "_py", None)
        if py is not None:
            py.close()

    def __del__(self):
        self.close()


class _PyEngine:
    """The serial engine (the JAX package's Python engine), and the
    decode kernel of each pool worker: a worker builds one with its
    pre-sharded ``offsets`` and the parent's ``mean_arr`` and calls
    ``load_batch``, which depends only on (seed, epoch, batch index)."""

    def __init__(self, path, data_shape, batch_size, label_width, means,
                 scale, resize, rand_crop, rand_mirror, shuffle, seed,
                 num_parts, part_index, round_batch, mean_img=None,
                 max_rotate_angle=0, random_h=0, random_s=0, random_l=0,
                 out_uint8=False, scaled_decode=True, path_imgidx=None,
                 offsets=None, mean_arr=None):
        self.out_uint8 = out_uint8
        self.scaled_decode = scaled_decode
        self.path = path
        self.data_shape = data_shape
        self.batch_size = batch_size
        self.label_width = label_width
        self.means = np.array(means, np.float32)
        self.scale = scale
        self.resize = resize
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.shuffle = shuffle
        self.seed = seed
        self.round_batch = round_batch
        self.max_rotate_angle = max_rotate_angle
        self.random_h = random_h
        self.random_s = random_s
        self.random_l = random_l
        self.mean_arr = mean_arr
        self.part_index = part_index
        if offsets is not None:
            # a pool worker: the parent scanned and sharded
            self._all_offsets = list(offsets)
            self.offsets = list(offsets)
        else:
            all_offsets = rec.list_record_offsets(path, path_imgidx)
            self._all_offsets = all_offsets  # the mean image is global
            self.offsets = all_offsets[part_index::num_parts]
        if not self.offsets:
            raise MXNetError("empty shard")
        self.epoch = 0
        self.reset()
        if mean_img is not None and mean_arr is None:
            self._setup_mean_img(mean_img)

    def _setup_mean_img(self, path):
        """Load the (c, h, w) mean image, computing and caching it on
        first use (reference ``iter_normalize.h``): over ALL records, raw
        pixels (no augmentation, no scalar normalization), written
        atomically (tmp + os.replace) in the ``.params`` format either
        package reads. Under ``num_parts > 1`` only part 0 computes; the
        others wait for the file (``MXNET_MEAN_IMG_TIMEOUT``)."""
        if self.part_index != 0 and not os.path.exists(path):
            deadline = _time.time() + float(
                os.environ.get("MXNET_MEAN_IMG_TIMEOUT", 600))
            while not os.path.exists(path):
                if _time.time() > deadline:
                    break  # compute it here: the same result
                _time.sleep(0.2)
        if os.path.exists(path):
            loaded = nd.load(path)
            arr = (loaded.get("mean_img") if isinstance(loaded, dict)
                   else loaded[0])
            self.mean_arr = arr.asnumpy().astype(np.float32)
            return
        saved = (self.rand_crop, self.rand_mirror, self.max_rotate_angle,
                 self.random_h, self.random_s, self.random_l, self.means,
                 self.scale)
        self.rand_crop = self.rand_mirror = False
        self.max_rotate_angle = self.random_h = self.random_s = \
            self.random_l = 0
        self.means = np.zeros(3, np.float32)
        self.scale = 1.0
        total = np.zeros(self.data_shape, np.float64)
        count = 0
        no_draws = _record_rng(0, 0, 0)  # augmentation is off
        for off in self._all_offsets:
            img, _ = self._load(off, no_draws)
            total += img
            count += 1
        self.mean_arr = (total / max(count, 1)).astype(np.float32)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        nd.save(tmp, {"mean_img": self.mean_arr})
        os.replace(tmp, path)
        (self.rand_crop, self.rand_mirror, self.max_rotate_angle,
         self.random_h, self.random_s, self.random_l, self.means,
         self.scale) = saved
        # rewind the epoch count: a cold cache (computed) and a warm one
        # (loaded) then see the same shuffles and draws
        self.epoch -= 1
        self.reset()

    def order_for(self, epoch):
        """Epoch ``epoch``'s record order: the shard's offsets shuffled
        under the (seed, epoch) stream."""
        order = list(self.offsets)
        if self.shuffle:
            rng = np.random.RandomState(
                ((self.seed << 10) + epoch) & 0xffffffff)
            rng.shuffle(order)
        return order

    def num_batches(self):
        """Batches an epoch (the last partial one padded under
        round_batch, dropped otherwise)."""
        full, rem = divmod(len(self.offsets), self.batch_size)
        return full + (1 if rem and self.round_batch else 0)

    def reset(self):
        self.cur_epoch = self.epoch
        self.order = self.order_for(self.cur_epoch)
        self.cursor = 0
        self.epoch += 1
        self.reader = rec.MXRecordIO(self.path, "r")

    def _header_label(self, header):
        label = np.zeros(self.label_width, np.float32)
        lab = header.label
        if isinstance(lab, np.ndarray):
            label[:min(self.label_width, lab.size)] = lab[:self.label_width]
        else:
            label[0] = lab
        return label

    @staticmethod
    def _probe_size(blob):
        """(rows, cols) from the JPEG SOF or PNG IHDR bytes, without a
        decode."""
        d = blob
        n = len(d)
        if n >= 24 and d[:4] == b"\x89PNG":
            cols = int.from_bytes(d[16:20], "big")
            rows = int.from_bytes(d[20:24], "big")
            return (rows, cols) if rows and cols else None
        if n < 4 or d[0] != 0xFF or d[1] != 0xD8:
            return None
        i = 2
        while i + 9 < n:
            if d[i] != 0xFF:
                return None
            marker = d[i + 1]
            if marker == 0xD8 or 0xD0 <= marker <= 0xD9:
                i += 2
                continue
            seg = (d[i + 2] << 8) | d[i + 3]
            if (0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8,
                                                          0xCC)):
                rows = (d[i + 5] << 8) | d[i + 6]
                cols = (d[i + 7] << 8) | d[i + 8]
                return (rows, cols) if rows and cols else None
            i += 2 + seg
        return None

    def _decode(self, raw):
        """Header and pixels; a JPEG decodes at the largest reduction (1/8,
        1/4, 1/2 of its DCT) that still covers the resize or crop target
        (OpenCV's ``IMREAD_REDUCED_*``, Pillow's ``draft``)."""
        iscolor = 1 if self.data_shape[0] == 3 else 0
        header, blob = rec.unpack(raw)
        if blob[:4] == rec._RAW_MAGIC or not self.scaled_decode:
            return rec.unpack_img(raw, iscolor)
        probed = self._probe_size(blob)
        if probed is None:
            return rec.unpack_img(raw, iscolor)
        rows, cols = probed
        c, h, w = self.data_shape
        need = self.resize if self.resize > 0 else max(h, w)
        for k in (8, 4, 2):
            if rows // k >= max(need, h) and cols // k >= max(need, w):
                img = _decode_reduced(blob, k, iscolor)
                if img is not None:
                    return header, img
                break
        return rec.unpack_img(raw, iscolor)

    def _load(self, offset, rng):
        self.reader.seek(offset)
        raw = self.reader.read()
        header, img = self._decode(raw)
        c, h, w = self.data_shape
        fx = self.resize / min(img.shape[0], img.shape[1]) \
            if self.resize > 0 else None
        if fx is not None:
            H, W = _resize_shape(img.shape, fx=fx)[:2]
            if H < h or W < w:
                img = _resize(img, fx=fx)
                fx = None
        else:
            H, W = img.shape[:2]
        if H < h or W < w:
            img = _resize(img, (max(img.shape[1], w), max(img.shape[0], h)))
            H, W = img.shape[:2]
        if self.rand_crop:
            y0 = rng.randint(0, H - h + 1)
            x0 = rng.randint(0, W - w + 1)
        else:
            y0 = (H - h) // 2
            x0 = (W - w) // 2
        if fx is not None:
            # only the crop of the resize is computed
            img = _resize(img, fx=fx, window=(y0, x0, h, w))
        else:
            img = img[y0:y0 + h, x0:x0 + w]
        if self.rand_mirror and rng.randint(2):
            img = img[:, ::-1]
        if self.max_rotate_angle:
            angle = rng.uniform(-self.max_rotate_angle,
                                self.max_rotate_angle)
            m = _rotation_matrix(w / 2.0, h / 2.0, angle)
            img = _warp_affine_reflect(img, m, (w, h))
        if (self.random_h or self.random_s or self.random_l) and \
                img.ndim == 3 and img.shape[2] == 3:
            # the reference's HSL jitter: uniform noise added per channel
            # in HLS space
            hls = _rgb_to_hls(img).astype(np.float32)
            hls[..., 0] += rng.uniform(-self.random_h, self.random_h)
            hls[..., 1] += rng.uniform(-self.random_l, self.random_l)
            hls[..., 2] += rng.uniform(-self.random_s, self.random_s)
            hls[..., 0] %= 180.0
            img = _hls_to_rgb(np.clip(hls, 0, 255).astype(np.uint8))
        if img.ndim == 2:
            img = img[:, :, None]
        if self.out_uint8:
            return (np.ascontiguousarray(img, np.uint8),
                    self._header_label(header))
        out = img.astype(np.float32)
        if self.mean_arr is not None:
            out = out - self.mean_arr.transpose(1, 2, 0)
            out = out * self.scale
        else:
            out = (out - self.means[:c]) * self.scale
        return out.transpose(2, 0, 1), self._header_label(header)

    def batch_buffers(self):
        """Fresh (data, label) arrays of one batch: also the slot layout
        of the pool's shared memory."""
        c, h, w = self.data_shape
        if self.out_uint8:
            data = np.zeros((self.batch_size, h, w, c), np.uint8)
        else:
            data = np.zeros((self.batch_size, c, h, w), np.float32)
        label = np.zeros((self.batch_size, self.label_width), np.float32)
        return data, label

    def load_batch(self, order, epoch, b, data=None, label=None):
        """Decode batch ``b`` of epoch ``epoch`` of ``order`` into (data,
        label, pad), into the caller's buffers when given."""
        n = len(order)
        start = b * self.batch_size
        count = min(self.batch_size, n - start)
        if data is None:
            data, label = self.batch_buffers()
        for s in range(self.batch_size):
            pos = start + s
            idx = pos % n  # round-over padding
            data[s], label[s] = self._load(order[idx],
                                           _record_rng(self.seed, epoch,
                                                       pos))
        return data, label, self.batch_size - count

    def next(self):
        n = len(self.order)
        if self.cursor >= n:
            return None
        count = min(self.batch_size, n - self.cursor)
        if not self.round_batch and count < self.batch_size:
            return None
        out = self.load_batch(self.order, self.cur_epoch,
                              self.cursor // self.batch_size)
        self.cursor += self.batch_size
        return out

    def close(self):
        reader = getattr(self, "reader", None)
        if reader is not None:
            reader.close()


def _decode_reduced(blob, k, iscolor):
    """A JPEG/PNG decoded at 1/k scale (RGB or gray), or None."""
    kind, lib = rec._codec()
    if kind == "cv2":
        flags = {8: lib.IMREAD_REDUCED_COLOR_8, 4: lib.IMREAD_REDUCED_COLOR_4,
                 2: lib.IMREAD_REDUCED_COLOR_2} if iscolor else \
            {8: lib.IMREAD_REDUCED_GRAYSCALE_8,
             4: lib.IMREAD_REDUCED_GRAYSCALE_4,
             2: lib.IMREAD_REDUCED_GRAYSCALE_2}
        img = lib.imdecode(np.frombuffer(blob, np.uint8), flags[k])
        if img is not None and img.ndim == 3:
            img = img[:, :, ::-1]  # BGR -> RGB
        return img
    import io as _io
    try:
        pil = lib.open(_io.BytesIO(blob))
        mode = "RGB" if iscolor else "L"
        pil.draft(mode, (pil.size[0] // k, pil.size[1] // k))
        return np.asarray(pil.convert(mode))
    except Exception:
        return None


def _shared_batch_buffers(template, nslots, shared):
    """``nslots`` (data, label) slot pairs shaped like one batch; with
    ``shared`` in anonymous MAP_SHARED mmaps made before the fork, so the
    workers collate into memory the consumer reads (only an (epoch,
    batch, slot, pad) tuple crosses a pipe)."""
    import mmap

    slots = []
    for _ in range(nslots):
        data, label = template.batch_buffers()
        if shared:
            pair = []
            for a in (data, label):
                buf = mmap.mmap(-1, max(a.nbytes, 1))
                pair.append(np.frombuffer(buf, dtype=a.dtype)
                            .reshape(a.shape))
            slots.append(tuple(pair))
        else:
            slots.append((data, label))
    return slots


def _decode_worker_main(cfg, mean_arr, wid, num_workers, ctl_q, out_q,
                        gen, slots, own_process=True):
    """A decode worker (forked process, or a thread under
    ``worker_mode="thread"``): for each epoch command, decode this
    worker's share of the batches (batch b goes to worker b % N) into its
    slot ring and announce each as (epoch, batch, slot, pad, decode
    seconds). A bumped ``gen`` abandons a stale epoch between batches;
    an exception is reported on the queue and ends the worker. Numpy
    only: no torch op, no CUDA."""
    try:
        if own_process:
            # the pool is the parallelism: a codec's own threads would
            # oversubscribe the cores (processes only; in thread mode
            # this would change the parent's setting)
            try:
                import cv2
                cv2.setNumThreads(0)
            except Exception:
                pass
        eng = _PyEngine(mean_arr=mean_arr, **cfg)
        while True:
            cmd = ctl_q.get()
            if cmd[0] == "quit":
                return
            epoch = cmd[1]
            order = eng.order_for(epoch)
            produced = 0
            for b in range(wid, eng.num_batches(), num_workers):
                if gen.value != epoch:
                    break  # superseded by a reset
                data, label = slots[produced % len(slots)]
                tic = _time.perf_counter()
                _, _, pad = eng.load_batch(order, epoch, b, data, label)
                out_q.put((epoch, b, produced % len(slots), pad,
                           _time.perf_counter() - tic))
                produced += 1
    except BaseException:
        import traceback
        try:
            out_q.put(("error", traceback.format_exc()))
        except Exception:
            pass


class _ParallelEngine:
    """The pool of decode workers behind the ``_PyEngine`` interface.

    An epoch's batches are dealt round-robin over ``num_workers`` workers
    (forked processes, or threads); each decodes and collates into its
    shared slot ring and announces finished batches on a bounded queue
    (``queue_depth``); the consumer takes batch b from worker b % N, so
    the order is the serial engine's. ``reset()`` bumps the epoch
    generation (workers abandon a stale epoch at the next batch; stale
    announcements are discarded by tag). A worker's death (an exception
    or a kill) raises ``MXNetError`` at the consumer; ``close()`` stops
    and reaps every worker."""

    def __init__(self, path, data_shape, batch_size, label_width, means,
                 scale, resize, rand_crop, rand_mirror, shuffle, seed,
                 num_parts, part_index, round_batch, mean_img=None,
                 max_rotate_angle=0, random_h=0, random_s=0, random_l=0,
                 out_uint8=False, scaled_decode=True, path_imgidx=None,
                 num_workers=1, worker_mode="process", queue_depth=None):
        if queue_depth is None:
            queue_depth = int(os.environ.get("MXNET_IO_QUEUE_DEPTH",
                                             "4") or 4)
        self.num_workers = int(num_workers)
        self.queue_depth = max(1, int(queue_depth))
        if worker_mode not in ("process", "thread"):
            raise MXNetError("worker_mode must be 'process' or 'thread', "
                             "got %r" % (worker_mode,))
        # the template scans the offsets, checks the configuration and
        # makes the mean image ONCE in the parent; workers inherit them
        self._template = _PyEngine(
            path, data_shape, batch_size, label_width, means, scale,
            resize, rand_crop, rand_mirror, shuffle, seed, num_parts,
            part_index, round_batch, mean_img=mean_img,
            max_rotate_angle=max_rotate_angle, random_h=random_h,
            random_s=random_s, random_l=random_l, out_uint8=out_uint8,
            scaled_decode=scaled_decode, path_imgidx=path_imgidx)
        self._template.close()  # the parent never decodes
        self.batch_size = batch_size
        self._nb = self._template.num_batches()
        self._timeout = float(os.environ.get("MXNET_IO_WORKER_TIMEOUT",
                                             "300") or 300)
        use_proc = worker_mode == "process"
        ctx = None
        if use_proc:
            import multiprocessing as mp
            try:
                ctx = mp.get_context("fork")
            except ValueError:  # no fork on this platform
                use_proc = False
        self._is_proc = use_proc
        cfg = dict(path=path, data_shape=data_shape,
                   batch_size=batch_size, label_width=label_width,
                   means=tuple(np.asarray(means, np.float32)),
                   scale=scale, resize=resize, rand_crop=rand_crop,
                   rand_mirror=rand_mirror, shuffle=shuffle, seed=seed,
                   num_parts=1, part_index=0, round_batch=round_batch,
                   max_rotate_angle=max_rotate_angle, random_h=random_h,
                   random_s=random_s, random_l=random_l,
                   out_uint8=out_uint8, scaled_decode=scaled_decode,
                   offsets=self._template.offsets)
        # queue_depth announced + 1 the consumer reads + 1 being written
        nslots = self.queue_depth + 2
        self._slots, self._ctl, self._out, self._workers = [], [], [], []
        if use_proc:
            self._gen = ctx.Value("l", 0)
        else:
            class _Gen:
                value = 0
            self._gen = _Gen()
        for wid in range(self.num_workers):
            slots = _shared_batch_buffers(self._template, nslots,
                                          shared=use_proc)
            if use_proc:
                ctl, out = ctx.Queue(), ctx.Queue(maxsize=self.queue_depth)
                make = ctx.Process
            else:
                ctl, out = _queue.Queue(), \
                    _queue.Queue(maxsize=self.queue_depth)
                make = threading.Thread
            w = make(target=_decode_worker_main,
                     args=(cfg, self._template.mean_arr, wid,
                           self.num_workers, ctl, out, self._gen, slots,
                           use_proc),
                     daemon=True, name="mx-decode-%d" % wid)
            self._slots.append(slots)
            self._ctl.append(ctl)
            self._out.append(out)
            self._workers.append(w)
            import warnings
            with warnings.catch_warnings():
                # Python warns that fork() from a multithreaded process
                # can deadlock; the workers run numpy only
                warnings.filterwarnings(
                    "ignore", message=r".*fork\(\).*",
                    category=DeprecationWarning)
                warnings.filterwarnings(
                    "ignore", message=r".*fork\(\).*",
                    category=RuntimeWarning)
                w.start()
        self._closed = False
        self.epoch = 0
        self.reset()

    @property
    def offsets(self):
        return self._template.offsets

    @property
    def mean_arr(self):
        return self._template.mean_arr

    def reset(self):
        """Start the next epoch: bump the generation and send the epoch
        command; stale batches in flight are discarded by tag."""
        if self._closed:
            raise MXNetError("ImageRecordIter worker pool is closed")
        self.cur_epoch = self.epoch
        self.epoch += 1
        self._gen.value = self.cur_epoch
        for ctl in self._ctl:
            ctl.put(("epoch", self.cur_epoch))
        self._next_b = 0

    def _pop(self, wid):
        """Worker ``wid``'s next announcement of this epoch; raises on a
        failure, a death or ``MXNET_IO_WORKER_TIMEOUT`` seconds of
        silence instead of hanging."""
        deadline = _time.time() + self._timeout
        tic = _time.perf_counter()
        while True:
            try:
                item = self._out[wid].get(timeout=0.2)
            except _queue.Empty:
                if not self._workers[wid].is_alive():
                    self.close()
                    raise MXNetError(
                        "decode worker %d died (killed or crashed "
                        "without a traceback) - batch %d will never "
                        "arrive" % (wid, self._next_b))
                if _time.time() > deadline:
                    self.close()
                    raise MXNetError(
                        "decode worker %d produced nothing for %.0f s "
                        "(MXNET_IO_WORKER_TIMEOUT)"
                        % (wid, self._timeout))
                continue
            if item[0] == "error":
                self.close()
                raise MXNetError("decode worker %d failed:\n%s"
                                 % (wid, item[1]))
            if item[0] != self.cur_epoch:
                continue  # left over from before a reset
            wait = _time.perf_counter() - tic
            _TM_POOL_WAIT_MS.observe(wait * 1e3)
            if wait > 1e-3:  # the pool kept the consumer waiting
                _TM_POOL_STARVED.inc()
            return item

    def next(self):
        if self._next_b >= self._nb:
            return None
        b = self._next_b
        wid = b % self.num_workers
        epoch, got_b, slot, pad, decode_s = self._pop(wid)
        if got_b != b:  # pragma: no cover - protocol invariant
            self.close()
            raise MXNetError(
                "decode pool out of order: expected batch %d from "
                "worker %d, got %d" % (b, wid, got_b))
        _TM_DECODE_MS.observe(decode_s * 1e3)
        _TM_POOL_BATCHES.inc()
        try:
            # ready batches queued over the whole pool
            _TM_POOL_QDEPTH.set(sum(q.qsize() for q in self._out))
        except NotImplementedError:  # no qsize on some platforms
            pass
        self._next_b += 1
        data, label = self._slots[wid][slot]
        return data, label, pad

    def close(self):
        """Shut the pool down: abandon the epoch, drain the queues so a
        blocked worker can exit, and reap every process."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        self._gen.value = -1
        for ctl in self._ctl:
            try:
                ctl.put(("quit",))
            except Exception:
                pass
        deadline = _time.time() + 5.0
        for wid, w in enumerate(self._workers):
            while w.is_alive() and _time.time() < deadline:
                try:  # unblock a worker stuck in a full-queue put
                    self._out[wid].get_nowait()
                except _queue.Empty:
                    pass
                w.join(timeout=0.05)
            if self._is_proc and w.is_alive():
                w.terminate()
                w.join(timeout=1.0)
        if self._is_proc:
            for q in self._ctl + self._out:
                q.cancel_join_thread()
                q.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DeviceAugmentIter(DataIter):
    """Wrap a ``device_augment=True`` ImageRecordIter: its uint8 HWC
    batches go to the device (a quarter of the float bytes) and the
    random crop, mirror and normalization run there
    (``device_augment_batch``, plain PyTorch), giving normalized float
    NCHW batches as the host pipeline would. ``crop_shape=(h, w)`` is the
    training crop (default: the storage shape). The draws come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``. ``device``
    (keyword-only, the port's own): where the batches go; None means
    ``cuda:0``. Wrap it in ``DevicePrefetchIter`` to run the upload and
    the augmentation on its pipeline thread."""

    def __init__(self, base, crop_shape=None, rand_crop=True,
                 rand_mirror=True, mean=(0.0, 0.0, 0.0), scale=1.0,
                 seed=0, *, device=None):
        super().__init__()
        if not getattr(base, "_device_augment", False):
            raise MXNetError("DeviceAugmentIter needs an ImageRecordIter "
                             "created with device_augment=True")
        self._base = base
        self.batch_size = base.batch_size
        c, big_h, big_w = base._data_shape
        self._crop = tuple(crop_shape) if crop_shape else (big_h, big_w)
        if self._crop[0] > big_h or self._crop[1] > big_w:
            raise MXNetError(
                "DeviceAugmentIter: crop_shape %s exceeds the base "
                "iterator's storage shape (%d, %d)"
                % (self._crop, big_h, big_w))
        self._chans = c
        self._device = resolve_device(device)
        self._gen = torch.Generator(device=self._device).manual_seed(
            int(seed))
        self._opts = dict(crop_shape=self._crop, rand_crop=bool(rand_crop),
                          rand_mirror=bool(rand_mirror),
                          mean=tuple(float(m) for m in mean),
                          scale=float(scale))
        self._data = None
        self._label = None
        self._pad = 0

    @property
    def provide_data(self):
        h, w = self._crop
        return [(self._base._data_name,
                 (self.batch_size, self._chans, h, w))]

    @property
    def provide_label(self):
        return self._base.provide_label

    def reset(self):
        self._base.reset()

    def iter_next(self):
        if not self._base.iter_next():
            return False
        u8 = _stage_tensor(self._base._data._tensor, self._device)
        self._data = nd.NDArray(device_augment_batch(
            u8, key=self._gen, **self._opts))
        self._label = nd.NDArray(_stage_tensor(self._base._label._tensor,
                                               self._device))
        self._pad = self._base.getpad()
        return True

    def getdata(self):
        return [self._data]

    def getlabel(self):
        return [self._label]

    def getpad(self):
        return self._pad
