"""RecordIO: the dmlc record container and image record packing.

Counterpart of ``mxnet_tpu/recordio.py`` (the reference's
``python/mxnet/recordio.py``: ``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``, ``pack``/``unpack``, ``pack_img``/``unpack_img``) over the
same binary format, in pure Python: magic 0xced7230a, a cflag/length
word, 4-byte alignment, and records that contain the magic split into
parts. Files read back byte for byte whichever package, or the JAX
package's native writer, wrote them.

The lossless ``RAW0`` payload (``img_fmt=".raw"``) needs nothing beyond
numpy; JPEG and PNG need OpenCV or Pillow, imported when used (without
either they raise ``MXNetError``).
"""
from __future__ import annotations

import io
import logging
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "list_record_offsets"]

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _MAGIC)


class _Writer:
    def __init__(self, path):
        self._f = open(path, "wb")
        self._tell = 0

    def write(self, buf):
        if len(buf) >= (1 << 29):
            raise MXNetError("record too large")
        n = len(buf)
        lower = (n >> 2) << 2
        upper = ((n + 3) >> 2) << 2
        dptr = 0
        out = []
        # a payload word equal to the magic splits the record there (the
        # reader puts the magic back between the parts)
        i = buf.find(_MAGIC_BYTES)
        while 0 <= i < lower:
            if i % 4 == 0:
                out.append(_MAGIC_BYTES)
                out.append(struct.pack("<I", ((1 if dptr == 0 else 2) << 29)
                                       | (i - dptr)))
                out.append(buf[dptr:i])
                dptr = i + 4
                i = buf.find(_MAGIC_BYTES, i + 4)
            else:
                i = buf.find(_MAGIC_BYTES, i + 1)
        out.append(_MAGIC_BYTES)
        out.append(struct.pack("<I", ((3 if dptr else 0) << 29) | (n - dptr)))
        out.append(buf[dptr:n])
        out.append(b"\x00" * (upper - n))
        blob = b"".join(out)
        self._f.write(blob)
        self._tell += len(blob)

    def tell(self):
        return self._tell

    def close(self):
        self._f.close()


class _Reader:
    def __init__(self, path):
        self._f = open(path, "rb")

    def read(self):
        parts = []
        multi = False
        while True:
            head = self._f.read(8)
            if len(head) < 8:
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError("recordio: bad magic")
            cflag, n = lrec >> 29, lrec & ((1 << 29) - 1)
            if multi:
                parts.append(_MAGIC_BYTES)
            data = self._f.read(n)
            if len(data) != n:
                raise MXNetError("recordio: truncated payload")
            pad = (((n + 3) >> 2) << 2) - n
            if pad:
                self._f.read(pad)
            parts.append(data)
            if cflag in (0, 3):
                return b"".join(parts)
            multi = True

    def seek(self, pos):
        self._f.seek(pos)

    def tell(self):
        return self._f.tell()

    def close(self):
        self._f.close()


class MXRecordIO:
    """Read (``flag="r"``) or write (``"w"``) a RecordIO file."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.handle = _Writer(self.uri) if self.writable \
            else _Reader(self.uri)
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.handle.close()
        self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        """Reopen (truncates in 'w' mode), as the reference does."""
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        if isinstance(buf, str):
            buf = buf.encode()
        self.handle.write(bytes(buf))

    def read(self):
        """The next record's bytes, or None at the end."""
        assert not self.writable
        return self.handle.read()

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``key\\toffset`` index sidecar for random access."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write("%s\t%d\n" % (k, self.idx[k]))
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


def _sidecar_offsets(uri, idx_path):
    """The offsets of the index sidecar, or None when it does not fit
    ``uri`` (stale, truncated or malformed): sorted, starting at 0,
    strictly increasing, inside the file, and a magic at the last one."""
    offsets = []
    try:
        with open(idx_path) as f:
            for line in f:
                if not line.strip():
                    continue
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    return None
                offsets.append(int(parts[1]))
    except ValueError:
        return None
    offsets.sort()
    if not offsets:
        return None
    if not (offsets[0] == 0 and offsets[-1] < os.path.getsize(uri)
            and all(b > a for a, b in zip(offsets, offsets[1:]))):
        return None
    with open(uri, "rb") as f:
        f.seek(offsets[-1])
        if f.read(4) != _MAGIC_BYTES:
            return None
    return offsets


def list_record_offsets(uri, idx_path=None):
    """Byte offsets of every record of a RecordIO file, in file order:
    from the ``MXIndexedRecordIO`` sidecar ``idx_path`` when it exists
    and fits the file, else from one scan of the container (a sidecar
    that does not fit is logged and scanned past, never trusted)."""
    if idx_path is not None and os.path.isfile(idx_path):
        offsets = _sidecar_offsets(uri, idx_path)
        if offsets is not None:
            return offsets
        logging.warning(
            "list_record_offsets: index %s does not fit %s (stale or "
            "truncated sidecar?) - falling back to a full scan",
            idx_path, uri)
    reader = MXRecordIO(uri, "r")
    offsets = []
    try:
        while True:
            pos = reader.tell()
            if reader.read() is None:
                break
            offsets.append(pos)
    finally:
        reader.close()
    return offsets


# -- image records ---------------------------------------------------------------

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IRFormat = "<IfQQ"
_IRSize = struct.calcsize(_IRFormat)


def pack(header, s):
    """A header and raw bytes as one image-record payload (a label array
    goes before the bytes, its length in ``flag``)."""
    header = IRHeader(*header)
    if isinstance(header.label, (np.ndarray, list, tuple)):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    return struct.pack(_IRFormat, *header) + s


def unpack(s):
    """An image-record payload as ``(IRHeader, bytes)``."""
    header = IRHeader(*struct.unpack(_IRFormat, s[:_IRSize]))
    s = s[_IRSize:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


#: the raw (unencoded) image payload: magic, u16 height, u16 width, u8
#: channels, then HWC BGR (or gray) uint8 pixels
_RAW_MAGIC = b"RAW0"


def _codec():
    """``("cv2", module)`` or ``("pil", module)``: the JPEG/PNG codec,
    OpenCV first (the JAX package's), else Pillow."""
    try:
        import cv2
        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return "pil", Image
    except ImportError:
        raise MXNetError("JPEG/PNG records need OpenCV (cv2) or Pillow, "
                         "and neither is installed; RAW0 records "
                         "(pack_img(img_fmt='.raw')) need neither")


def _bgr_to_gray(bgr):
    """OpenCV's ``COLOR_BGR2GRAY`` on uint8: BT.601 weights in 15-bit
    fixed point, as OpenCV 5 computes it."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15
            ).astype(np.uint8)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HxWx3 (RGB) or HxW uint8 array and pack it.
    ``img_fmt=".raw"`` stores the pixels unencoded (lossless)."""
    if img_fmt == ".raw":
        a = np.ascontiguousarray(
            img[:, :, ::-1] if img.ndim == 3 else img, dtype=np.uint8)
        h, w = a.shape[:2]
        c = a.shape[2] if a.ndim == 3 else 1
        blob = (_RAW_MAGIC + struct.pack("<HHB", h, w, c) + a.tobytes())
        return pack(header, blob)
    kind, lib = _codec()
    if kind == "cv2":
        if img.ndim == 3:
            img = img[:, :, ::-1]  # RGB -> BGR for OpenCV encoding
        if img_fmt in (".jpg", ".jpeg"):
            params = [lib.IMWRITE_JPEG_QUALITY, quality]
        elif img_fmt == ".png":
            params = [lib.IMWRITE_PNG_COMPRESSION, quality]
        else:
            params = []
        ok, buf = lib.imencode(img_fmt, img, params)
        if not ok:
            raise MXNetError("pack_img: encode failed")
        return pack(header, buf.tobytes())
    out = io.BytesIO()
    pil = lib.fromarray(np.ascontiguousarray(img, dtype=np.uint8))
    if img_fmt in (".jpg", ".jpeg"):
        pil.save(out, format="JPEG", quality=quality)
    elif img_fmt == ".png":
        pil.save(out, format="PNG", compress_level=min(int(quality), 9))
    else:
        raise MXNetError("pack_img: Pillow cannot encode %s" % img_fmt)
    return pack(header, out.getvalue())


def _decode_blob(blob, iscolor):
    """An encoded JPEG/PNG as an RGB (or gray) array, or None when the
    codec cannot read it. ``iscolor``: -1 as stored, 0 gray, 1 color."""
    kind, lib = _codec()
    if kind == "cv2":
        img = lib.imdecode(np.frombuffer(blob, dtype=np.uint8), iscolor)
        if img is not None and img.ndim == 3:
            img = img[:, :, ::-1]  # BGR -> RGB
        return img
    try:
        pil = lib.open(io.BytesIO(blob))
        if iscolor == 0:
            pil = pil.convert("L")
        elif iscolor == 1 or pil.mode not in ("L", "RGB"):
            pil = pil.convert("RGB")
        return np.asarray(pil)
    except Exception:
        return None


def unpack_img(s, iscolor=-1):
    """An image-record payload as ``(IRHeader, RGB or gray array)``."""
    header, blob = unpack(s)
    if blob[:4] == _RAW_MAGIC:
        h, w, c = struct.unpack("<HHB", blob[4:9])
        a = np.frombuffer(blob[9:9 + h * w * c], np.uint8)
        a = a.reshape((h, w) if c == 1 else (h, w, c))
        if iscolor == 0 and a.ndim == 3:
            return header, _bgr_to_gray(a)
        if a.ndim == 3:
            a = a[:, :, ::-1]  # stored BGR -> RGB
        elif iscolor == 1:
            a = np.repeat(a[:, :, None], 3, axis=2)
        return header, a
    img = _decode_blob(blob, iscolor)
    if img is None:
        raise MXNetError("unpack_img: decode failed")
    return header, img
