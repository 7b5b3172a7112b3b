"""URI streams: the ``dmlc::Stream`` dispatch.

Counterpart of ``mxnet_tpu/stream.py``. ``open_stream`` opens a path by
its scheme: local paths and ``file://`` directly, ``s3://`` through boto3
and ``hdfs://`` through pyarrow when they can be imported (buffered in
memory; a write publishes on a successful close only, so a failed save
never leaves a truncated object). Without them those schemes raise
``MXNetError`` instead of writing a local file named "s3:/...". The
port's ``nd.save``/``nd.load``, ``Symbol.save``/``load`` and the
checkpoint helpers of ``model.py`` open their files through it.
"""
from __future__ import annotations

import io
import os

from .base import MXNetError

__all__ = ["open_stream", "is_uri"]

_SCHEMES = ("s3://", "hdfs://", "file://")


def is_uri(path):
    return isinstance(path, str) and path.startswith(_SCHEMES)


class _S3Stream(io.BytesIO):
    """Memory-buffered S3 object stream: read pulls the object once,
    write uploads on SUCCESSFUL close (matching dmlc's buffered S3
    writer). Exception safety: the ``with`` form ABORTS the upload when
    the body raises, and a stream dropped to GC aborts too — publishing
    a truncated object that "looks complete" is exactly the corruption
    the local tmp+rename path prevents. A bare ``close()`` call always
    publishes (an explicit call is taken as intent); non-``with`` users
    must call ``abort()`` on their exception paths."""

    def __init__(self, uri, mode):
        try:
            import boto3
        except ImportError:
            raise MXNetError(
                "%s: S3 streams need boto3, which is not installed (the "
                "reference gates this behind USE_S3=1 at compile time). "
                "Install boto3 or copy to a local path first." % uri)
        self._client = boto3.client("s3")
        rest = uri[len("s3://"):]
        self._bucket, _, self._key = rest.partition("/")
        if not self._bucket or not self._key:
            raise MXNetError("malformed S3 uri: %s" % uri)
        self._writing = "w" in mode
        self._abort = False
        if self._writing:
            super().__init__()
        else:
            body = self._client.get_object(Bucket=self._bucket,
                                           Key=self._key)["Body"].read()
            super().__init__(body)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            self._abort = True
        self.close()
        return False

    def __del__(self):
        # GC finalization is NOT a successful close: a stream dropped
        # during exception unwind (no ``with`` block) must never publish
        # its partial buffer.
        self._abort = True
        try:
            self.close()
        except Exception:
            pass

    def abort(self):
        """Discard the buffer: a following close() will NOT upload.
        Non-``with`` users should call this from their exception path —
        only the context-manager form aborts automatically."""
        self._abort = True

    def close(self):
        if self._writing and not self.closed and not self._abort:
            self._client.put_object(Bucket=self._bucket, Key=self._key,
                                    Body=self.getvalue())
        super().close()


class _TextStream(io.TextIOWrapper):
    """Text wrapper that propagates abort-on-exception to the S3/HDFS
    buffer underneath."""

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None and hasattr(self.buffer, "_abort"):
            self.buffer._abort = True
        return super().__exit__(exc_type, exc_val, exc_tb)


class _HdfsWriteStream(io.BytesIO):
    """Memory-buffered HDFS write: upload on SUCCESSFUL close only —
    same abort-on-exception contract as _S3Stream, so a failed save
    never publishes a truncated file."""

    def __init__(self, hdfs, path):
        super().__init__()
        self._hdfs = hdfs
        self._path = path
        self._abort = False

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            self._abort = True
        self.close()
        return False

    def __del__(self):
        self._abort = True  # see _S3Stream.__del__
        try:
            self.close()
        except Exception:
            pass

    def abort(self):
        """See _S3Stream.abort."""
        self._abort = True

    def close(self):
        if not self.closed and not self._abort:
            with self._hdfs.open_output_stream(self._path) as out:
                out.write(self.getvalue())
        super().close()


def open_stream(path, mode="rb"):
    """Open ``path`` by URI scheme (the ``dmlc::Stream::Create``
    dispatch). Returns a file-like object usable as a context manager.
    Remote schemes support plain read ("r"/"rb") and whole-object write
    ("w"/"wb") only — append/update modes raise (the reference's
    dmlc::Stream has the same read-or-create contract)."""
    if not isinstance(path, (str, os.PathLike)):
        raise MXNetError("open_stream: path must be str, got %r"
                         % type(path))
    p = os.fspath(path)
    if p.startswith("file://"):
        p = p[len("file://"):]
        return open(p, mode)
    if p.startswith(("s3://", "hdfs://")):
        base = mode.replace("b", "")
        if base not in ("r", "w"):
            raise MXNetError(
                "%s: remote streams support only 'r'/'w' modes, got %r "
                "(append/update need read-modify-write through a local "
                "copy)" % (p, mode))
    if p.startswith("s3://"):
        s = _S3Stream(p, mode)
        if "b" not in mode:
            return _TextStream(s, encoding="utf-8")
        return s
    if p.startswith("hdfs://"):
        try:
            from pyarrow import fs as pafs
        except ImportError:
            raise MXNetError(
                "%s: HDFS streams need pyarrow, which is not installed "
                "(the reference gates this behind USE_HDFS=1). Copy to a "
                "local path first." % p)
        rest = p.split("://", 1)[1]
        if "/" not in rest:
            raise MXNetError("malformed HDFS uri (no path): %s" % p)
        hdfs = pafs.HadoopFileSystem.from_uri(p)
        rel = "/" + rest.split("/", 1)[1]
        if "w" in mode:
            stream = _HdfsWriteStream(hdfs, rel)
            if "b" not in mode:
                return _TextStream(stream, encoding="utf-8")
            return stream
        stream = hdfs.open_input_stream(rel)
        if "b" not in mode:
            return io.TextIOWrapper(stream, encoding="utf-8")
        return stream
    return open(p, mode)
