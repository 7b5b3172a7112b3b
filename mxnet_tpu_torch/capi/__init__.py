"""The port's native C ABIs: the predict ABI and the full graph ABI.

Counterparts of ``cpp/c_predict_api.cc``/``.h`` and
``cpp/c_api_graph.cc``/``.h`` (the port keeps its own copies here: they
import ``mxnet_tpu_torch.c_predict`` and ``mxnet_tpu_torch.c_api_impl``),
and of the example clients ``predict_example.c`` (which takes the device
on its command line), ``capi_example.c`` and ``train_c.c``.

Each library embeds CPython: :func:`build` compiles it with ``g++`` at
first use into ``build/capi/`` beside the package, keyed by a hash of its
sources, the interpreter and the repo root, and links it against the
running interpreter's ``libpython`` (the flags ``python3-config --embed``
gives, read from ``sysconfig``). ``MXT_PYTHON`` (the interpreter, so an
embedded run finds the same site-packages, a venv's included) and
``MXT_ROOT`` (the repo, put first on the embedded ``sys.path``) are
compiled in: another interpreter gets a build of its own.

    from mxnet_tpu_torch import capi
    lib = capi.build("predict")          # libmxnet_tpu_torch_predict.so
    exe = capi.build_example("predict_example")
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig

from ..base import MXNetError

__all__ = ["build", "build_example", "LIBRARIES", "EXAMPLES"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BUILD = os.path.join(ROOT, "build", "capi")

# library -> (output name, sources and headers)
LIBRARIES = {
    "predict": ("libmxnet_tpu_torch_predict.so",
                ("c_predict_api.cc", "c_predict_api.h")),
    "graph": ("libmxnet_tpu_torch_capi.so",
              ("c_api_graph.cc", "c_api_graph.h")),
}
# example client -> the library it links
EXAMPLES = {"predict_example": "predict", "capi_example": "graph",
            "train_c": "graph"}


def _python_flags():
    """Compile and link flags of the running interpreter (what
    ``python3-config --includes`` and ``--ldflags --embed`` print)."""
    cfg = sysconfig.get_config_vars()
    inc = ["-I" + sysconfig.get_paths()["include"]]
    ver = cfg.get("LDVERSION") or cfg.get("VERSION")
    libs = ["-L" + cfg["LIBDIR"], "-lpython" + ver]
    libs += (cfg.get("LIBS") or "").split() + \
        (cfg.get("SYSLIBS") or "").split()
    return inc, libs, cfg["LIBDIR"]


def _key(files):
    h = hashlib.sha256()
    for fn in files:
        with open(os.path.join(HERE, fn), "rb") as f:
            h.update(f.read())
    h.update(sys.executable.encode())
    h.update(ROOT.encode())
    return h.hexdigest()[:16]


def _run(cmd, what):
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise MXNetError("building %s failed:\n%s\n%s"
                         % (what, " ".join(cmd), r.stderr[-4000:]))


def build(name):
    """The path of library ``name`` (``"predict"`` or ``"graph"``), built
    with ``g++`` if it is not built yet (a temporary file, then
    ``os.replace``, so concurrent builds are safe)."""
    out_name, files = LIBRARIES[name]
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise MXNetError("g++ not found: the C ABIs build with g++")
    out_dir = os.path.join(BUILD, _key(files))
    out = os.path.join(out_dir, out_name)
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    inc, libs, libdir = _python_flags()
    tmp = "%s.%d.tmp" % (out, os.getpid())
    _run([cxx, "-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared",
          '-DMXT_PYTHON="%s"' % sys.executable, '-DMXT_ROOT="%s"' % ROOT]
         + inc + [os.path.join(HERE, files[0]), "-o", tmp]
         + libs + ["-Wl,-rpath," + libdir], out_name)
    os.replace(tmp, out)
    return out


def build_example(name):
    """The path of example client ``name`` (``"predict_example"``,
    ``"capi_example"`` or ``"train_c"``), built with ``gcc`` against its
    library (which :func:`build` makes first) if it is not built yet."""
    lib = build(EXAMPLES[name])
    cc = shutil.which(os.environ.get("CC", "gcc"))
    if cc is None:
        raise MXNetError("gcc not found: the C examples build with gcc")
    src = name + ".c"
    out = os.path.join(os.path.dirname(lib), name + "-" + _key((src,)))
    if os.path.exists(out):
        return out
    lib_dir = os.path.dirname(lib)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    _run([cc, "-O2", "-Wall", "-I" + HERE, os.path.join(HERE, src),
          lib, "-Wl,-rpath," + lib_dir, "-lm", "-o", tmp], name)
    os.replace(tmp, out)
    return out
