"""The PyTorch port stands alone: importing every module of
``mxnet_tpu_torch``, and what ``chip_smoke.py`` imports, loads neither
``jax`` nor anything of ``mxnet_tpu``. Checked in a fresh interpreter in
which both are made unimportable, so an import of either anywhere in the
port fails loudly instead of passing unnoticed.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("the port imported %s" % name)

for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())

import mxnet_tpu_torch
names = []
for info in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                  "mxnet_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
from mxnet_tpu_torch.serving import InferenceEngine, Request  # noqa
from mxnet_tpu_torch.parallel import ParallelTrainer, make_graph_fn  # noqa
from mxnet_tpu_torch.parallel import (  # noqa: F401
    SequenceParallelTrainer, build_mesh, collectives, ring_attention,
    striped_ring_attention)
import chip_smoke  # noqa: F401  (module level: its imports only)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # every module of the slice was imported
    assert int(out.stdout.strip().splitlines()[-1]) >= 34


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA the script exits non-zero and prints no result line."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
