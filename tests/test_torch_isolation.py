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
from mxnet_tpu_torch.serving import (  # noqa: F401
    FleetRouter, KVHandoff, CaptureStream, load_capture, pack_rows)
from mxnet_tpu_torch.serving import replay, handoff, fleet, capture  # noqa
from mxnet_tpu_torch import telemetry_http  # noqa: F401
from mxnet_tpu_torch.parallel import ParallelTrainer, make_graph_fn  # noqa
from mxnet_tpu_torch.parallel import (  # noqa: F401
    SequenceParallelTrainer, build_mesh, collectives, ring_attention,
    striped_ring_attention)
from mxnet_tpu_torch import (  # noqa: F401
    callback, io, lr_scheduler, metric, model, optimizer)
from mxnet_tpu_torch import (  # noqa: F401
    executor, executor_manager, kvstore, monitor, random)
import mxnet_tpu_torch as mx
assert mx.nd.NDArray and mx.sym.Group and mx.kv.create  # the namespace
from mxnet_tpu_torch.parallel import checkpoint, optim  # noqa: F401
from mxnet_tpu_torch.parallel import (  # noqa: F401
    layout, pipeline, sharded, PipelineTrainer, ShardingRules,
    partition_stages, pipeline_spmd)
from mxnet_tpu_torch.models import (  # noqa: F401
    alexnet, classifiers, fcn, inception, lstm, vgg)
from mxnet_tpu_torch.models import get_symbol  # noqa: F401
from mxnet_tpu_torch import image_io, recordio, stream  # noqa: F401
assert mx.recordio and mx.ImageRecordIter and mx.DeviceAugmentIter
assert mx.DevicePrefetchIter and mx.io.ImageRecordIter
from mxnet_tpu_torch import (  # noqa: F401
    distributed, kvstore_dist, kvstore_server, predict, c_predict,
    c_api_impl, libinfo, profiler, visualization, operator, misc, rtc,
    capi)
from mxnet_tpu_torch import torch as th  # noqa: F401
from mxnet_tpu_torch.testing import dist_worker  # noqa: F401
assert mx.Predictor and mx.viz and mx.th and mx.rtc.Rtc and mx.profiler
assert mx.operator.NumpyOp and mx.distributed.rank() == 0
assert mx.distributed.process_index() == 0
assert mx.distributed.process_count() == 1
from mxnet_tpu_torch.parallel.collectives import (  # noqa: F401
    Span, process_broadcast, process_sum, psum_ranked)
from mxnet_tpu_torch.parallel.program import ProgramChain  # noqa: F401
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
    # every module of the slice was imported (the fleet's included:
    # serving.capture, .handoff, .fleet, .replay and telemetry_http; the
    # training surface's metric, callback and parallel.checkpoint; the
    # classic API's executor, executor_manager, kvstore, monitor, random;
    # the model zoo's classifiers, alexnet, vgg, inception, lstm, fcn;
    # the parallelisms' parallel.layout, .sharded and .pipeline; the IO
    # layer's recordio, stream and image_io; the periphery's distributed,
    # kvstore_dist, kvstore_server, predict, c_predict, c_api_impl,
    # libinfo, profiler, visualization, operator, torch, misc, rtc, capi
    # and testing.dist_worker)
    assert int(out.stdout.strip().splitlines()[-1]) >= 81


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA the script exits non-zero and prints no result line."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
