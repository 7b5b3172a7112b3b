"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``, with the API
surface of dmlc-era MXNet (``mxnet_tpu/__init__.py:22-82``) for every
module: ``mx.nd``, ``mx.sym``, ``mx.kv`` (the ``dist_*`` stores over
``mx.distributed``), ``mx.init``, ``mx.mon``, ``mx.rnd``, ``mx.io``,
``mx.recordio``, ``mx.ImageRecordIter``, ``mx.DeviceAugmentIter``,
``mx.DevicePrefetchIter``, ``mx.model.FeedForward``, ``mx.operator``,
``mx.profiler``, ``mx.viz``, ``mx.rtc``, ``mx.th`` (``mx.torch``),
``mx.Predictor``, the trainers and the serving engine.
``mxnet_tpu_torch.kvstore_server`` is imported explicitly, as in the
reference (it runs the server role at import). Importing it touches no CUDA device;
``mx.cpu()``/``mx.gpu(i)`` name where arrays live, and the default
context is ``mx.gpu(0)`` (``context.py``).
"""
from __future__ import annotations

from .base import MXNetError  # noqa: F401
from .context import Context, current_context, cpu, gpu  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray import NDArray  # noqa: F401
from . import random  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from .symbol import Symbol, Group  # noqa: F401
from . import executor  # noqa: F401
from .executor import Executor  # noqa: F401
from . import operator  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .name import NameManager, Prefix  # noqa: F401
from . import optimizer  # noqa: F401
from . import metric  # noqa: F401
from . import initializer  # noqa: F401
from .initializer import (Uniform, Normal, Orthogonal, Xavier,  # noqa: F401
                          MSRAPrelu)
from . import lr_scheduler  # noqa: F401
from . import misc  # noqa: F401
from . import telemetry  # noqa: F401
from . import profiler  # noqa: F401
from . import io  # noqa: F401
from . import recordio  # noqa: F401
from . import stream  # noqa: F401
from . import image_io  # noqa: F401
from .image_io import ImageRecordIter, DeviceAugmentIter  # noqa: F401
from .io import DevicePrefetchIter  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import executor_manager  # noqa: F401
from . import callback  # noqa: F401
from . import monitor  # noqa: F401
from .monitor import Monitor  # noqa: F401
from . import model  # noqa: F401
from .model import FeedForward  # noqa: F401
from . import parallel  # noqa: F401
from .parallel import ParallelTrainer  # noqa: F401
from . import distributed  # noqa: F401
from . import visualization  # noqa: F401
# reference short aliases: mx.init, mx.viz, mx.mon, mx.rnd, mx.th
from . import initializer as init  # noqa: F401
from . import visualization as viz  # noqa: F401
from . import monitor as mon  # noqa: F401
from . import random as rnd  # noqa: F401
from . import rtc  # noqa: F401
from . import torch  # noqa: F401
from . import torch as th  # noqa: F401
from . import predict  # noqa: F401
from .predict import Predictor  # noqa: F401
from . import serving  # noqa: F401
from .serving import InferenceEngine  # noqa: F401
# after serving: the exposition server's endpoints walk the engine
# registry, and MXNET_TELEMETRY_PORT arms it at import
from . import telemetry_http  # noqa: F401

__version__ = "0.1.0"
