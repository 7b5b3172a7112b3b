"""The port's public callables take the JAX package's parameters, by name
and in order, so that a call written for one package binds the same way
in the other. The port's own parameters (``device``) may follow them, and
only keyword-only. A parameter the port accepts but has not implemented
yet raises its "later slice" ``MXNetError`` when set to anything but the
default. Small 1-layer models, on the CPU.
"""
import inspect
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu.model as jax_model
import mxnet_tpu.optimizer as jax_opt
from mxnet_tpu import callback as jax_callback
from mxnet_tpu import initializer as jax_init
from mxnet_tpu import lr_scheduler as jax_lrs
from mxnet_tpu import metric as jax_metric
from mxnet_tpu.parallel import checkpoint as jax_ckpt
from mxnet_tpu.models import transformer as jax_transformer
from mxnet_tpu.ops import pallas_kernels as jax_kernels
from mxnet_tpu.parallel import decode as jax_decode
from mxnet_tpu.parallel import graph as jax_graph
from mxnet_tpu.parallel import ring as jax_ring
from mxnet_tpu.parallel import sp as jax_sp
from mxnet_tpu.parallel import trainer as jax_trainer
from mxnet_tpu import image_io as jax_iio
from mxnet_tpu import io as jax_io
from mxnet_tpu import recordio as jax_rec
from mxnet_tpu import stream as jax_stream
from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.serving import capture as jax_capture
from mxnet_tpu.serving import engine as jax_engine
from mxnet_tpu.serving import fleet as jax_fleet
from mxnet_tpu.serving import flight as jax_flight
from mxnet_tpu.serving import handoff as jax_handoff
from mxnet_tpu.testing import faults as jax_faults

import mxnet_tpu_torch.model as tmodel
import mxnet_tpu_torch.optimizer as topt
from mxnet_tpu_torch import callback as tcallback
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.parallel import checkpoint as tckpt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.initializer import Uniform
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.ops import kernels as tkernels
from mxnet_tpu_torch.parallel import decode as tdecode
from mxnet_tpu_torch.parallel import graph as tgraph
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import ring as tring
from mxnet_tpu_torch.parallel import sp as tsp
from mxnet_tpu_torch.parallel import trainer as ttrainer
from mxnet_tpu_torch import image_io as tiio
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import stream as tstream
from mxnet_tpu_torch import telemetry as ttele
from mxnet_tpu_torch.serving import capture as tcapture
from mxnet_tpu_torch.serving import engine as tengine
from mxnet_tpu_torch.serving import fleet as tfleet
from mxnet_tpu_torch.serving import flight as tflight
from mxnet_tpu_torch.serving import handoff as thandoff
from mxnet_tpu_torch.serving import replay as treplay
from mxnet_tpu_torch.testing import faults as tfaults

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import replay_serving as jax_replay  # noqa: E402

VOCAB, T = 23, 16

# (name, JAX callable, port callable)
CALLABLES = [
    ("ParallelTrainer", jax_trainer.ParallelTrainer.__init__,
     ttrainer.ParallelTrainer.__init__),
    ("ParallelTrainer.multi_step", jax_trainer.ParallelTrainer.multi_step,
     ttrainer.ParallelTrainer.multi_step),
    ("SequenceParallelTrainer", jax_sp.SequenceParallelTrainer.__init__,
     tsp.SequenceParallelTrainer.__init__),
    ("InferenceEngine", jax_engine.InferenceEngine.__init__,
     tengine.InferenceEngine.__init__),
    ("InferenceEngine.from_checkpoint",
     jax_engine.InferenceEngine.from_checkpoint,
     tengine.InferenceEngine.from_checkpoint),
    ("Decoder", jax_decode.Decoder.__init__, tdecode.Decoder.__init__),
    ("Decoder.from_checkpoint", jax_decode.Decoder.from_checkpoint,
     tdecode.Decoder.from_checkpoint),
    ("Decoder.generate", jax_decode.Decoder.generate,
     tdecode.Decoder.generate),
    ("get_transformer_lm", jax_transformer.get_transformer_lm,
     ttransformer.get_transformer_lm),
    ("Optimizer", jax_opt.Optimizer.__init__, topt.Optimizer.__init__),
    ("SGD", jax_opt.SGD.__init__, topt.SGD.__init__),
    ("save_checkpoint", jax_model.save_checkpoint,
     tmodel.save_checkpoint),
    ("load_checkpoint", jax_model.load_checkpoint,
     tmodel.load_checkpoint),
    ("InferenceEngine.submit", jax_engine.InferenceEngine.submit,
     tengine.InferenceEngine.submit),
    ("Decoder.init_cache", jax_decode.Decoder.init_cache,
     tdecode.Decoder.init_cache),
] + [("Decoder." + name, getattr(jax_decode.Decoder, name),
      getattr(tdecode.Decoder, name))
     for name in ("beam_search", "clone_cache", "clear_window_positions",
                  "slot_slice", "slot_update", "_run", "_run_slots")
] + [
    ("make_graph_fn", jax_graph.make_graph_fn, tgraph.make_graph_fn),
    ("striped_ring_attention", jax_ring.striped_ring_attention,
     tring.striped_ring_attention),
] + [(name, getattr(jax_kernels, name), getattr(tkernels, name))
     for name in ("flash_attention", "striped_pair_attention",
                  "fused_linear", "fused_conv_bn_act", "matmul_stats",
                  "paged_attention", "quant_matmul",
                  "fused_decode_attention")
] + [("Request", jax_engine.Request.__init__, tengine.Request.__init__)
] + [("InferenceEngine." + name, getattr(jax_engine.InferenceEngine, name),
      getattr(tengine.InferenceEngine, name))
     for name in ("cancel", "serve_forever", "close", "snapshot", "restore",
                  "health", "round_table", "request_table", "admit_handoff",
                  "set_role", "take_handoffs")
] + [("FleetRouter." + name, getattr(jax_fleet.FleetRouter, name),
      getattr(tfleet.FleetRouter, name))
     for name in ("__init__", "submit", "drain", "add_replica", "step",
                  "serve_forever", "cancel", "close", "health",
                  "fleet_table", "replica", "replica_ids")
] + [("FleetFlightRecorder." + name,
      getattr(jax_fleet.FleetFlightRecorder, name),
      getattr(tfleet.FleetFlightRecorder, name))
     for name in ("__init__", "start", "event", "hop", "absorb", "retire",
                  "timeline", "chrome_trace", "rows", "ids")
] + [("KVHandoff.payload", jax_handoff.KVHandoff.payload,
      thandoff.KVHandoff.payload),
     ("pack_rows", jax_handoff.pack_rows, thandoff.pack_rows),
     ("unpack_rows", jax_handoff.unpack_rows, thandoff.unpack_rows),
     ("CaptureStream.open", jax_capture.CaptureStream.open,
      tcapture.CaptureStream.open),
     ("CaptureStream", jax_capture.CaptureStream.__init__,
      tcapture.CaptureStream.__init__),
     ("load_capture", jax_capture.load_capture, tcapture.load_capture),
     ("replay.replay", jax_replay.replay, treplay.replay),
     ("replay.build_engine", jax_replay.build_engine,
      treplay.build_engine),
     ("replay.rolling_restart", jax_replay.rolling_restart,
      treplay.rolling_restart),
     ("replay.role_report", jax_replay.role_report, treplay.role_report),
     ("replay.recorded_latency", jax_replay.recorded_latency,
      treplay.recorded_latency)
] + [("FlightRecorder." + name, getattr(jax_flight.FlightRecorder, name),
      getattr(tflight.FlightRecorder, name))
     for name in ("__init__", "start", "event", "token", "retire",
                  "timeline", "records", "rows", "ids")
] + [("FaultInjector." + name, getattr(jax_faults.FaultInjector, name),
      getattr(tfaults.FaultInjector, name))
     for name in ("__init__", "serving_h2d_failures", "serving_round_hang",
                  "serving_crash_mid_round", "serving_h2d",
                  "serving_round_stuck", "serving_crash",
                  "fleet_kill_replica", "fleet_heartbeat_blackhole",
                  "fleet_slow_replica", "fleet_submit_failures",
                  "fleet_handoff_failures", "fleet_step_context",
                  "fleet_ping_blackholed", "fleet_submit", "fleet_handoff")
] + [("StagedStream." + name, getattr(jax_io.StagedStream, name),
      getattr(tio.StagedStream, name))
     for name in ("__init__", "next", "staged", "prune", "reset", "close")
] + [("telemetry." + name, getattr(jax_tele, name), getattr(ttele, name))
     for name in ("counter", "gauge", "histogram", "enable", "enabled",
                  "reset", "snapshot", "to_prometheus", "tracing",
                  "start_trace", "stop_trace", "trace_complete", "mark",
                  "tracing_paused", "span", "serve", "stop_server",
                  "start_reporter", "stop_reporter")
] + [("telemetry.%s.%s" % (cls, name),
      getattr(getattr(jax_tele, cls), name),
      getattr(getattr(ttele, cls), name))
     for cls, names in (("Counter", ("__init__", "inc")),
                        ("Gauge", ("__init__", "set")),
                        ("Histogram", ("__init__", "observe", "percentile",
                                       "count_le")),
                        ("SloWindow", ("__init__", "tick")))
     for name in names]
# the training surface: the trainers' methods, the optimizers, schedulers,
# initializers, metrics, iterators, callbacks and checkpoints
CALLABLES += [
    ("ParallelTrainer." + name, getattr(jax_trainer.ParallelTrainer, name),
     getattr(ttrainer.ParallelTrainer, name))
    for name in ("fit", "prefetch", "staged_batches", "step", "forward",
                 "init_params", "get_optimizer_states",
                 "set_optimizer_states", "save_sharded_checkpoint",
                 "restore_sharded_checkpoint", "resume_sharded_checkpoint")
] + [("SequenceParallelTrainer." + name,
      getattr(jax_sp.SequenceParallelTrainer, name),
      getattr(tsp.SequenceParallelTrainer, name))
     for name in ("step", "init_params", "save_sharded_checkpoint",
                  "restore_sharded_checkpoint")
] + [("optimizer.%s.%s" % (cls, name),
      getattr(getattr(jax_opt, cls), name),
      getattr(getattr(topt, cls), name))
     for cls in ("SGLD", "Adam", "AdamW", "AdaFactor", "AdaGrad", "RMSProp",
                 "AdaDelta", "Test")
     for name in ("__init__", "create_state", "update")
] + [("optimizer.Optimizer." + name, getattr(jax_opt.Optimizer, name),
      getattr(topt.Optimizer, name))
     for name in ("set_lr_scale", "set_lr_mult", "_get_lr")
] + [("optimizer.get_updater", jax_opt.get_updater, topt.get_updater)
] + [("lr_scheduler.%s" % cls, getattr(jax_lrs, cls).__init__,
      getattr(tlrs, cls).__init__)
     for cls in ("CosineScheduler", "PolyScheduler")
] + [("initializer.%s" % cls, getattr(jax_init, cls).__init__,
      getattr(tinit, cls).__init__)
     for cls in ("Load", "Mixed", "Orthogonal", "MSRAPrelu")
] + [("metric.%s" % name, getattr(jax_metric, name), getattr(tmetric, name))
     for name in ("create", "np", "check_label_shapes")
] + [("metric.%s" % cls, getattr(jax_metric, cls).__init__,
      getattr(tmetric, cls).__init__)
     for cls in ("TopKAccuracy", "CustomMetric")
] + [("io.%s.%s" % (cls, name), getattr(getattr(jax_io, cls), name),
      getattr(getattr(tio, cls), name))
     for cls, names in (("NDArrayIter", ("__init__", "reset", "getpad")),
                        ("DataBatch", ("__init__",)))
     for name in names
] + [("io.%s.__init__" % cls, getattr(jax_io, cls).__init__,
      getattr(tio, cls).__init__)
     for cls in ("ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
                 "MNISTIter", "CSVIter", "MXDataIter")
] + [("io.DevicePrefetchIter.close", jax_io.DevicePrefetchIter.close,
      tio.DevicePrefetchIter.close)
] + [("image_io.%s" % name, getattr(jax_iio, name), getattr(tiio, name))
     for name in ("device_augment_batch",)
] + [("image_io.%s.%s" % (cls, name), getattr(getattr(jax_iio, cls), name),
      getattr(getattr(tiio, cls), name))
     for cls, names in (("ImageRecordIter", ("__init__", "reset",
                                             "iter_numpy", "close")),
                        ("DeviceAugmentIter", ("__init__",)))
     for name in names
] + [("recordio.%s" % name, getattr(jax_rec, name), getattr(trec, name))
     for name in ("pack", "unpack", "pack_img", "unpack_img",
                  "list_record_offsets")
] + [("recordio.%s.%s" % (cls, name), getattr(getattr(jax_rec, cls), name),
      getattr(getattr(trec, cls), name))
     for cls, names in (("MXRecordIO", ("__init__", "open", "close",
                                        "reset", "write", "read", "tell",
                                        "seek")),
                        ("MXIndexedRecordIO", ("__init__", "read_idx",
                                               "write_idx")))
     for name in names
] + [("stream.%s" % name, getattr(jax_stream, name), getattr(tstream, name))
     for name in ("open_stream", "is_uri")
] + [("callback.%s" % name, getattr(jax_callback, name),
      getattr(tcallback, name))
     for name in ("do_checkpoint", "log_train_metric")
] + [("callback.%s" % cls, getattr(jax_callback, cls).__init__,
      getattr(tcallback, cls).__init__)
     for cls in ("Speedometer", "ProgressBar")
] + [("model.%s" % name, getattr(jax_model, name), getattr(tmodel, name))
     for name in ("load_optimizer_states", "latest_checkpoint")
] + [("checkpoint.%s" % name, getattr(jax_ckpt, name),
      getattr(tckpt, name))
     for name in ("save_sharded", "load_sharded", "latest_step",
                  "flatten_train_state", "restore_opt_state")]

# the classic API: NDArray, random, Symbol binding, Executor, KVStore,
# executor manager, Monitor and FeedForward
import mxnet_tpu.executor as jax_exe  # noqa: E402
import mxnet_tpu.executor_manager as jax_em  # noqa: E402
import mxnet_tpu.kvstore as jax_kv  # noqa: E402
import mxnet_tpu.monitor as jax_mon  # noqa: E402
import mxnet_tpu.ndarray as jax_nd  # noqa: E402
import mxnet_tpu.random as jax_rnd  # noqa: E402
import mxnet_tpu.symbol as jax_sym  # noqa: E402
import mxnet_tpu_torch.executor as t_exe  # noqa: E402
import mxnet_tpu_torch.executor_manager as t_em  # noqa: E402
import mxnet_tpu_torch.kvstore as t_kv  # noqa: E402
import mxnet_tpu_torch.monitor as t_mon  # noqa: E402
import mxnet_tpu_torch.ndarray as t_nd  # noqa: E402
import mxnet_tpu_torch.random as t_rnd  # noqa: E402
import mxnet_tpu_torch.symbol as t_sym  # noqa: E402

CLASSIC = [
    (jax_nd, t_nd, ["empty", "zeros", "ones", "full", "array",
                    "concatenate", "waitall", "save", "load",
                    "load_buffer", "onehot_encode", "clip", "dot", "norm",
                    "sqrt", "rsqrt", "square", "abs", "sign", "round",
                    "ceil", "floor", "exp", "log", "cos", "sin", "maximum",
                    "minimum", "negative", "choose_element_0index",
                    "fill_element_0index", "sum", "max", "min",
                    "argmax_channel", "transpose", "imdecode"]),
    (jax_nd.NDArray, t_nd.NDArray,
     ["wait_to_read", "asnumpy", "asscalar", "astype", "reshape", "slice",
      "__getitem__", "__setitem__", "copy", "copyto", "as_in_context"]),
    (jax_rnd, t_rnd, ["seed", "uniform", "normal"]),
    (jax_sym, t_sym, ["Group", "pow", "maximum", "minimum"]),
    (jax_sym.Symbol, t_sym.Symbol,
     ["attr", "attr_dict", "_set_attr", "__call__", "infer_type",
      "debug_str", "bind", "simple_bind", "grad", "__iter__"]),
    (jax_exe.Executor, t_exe.Executor,
     ["__init__", "forward", "backward", "copy_params_from", "reshape",
      "set_monitor_callback", "debug_str"]),
    (jax_kv, t_kv, ["create"]),
    (jax_kv.KVStore, t_kv.KVStore,
     ["__init__", "init", "push", "pull", "_set_updater", "set_optimizer",
      "barrier", "send_command_to_servers"]),
    (jax_mon.Monitor, t_mon.Monitor,
     ["__init__", "stat_helper", "install", "tic", "toc", "toc_print"]),
    (jax_em, t_em, ["_split_input_slice", "_check_arguments", "_load_data",
                    "_load_label"]),
    (jax_em.DataParallelExecutorGroup, t_em.DataParallelExecutorGroup,
     ["__init__", "load_data_batch", "forward", "backward",
      "update_metric"]),
    (jax_em.DataParallelExecutorManager, t_em.DataParallelExecutorManager,
     ["__init__", "install_monitor", "set_params", "copy_to",
      "load_data_batch", "forward", "backward", "update_metric"]),
    (jax_model, tmodel,
     ["_create_kvstore", "_initialize_kvstore", "_update_params",
      "_update_params_on_kvstore", "_train_multi_device",
      "_fused_fit_eligible", "_train_fused"]),
    (jax_model.FeedForward, tmodel.FeedForward,
     ["__init__", "fit", "predict", "score", "save", "load", "create",
      "as_serving_engine", "__getstate__"]),
]
CALLABLES += [("%s.%s" % (getattr(j, "__name__", "?"), name),
               getattr(j, name), getattr(t, name))
              for j, t, names in CLASSIC for name in names]

# the model zoo: every constructor of the JAX package's models
import mxnet_tpu.models as jax_models  # noqa: E402
import mxnet_tpu_torch.models as t_models  # noqa: E402

ZOO = [
    (jax_models, t_models, ["get_symbol", "get_mlp", "get_lenet",
                            "get_alexnet", "get_vgg",
                            "get_inception_bn_small", "get_inception_bn",
                            "get_inception_v3", "get_googlenet",
                            "lstm_unroll", "get_fcn_symbol"]),
    (jax_models.inception, t_models.inception, ["conv_factory"]),
    (jax_models.lstm, t_models.lstm, ["lstm_cell"]),
    (jax_models.vgg, t_models.vgg, ["vgg_backbone"]),
    (jax_models.fcn, t_models.fcn, ["_vgg_stage", "_score_head"]),
]
CALLABLES += [("%s.%s" % (j.__name__, name), getattr(j, name),
               getattr(t, name)) for j, t, names in ZOO for name in names]


# the periphery: the distributed store and its bootstrap, the predictor
# and the C ABIs' shims, the profiler, the extension points and the small
# modules
import mxnet_tpu.c_api_impl as jax_capi  # noqa: E402
import mxnet_tpu.c_predict as jax_cpred  # noqa: E402
import mxnet_tpu.distributed as jax_dist  # noqa: E402
import mxnet_tpu.kvstore_dist as jax_kvd  # noqa: E402
import mxnet_tpu.kvstore_server as jax_kvs  # noqa: E402
import mxnet_tpu.libinfo as jax_libinfo  # noqa: E402
import mxnet_tpu.misc as jax_misc  # noqa: E402
import mxnet_tpu.operator as jax_op  # noqa: E402
import mxnet_tpu.predict as jax_pred  # noqa: E402
import mxnet_tpu.profiler as jax_prof  # noqa: E402
import mxnet_tpu.torch as jax_th  # noqa: E402
import mxnet_tpu.visualization as jax_viz  # noqa: E402
from mxnet_tpu.serving import quant as jax_quant  # noqa: E402
import mxnet_tpu_torch.c_api_impl as t_capi  # noqa: E402
import mxnet_tpu_torch.c_predict as t_cpred  # noqa: E402
import mxnet_tpu_torch.distributed as t_dist  # noqa: E402
import mxnet_tpu_torch.kvstore_dist as t_kvd  # noqa: E402
import mxnet_tpu_torch.kvstore_server as t_kvs  # noqa: E402
import mxnet_tpu_torch.libinfo as t_libinfo  # noqa: E402
import mxnet_tpu_torch.misc as t_misc  # noqa: E402
import mxnet_tpu_torch.operator as t_op  # noqa: E402
import mxnet_tpu_torch.predict as t_pred  # noqa: E402
import mxnet_tpu_torch.profiler as t_prof  # noqa: E402
import mxnet_tpu_torch.torch as t_th  # noqa: E402
import mxnet_tpu_torch.visualization as t_viz  # noqa: E402
from mxnet_tpu_torch.serving import quant as t_quant  # noqa: E402

PERIPHERY = [
    (jax_dist, t_dist, ["initialize", "is_initialized", "rank",
                        "num_workers", "local_devices", "barrier",
                        "shutdown"]),
    (jax_kv, t_kv, ["_ctype_key_value", "_bigarray_bound"]),
    (jax_kv.KVStore, t_kv.KVStore, ["_call_updater", "_sync_rng", "close",
                                    "rank", "num_workers"]),
    (jax_kvd, t_kvd, ["_send_msg", "_recv_msg", "_recv_exact",
                      "_port_base", "_request_timeout", "_max_retries",
                      "_backoff_base_s", "_secret"]),
    (jax_kvd.PSBackend, t_kvd.PSBackend,
     ["__init__", "init", "push", "pull", "set_optimizer", "close",
      "_request", "_ping", "_owner", "_partition", "_port"]),
    (jax_kvd._Server, t_kvd._Server,
     ["__init__", "run", "close", "_claim", "_serve", "_handle"]),
    (jax_kvs.KVStoreServer, t_kvs.KVStoreServer,
     ["__init__", "_controller", "run"]),
    (jax_pred.Predictor, t_pred.Predictor,
     ["__init__", "forward", "get_output"]),
    (jax_cpred, t_cpred, ["create", "create_partial_out", "set_input",
                          "forward", "num_outputs", "get_output_shape",
                          "get_output"]),
    (jax_capi, t_capi, sorted(
        n for n, f in vars(jax_capi).items()
        if inspect.isfunction(f) and f.__module__ == jax_capi.__name__
        and not n.startswith("__"))),
    (jax_libinfo, t_libinfo, ["find_lib_path", "get_lib", "check_call"]),
    (jax_prof, t_prof, ["profiler_set_config", "start", "stop", "scope",
                        "device_memory_profile", "record_step",
                        "reset_step_stats", "get_step_stats",
                        "benchmark_chain", "compiled_stats", "collecting",
                        "register_program", "collect_program_stats",
                        "registered_programs", "device_memory"]),
    (jax_viz, t_viz, ["plot_network", "print_summary", "network_dot"]),
    (jax_op.PythonOp, t_op.PythonOp,
     ["__init__", "forward", "backward", "infer_shape", "list_arguments",
      "list_outputs", "need_top_grad", "__call__", "get_symbol"]),
    (jax_th, t_th, ["to_torch", "from_torch", "th_function"]),
    (jax_th.TorchModuleOp, t_th.TorchModuleOp,
     ["__init__", "list_arguments", "list_outputs", "infer_shape",
      "forward", "backward"]),
    (jax_misc.FactorScheduler, t_misc.FactorScheduler,
     ["__init__", "__call__"]),
    (jax_misc.LearningRateScheduler, t_misc.LearningRateScheduler,
     ["__init__", "__call__"]),
    (jax_quant, t_quant, ["weight_nbytes"]),
    (jax_io.MXDataIter, tio.MXDataIter,
     ["__init__", "reset", "iter_next", "getdata", "getlabel", "getindex",
      "getpad"]),
    (jax_faults.FaultInjector, tfaults.FaultInjector,
     ["random_faults", "drop_sends", "delay_sends", "sever_connections",
      "close_mid_message", "drop_replies", "_scheduled", "before_send",
      "after_recv"]),
    (jax_faults, tfaults, ["kill_server", "restart_server", "server_down"]),
    (jax_model, tmodel, ["_is_checkpoint_writer"]),
]
CALLABLES += [("%s.%s" % (getattr(j, "__name__", "?"), name),
               getattr(j, name), getattr(t, name))
              for j, t, names in PERIPHERY for name in names
              if not isinstance(getattr(j, name), property)]


def test_periphery_names_follow_the_jax_package():
    """Every public name of the JAX package's periphery modules is in the
    port's (the JAX ``rtc.PallasOp``, a Pallas user kernel, is the one
    deviation: the port's ``Rtc`` takes CUDA source)."""
    import mxnet_tpu.rtc as jax_rtc
    import mxnet_tpu_torch.rtc as t_rtc
    for j, t in ((jax_dist, t_dist), (jax_kvd, t_kvd), (jax_kvs, t_kvs),
                 (jax_pred, t_pred), (jax_cpred, t_cpred),
                 (jax_prof, t_prof), (jax_viz, t_viz), (jax_op, t_op),
                 (jax_th, t_th), (jax_misc, t_misc)):
        names = getattr(j, "__all__", None) or [
            n for n, f in vars(j).items() if inspect.isfunction(f)
            and f.__module__ == j.__name__ and not n.startswith("_")]
        assert all(hasattr(t, n) for n in names), j.__name__
    assert set(jax_rtc.__all__) - set(t_rtc.__all__) == {"PallasOp"}
    for prop in ("rank", "num_workers"):
        assert isinstance(getattr(t_kv.KVStore, prop), property)


def test_multiprocess_names():
    """The multi-process trainer's names: ``distributed.process_index``
    and ``process_count`` (``jax.process_index``/``process_count``, no
    backend to choose), ``devices`` and ``device_processes`` (the global
    ``jax.devices()`` and each device's ``process_index``); the mesh
    functions keep the JAX package's parameters in its order, the port's
    ``processes`` keyword-only after them; the cross-process collectives
    are exported."""
    import jax
    import mxnet_tpu.parallel.mesh as jmesh
    from mxnet_tpu_torch.parallel import collectives as tcoll
    from mxnet_tpu_torch.parallel import program as tprog
    assert t_dist.process_index() == jax.process_index() == 0
    assert t_dist.process_count() == jax.process_count() == 1
    for name in ("process_index", "process_count", "devices",
                 "device_processes"):
        assert name in t_dist.__all__
        assert not inspect.signature(getattr(t_dist, name)).parameters
    assert t_dist.device_processes() == [0] * len(t_dist.devices())
    for name in ("build_mesh", "data_parallel_mesh"):
        got = inspect.signature(getattr(tmesh, name)).parameters
        want = inspect.signature(getattr(jmesh, name)).parameters
        pos = [p.name for p in got.values()
               if p.kind != p.KEYWORD_ONLY]
        assert pos[:len(want)] == list(want), name
    for f in (tmesh.build_mesh, tmesh.Mesh.__init__):
        p = inspect.signature(f).parameters["processes"]
        assert p.kind == p.KEYWORD_ONLY and p.default is None
    for name in ("Span", "psum_ranked", "process_sum", "process_broadcast"):
        assert name in tcoll.__all__, name
    assert "ProgramChain" in tprog.__all__
    assert isinstance(ttrainer.ParallelTrainer.compile_counts, property)


@pytest.mark.parametrize("j,t,name", [(j, t, n) for j, t, names in ZOO
                                      for n in names],
                         ids=[n for _, _, names in ZOO for n in names])
def test_zoo_defaults_follow_the_jax_package(j, t, name):
    want = inspect.signature(getattr(j, name)).parameters.values()
    got = inspect.signature(getattr(t, name)).parameters.values()
    assert [(p.name, p.default) for p in got] == \
        [(p.name, p.default) for p in want]


@pytest.mark.parametrize("name,jax_fn,port_fn", CALLABLES,
                         ids=[c[0] for c in CALLABLES])
def test_parameters_follow_the_jax_package(name, jax_fn, port_fn):
    want = list(inspect.signature(jax_fn).parameters.values())
    got = list(inspect.signature(port_fn).parameters.values())
    assert [(p.name, p.kind) for p in got[:len(want)]] == \
        [(p.name, p.kind) for p in want], name
    extra = got[len(want):]
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in extra), \
        (name, [p.name for p in extra])
    assert [p.name for p in extra] in ([], ["device"]), name


@pytest.fixture(scope="module")
def lm():
    symbol = get_transformer_lm(VOCAB, num_layers=1, embed_dim=16,
                                num_heads=2)
    shapes = {"data": (2, T), "softmax_label": (2, T)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    params = {n: (0.3 * rng.randn(*s)).astype(np.float32)
              for n, s in zip(symbol.list_arguments(), arg_shapes)
              if n not in shapes}
    return symbol, shapes, params


@pytest.fixture(scope="module")
def decoder(lm):
    symbol, _, params = lm
    return tdecode.Decoder(symbol, params, T, device="cpu")


def test_trainer_binds_positionally_as_jax(lm):
    symbol, shapes, _ = lm
    init = Uniform(0.02)
    tr = ttrainer.ParallelTrainer(symbol, shapes, "sgd", None, None, init,
                                  3, device="cpu")
    assert tr._initializer is init
    a = tr.init_params().get_params()[0]
    b = ttrainer.ParallelTrainer(symbol, shapes, initializer=init, seed=3,
                                 device="cpu").init_params().get_params()[0]
    assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
               for k in a)


def test_compile_counts_is_a_property_as_in_jax():
    for cls in (jax_engine.InferenceEngine, tengine.InferenceEngine):
        assert isinstance(inspect.getattr_static(cls, "compile_counts"),
                          property), cls


def test_engine_binds_positionally_as_jax(decoder):
    # decoder, slots, prefill_buckets, max_queue, stage_depth, drain_depth,
    # steps_per_round
    eng = tengine.InferenceEngine(decoder, 3, (8, 16), 5, 2, 0, 4)
    assert (eng.slots, eng.prefill_buckets, eng.max_queue) == \
        (3, (8, 16), 5)
    assert (eng._drain_depth, eng.steps_per_round) == (0, 4)


def test_decoder_binds_positionally_as_jax(lm):
    symbol, _, params = lm
    # symbol, params, max_len, aux_params, compute_dtype, cache_block,
    # cache_dtype, attn_impl, weight_dtype
    d = tdecode.Decoder(symbol, params, T, None, None, None, "int8",
                        "paged", "int8", device="cpu")
    assert d._cache_int8 and d.weight_dtype == "int8"
    # cache_block is the sixth: an integer block under the paged read is
    # refused as in the JAX package, and taken by the dense one
    with pytest.raises(MXNetError, match="two prefix-bounded"):
        tdecode.Decoder(symbol, params, T, None, None, 8, device="cpu")
    assert tdecode.Decoder(symbol, params, T, None, None, 8, None, "dense",
                           device="cpu")._cache_block == 8


def test_lm_and_optimizer_bind_positionally_as_jax():
    # ..., num_experts, pipeline_stages, moe_top_k, loss_layout
    sym = get_transformer_lm(VOCAB, 1, 16, 2, None, None, "flash", 0.0, 0,
                             None, 0, "flat")
    assert sym.infer_shape(data=(2, T), softmax_label=(2 * T,))[1] == \
        [(2 * T, VOCAB)]
    opt = topt.SGD(0.9, rescale_grad=0.5, arg_names=["w", "b"], wd=0.1,
                   sym=sym)
    assert (opt.momentum, opt.rescale_grad, opt.wd) == (0.9, 0.5, 0.1)
    assert opt.idx2name == {0: "w", 1: "b"} and opt.sym is sym
    base = topt.Optimizer(2.0, ["x"], 0.3, 1.0, 0.5)
    assert (base.rescale_grad, base.idx2name, base.wd, base.clip_gradient,
            base.lr) == (2.0, {0: "x"}, 0.3, 1.0, 0.5)


def test_generate_repeats_for_the_same_rng_seed(decoder):
    prompt = np.random.RandomState(1).randint(0, VOCAB, (2, 4))
    runs = [decoder.generate(prompt, 5,
                             rng=torch.Generator().manual_seed(s),
                             temperature=1.0) for s in (5, 5)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 9)
    with pytest.raises(MXNetError, match="torch.Generator"):
        decoder.generate(prompt, 5, rng=5, temperature=1.0)


# tensor and expert parallelism are ported, so their cases here are their
# refusals: a degree that does not divide the 2 kv heads, a mesh that is
# not a parallel.Mesh, ep > 1 over an LM with no MoE node
ENGINE_UNPORTED = [("tp", 3, "divide evenly"),
                   ("mesh", object(), "parallel.Mesh"),
                   ("ep", 2, "needs a MoE decoder")]


@pytest.mark.parametrize("param,value,match", ENGINE_UNPORTED,
                         ids=[p for p, _, _ in ENGINE_UNPORTED])
def test_engine_unported_parameters_raise(decoder, param, value, match):
    with pytest.raises(MXNetError, match=match):
        tengine.InferenceEngine(decoder, **{param: value})


# the tensor-parallel parameters (they raised "later slice" before this
# slice of the port): each is taken and gives the degree
ENGINE_TP = [
    ("tp", 2),
    ("mesh", lambda: tmesh.model_parallel_mesh(2, devices=["cpu"] * 2))]


@pytest.mark.parametrize("param,value", ENGINE_TP,
                         ids=[p for p, _ in ENGINE_TP])
def test_engine_tp_parameters_are_accepted(decoder, param, value):
    eng = tengine.InferenceEngine(
        decoder, 2, **{param: value() if callable(value) else value})
    try:
        assert eng.tp == 2 and len(eng._caches) == 2
        assert eng.snapshot()["engine"]["tp"] == 2
    finally:
        eng.close()


# the fleet parameters (they raised "later slice" before this slice of the
# port): (name, value, what the engine reads)
ENGINE_FLEET = [
    ("capture_dir", "cap", lambda e: e.capture_dir),
    ("capture_mb", 8, lambda e: e.capture.max_bytes >> 20),
    ("role", "prefill", lambda e: e.role),
    ("handoff_dtype", "int8", lambda e: e.handoff_dtype)]


@pytest.mark.parametrize("param,value,reads", ENGINE_FLEET,
                         ids=[p for p, _, _ in ENGINE_FLEET])
def test_engine_fleet_parameters_are_accepted(decoder, tmp_path,
                                              monkeypatch, param, value,
                                              reads):
    """Each is taken and reaches the engine (a capture_mb needs a
    directory to bound: the env default's)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MXNET_SERVING_CAPTURE_DIR", "cap")
    eng = tengine.InferenceEngine(decoder, 2, **{param: value})
    try:
        assert reads(eng) == value
    finally:
        eng.close()


# the robustness and observability parameters (they raised "later slice"
# before this slice of the port): (name, value, what the engine reads)
ENGINE_ROBUSTNESS = [
    ("stage_depth", 3, lambda e: e.stage_depth),
    ("overload", "shed", lambda e: e.overload),
    ("round_timeout_ms", 100.0, lambda e: e.round_timeout_ms),
    ("slo_ttft_ms", 50.0, lambda e: e.slo_ttft_ms),
    ("slo_cadence_ms", 5.0, lambda e: e.slo_cadence_ms),
    ("slo_target", 0.9, lambda e: e.slo_target),
    ("flight_recorder", 16, lambda e: e.flight.retain),
    ("engine_id", "e0", lambda e: e.engine_id),
    ("migrated_from", "e1", lambda e: e.migrated_from)]

ROBUSTNESS_ENV = ("MXNET_SERVING_OVERLOAD", "MXNET_SERVING_ROUND_TIMEOUT_MS",
                  "MXNET_SERVING_SLO_TTFT_MS", "MXNET_SERVING_SLO_CADENCE_MS",
                  "MXNET_SERVING_FLIGHT_RECORDER")


@pytest.mark.parametrize("param,value,reads", ENGINE_ROBUSTNESS,
                         ids=[p for p, _, _ in ENGINE_ROBUSTNESS])
def test_engine_robustness_parameters_are_accepted(
        decoder, jax_engine_build, monkeypatch, param, value, reads):
    """Each is taken and reaches the engine; unset, it resolves as the JAX
    engine resolves it (an auto ``engine_id`` is ``"e<pid>.<n>"``)."""
    for name in ROBUSTNESS_ENV:
        monkeypatch.delenv(name, raising=False)
    assert reads(tengine.InferenceEngine(decoder, 2, **{param: value})) \
        == value
    got, want = (reads(tengine.InferenceEngine(decoder, 2)),
                 reads(jax_engine_build()))
    if param == "engine_id":
        got, want = got.split(".")[0], want.split(".")[0]
    assert got == want


def test_submit_takes_deadlines_and_resume_tokens(decoder):
    eng = tengine.InferenceEngine(decoder, 2, prefix_cache_mb=0)
    r = eng.submit([1, 2, 3], 4, deadline_ms=1e6, ttft_deadline_ms=1e6,
                   _resume_tokens=[5, 6])
    assert (r.tokens, r.resumed, r.seq.tolist()) == ([5, 6], 2,
                                                     [1, 2, 3, 5, 6])
    assert r.deadline_ms == 1e6 and r._deadline is not None
    assert eng.submit([1, 2, 3], 4, _trace=("t", 0)).trace == ("t", 0)
    eng.close()


def _lm_unported(kw):
    return lambda lm: get_transformer_lm(VOCAB, num_layers=1, embed_dim=16,
                                         num_heads=2, **kw)


# parameters that raised "later slice" before the port had pipelines and
# meshes: each now builds what the JAX package builds
OTHER_UNPORTED = {
    "pipeline_stages": (_lm_unported(dict(pipeline_stages=2)),
                        lambda sym: all(
                            n.attrs.get("ctx_group") in ("stage0", "stage1")
                            for n in sym._topo() if not n.is_var)),
    "trainer_mesh": (lambda lm: ttrainer.ParallelTrainer(
        lm[0], lm[1], "sgd", tmesh.build_mesh({"dp": 2}, ["cpu"] * 2)),
        lambda tr: tr.mesh.shape == {"dp": 2} and tr._sharded is not None),
    "trainer_remat": (lambda lm: ttrainer.ParallelTrainer(
        lm[0], lm[1], remat=True, device="cpu"), lambda tr: tr.remat),
}


@pytest.mark.parametrize("case", sorted(OTHER_UNPORTED))
def test_other_unported_parameters_raise(lm, case):
    build, check = OTHER_UNPORTED[case]
    assert check(build(lm))


# the parallelism names the JAX package exports, with its parameters, in
# its order; the collectives keep the drift the port records for them:
# each takes the LIST of the ranks' shards where JAX takes one shard and
# an axis name, so the first parameter differs and the axis goes
def test_parallel_names_follow_the_jax_package():
    import mxnet_tpu.parallel as jpar
    from mxnet_tpu.parallel import collectives as jcoll
    from mxnet_tpu.parallel import pipeline as jpipe
    from mxnet_tpu.parallel import shard as jshard
    import mxnet_tpu_torch.parallel as tpar
    from mxnet_tpu_torch.parallel import collectives as tcoll
    from mxnet_tpu_torch.parallel import pipeline as tpipe
    from mxnet_tpu_torch.parallel import shard as tshard

    for name in ("ShardingRules", "pipeline_spmd", "partition_stages",
                 "PipelineTrainer"):
        assert hasattr(jpar, name) and hasattr(tpar, name), name
    pairs = [(jshard.ShardingRules.__init__, tshard.ShardingRules.__init__),
             (jpipe.PipelineTrainer.__init__, tpipe.PipelineTrainer.__init__),
             (jpipe.partition_stages, tpipe.partition_stages),
             (jpipe.pipeline_spmd, tpipe.pipeline_spmd),
             (jax_transformer.tp_rules, ttransformer.tp_rules)]
    for jf, tf in pairs:
        want = inspect.signature(jf).parameters
        got = inspect.signature(tf).parameters
        assert [(p.name, p.default) for p in got.values()] == \
            [(p.name, p.default) for p in want.values()], jf.__qualname__
    assert ttransformer.tp_rules() == [
        (pat, tuple(spec)) for pat, spec in jax_transformer.tp_rules()]
    for name in ("pmean", "pmax", "axis_index"):
        assert name in jcoll.__all__ and name in tcoll.__all__, name
        got = list(inspect.signature(getattr(tcoll, name)).parameters)
        assert got == ["xs"], (name, got)


# the mixture-of-experts parameters (they raised "later slice" before this
# slice of the port): each builds the JAX package's symbol, its argument
# names and shapes; moe_top_k alone is read only with num_experts, as in
# the JAX package (the dense LM)
MOE_PORTED = {"moe_top_k": dict(moe_top_k=2),
              "num_experts": dict(num_experts=4, moe_top_k=1)}


@pytest.mark.parametrize("case", sorted(MOE_PORTED))
def test_moe_parameters_build_the_jax_symbol(case):
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as TorchNames

    kw = dict(num_layers=1, embed_dim=16, num_heads=2, **MOE_PORTED[case])
    with JaxNames():
        js = jax_transformer.get_transformer_lm(VOCAB, **kw)
    with TorchNames():
        ts = get_transformer_lm(VOCAB, **kw)
    shapes = {"data": (2, T), "softmax_label": (2, T)}
    assert ts.list_arguments() == js.list_arguments()
    assert ts.infer_shape(**shapes)[0] == \
        [tuple(s) for s in js.infer_shape(**shapes)[0]]
    moe = [n for n in ts._topo() if not n.is_var
           and n.spec.name == "MoEFFN"]
    assert len(moe) == (1 if "num_experts" in MOE_PORTED[case] else 0)


def test_save_checkpoint_optimizer_states_round_trip(tmp_path, lm):
    """``optimizer_states`` (which raised before this slice of the port)
    writes ``prefix-0000.states`` beside the parameters; the JAX package
    reads back the port's blob and the port the JAX package's."""
    symbol, _, params = lm
    blob = {"step": 3, "opt": {"embed_weight": [np.arange(4.0)]}}
    prefix = str(tmp_path / "m")
    tmodel.save_checkpoint(prefix, 0, symbol,
                           {k: torch.from_numpy(v) for k, v in params.items()},
                           {}, optimizer_states=blob)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["m-0000.params", "m-0000.states", "m-symbol.json"]
    for load in (tmodel.load_optimizer_states,
                 jax_model.load_optimizer_states):
        got = load(prefix, 0)
        assert got["step"] == 3
        np.testing.assert_array_equal(got["opt"]["embed_weight"][0],
                                      np.arange(4.0))
    assert tmodel.load_optimizer_states(prefix, 1) is None
    assert tmodel.latest_checkpoint(prefix) == \
        jax_model.latest_checkpoint(prefix) == 0
    # a remote prefix goes through the URI streams, as in the JAX
    # package: without boto3 it raises there and writes nothing locally
    try:
        import boto3  # noqa: F401
    except ImportError:
        with pytest.raises(MXNetError, match="boto3"):
            tmodel.save_checkpoint("s3://bucket/m", 0, symbol, {}, {})
    assert not os.path.exists("s3:")


# the engine's view of the reuse and speculation parameters:
# (prefix_cache_mb, prefill_chunk, spec_k, draft, the draft decoder)
def _resolved(eng):
    return (eng.prefix_cache_mb, eng.prefill_chunk, eng.spec_k,
            eng.spec_draft, eng._draft_dec)


SERVING_ENV = ("MXNET_SERVING_PREFIX_CACHE_MB", "MXNET_SERVING_PREFILL_CHUNK",
               "MXNET_SERVING_SPEC_K", "MXNET_SERVING_DRAFT")


@pytest.fixture
def jax_engine_build():
    """A JAX engine (2 slots) over a 1-layer LM of its own, built under
    the current environment."""
    import jax.numpy as jnp
    from mxnet_tpu.name import NameManager

    with NameManager():
        sym = jax_transformer.get_transformer_lm(VOCAB, num_layers=1,
                                                 embed_dim=16, num_heads=2)
    arg_shapes, _, _ = sym.infer_shape(data=(1, T), softmax_label=(1, T))
    params = {n: jnp.zeros(s, jnp.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    return lambda: jax_engine.InferenceEngine(
        jax_decode.Decoder(sym, params, T, cache_block=None), 2)


@pytest.fixture
def jax_engine_defaults(jax_engine_build):
    """What the JAX engine resolves the reuse and speculation parameters
    to, under the current environment."""
    return lambda: _resolved(jax_engine_build())


# each reuse or speculation parameter the port now takes (they raised
# "later slice" before): (name, where, value, what the engine reads,
# index in _resolved)
ACCEPTED = [
    ("prefix_cache_mb", "engine", 0.0021, 0.0021, 0),
    ("prefill_chunk", "engine", 8, 8, 1),
    ("spec_k", "engine", 2, 2, 2),
    ("draft", "engine", "ngram", "ngram", 3),
    ("draft_decoder", "engine", "decoder", "decoder", 4),
    ("draft_prefix", "from_checkpoint", "ckpt", "model", 3),
    ("draft_epoch", "from_checkpoint", 0, None, 4),
    ("spec_k", "from_checkpoint", 2, 2, 2)]


@pytest.mark.parametrize("param,where,value,reads,idx", ACCEPTED,
                         ids=["%s-%s" % (a[1], a[0]) for a in ACCEPTED])
def test_reuse_and_speculation_parameters_are_accepted(
        tmp_path, lm, decoder, jax_engine_defaults, monkeypatch, param,
        where, value, reads, idx):
    """Each is taken and reaches the engine; unset, it resolves to what the
    JAX engine resolves it to. ``draft_decoder`` serves with
    ``draft="model"`` (without it the JAX engine ignores it, and so does
    the port's); ``draft_epoch`` without ``draft_prefix`` loads nothing, as
    in the JAX package; ``draft_prefix`` loads a draft model and turns
    ``draft`` to ``"model"``."""
    for name in SERVING_ENV:
        monkeypatch.delenv(name, raising=False)
    if where == "engine":
        kw = {param: decoder if value == "decoder" else value}
        if param == "draft_decoder":
            kw["draft"] = "model"
        eng = tengine.InferenceEngine(decoder, 2, **kw)
        base = tengine.InferenceEngine(decoder, 2)
    else:
        symbol, _, params = lm
        prefix = str(tmp_path / "m")
        tmodel.save_checkpoint(prefix, 0, symbol, {
            k: torch.from_numpy(v) for k, v in params.items()}, {})
        kw = {param: prefix if value == "ckpt" else value}
        eng = tengine.InferenceEngine.from_checkpoint(prefix, 0, T, 2,
                                                      device="cpu", **kw)
        base = tengine.InferenceEngine.from_checkpoint(prefix, 0, T, 2,
                                                       device="cpu")
    got = _resolved(eng)[idx]
    if reads == "decoder":
        assert got is decoder
    elif param == "draft_prefix":
        assert got == reads and isinstance(eng._draft_dec, tdecode.Decoder)
        assert eng._draft_dec is not eng._dec
    else:
        assert got == reads
    assert _resolved(base) == jax_engine_defaults() \
        == (64.0, 0, 4, "off", None)


def test_defaults_resolve_as_in_jax(lm, decoder, jax_engine_defaults,
                                    monkeypatch):
    """The decoder's defaults, and the engine's four environment defaults
    (the prefix pool's MiB, the prefill chunk, spec_k and the drafter),
    read as the JAX package reads them."""
    symbol, _, params = lm
    monkeypatch.delenv("MXNET_SERVING_ATTN_IMPL", raising=False)
    monkeypatch.delenv("MXNET_SERVING_MATMUL_IMPL", raising=False)
    monkeypatch.setenv("MXNET_SERVING_WEIGHT_DTYPE", "int8")
    d = tdecode.Decoder(symbol, params, T, device="cpu")
    assert (d._attn_impl, d._matmul_impl, d.weight_dtype) == \
        ("paged", "dense", "int8")
    for cb in ("auto", None):
        tdecode.Decoder(symbol, params, T, cache_block=cb,
                        weight_dtype="float", device="cpu")

    for name, value in zip(SERVING_ENV, ("0.5", "8", "2", "ngram")):
        monkeypatch.setenv(name, value)
    got = _resolved(tengine.InferenceEngine(decoder, 2))
    assert got == jax_engine_defaults() == (0.5, 8, 2, "ngram", None)
