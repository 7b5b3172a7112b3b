"""Multi-process checks of the distributed store, one worker each.

Counterpart of ``tests/dist_worker.py`` for the port (the reference's
nightly ``tests/nightly/dist_sync_kvstore.py`` strategy: exact BSP values
across real worker processes on one machine). Launched by the unchanged
``tools/launch.py``::

    MXNET_DISTTEST_CHECKS=kvstore,async python tools/launch.py -n 2 \\
        --local-devices 1 -- python -m mxnet_tpu_torch.testing.dist_worker

Each rank runs the checks named by ``MXNET_DISTTEST_CHECKS`` (comma list)
and prints ``OK <check> rank=<r>`` for each; a check that writes results
puts them under ``MXNET_DISTTEST_OUT`` as ``<check>-<rank>.npz`` (or
``.json``) for the launching process to hold against its oracle. The
CPU checks (``kvstore``, ``intdtype``, ``rngupd``, ``async``, ``fit``,
``afit``) run with ``--local-devices 1``; the card checks
(``resnet_sync``: ResNet-50 under ``dist_sync`` through the legacy
``fit``; ``mlp_async``: an MLP fit over the ``dist_async`` servers;
``card_routes``: exact sums of values kept on the card and the device
each collective handed gloo) put both ranks on ``gpu(0)``.

The multi-process trainer checks build ``ParallelTrainer`` over ONE mesh
that spans the processes (``build_mesh({"dp": -1})`` over every
process's devices; with ``--local-devices 2`` and 2 processes, 4 ranks
on the host; without it, every process's cards: two ranks on one card
with ``-n 2``), each process passing its rows of the global batch:
``trainer`` (the JAX package's ``check_trainer``: an FC layer, 3 SGD
steps), ``shardio`` (its ``check_sharded_io``: RAW0 records written by
rank 0, ``ImageRecordIter(num_parts=, part_index=)`` into
``fit(device_metric=True)``), ``lm_dp`` (the LM, 3 SGD steps, plain,
``zero1`` and ``fsdp``; then AdaFactor with ``fsdp``, its factored state
sharded across the processes; 2 steps each at the full size),
``bn_global`` (a conv net's BatchNorm over the global batch, 2 steps,
also with ``grad_accum=2`` at the tiny size) and ``ckpt``
(``save_sharded_checkpoint`` from every process, synchronous and, at
the tiny size, asynchronous, restored in every process). ``pipe`` builds
``PipelineTrainer`` (the LM with ``pipeline_stages=2``, f32, 3 SGD
momentum steps) over meshes whose ranks it places across the processes
itself (``PIPE_LAYOUTS``): {pp: 2} with one stage a process, GPipe and
1F1B, and at the tiny size also {dp: 2, pp: 2} with pp across the
processes and dp inside each, the same with dp across and pp inside, and
{pp: 2} with a pp-sharded parameter across the processes and with
``param_placement="replicated"``. ``sp`` builds
``SequenceParallelTrainer`` (the LM with ``impl="ring_striped"`` and, at
the tiny size, ``"ring"``; f32, 3 SGD momentum steps, every process
passing the global batch) over {dp, sp} meshes whose ranks it places
across the processes (``SP_LAYOUTS``: a rank a process; 2 a process;
dp across with the rings inside a process; sp across with dp inside),
with (at the tiny size) a checkpoint written by both processes and
restored in both.
``MXNET_DISTTEST_SIZE`` picks their sizes: ``tiny`` (the CPU tests; the
default with ``MXNET_DISTTEST_CTX=cpu``) or ``full`` (phase 7f, the
default on the card: the 124M LM in bf16 at B=8 T=1024 (f32 in ``pipe``;
in ``sp`` f32 at B=2 T=4096, 2 ranks a process), ResNet-50 f32 at 224 x
224 B=64).
They write each trainer's parameters, aux and optimizer states as
digests (and at the tiny size as ``.npz``), losses, ms a step, the
collectives' ms and bytes a step, the programs a step and the kernels'
launches. Importing this module does nothing; the work is in
:func:`main`.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

# the global batch of the fit checks and the per-rank split: rank r gets
# the rows that context r of a [ctx] * n run gets (executor_manager splits
# each batch into n contiguous parts)
FIT_SAMPLES, FIT_D, FIT_K, FIT_B = 400, 16, 4, 100
RESNET_HW, RESNET_CLASSES, RESNET_GB, RESNET_BATCHES = 224, 1000, 64, 2
RESNET_LR, RESNET_EPOCHS = 0.01, 2
MLP_DIMS = (784, 128, 64, 10)        # train_mnist.py's MLP
MLP_SAMPLES, MLP_B, MLP_EPOCHS = 2000, 100, 6
# the multi-process trainer checks: the LM (vocab, layers, width, heads,
# global batch, sequence, compute dtype) and the BatchNorm net (ResNet-50
# at 224 x 224, else a conv -> BatchNorm -> relu -> pool -> FC net; its
# grad_accum runs and global-norm clip) by size
LM_SIZES = {"tiny": dict(vocab=61, layers=1, embed=64, heads=4, b=8, t=16,
                         dtype=None),
            "full": dict(vocab=32000, layers=12, embed=768, heads=12, b=8,
                         t=1024, dtype="bfloat16")}
LM_STEPS, LM_LR, LM_SEED = 3, 1e-3, 7
LM_VARIANTS = (("plain", {}), ("zero1", {"zero1": True}),
               ("fsdp", {"fsdp": True}))
# lm_dp's AdaFactor variant (its state sharded with the parameters), and
# the steps of every lm_dp variant by size
LM_ADAFACTOR = ("adafactor_fsdp", {"optimizer": "adafactor", "fsdp": True})
LM_DP_STEPS = {"tiny": LM_STEPS, "full": 2}
BN_SIZES = {"tiny": dict(b=16, hw=8, classes=5, accum=(1, 2), clip=1.0),
            "full": dict(b=RESNET_GB, hw=RESNET_HW, classes=RESNET_CLASSES,
                         accum=(1,), clip=None)}
BN_STEPS, BN_LR = 2, 0.01
# the pipeline check: microbatches a step, the layouts by size (each a
# mesh shape, where each process's ranks lie, and the trainer's options)
PIPE_M = 4
PIPE_AXES = {"a": {"pp": 2}, "b": {"dp": 2, "pp": 2},
             "c": {"dp": 2, "pp": 2}, "d_shard": {"pp": 2},
             "d_repl": {"pp": 2}}
PIPE_KW = {"a": {}, "b": {}, "c": {}, "d_shard": {"pp_shard_min_size": 1024},
           "d_repl": {"param_placement": "replicated"}}
PIPE_LAYOUTS = {"tiny": ("a", "b", "c", "d_shard", "d_repl"),
                "full": ("a",)}
# the sequence-parallel check: the LM by size (phase 7's SP cell at the
# full size) and its layouts, each a {dp, sp} mesh shape and where each
# process's ranks lie: "a" a rank a process; "b" 2 ranks a process (two
# hops of each rotation cross); "c" dp across the processes (the rings
# inside one); "d" sp across them, dp inside
SP_SIZES = {"tiny": dict(vocab=61, layers=1, embed=64, heads=4, b=4, t=16,
                         impls=("ring_striped", "ring")),
            "full": dict(vocab=32000, layers=12, embed=768, heads=12, b=2,
                         t=4096, impls=("ring_striped",))}
SP_AXES = {"a": {"dp": 1, "sp": 2}, "b": {"dp": 1, "sp": 4},
           "c": {"dp": 2, "sp": 2}, "d": {"dp": 2, "sp": 2}}
SP_LAYOUTS = {"tiny": ("a", "b", "c", "d"), "full": ("b",)}
# the checkpoint checks' writes by size (the asynchronous writer's
# protocol is host-side: the tiny size holds it)
CKPT_KINDS = {"tiny": ("sync", "async"), "full": ("sync",)}
TRAINER_GB, SHARDIO_HW, SHARDIO_N, SHARDIO_K = 16, 12, 64, 4


def _acc_updater(key, recv, stored):
    """Module-level so it pickles to the server threads."""
    stored += recv


def _noisy_updater(key, recv, stored):
    """An RNG-drawing updater (SGLD-style): correct only if every
    process's ``mx.random`` stream is in lockstep."""
    import mxnet_tpu_torch as mx
    noise = mx.random.normal(0, 1, stored.shape, ctx=stored.context)
    stored += recv + noise


def rank_rows(x, rank, n, gb):
    """The rows of ``x`` that context ``rank`` of a ``[ctx] * n`` run
    gets from each global batch of ``gb`` rows, in order."""
    per = gb // n
    return np.concatenate([x[b * gb + rank * per:b * gb + (rank + 1) * per]
                           for b in range(len(x) // gb)])


def fit_data():
    rs = np.random.RandomState(11)
    x = rs.randn(FIT_SAMPLES, FIT_D).astype(np.float32)
    w = rs.randn(FIT_D, FIT_K)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    return x, y


def mlp_symbol(mx, dims):
    """``dims[0]`` inputs, FullyConnected -> relu for each hidden width,
    then the output layer and SoftmaxOutput."""
    net = mx.symbol.Variable("data")
    for i, h in enumerate(dims[1:-1]):
        net = mx.symbol.FullyConnected(data=net, name="fc%d" % (i + 1),
                                       num_hidden=h)
        net = mx.symbol.Activation(data=net, act_type="relu",
                                   name="relu%d" % (i + 1))
    net = mx.symbol.FullyConnected(data=net, name="fc%d" % (len(dims) - 1),
                                   num_hidden=dims[-1])
    return mx.symbol.SoftmaxOutput(data=net, name="softmax")


def mlp_params(symbol, data_shape, seed):
    """Seeded fan-in-scaled weights and zero biases, as numpy."""
    arg_shapes, _, _ = symbol.infer_shape(data=data_shape)
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("weight"):
            out[name] = (rs.randn(*shape) / np.sqrt(shape[1])).astype(
                np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def resnet_params(symbol, seed):
    """Seeded weights of ResNet-50 (numpy), as the classic phases of
    ``chip_smoke.py`` make them: fan-in-scaled convolutions, gamma near 1
    but near 0.2 at the end of each residual branch (the residual stream
    stays O(1) through 16 units, the logits O(1)), small nonzero beta and
    moving statistics."""
    shapes = {"data": (1, 3, RESNET_HW, RESNET_HW), "softmax_label": (1,)}
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {}
    for n, sh in zip(symbol.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_weight"):
            v = rs.randn(*sh) * np.sqrt(2.0 / np.prod(sh[1:]))
        elif n.endswith("_gamma"):
            v = (0.2 if n.endswith("_c_bn_gamma") else 1.0) \
                * (1.0 + 0.1 * rs.randn(*sh))
        else:
            v = 0.1 * rs.randn(*sh)
        args[n] = v.astype(np.float32)
    aux = {n: (0.1 * rs.randn(*sh) if n.endswith("mean")
               else rs.uniform(0.5, 1.5, sh)).astype(np.float32)
           for n, sh in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def resnet_batches(seed=3):
    """The ResNet check's seeded global batches: uniform images [N, 3,
    224, 224] and labels of ``RESNET_BATCHES`` batches of
    ``RESNET_GB``."""
    rs = np.random.RandomState(seed)
    n = RESNET_GB * RESNET_BATCHES
    x = rs.rand(n, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, n).astype(np.float32)
    return x, y


def mlp_data(seed=21):
    """Seeded separable data of the async MLP check: ``MLP_DIMS[-1]``
    random class prototypes over ``MLP_DIMS[0]`` features, each sample
    its class's prototype plus unit noise, scaled by 0.1 (MNIST's pixels
    are in [0, 1])."""
    rs = np.random.RandomState(seed)
    protos = rs.randn(MLP_DIMS[-1], MLP_DIMS[0])
    y = rs.randint(0, MLP_DIMS[-1], MLP_SAMPLES)
    x = 0.1 * (protos[y] + rs.randn(MLP_SAMPLES, MLP_DIMS[0]))
    return x.astype(np.float32), y.astype(np.float32)


def lm_symbol(cfg, stages=None):
    """The LM of size ``cfg`` (``LM_SIZES``), ``impl="flash"``, tagged
    for ``stages`` pipeline stages."""
    from mxnet_tpu_torch.models import get_transformer_lm
    return get_transformer_lm(cfg["vocab"], num_layers=cfg["layers"],
                              embed_dim=cfg["embed"],
                              num_heads=cfg["heads"], impl="flash",
                              pipeline_stages=stages)


def lm_batch(cfg, seed=LM_SEED):
    """The LM checks' seeded global batch: token ids and labels, int32
    [b, t]."""
    rs = np.random.RandomState(seed)
    shape = (cfg["b"], cfg["t"])
    return {"data": rs.randint(0, cfg["vocab"], shape).astype(np.int32),
            "softmax_label": rs.randint(0, cfg["vocab"], shape)
            .astype(np.int32)}


def lm_trainer(par, cfg, mesh, optimizer="sgd", **kw):
    """The LM checks' trainer: SGD lr ``LM_LR`` momentum 0.9 (or
    ``optimizer`` at lr ``LM_LR``) over ``mesh``, the default initializer
    from seed 0 (every process and the one-process oracle draw the same
    weights)."""
    shape = (cfg["b"], cfg["t"])
    opt = {"learning_rate": LM_LR}
    if optimizer == "sgd":
        opt["momentum"] = 0.9
    return par.ParallelTrainer(
        lm_symbol(cfg), {"data": shape, "softmax_label": shape},
        optimizer=optimizer, optimizer_params=opt,
        mesh=mesh, compute_dtype=cfg["dtype"], seed=0, **kw).init_params()


def sp_trainer(par, cfg, mesh, impl, init=True):
    """The SP check's trainer: the LM of size ``cfg`` (``SP_SIZES``) with
    ``impl``, f32, over ``mesh``, SGD lr ``LM_LR`` momentum 0.9 and
    rescale_grad 1/(B T), the default initializer from seed 0: phase 7's
    SP trainer at the full size."""
    from mxnet_tpu_torch.models import get_transformer_lm
    shape = (cfg["b"], cfg["t"])
    tr = par.SequenceParallelTrainer(
        get_transformer_lm(cfg["vocab"], num_layers=cfg["layers"],
                           embed_dim=cfg["embed"], num_heads=cfg["heads"],
                           impl=impl),
        {"data": shape, "softmax_label": shape}, mesh, optimizer="sgd",
        optimizer_params={"learning_rate": LM_LR, "momentum": 0.9}, seed=0)
    return tr.init_params() if init else tr


def sp_mesh(par, layout, devs, owners):
    """Layout ``layout``'s {dp, sp} mesh over the global device list
    ``devs`` owned by ``owners`` (two processes; a process with one
    device repeats it)."""
    own = [[d for d, p in zip(devs, owners) if p == q] for q in (0, 1)]

    def dev(q, k):
        return own[q][k % len(own[q])]

    if layout == "a":
        grid, procs = [[dev(0, 0), dev(1, 0)]], [[0, 1]]
    elif layout == "b":
        grid = [[dev(0, 0), dev(0, 1), dev(1, 0), dev(1, 1)]]
        procs = [[0, 0, 1, 1]]
    elif layout == "c":
        grid = [[dev(0, 0), dev(0, 1)], [dev(1, 0), dev(1, 1)]]
        procs = [[0, 0], [1, 1]]
    else:
        grid = [[dev(0, 0), dev(1, 0)], [dev(0, 1), dev(1, 1)]]
        procs = [[0, 1], [0, 1]]
    devices = np.empty(np.shape(procs), dtype=object)
    devices[:] = grid
    return par.Mesh(devices, ("dp", "sp"), processes=procs)


def sp_state(tr):
    """An SP trainer's parameters (``arg:``) and optimizer state leaves
    (``opt:<name>:<i>``) as host numpy arrays (whole in every
    process)."""
    out = {"arg:" + k: v.numpy() for k, v in tr.get_params().items()}
    for k, leaves in tr._state.by_name().items():
        for i, leaf in enumerate(leaves):
            out["opt:%s:%d" % (k, i)] = leaf.detach().to(
                "cpu", copy=True).numpy()
    return out


def pipe_schedules(layout):
    """The schedules a pipeline layout runs (1F1B needs the "stage"
    placement)."""
    return ("gpipe",) if layout == "d_repl" else ("gpipe", "1f1b")


def pipe_mesh(par, layout, devs, owners):
    """Layout ``layout``'s mesh over the global device list ``devs``
    owned by ``owners`` (two processes): stage s in process s ("a", "b",
    "d_*"; "b" with dp over two devices of each), or dp group d in process
    d with both stages on two of its devices ("c")."""
    own = [[d for d, p in zip(devs, owners) if p == q] for q in (0, 1)]
    if PIPE_AXES[layout] == {"pp": 2}:
        return par.Mesh([own[0][0], own[1][0]], ("pp",), processes=[0, 1])
    if layout == "b":
        grid = [[own[0][0], own[1][0]], [own[0][1], own[1][1]]]
        procs = [[0, 1], [0, 1]]
    else:
        grid = [own[0][:2], own[1][:2]]
        procs = [[0, 0], [1, 1]]
    devices = np.empty((2, 2), dtype=object)
    devices[:] = grid
    return par.Mesh(devices, ("dp", "pp"), processes=procs)


def pipe_trainer(par, cfg, mesh, schedule, init=True, **kw):
    """The pipeline check's trainer: the LM of size ``cfg`` with
    ``pipeline_stages=2`` (f32), PIPE_M microbatches, SGD lr ``LM_LR``
    momentum 0.9 over ``mesh``, the default initializer from seed 0;
    its parameters drawn unless ``init`` is False."""
    shape = (cfg["b"], cfg["t"])
    kw.setdefault("seed", 0)
    tr = par.PipelineTrainer(
        lm_symbol(cfg, stages=2), {"data": shape, "softmax_label": shape},
        mesh, num_microbatches=PIPE_M, optimizer="sgd",
        optimizer_params={"learning_rate": LM_LR, "momentum": 0.9},
        schedule=schedule, **kw)
    return tr.init_params() if init else tr


def pipe_state(tr):
    """A PipelineTrainer's whole parameters (``arg:``; ``get_params``
    gathers them, so every process calls it together) and the optimizer
    state this process holds, by rank (``opt:<row|flat|name>:<rank>:<i>``),
    as host numpy arrays."""
    out = {"arg:" + k: v.numpy() for k, v in tr.get_params().items()}
    st = tr.opt_state
    per = dict(st["big"], row=st["rows"]) \
        if tr.param_placement == "stage" else {"flat": st}
    for name, states in per.items():
        for r, rank_state in enumerate(states):
            if rank_state is None:
                continue
            for i, b in enumerate(rank_state.buffers()):
                out["opt:%s:%d:%d" % (name, r, i)] = \
                    b.detach().cpu().numpy()
    return out


def bn_symbol(mx, cfg):
    """The BatchNorm checks' net: ResNet-50 at the full size, else conv
    3x3 -> BatchNorm -> relu -> max pool -> FC -> softmax."""
    if cfg["hw"] == RESNET_HW:
        from mxnet_tpu_torch.models import get_resnet
        return get_resnet(cfg["classes"], 50)
    s = mx.symbol
    x = s.Convolution(data=s.Variable("data"), name="conv", kernel=(3, 3),
                      num_filter=4, pad=(1, 1))
    x = s.BatchNorm(data=x, name="bn")
    x = s.Activation(data=x, name="relu", act_type="relu")
    x = s.Pooling(data=x, name="pool", kernel=(2, 2), stride=(2, 2),
                  pool_type="max")
    x = s.FullyConnected(data=s.Flatten(data=x, name="flat"), name="fc",
                         num_hidden=cfg["classes"])
    return s.SoftmaxOutput(data=x, name="softmax")


def bn_problem(symbol, cfg, seed=3):
    """(weights, aux, global batches) of the BatchNorm checks: at the full
    size ``resnet_params`` and ``resnet_batches``; else seeded uniform
    weights and ``BN_STEPS`` batches whose halves differ in scale (a split
    by process would see other statistics)."""
    if cfg["hw"] == RESNET_HW:
        args, aux = resnet_params(symbol, 5)
        x, y = resnet_batches()
        return args, aux, [{"data": x[i * cfg["b"]:(i + 1) * cfg["b"]],
                            "softmax_label": y[i * cfg["b"]:
                                               (i + 1) * cfg["b"]]}
                           for i in range(BN_STEPS)]
    rs = np.random.RandomState(seed)
    shapes = {"data": (cfg["b"], 3, cfg["hw"], cfg["hw"]),
              "softmax_label": (cfg["b"],)}
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    args = {n: rs.uniform(-0.3, 0.3, sh).astype(np.float32)
            for n, sh in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: (np.zeros(sh) if n.endswith("mean") else np.ones(sh))
           .astype(np.float32)
           for n, sh in zip(symbol.list_auxiliary_states(), aux_shapes)}
    batches = []
    for _ in range(BN_STEPS):
        x = rs.randn(*shapes["data"]).astype(np.float32)
        x[cfg["b"] // 2:] = x[cfg["b"] // 2:] * 3.0 + 2.0
        batches.append({"data": x, "softmax_label": rs.randint(
            0, cfg["classes"], (cfg["b"],)).astype(np.float32)})
    return args, aux, batches


def fc_symbol(mx, k=4):
    """The ``trainer`` check's net: FullyConnected(4) -> SoftmaxOutput."""
    fc = mx.symbol.FullyConnected(data=mx.symbol.Variable("data"),
                                  name="fc", num_hidden=k)
    return mx.symbol.SoftmaxOutput(data=fc, name="softmax")


def fc_problem():
    """The ``trainer`` check's weights and global batch (the JAX package's
    ``check_trainer``: seed 123)."""
    rng = np.random.RandomState(123)
    w = rng.uniform(-0.1, 0.1, (4, 8)).astype(np.float32)
    b = np.zeros(4, np.float32)
    data = rng.randn(TRAINER_GB, 8).astype(np.float32)
    label = rng.randint(0, 4, (TRAINER_GB,)).astype(np.float32)
    return {"fc_weight": w, "fc_bias": b}, {"data": data,
                                            "softmax_label": label}


def digests(state):
    """{key: sha1 of the array's bytes} of a flat dict of arrays."""
    import hashlib
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in state.items()}


def trainer_state(tr):
    """A trainer's parameters, aux states and optimizer state leaves as
    one flat dict of host numpy arrays (``arg:``, ``aux:``,
    ``opt:<name>:<i>``)."""
    args, aux = tr.get_params()
    out = {"arg:" + k: v.numpy() for k, v in args.items()}
    out.update({"aux:" + k: v.numpy() for k, v in aux.items()})
    for k, leaves in tr.get_optimizer_states()["opt"].items():
        for i, leaf in enumerate(leaves):
            out["opt:%s:%d" % (k, i)] = np.asarray(leaf)
    return out


class _EpochLoss:
    """A batch-end callback keeping each epoch's mean cross-entropy from
    the metric (``eval_metric="ce"``)."""

    def __init__(self):
        self.by_epoch = {}

    def __call__(self, param):
        self.by_epoch[param.epoch] = float(param.eval_metric.get()[1])


def _out(name, rank):
    return os.path.join(os.environ["MXNET_DISTTEST_OUT"],
                        "%s-%d" % (name, rank))


def main():
    from mxnet_tpu_torch import distributed
    distributed.initialize()  # from the MXNET_TPU_* env of tools/launch.py

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as kvs
    from mxnet_tpu_torch import telemetry as tele

    rank = distributed.rank()
    n = distributed.num_workers()
    assert n > 1, "launch with tools/launch.py -n 2+"
    # the card checks' context: gpu(0), or the host for a rehearsal
    # (MXNET_DISTTEST_CTX=cpu; the CPU tests run mlp_async so)
    card = mx.cpu(0) if os.environ.get("MXNET_DISTTEST_CTX") == "cpu" \
        else mx.gpu(0)

    def sync():
        if card.device_type == "gpu":
            torch.cuda.synchronize()

    def check_kvstore():
        """push/pull BSP exact values: sum of (rank+1) = n(n+1)/2, on a
        small array (replicated) AND a big one (reduce-scattered until
        pulled); an updater installed after an unpulled big push folds
        the pending aggregate in first."""
        kv = mx.kv.create("dist_sync")
        assert kv.rank == rank and kv.num_workers == n
        expect = n * (n + 1) / 2
        shape = (4, 3)
        kv.init(9, mx.nd.zeros(shape))
        kv.push(9, mx.nd.ones(shape) * (rank + 1))
        out = mx.nd.zeros(shape)
        kv.pull(9, out)
        np.testing.assert_array_equal(out.asnumpy(), expect)
        big = (1200,)
        kv.init(99, mx.nd.zeros(big))
        for _ in range(2):  # two rounds: the shard state is rebuilt
            kv.push(99, mx.nd.ones(big) * (rank + 1))
            assert 99 in kv._sharded, "a big push stays reduce-scattered"
            out = mx.nd.zeros(big)
            kv.pull(99, out)
            np.testing.assert_array_equal(out.asnumpy(), expect)
        kv.push(99, mx.nd.ones(big) * (rank + 1))  # pending: expect
        kv._set_updater(_acc_updater)
        kv.push(99, mx.nd.ones(big) * (rank + 1))  # store=expect, +=expect
        out = mx.nd.zeros(big)
        kv.pull(99, out)
        np.testing.assert_array_equal(out.asnumpy(), 2 * expect)
        # two device copies a rank: merged locally, then across ranks
        kv.init(7, mx.nd.zeros(shape))
        kv.push(7, [mx.nd.ones(shape) * (rank + 1),
                    mx.nd.ones(shape) * 10 * (rank + 1)])
        out = mx.nd.zeros(shape)
        kv.pull(7, out)
        np.savez(_out("kvstore", rank), key7=out.asnumpy())
        print("OK kvstore rank=%d" % rank, flush=True)

    def check_int_dtype():
        """Integer pushes keep their dtype through the all-reduce and sum
        exactly."""
        v = torch.arange(6, dtype=torch.int32).reshape(2, 3)
        out = kvs._allreduce(v * (rank + 1), shard_big=False)
        assert out.dtype == torch.int32, out.dtype
        np.testing.assert_array_equal(out.numpy(),
                                      v.numpy() * (n * (n + 1) // 2))
        kv = mx.kv.create("dist_sync")
        kv.init(5, mx.nd.zeros((3,), dtype=np.int32))
        kv.push(5, mx.nd.array(np.full(3, rank + 1, np.int32)))
        out = mx.nd.zeros((3,), dtype=np.int32)
        kv.pull(5, out)
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out.asnumpy(), n * (n + 1) // 2)
        print("OK intdtype rank=%d" % rank, flush=True)

    def check_rng_updater():
        """An updater drawing from ``mx.random`` stays in lockstep across
        ranks despite deliberately divergent per-process seeds; the
        user's stream is untouched by it."""
        kv = mx.kv.create("dist_sync")
        kv.init(55, mx.nd.zeros((4, 3)))
        mx.random.seed(1234 + rank)  # deliberately divergent
        mine = mx.random.uniform(0, 1, (3,)).asnumpy()
        mx.random.seed(1234 + rank)
        kv._set_updater(_noisy_updater)
        for _ in range(3):
            kv.push(55, mx.nd.ones((4, 3)) * (rank + 1))
        out = mx.nd.zeros((4, 3))
        kv.pull(55, out)
        # the user stream continues as if the updater had not drawn
        # (the seed broadcast drew from it on rank 0 only)
        after = mx.random.uniform(0, 1, (3,)).asnumpy()
        if rank:
            np.testing.assert_array_equal(after, mine)
        np.savez(_out("rngupd", rank), value=out.asnumpy())
        print("OK rngupd rank=%d" % rank, flush=True)

    def check_async():
        """dist_async: update-per-push servers, no worker lockstep; with
        an accumulating updater the final value is exact: nrepeat *
        n(n+1)/2, on a hashed small key and a range-partitioned big
        key."""
        kv = mx.kv.create("dist_async")
        assert kv.rank == rank and kv.num_workers == n
        nrepeat = 3
        kv.init(3, mx.nd.zeros((4, 3)))
        kv.init(97, mx.nd.zeros((1200,)))
        assert len(kv._ps._layout[97]) == n  # range-partitioned
        kv._set_updater(_acc_updater)
        kv.barrier()
        for _ in range(nrepeat):
            kv.push(3, mx.nd.ones((4, 3)) * (rank + 1))
            kv.push(97, mx.nd.ones((1200,)) * (rank + 1))
        kv.barrier()  # quiesce: every worker's pushes are acked
        expect = nrepeat * n * (n + 1) / 2
        for key, shape in ((3, (4, 3)), (97, (1200,))):
            out = mx.nd.zeros(shape)
            kv.pull(key, out)
            np.testing.assert_array_equal(out.asnumpy(), expect)
        kv.close()
        print("OK async rank=%d" % rank, flush=True)

    def check_fit():
        """FeedForward.fit under dist_sync: every rank its contexts' rows
        of each global batch; the ranks end with the same parameters,
        written out for the launcher's one-process oracle."""
        x, y = fit_data()
        sym = mlp_symbol(mx, (FIT_D, 32, FIT_K))
        params = mlp_params(sym, (FIT_B, FIT_D), 5)
        xs, ys = (rank_rows(a, rank, n, FIT_B) for a in (x, y))
        model = mx.model.FeedForward(
            sym, ctx=mx.cpu(), num_epoch=5, learning_rate=0.2,
            momentum=0.9, arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                      for k, v in params.items()})
        model.fit(mx.io.NDArrayIter(xs, ys, batch_size=FIT_B // n),
                  kvstore="dist_sync")
        acc = model.score(mx.io.NDArrayIter(x, y, batch_size=FIT_B))
        np.savez(_out("fit", rank), **{k: v.asnumpy() for k, v in
                                        model.arg_params.items()})
        print("OK fit rank=%d acc=%.3f" % (rank, acc), flush=True)

    def check_fit_async():
        """FeedForward.fit over the async servers with fc1_weight range-
        partitioned (bigger than MXNET_KVSTORE_BIGARRAY_BOUND): update-
        per-push on a big key still converges."""
        x, y = fit_data()
        sym = mlp_symbol(mx, (FIT_D, 32, FIT_K))
        kv = mx.kv.create("dist_async")
        model = mx.model.FeedForward(sym, ctx=mx.cpu(), num_epoch=25,
                                     learning_rate=0.1, momentum=0.9,
                                     numpy_batch_size=50)
        model.fit(x[rank::n], y[rank::n], kvstore=kv)
        kv.barrier()
        acc = model.score(mx.io.NDArrayIter(x, y, batch_size=FIT_B))
        assert acc > 0.85, "async fit failed to converge: %f" % acc
        kv.close()
        print("OK afit rank=%d acc=%.3f" % (rank, acc), flush=True)

    def check_resnet_sync():
        """ResNet-50 f32 through ``FeedForward(ctx=gpu(0)).fit`` under
        dist_sync on the legacy loop with the conv-BN train gate on: the
        matmul_stats launches a step, the epoch losses, the parameters,
        the step and push/pull times and bytes, written out."""
        from mxnet_tpu_torch.models import get_symbol
        from mxnet_tpu_torch.ops import kernels as K
        os.environ["MXNET_PALLAS_CONVBN_TRAIN"] = "1"
        # reproducible f32 convolutions (no TF32, fixed algorithms): the
        # launcher's one-process oracle runs them so
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        gb = RESNET_GB
        sym = get_symbol("resnet", num_classes=RESNET_CLASSES,
                         num_layers=50)
        args, aux = resnet_params(sym, 5)
        x, y = resnet_batches()
        xs, ys = (rank_rows(a, rank, n, gb) for a in (x, y))
        from mxnet_tpu_torch import model as mx_model
        ctx = card
        loss = _EpochLoss()
        steps, update_s = [], []

        def stamp(param):
            sync()
            steps.append(time.perf_counter())
            loss(param)

        real = mx_model._update_params_on_kvstore

        def timed_update(*a, **kw):
            # push/pull of every key: the legacy loop's update (its first
            # copy to the host waits for the backward anyway)
            sync()
            tic = time.perf_counter()
            real(*a, **kw)
            sync()
            update_s.append(time.perf_counter() - tic)

        model = mx.model.FeedForward(
            sym, ctx=ctx, num_epoch=RESNET_EPOCHS, learning_rate=RESNET_LR,
            momentum=0.9,
            arg_params={k: mx.nd.array(v, ctx=ctx) for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=ctx) for k, v in aux.items()})
        it = mx.io.NDArrayIter(xs, ys, batch_size=gb // n)
        kv = mx.kv.create("dist_sync")
        K.reset_launch_counts()
        hist = tele.histogram("kvstore.sync_ms")
        sync0 = (hist.sum, hist.count)
        bytes0 = tele.counter("kvstore.sync_bytes").value
        sync()
        t0 = time.perf_counter()
        mx_model._update_params_on_kvstore = timed_update
        try:
            model.fit(it, eval_metric="ce", kvstore=kv,
                      batch_end_callback=stamp)
        finally:
            mx_model._update_params_on_kvstore = real
        nsteps = len(steps)
        counts = K.launch_counts()
        # the steady steps: the first epoch's first step builds and loads
        step_ms = [(b - a) * 1e3 for a, b in zip(steps, steps[1:])]
        res = {
            "steps": nsteps,
            "matmul_stats": counts["matmul_stats"],
            "launches": {k: v for k, v in counts.items() if v},
            "loss": [loss.by_epoch[e] for e in sorted(loss.by_epoch)],
            "first_step_ms": (steps[0] - t0) * 1e3,
            "step_ms": step_ms,
            "update_ms": [t * 1e3 for t in update_s],
            "sync_ms_total": hist.sum - sync0[0],
            "sync_calls": hist.count - sync0[1],
            "sync_bytes": tele.counter("kvstore.sync_bytes").value - bytes0,
            "routes": dict(kvs.ROUTES),
        }
        with open(_out("resnet_sync", rank) + ".json", "w") as f:
            json.dump(res, f)
        np.savez(_out("resnet_sync", rank),
                 **{k: v.asnumpy() for k, v in model.arg_params.items()})
        print("OK resnet_sync rank=%d" % rank, flush=True)

    def check_mlp_async():
        """The train_mnist MLP fit over the async servers on the card,
        fc1_weight range-partitioned: accuracy, the push and pull counts
        and their rates, written out."""
        from mxnet_tpu_torch.ops import kernels as K
        x, y = mlp_data()
        sym = mlp_symbol(mx, MLP_DIMS)
        kv = mx.kv.create("dist_async")
        ps = kv._ps
        timed = {"push": [0.0, 0], "pull": [0.0, 0]}

        def timer(name, fn):
            def run(*a):
                t0 = time.perf_counter()
                r = fn(*a)
                timed[name][0] += time.perf_counter() - t0
                timed[name][1] += 1
                return r
            return run

        ps.push, ps.pull = timer("push", ps.push), timer("pull", ps.pull)
        pushes0 = tele.counter("kvstore.pushes").value
        pulls0 = tele.counter("kvstore.pulls").value
        pb0 = tele.counter("kvstore.push_bytes").value
        lb0 = tele.counter("kvstore.pull_bytes").value
        params = mlp_params(sym, (MLP_B, MLP_DIMS[0]), 7)
        ctx = card
        model = mx.model.FeedForward(
            sym, ctx=ctx, num_epoch=MLP_EPOCHS, learning_rate=0.1,
            momentum=0.9, arg_params={k: mx.nd.array(v, ctx=ctx)
                                      for k, v in params.items()})
        nb = []
        K.reset_launch_counts()
        model.fit(mx.io.NDArrayIter(x[rank::n], y[rank::n],
                                    batch_size=MLP_B // n),
                  kvstore=kv, batch_end_callback=lambda p: nb.append(1))
        launches = K.launch_counts()
        kv.barrier()
        acc = model.score(mx.io.NDArrayIter(x, y, batch_size=MLP_B))
        res = {
            "acc": acc, "steps": len(nb), "keys": len(params),
            "parts_fc1": len(ps._layout[[
                a for a in sym.list_arguments()
                if a not in ("data", "softmax_label")].index(
                    "fc1_weight")]),
            "pushes": tele.counter("kvstore.pushes").value - pushes0,
            "pulls": tele.counter("kvstore.pulls").value - pulls0,
            "push_bytes": tele.counter("kvstore.push_bytes").value - pb0,
            "pull_bytes": tele.counter("kvstore.pull_bytes").value - lb0,
            "push_s": timed["push"][0], "pull_s": timed["pull"][0],
            "fused_linear": launches["fused_linear"],
        }
        kv.close()
        with open(_out("mlp_async", rank) + ".json", "w") as f:
            json.dump(res, f)
        print("OK mlp_async rank=%d acc=%.3f" % (rank, acc), flush=True)

    def check_card_routes():
        """Exact dist_sync sums of values kept on the card context, f32
        and int32: a replicated key, a reduce-scattered one whose rows do
        not split evenly over the ranks and one that does (the big-array
        bound as set), then the device of the tensors each collective
        handed gloo (``kvstore.ROUTES``), written out."""
        kv = mx.kv.create("dist_sync")
        expect = n * (n + 1) // 2
        bound = kvs._bigarray_bound()
        cases = [(shape, dt) for shape in ((4, 3), (bound + 1,),
                                           (2 * bound, 2))
                 for dt in (np.float32, np.int32)]
        for key, (shape, dt) in enumerate(cases):
            kv.init(key, mx.nd.zeros(shape, ctx=card, dtype=dt))
            kv.push(key, mx.nd.array(np.full(shape, rank + 1, dt),
                                     ctx=card, dtype=dt))
            out = mx.nd.zeros(shape, ctx=card, dtype=dt)
            kv.pull(key, out)
            assert out.dtype == dt, (out.dtype, dt)
            np.testing.assert_array_equal(out.asnumpy(),
                                          np.full(shape, expect, dt))
        with open(_out("card_routes", rank) + ".json", "w") as f:
            json.dump(dict(kvs.ROUTES), f)
        print("OK card_routes rank=%d" % rank, flush=True)

    # -- the multi-process trainer ---------------------------------------
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.parallel import collectives as coll
    # the trainer checks' size: tiny on the host, full on the card
    size = os.environ.get("MXNET_DISTTEST_SIZE") or (
        "tiny" if card.device_type == "cpu" else "full")

    def rows(gb):
        """This process's rows of a global batch of ``gb`` (the mesh over
        every process's devices is process-ordered)."""
        return slice(rank * gb // n, (rank + 1) * gb // n)

    def local(batch, gb):
        return {k: v[rows(gb)] for k, v in batch.items()}

    def settle(tr):
        if tr.device.type == "cuda":
            torch.cuda.synchronize()

    def cross():
        hist = tele.histogram("collectives.cross_ms")
        return (hist.sum, hist.count,
                tele.counter("collectives.cross_bytes").value)

    def global_nll(out, label):
        """The mean -log p[label] over the global batch of the softmax
        output (classes on dimension 1: [B, K] or the LM's [B, V, T];
        this process's sum and count, summed over the processes; a
        process that returns no output adds nothing)."""
        if out is None:
            acc = torch.zeros(2)
        else:
            lab = torch.as_tensor(label).long().to(out.device)
            p = out.gather(1, lab.unsqueeze(1))
            acc = torch.stack([-torch.log(p.float().clamp_min(1e-30)).sum(),
                               torch.tensor(float(lab.numel()),
                                            device=out.device)])
        tot = coll.process_sum(acc).tolist()
        return tot[0] / tot[1]

    def train(tr, batches, what):
        """Step over ``batches`` (this process's rows, a list; each step
        the next): (ms a step, losses, the collectives and the launches
        of every step after the first (which builds and captures), the
        step's programs; the last step's first head output, None where
        this process returns none)."""
        res = {"ms": [], "loss": []}
        for i, b in enumerate(batches):
            if i == 1:
                K.reset_launch_counts()
                c0 = cross()
            settle(tr)
            t0 = time.perf_counter()
            outs = tr.step(b)
            settle(tr)
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            out = outs[0] if isinstance(outs, list) else outs
            res["loss"].append(global_nll(out, b["softmax_label"]))
        figures(res, c0, len(batches))
        progs = getattr(tr._program, "programs", [tr._program])
        res["programs"] = len(progs)
        res["captured"] = sum(1 for p in progs if p._capture_ok
                              and p.device.type == "cuda")
        res["host_stages"] = getattr(tr._program, "host_stages", 0)
        res["compile_counts"] = tr.compile_counts
        res["what"] = what
        return res, out

    def figures(res, c0, nsteps):
        """The launches and the collectives' ms, calls and bytes a step
        since ``c0`` (``cross()`` before step 2) into ``res``."""
        c1 = cross()
        steps = max(nsteps - 1, 1)
        res["launches"] = {k: v for k, v in K.launch_counts().items() if v}
        res["cross_ms"] = (c1[0] - c0[0]) / steps
        res["cross_calls"] = (c1[1] - c0[1]) / steps
        res["cross_bytes"] = (c1[2] - c0[2]) / steps

    def sp_train(tr, batch, steps):
        """``steps`` SP steps on the global ``batch``: ms a step, the
        losses (the global mean NLL ``step`` returns) and the figures of
        every step after the first."""
        res = {"ms": [], "loss": []}
        for i in range(steps):
            if i == 1:
                K.reset_launch_counts()
                c0 = cross()
            settle(tr)
            t0 = time.perf_counter()
            loss = float(tr.step(batch))
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["loss"].append(loss)
        figures(res, c0, steps)
        return res

    def keep(name, state, extra):
        """Write a trainer's state: digests (and at the tiny size the
        arrays) and ``extra``."""
        extra = dict(extra, digests=digests(state))
        with open(_out(name, rank) + ".json", "w") as f:
            json.dump(extra, f)
        if size == "tiny":
            np.savez(_out(name, rank), **state)

    def card_math():
        # reproducible f32 convolutions and products (no TF32, fixed
        # algorithms), as the one-process oracle runs them
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def check_trainer():
        """The JAX package's check_trainer: an FC layer over the mesh of
        every process's devices, 3 SGD steps on this process's rows; the
        same by ``multi_step(batch, 3)``, bitwise; the eval forward of
        this process's rows gives the global batch's outputs."""
        sym = fc_symbol(mx)
        init, batch = fc_problem()
        trainers = []
        for _ in range(2):
            tr = par.ParallelTrainer(
                sym, {k: v.shape for k, v in batch.items()},
                optimizer="sgd", mesh=par.build_mesh({"dp": -1}),
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
            tr.init_params(init)
            trainers.append(tr)
        for _ in range(3):
            trainers[0].step(local(batch, TRAINER_GB))
        trainers[1].multi_step(local(batch, TRAINER_GB), 3)
        state = trainer_state(trainers[0])
        again = trainer_state(trainers[1])
        assert all(np.array_equal(state[k], again[k]) for k in state)
        state["forward"] = trainers[0].forward(
            local(batch, TRAINER_GB))[0].cpu().numpy()
        keep("trainer", state, {"ranks": tr.mesh.size})
        csum = float(np.abs(state["arg:fc_weight"]).sum())
        print("OK trainer rank=%d csum=%.6f" % (rank, csum), flush=True)

    kept = {}   # lm_dp's fsdp trainer and its state, for ckpt

    def check_lm_dp():
        """The LM over the mesh of every process's devices, 3 SGD steps on
        one global batch (this process's rows), plain, zero1 and fsdp."""
        cfg = LM_SIZES[size]
        batch = local(lm_batch(cfg), cfg["b"])
        for variant, kw in LM_VARIANTS + (LM_ADAFACTOR,):
            tr = lm_trainer(par, cfg, par.build_mesh({"dp": -1}), **kw)
            if tr.device.type == "cuda":
                card_math()
            res, _ = train(tr, [batch] * LM_DP_STEPS[size], variant)
            res["state_bytes"] = [list(tr._sharded.state_bytes(r))
                                  for r in tr._sharded.local]
            state = trainer_state(tr)
            keep("lm_dp-%s" % variant, state, res)
            if variant == "fsdp":
                kept.update(tr=tr, state=state)
            del tr
            gc.collect()
        print("OK lm_dp rank=%d" % rank, flush=True)

    def check_bn_global():
        """A training BatchNorm over the global batch of every process
        (ResNet-50 f32 at the full size), BN_STEPS SGD steps, each
        grad_accum of the size, with its global-norm clip."""
        cfg = BN_SIZES[size]
        sym = bn_symbol(mx, cfg)
        args, aux, batches = bn_problem(sym, cfg)
        for accum in cfg["accum"]:
            tr = par.ParallelTrainer(
                sym, {k: v.shape for k, v in batches[0].items()},
                optimizer="sgd", mesh=par.build_mesh({"dp": -1}),
                optimizer_params={"learning_rate": BN_LR, "momentum": 0.9},
                grad_accum=accum, clip_grad_norm=cfg["clip"])
            tr.init_params(args, aux)
            if tr.device.type == "cuda":
                card_math()
            res, _ = train(tr, [local(b, cfg["b"]) for b in batches],
                           "accum%d" % accum)
            keep("bn_global-%d" % accum, trainer_state(tr), res)
            del tr
            gc.collect()
        print("OK bn_global rank=%d" % rank, flush=True)

    def check_ckpt():
        """save_sharded_checkpoint of the fsdp LM (lm_dp's trainer after
        its steps when that check ran, else a fresh one after one step)
        from every process, synchronous and asynchronous; after one more
        step each is restored into the trainer in every process: this
        process's buffers (parameters, optimizer state, aux) bitwise the
        saved ones."""
        from mxnet_tpu_torch.parallel.checkpoint import latest_step
        cfg = LM_SIZES[size]
        batch = local(lm_batch(cfg), cfg["b"])
        tr, want = kept.pop("tr", None), kept.pop("state", None)
        if tr is None:
            tr = lm_trainer(par, cfg, par.build_mesh({"dp": -1}),
                            fsdp=True)
            if tr.device.type == "cuda":
                card_math()
            tr.step(batch)
            want = trainer_state(tr)
        saved = [b.clone() for b in tr._sharded.buffers()]
        step = tr._t
        res = {"save_s": {}, "bytes": {}, "step": step}
        prefixes = {how: os.path.join(os.environ["MXNET_DISTTEST_OUT"],
                                      "ckpt-" + how)
                    for how in CKPT_KINDS[size]}
        for how, prefix in prefixes.items():
            t0 = time.perf_counter()
            tr.save_sharded_checkpoint(
                prefix, async_write=how == "async")()
            distributed.barrier("ckpt")
            res["save_s"][how] = time.perf_counter() - t0
            assert latest_step(prefix) == step, (how, latest_step(prefix))
            res["bytes"][how] = os.path.getsize(
                "%s-shards-p%d.npz" % (prefix, rank))
        for how, prefix in prefixes.items():
            tr.step(batch)  # the live state moves on
            tr.restore_sharded_checkpoint(prefix)
            bad = [i for i, (b, v) in enumerate(zip(
                tr._sharded.buffers(), saved)) if not torch.equal(b, v)]
            assert not bad and tr._t == step, \
                "ckpt %s: %d restored buffers differ" % (how, len(bad))
        keep("ckpt", want, res)
        del tr, saved
        gc.collect()
        print("OK ckpt rank=%d" % rank, flush=True)

    def check_pipe():
        """PipelineTrainer over meshes whose ranks lie across the two
        processes (``PIPE_LAYOUTS`` of the size; each schedule the layout
        runs), LM_STEPS steps on one global batch, each process passing
        its rows (``process_rows``): the state (whole parameters, this
        process's optimizer state; at the tiny size the last head output
        where this process returns one, ``<name>-head-<rank>.npy``) and
        the step's figures, written for the launcher's one-process
        oracle; ``seed=None`` takes process 0's seed in both."""
        cfg = LM_SIZES[size]
        devs, owners = distributed.devices(), distributed.device_processes()
        gbatch = lm_batch(cfg)
        drawn = pipe_trainer(par, cfg, pipe_mesh(par, "a", devs, owners),
                             "gpipe", init=False, seed=None)._seed
        for layout in PIPE_LAYOUTS[size]:
            for schedule in pipe_schedules(layout):
                tr = pipe_trainer(par, cfg,
                                  pipe_mesh(par, layout, devs, owners),
                                  schedule, **PIPE_KW[layout])
                if tr.device.type == "cuda":
                    card_math()
                lo, hi = tr.process_rows
                res, head = train(tr, [{k: v[lo:hi] for k, v in
                                        gbatch.items()}] * LM_STEPS,
                                  "%s %s" % (layout, schedule))
                res.update(process_rows=[lo, hi], has_head=head is not None,
                           seed_none=drawn)
                name = "pipe-%s-%s" % (layout, schedule)
                state = pipe_state(tr)
                keep(name, state, res)
                if head is not None and size == "tiny":
                    np.save(_out(name + "-head", rank), head.cpu().numpy())
                del tr, state
                gc.collect()
        print("OK pipe rank=%d" % rank, flush=True)

    def check_sp():
        """SequenceParallelTrainer over {dp, sp} meshes whose ranks lie
        across the two processes (``SP_LAYOUTS`` of the size, each impl of
        the size), LM_STEPS steps on one global batch, which every process
        passes whole: the state (whole in every process) and the step's
        figures, written for the launcher's one-process oracle. At the
        tiny size, on layout "b" with the first impl, a checkpoint written
        by both processes (``sp-ckpt``) restored in both after one more
        step, bitwise, and the launcher's one-process checkpoint
        (``sp-onep``, when there) restored in both, then one step
        (``sp-onep-restored``, ``sp-onep-step``)."""
        from mxnet_tpu_torch.parallel.checkpoint import latest_step
        cfg = SP_SIZES[size]
        devs, owners = distributed.devices(), distributed.device_processes()
        batch = lm_batch(cfg)
        first = cfg["impls"][0]
        for impl in cfg["impls"]:
            for layout in SP_LAYOUTS[size]:
                tr = sp_trainer(par, cfg, sp_mesh(par, layout, devs, owners),
                                impl)
                if tr.device.type == "cuda":
                    card_math()
                res = sp_train(tr, batch, LM_STEPS)
                state = sp_state(tr)
                if size == "tiny" and layout == "b" and impl == first:
                    res["ckpt"] = sp_round_trip(tr, batch, state)
                keep("sp-%s-%s" % (impl, layout), state, res)
                del tr, state
                gc.collect()
        onep = os.path.join(os.environ["MXNET_DISTTEST_OUT"], "sp-onep")
        if size == "tiny" and latest_step(onep) is not None:
            tr = sp_trainer(par, cfg, sp_mesh(par, "b", devs, owners),
                            first, init=False)
            tr.restore_sharded_checkpoint(onep)
            state = sp_state(tr)
            state.update({"rng:%d" % r: g.get_state().numpy()
                          for r, g in tr._generators().items()})
            keep("sp-onep-restored", state, {"t": tr._t})
            tr.step(batch)
            keep("sp-onep-step", sp_state(tr), {"t": tr._t})
            del tr
        print("OK sp rank=%d" % rank, flush=True)

    def sp_round_trip(tr, batch, state):
        """save_sharded_checkpoint of the SP trainer from every process,
        one more step, then restore_sharded_checkpoint in every process:
        the state, the step and this process's generators bitwise the
        saved ones; the seconds of each."""
        prefix = os.path.join(os.environ["MXNET_DISTTEST_OUT"], "sp-ckpt")
        gens = [g.get_state() for g in tr._generators().values()]
        step = tr._t
        t0 = time.perf_counter()
        tr.save_sharded_checkpoint(prefix)()
        save_s = time.perf_counter() - t0
        tr.step(batch)
        for g in tr._generators().values():  # the restore must reset them
            torch.rand(1, generator=g, device=g.device)
        t0 = time.perf_counter()
        tr.restore_sharded_checkpoint(prefix)
        settle(tr)
        load_s = time.perf_counter() - t0
        got = sp_state(tr)
        bad = [k for k in state if not np.array_equal(got[k], state[k])]
        assert not bad and tr._t == step and all(
            torch.equal(g.get_state(), want)
            for g, want in zip(tr._generators().values(), gens)), \
            "sp checkpoint: %d restored arrays differ" % len(bad)
        return {"save_s": save_s, "load_s": load_s, "step": step}

    def check_sharded_io():
        """The JAX package's check_sharded_io: rank 0 packs RAW0 records;
        every process feeds its num_parts/part_index shard through
        ImageRecordIter into the trainer's fit with the device metric
        (summed over the processes); the model converges."""
        from mxnet_tpu_torch import recordio
        from mxnet_tpu_torch.image_io import ImageRecordIter
        hw, k = SHARDIO_HW, SHARDIO_K
        path = os.path.join(os.environ["MXNET_DISTTEST_OUT"],
                            "shardio.rec")
        if rank == 0:
            rs = np.random.RandomState(0)
            w = recordio.MXRecordIO(path, "w")
            quad = [(0, 0), (0, 6), (6, 0), (6, 6)]
            for i in range(SHARDIO_N):
                lab = i % k
                img = np.clip(rs.randn(hw, hw, 3) * 2 + 20, 0, 255)
                r, c = quad[lab]
                img[r:r + 6, c:c + 6] += 120  # label = bright quadrant
                w.write(recordio.pack_img(
                    (0, float(lab), i, 0),
                    np.clip(img, 0, 255).astype(np.uint8), img_fmt=".raw"))
            w.close()
        distributed.barrier("shardio_written")
        gbatch = 16
        it = ImageRecordIter(path, (3, hw, hw), batch_size=gbatch // n,
                             shuffle=True, seed=7, num_parts=n,
                             part_index=rank, preprocess_threads=1)
        data = mx.symbol.Variable("data")
        fl = mx.symbol.Flatten(data=data)
        fc = mx.symbol.FullyConnected(data=fl, name="fc", num_hidden=k)
        sym = mx.symbol.SoftmaxOutput(data=fc, name="softmax")
        tr = par.ParallelTrainer(
            sym, {"data": (gbatch, 3, hw, hw), "softmax_label": (gbatch,)},
            optimizer="sgd", mesh=par.build_mesh({"dp": -1}),
            optimizer_params={"learning_rate": 1e-5, "momentum": 0.9})
        prng = np.random.RandomState(5)
        tr.init_params({  # raw-pixel-scale features: small explicit init
            "fc_weight": (prng.uniform(-1, 1, (k, 3 * hw * hw)) * 1e-4)
            .astype(np.float32),
            "fc_bias": np.zeros((k,), np.float32)})
        t0 = time.perf_counter()
        tr.fit(it, num_epoch=30, device_metric=True)
        name, acc = tr.last_train_metric
        with open(_out("shardio", rank) + ".json", "w") as f:
            json.dump({"acc": acc, "fit_s": time.perf_counter() - t0,
                       "steps": tele.counter("train.steps").value}, f)
        assert acc > 0.85, "sharded-IO fit failed to converge: %s=%f" \
            % (name, acc)
        print("OK shardio rank=%d ioacc=%.3f" % (rank, acc), flush=True)

    checks = {"kvstore": check_kvstore, "intdtype": check_int_dtype,
              "rngupd": check_rng_updater, "async": check_async,
              "fit": check_fit, "afit": check_fit_async,
              "resnet_sync": check_resnet_sync,
              "mlp_async": check_mlp_async,
              "card_routes": check_card_routes,
              "trainer": check_trainer, "shardio": check_sharded_io,
              "lm_dp": check_lm_dp, "bn_global": check_bn_global,
              "ckpt": check_ckpt, "pipe": check_pipe, "sp": check_sp}
    sel = os.environ.get("MXNET_DISTTEST_CHECKS", "")
    for name in [c for c in sel.split(",") if c] or list(checks)[:6]:
        tic = time.time()
        kvs.ROUTES.clear()  # each check records its own collectives
        checks[name]()
        print("TIMING %s rank=%d %.1fs" % (name, rank, time.time() - tic),
              flush=True)
    distributed.barrier("done")
    print("OK all rank=%d" % rank, flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
