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
each collective handed gloo) put both ranks on ``gpu(0)``. Importing this module does nothing; the work is
in :func:`main`.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# the global batch of the fit checks and the per-rank split: rank r gets
# the rows that context r of a [ctx] * n run gets (executor_manager splits
# each batch into n contiguous parts)
FIT_SAMPLES, FIT_D, FIT_K, FIT_B = 400, 16, 4, 100
RESNET_HW, RESNET_CLASSES, RESNET_GB, RESNET_BATCHES = 224, 1000, 64, 4
RESNET_LR, RESNET_EPOCHS = 0.01, 2
MLP_DIMS = (784, 128, 64, 10)        # train_mnist.py's MLP
MLP_SAMPLES, MLP_B, MLP_EPOCHS = 2000, 100, 6


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

    checks = {"kvstore": check_kvstore, "intdtype": check_int_dtype,
              "rngupd": check_rng_updater, "async": check_async,
              "fit": check_fit, "afit": check_fit_async,
              "resnet_sync": check_resnet_sync,
              "mlp_async": check_mlp_async,
              "card_routes": check_card_routes}
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
