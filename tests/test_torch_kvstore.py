"""The port's local KVStore and the executor manager's slicing against the
JAX package's: the cases of ``tests/test_kvstore.py`` (but the server
commands), ``_split_input_slice`` over a grid of batch sizes and work
loads, and the distributed stores in one process. On the CPU; contexts
``cpu(i)`` stand for devices, as in the JAX tests.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import executor_manager as jax_em

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor_manager as em
from mxnet_tpu_torch.base import MXNetError

SHAPE = (4, 4)
KEYS = [5, 7, 11]


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _init_kv(pkg, kind="local"):
    kv = pkg.kv.create(kind)
    kv.init(3, pkg.nd.zeros(SHAPE))
    kv.init(KEYS, [pkg.nd.zeros(SHAPE)] * len(KEYS))
    return kv


def _all(arrs, value):
    for a in arrs:
        np.testing.assert_array_equal(a.asnumpy(), np.full(SHAPE, value))


@pytest.mark.parametrize("kind", ["local", "device", "local_update_cpu",
                                  "local_allreduce_cpu",
                                  "local_allreduce_device"])
def test_single_and_list_pairs(kind):
    kv = _init_kv(mx, kind)
    assert kv.type == kind
    kv.push(3, mx.nd.ones(SHAPE))
    val = mx.nd.empty(SHAPE)
    kv.pull(3, out=val)
    _all([val], 1)
    kv.push(KEYS, [mx.nd.ones(SHAPE) * 4] * len(KEYS))
    vals = [mx.nd.empty(SHAPE) for _ in KEYS]
    kv.pull(KEYS, out=vals)
    _all(vals, 4)
    with pytest.raises(MXNetError, match="already"):
        kv.init(3, mx.nd.zeros(SHAPE))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push(99, mx.nd.zeros(SHAPE))


def test_init_copies_the_value():
    kv = mx.kv.create()
    src = mx.nd.ones(SHAPE) * 4
    kv.init(3, src)
    src[:] = 0
    a = mx.nd.zeros(SHAPE)
    kv.pull(3, out=a)
    _all([a], 4)


def _aggregate(pkg, updater=None, pushes=1):
    kv = _init_kv(pkg)
    if updater is not None:
        kv._set_updater(updater)
    devs = [pkg.Context("cpu", i) for i in range(4)]
    vals = [pkg.nd.ones(SHAPE, d) * (d.device_id + 1) for d in devs]
    kv.push(3, vals)
    kv.pull(3, out=vals)
    out = [v.asnumpy() for v in vals]
    lists = [[pkg.nd.ones(SHAPE, d) * 2.0 for d in devs]] * len(KEYS)
    for _ in range(pushes):
        kv.push(KEYS, lists)
    kv.pull(KEYS, out=lists)
    return out, [[v.asnumpy() for v in vv] for vv in lists], \
        [v.context for v in vals]


def _add_updater(key, recv, local):
    local += recv


@pytest.mark.parametrize("updater,pushes", [(None, 1),
                                            (_add_updater, 4)])
def test_aggregator_and_updater_match_jax(updater, pushes):
    """tests/test_kvstore.py::test_aggregator and ::test_updater: the
    copies of a key are summed; an updater accumulates every push."""
    got = _aggregate(mx, updater, pushes)
    want = _aggregate(jmx, updater, pushes)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0][0], np.full(SHAPE, 10.0))
    np.testing.assert_array_equal(np.array(got[1]), np.array(want[1]))
    assert got[1][0][0][0, 0] == 8.0 * pushes
    assert got[2] == [mx.cpu(i) for i in range(4)]


def test_set_optimizer_updates_the_stored_value():
    results = []
    for pkg in (mx, jmx):
        kv = pkg.kv.create("local")
        w0 = np.arange(16, dtype=np.float32).reshape(SHAPE)
        kv.init(0, pkg.nd.array(w0))
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=0.01))
        for step in range(3):
            kv.push(0, [pkg.nd.ones(SHAPE) * (step + 1),
                        pkg.nd.ones(SHAPE, pkg.cpu(1))])
        out = pkg.nd.zeros(SHAPE)
        kv.pull(0, out=out)
        results.append(out.asnumpy())
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)


def test_roles_and_the_distributed_store():
    """Roles of one process, and every dist store in one process is the
    local store: the same values as the JAX package's ``dist_sync`` in
    one process, a no-op server command, the same errors."""
    kv = mx.kv.create("local")
    assert (kv.rank, kv.num_workers) == (0, 1)
    kv.barrier()
    for kind in ("dist", "dist_sync", "dist_async"):
        got, want = (_init_kv(pkg, kind) for pkg in (mx, jmx))
        assert (got.rank, got.num_workers, got.type) == (0, 1, kind)
        got.barrier()
        for kvs, pkg in ((got, mx), (want, jmx)):
            kvs.push(3, [pkg.nd.ones(SHAPE) * v for v in (1, 2, 4)])
            kvs._set_updater(_upd_double)
            kvs.push(KEYS, [pkg.nd.ones(SHAPE) * 3] * len(KEYS))
        for k in [3] + KEYS:
            a, b = mx.nd.zeros(SHAPE), jmx.nd.zeros(SHAPE)
            got.pull(k, a)
            want.pull(k, b)
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        assert got.send_command_to_servers(0, b"") is None
        got.close()
        want.close()
    with pytest.raises(MXNetError, match="unknown"):
        mx.kv.create("nope")
    with pytest.raises(TypeError):
        mx.kv.create(3)


def _upd_double(key, recv, stored):
    stored += 2 * recv


GRID = [(b, w) for b in (1, 2, 3, 7, 8, 32, 100, 129)
        for w in ([1], [1, 1], [1, 2], [3, 1, 1], [1, 1, 1, 1], [2, 5, 3],
                  [0.5, 0.25, 0.25], [1] * 8)]


@pytest.mark.parametrize("batch,work", GRID,
                         ids=["%d-%s" % (b, "_".join(map(str, w)))
                              for b, w in GRID])
def test_split_input_slice_matches_jax(batch, work):
    try:
        want = jax_em._split_input_slice(batch, work)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            em._split_input_slice(batch, work)
        return
    assert em._split_input_slice(batch, work) == want


def test_check_arguments_rejects_duplicates():
    a = mx.sym.Variable("a")
    dup = mx.sym.FullyConnected(a, num_hidden=2, name="f") + \
        mx.sym.FullyConnected(a, num_hidden=2, name="f")
    with pytest.raises(ValueError, match="duplicated"):
        em._check_arguments(dup)
    em._check_arguments(mx.sym.FullyConnected(a, num_hidden=2, name="g"))
