"""The port's distributed store across real processes on the CPU: two
workers launched by the unchanged ``tools/launch.py --local-devices 1``
join one gloo process group and run the checks of
``mxnet_tpu_torch.testing.dist_worker`` (the counterparts of
``tests/dist_worker.py``'s ``kvstore``, ``intdtype``, ``rngupd``,
``async``, ``fit`` and ``afit``).

Oracles: the exact BSP values inside the workers (n(n+1)/2 on a small key
and on a big, reduce-scattered one; nrepeat * n(n+1)/2 through the async
servers); the JAX package's ``local`` store fed both ranks' values as two
device copies; both ranks' RNG-drawing updates bitwise equal; and for
``fit``, the JAX package's ``FeedForward`` over two CPU contexts on the
same data and initial weights (rtol 1e-4, atol 1e-5: a different order of
f32 sums than the port's).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx

from mxnet_tpu_torch.testing import dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = ("kvstore", "intdtype", "rngupd", "async", "fit", "afit",
          "mlp_async", "card_routes")


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    env = dict(os.environ)
    env.update(MXNET_DISTTEST_CHECKS=",".join(CHECKS),
               MXNET_DISTTEST_OUT=str(out),
               # the (1200,)-element arrays take the big-array paths
               MXNET_KVSTORE_BIGARRAY_BOUND="500",
               # every parameter-server frame carries an HMAC tag
               MXNET_KVSTORE_SECRET="disttest-secret",
               # the card checks (the async MLP, the card routes),
               # rehearsed on the host
               MXNET_DISTTEST_CTX="cpu",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    for k in ("MXNET_KVSTORE_PORT_BASE", "MXNET_TPU_COORDINATOR"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         "2", "--local-devices", "1", "--", sys.executable, "-m",
         "mxnet_tpu_torch.testing.dist_worker"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-4000:]
    return out, text


@pytest.mark.parametrize("check", CHECKS + ("all",))
def test_every_rank_passes(launched, check):
    _, text = launched
    assert text.count("OK %s rank=" % check) == 2, text[-3000:]


def test_two_copies_a_rank_sum_as_jax_local_store(launched):
    """Each rank pushes two device copies of key 7; the dist sum equals
    the JAX package's local store fed all four copies."""
    out, _ = launched
    kv = jmx.kv.create("local")
    kv.init(7, jmx.nd.zeros((4, 3)))
    vals = [jmx.nd.ones((4, 3)) * c * (r + 1) for r in range(2)
            for c in (1, 10)]
    kv.push(7, vals)
    want = jmx.nd.zeros((4, 3))
    kv.pull(7, want)
    for r in range(2):
        got = np.load(os.path.join(out, "kvstore-%d.npz" % r))["key7"]
        np.testing.assert_array_equal(got, want.asnumpy())


def test_rng_updater_ranks_bitwise_equal(launched):
    out, _ = launched
    a, b = (np.load(os.path.join(out, "rngupd-%d.npz" % r))["value"]
            for r in range(2))
    np.testing.assert_array_equal(a, b)
    # the noise was drawn: not the plain sum of three pushes
    assert np.abs(a - 9.0).max() > 0.1


def test_fit_ranks_equal_and_match_jax_two_contexts(launched):
    out, _ = launched
    got = [dict(np.load(os.path.join(out, "fit-%d.npz" % r)))
           for r in range(2)]
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k])
    x, y = W.fit_data()
    sym = W.mlp_symbol(jmx, (W.FIT_D, 32, W.FIT_K))
    params = W.mlp_params(sym, (W.FIT_B, W.FIT_D), 5)
    model = jmx.model.FeedForward(
        sym, ctx=[jmx.cpu(0), jmx.cpu(1)], num_epoch=5, learning_rate=0.2,
        momentum=0.9,
        arg_params={k: jmx.nd.array(v) for k, v in params.items()})
    model.fit(jmx.io.NDArrayIter(x, y, batch_size=W.FIT_B),
              kvstore="local")
    for k, v in model.arg_params.items():
        np.testing.assert_allclose(got[0][k], v.asnumpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_async_mlp_counts_and_converges(launched):
    """train_mnist's MLP over the async servers: every step pushes and
    pulls each key once (plus the pulls after ``init``), fc1_weight is
    range-partitioned over both servers, and both ranks converge."""
    out, _ = launched
    for r in range(2):
        with open(os.path.join(out, "mlp_async-%d.json" % r)) as f:
            a = json.load(f)
        assert a["acc"] > 0.85
        assert a["pushes"] == a["steps"] * a["keys"]
        assert a["pulls"] == (a["steps"] + 1) * a["keys"]
        assert a["parts_fc1"] == 2
        assert a["push_bytes"] > 0 and a["pull_bytes"] > 0


def test_card_routes_hand_gloo_the_values_where_they_live(launched):
    """The card-route check rehearsed on the host: exact sums (asserted in
    the workers) of replicated and reduce-scattered keys, f32 and int32,
    and every collective handed gloo the host tensors it was given; on
    the card the same check records "cuda"."""
    out, _ = launched
    for r in range(2):
        with open(os.path.join(out, "card_routes-%d.json" % r)) as f:
            routes = json.load(f)
        assert routes == {"broadcast": "host", "all_reduce": "cpu",
                          "reduce_scatter": "cpu", "all_gather": "cpu"}


def test_rank_rows_are_the_contexts_slices():
    x = np.arange(12)
    assert W.rank_rows(x, 0, 2, 4).tolist() == [0, 1, 4, 5, 8, 9]
    assert W.rank_rows(x, 1, 2, 4).tolist() == [2, 3, 6, 7, 10, 11]
