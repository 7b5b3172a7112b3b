"""The port's FeedForward against the JAX package's, on the CPU.

``tests/test_train.py``'s MLP on the legacy loop (Executor, KVStore and
the optimizer's updater) at one and at two contexts; one epoch from the
same initial parameters against JAX's ``FeedForward`` (parameter deltas
by per-tensor norm at 2e-2: the MLP has a ReLU; ``predict`` at 1e-5);
the fused loop (``MXNET_FUSED_FIT=1``) against ``ParallelTrainer.step``
on the same batches, bitwise, and over two contexts (a dp=2 mesh)
against one;
``fit(checkpoint_prefix=)`` crash and resume, bitwise within the port, on
both loops; a JAX-saved checkpoint through ``FeedForward.load``; and
``as_serving_engine`` against ``Decoder.generate``.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import get_transformer_lm as jax_lm

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.parallel import Decoder, ParallelTrainer

NORM_REL = 2e-2


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _problem(n=2000, d=20, k=5, seed=7):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rs.randn(d, k), axis=1).astype(np.float32)
    return X, y


def _mlp(pkg, num_hidden=64, k=5):
    s = pkg.sym
    data = s.Variable("data")
    fc1 = s.FullyConnected(data=data, name="fc1", num_hidden=num_hidden)
    act1 = s.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = s.FullyConnected(data=act1, name="fc2", num_hidden=k)
    return s.SoftmaxOutput(data=fc2, name="softmax")


def _init(sym, shapes, seed, scale=0.1):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-scale, scale, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


@pytest.mark.parametrize("ctx", ["one", "two"])
def test_mlp_converges_on_the_legacy_loop(ctx):
    """tests/test_train.py::test_mlp_convergence and
    ::test_mlp_multi_device_data_parallel (two host contexts: the batch
    sliced over two executors, the gradients summed by the kvstore)."""
    X, y = _problem()
    contexts = mx.cpu() if ctx == "one" else [mx.cpu(0), mx.cpu(1)]
    np.random.seed(0)
    model = mx.model.FeedForward(_mlp(mx), ctx=contexts, num_epoch=6,
                                 learning_rate=0.1, momentum=0.9, wd=1e-4)
    model.fit(X, y, kvstore="local")
    acc = model.score(mx.io.NDArrayIter(X, y, batch_size=100))
    assert acc > 0.95, acc
    pred = model.predict(X)
    assert pred.shape == (2000, 5)
    assert abs((np.argmax(pred, axis=1) == y).mean() - acc) < 0.02
    assert all(v.context == mx.cpu() for v in model.arg_params.values())


@pytest.mark.parametrize("ctx", [1, 2])
def test_one_epoch_matches_jax_feedforward(ctx):
    X, y = _problem(n=600)
    shapes = {"data": (100, 20), "softmax_label": (100,)}
    init = _init(_mlp(mx), shapes, seed=11)
    trained = []
    for pkg in (mx, jmx):
        contexts = [pkg.cpu(i) for i in range(ctx)]
        model = pkg.model.FeedForward(
            _mlp(pkg), ctx=contexts, num_epoch=1, numpy_batch_size=100,
            arg_params={n: pkg.nd.array(v) for n, v in init.items()},
            learning_rate=0.1, momentum=0.9, wd=1e-4)
        np.random.seed(3)  # the iterator's shuffle
        model.fit(X, y, kvstore="local")
        trained.append((model, {n: v.asnumpy()
                                for n, v in model.arg_params.items()}))
    (port, got), (jax_, want) = trained
    for n in init:
        delta = want[n] - init[n]
        assert np.abs(delta).sum() > 0, n
        err = np.linalg.norm((got[n] - init[n]) - delta)
        assert err <= NORM_REL * np.linalg.norm(delta), (n, err)
    np.testing.assert_allclose(port.predict(X[:256]), jax_.predict(X[:256]),
                               rtol=1e-5, atol=1e-5)


def test_fused_fit_matches_trainer_step(monkeypatch):
    """tests/test_train.py::test_fit_fused_path_matches_trainer_step: the
    fused loop and ParallelTrainer.step on the same batches give the same
    bits."""
    monkeypatch.setenv("MXNET_FUSED_FIT", "1")
    X, y = _problem(n=256, d=16, k=4)
    batch = 32
    sym = _mlp(mx, num_hidden=32, k=4)
    shapes = {"data": (batch, 16), "softmax_label": (batch,)}
    init = _init(sym, shapes, seed=11)
    model = mx.model.FeedForward(
        sym, ctx=mx.cpu(), num_epoch=2,
        arg_params={n: mx.nd.array(v) for n, v in init.items()},
        learning_rate=0.1, momentum=0.9, wd=1e-4)
    model.fit(mx.io.NDArrayIter(X, y, batch_size=batch, shuffle=False))
    trainer = ParallelTrainer(
        sym, shapes, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                          "wd": 1e-4}, device="cpu")
    trainer.init_params({n: mx.nd.array(v) for n, v in init.items()})
    it = mx.io.NDArrayIter(X, y, batch_size=batch, shuffle=False)
    for _ in range(2):
        it.reset()
        for b in it:
            trainer.step({"data": b.data[0], "softmax_label": b.label[0]})
    want, _ = trainer.get_params()
    for n in want:
        assert torch.equal(model.arg_params[n]._tensor, want[n]), n


def test_fused_fit_over_two_contexts_raises(monkeypatch):
    """The fused loop over several contexts (which raised "later slice"
    before the trainer had meshes): ``[cpu(0), cpu(1)]`` is a dp=2 mesh
    (``_mesh_for_ctx``), and one epoch gives the parameters of the fused
    loop on one context, up to the order of the gradient sum (the
    trainers' tolerance, rtol 2e-4, atol 2e-5)."""
    from mxnet_tpu_torch.model import _mesh_for_ctx
    monkeypatch.setenv("MXNET_FUSED_FIT", "1")
    mesh = _mesh_for_ctx([mx.cpu(0), mx.cpu(1)])
    assert mesh.shape == {"dp": 2}
    X, y = _problem(n=256, d=16, k=4)
    batch = 32
    sym = _mlp(mx, num_hidden=32, k=4)
    init = _init(sym, {"data": (batch, 16), "softmax_label": (batch,)},
                 seed=12)
    got = []
    for ctx in (mx.cpu(), [mx.cpu(0), mx.cpu(1)]):
        model = mx.model.FeedForward(
            sym, ctx=ctx, num_epoch=1,
            arg_params={n: mx.nd.array(v) for n, v in init.items()},
            learning_rate=0.1, momentum=0.9)
        model.fit(mx.io.NDArrayIter(X, y, batch_size=batch, shuffle=False))
        got.append({n: v.asnumpy() for n, v in model.arg_params.items()})
    for n in init:
        assert not np.array_equal(got[0][n], init[n]), n
        np.testing.assert_allclose(got[1][n], got[0][n], rtol=2e-4,
                                   atol=2e-5, err_msg=n)


def test_fused_loop_is_the_default_only_on_a_card(monkeypatch):
    from mxnet_tpu_torch.model import _fused_fit_eligible
    monkeypatch.delenv("MXNET_FUSED_FIT", raising=False)
    sgd = mx.optimizer.create("sgd")
    assert not _fused_fit_eligible([mx.cpu()], None, None, None, None, sgd)
    assert not _fused_fit_eligible([mx.gpu(0), mx.gpu(0)], None, None,
                                   None, None, sgd)
    assert _fused_fit_eligible([mx.gpu(0)], None, None, None, None, sgd) \
        == torch.cuda.is_available()
    assert not _fused_fit_eligible([mx.gpu(0)], None, mx.Monitor(1), None,
                                   None, sgd)
    monkeypatch.setenv("MXNET_FUSED_FIT", "0")
    assert not _fused_fit_eligible([mx.gpu(0)], None, None, None, None, sgd)


def _resume_run(tmp_path, fused, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_FIT", "1" if fused else "0")
    X, y = _problem(n=320, d=16, k=4)
    sym = _mlp(mx, num_hidden=16, k=4)
    init = _init(sym, {"data": (32, 16), "softmax_label": (32,)}, seed=5)

    def model(epochs):
        return mx.model.FeedForward(
            sym, ctx=mx.cpu(), num_epoch=epochs,
            arg_params={n: mx.nd.array(v) for n, v in init.items()},
            learning_rate=0.1, momentum=0.9, wd=1e-4)

    def data():
        return mx.io.NDArrayIter(X, y, batch_size=32, shuffle=False)

    straight = model(3).fit(data())
    prefix = str(tmp_path / ("fused" if fused else "legacy"))

    def crash(epoch, *_):
        if epoch == 1:
            raise RuntimeError("killed")

    with pytest.raises(RuntimeError, match="killed"):
        model(3).fit(data(), checkpoint_prefix=prefix,
                     epoch_end_callback=crash)
    assert mx.model.latest_checkpoint(prefix) == 1
    resumed = model(3)
    resumed.fit(data(), checkpoint_prefix=prefix)
    assert resumed.begin_epoch == 1
    assert mx.model.latest_checkpoint(prefix) == 3
    blob = mx.model.load_optimizer_states(prefix, 3)
    assert blob["format"] == ("fused" if fused else "updater")
    for n, v in straight.arg_params.items():
        assert torch.equal(resumed.arg_params[n]._tensor, v._tensor), n


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_checkpoint_crash_and_resume_is_bitwise(tmp_path, fused,
                                                monkeypatch):
    _resume_run(tmp_path, fused, monkeypatch)


def test_jax_checkpoint_loads_and_predicts_as_jax(tmp_path):
    X, y = _problem(n=300)
    prefix = str(tmp_path / "j")
    jmodel = jmx.model.FeedForward(_mlp(jmx), ctx=jmx.cpu(), num_epoch=2,
                                   learning_rate=0.1, momentum=0.9)
    jmodel.fit(X, y)
    jmodel.save(prefix)
    loaded = mx.model.FeedForward.load(prefix, 2, ctx=mx.cpu())
    assert loaded.begin_epoch == 2
    assert all(isinstance(v, mx.nd.NDArray)
               for v in loaded.arg_params.values())
    np.testing.assert_allclose(loaded.predict(X), jmodel.predict(X),
                               rtol=1e-5, atol=1e-5)
    it = mx.io.NDArrayIter(X, y, batch_size=100)
    assert abs(loaded.score(it) - jmodel.score(
        jmx.io.NDArrayIter(X, y, batch_size=100))) < 1e-6
    # and back: the port's save loads in the JAX package
    loaded.save(str(tmp_path / "t"), 2)
    back = jmx.model.FeedForward.load(str(tmp_path / "t"), 2)
    for n, v in jmodel.arg_params.items():
        np.testing.assert_array_equal(back.arg_params[n].asnumpy(),
                                      v.asnumpy())


def test_create_callbacks_and_eval_data(tmp_path):
    X, y = _problem(n=400)
    prefix = str(tmp_path / "cb")
    seen = []
    model = mx.model.FeedForward.create(
        _mlp(mx), X, y, ctx=mx.cpu(), num_epoch=2, learning_rate=0.1,
        eval_data=(X[:256], y[:256]),
        epoch_end_callback=mx.callback.do_checkpoint(prefix),
        batch_end_callback=lambda p: seen.append((p.epoch, p.nbatch)))
    assert seen[0] == (0, 1) and seen[-1][0] == 1
    assert mx.model.latest_checkpoint(prefix) == 2
    _, args, _ = mx.model.load_checkpoint(prefix, 2)
    for n, v in model.arg_params.items():
        np.testing.assert_array_equal(args[n].asnumpy(), v.asnumpy())
    out, data, label = model.predict(mx.io.NDArrayIter(X[:130], y[:130],
                                                       batch_size=64),
                                     return_data=True)
    assert out.shape == (130, 5) and data.shape == (130, 20)
    np.testing.assert_array_equal(label, y[:130])
    state = model.__getstate__()
    assert state["_pred_exec"] is None


def test_as_serving_engine_matches_decoder_generate(tmp_path):
    sym = get_transformer_lm(23, num_layers=1, embed_dim=16, num_heads=2)
    shapes = {"data": (1, 16), "softmax_label": (1, 16)}
    params = _init(sym, shapes, seed=2, scale=0.5)
    prefix = str(tmp_path / "lm")
    mx.model.save_checkpoint(prefix, 1, sym, params, {})
    model = mx.model.FeedForward.load(prefix, 1, ctx=mx.cpu())
    engine = model.as_serving_engine(16, slots=2, prefill_buckets=(8, 16),
                                     prefix_cache_mb=0, prefill_chunk=0)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    handles = [engine.submit(p, max_tokens=6) for p in prompts]
    while not all(h.done for h in handles):
        engine.step()
    dec = Decoder(sym, params, 16, device="cpu")
    for p, h in zip(prompts, handles):
        want = dec.generate(np.array([p]), 6).numpy()[0, len(p):]
        np.testing.assert_array_equal(h.result(), want)
    engine.close()
    with pytest.raises(MXNetError, match="trained model"):
        mx.model.FeedForward(sym, ctx=mx.cpu()).as_serving_engine(16)


def test_jax_lm_checkpoint_serves_on_the_port(tmp_path):
    jsym = jax_lm(23, num_layers=1, embed_dim=16, num_heads=2)
    params = _init(jsym, {"data": (1, 16), "softmax_label": (1, 16)},
                   seed=4, scale=0.5)
    prefix = str(tmp_path / "jlm")
    jmx.model.save_checkpoint(prefix, 0, jsym,
                              {k: jmx.nd.array(v) for k, v in params.items()},
                              {})
    model = mx.model.FeedForward.load(prefix, 0, ctx=mx.cpu())
    assert os.path.exists(prefix + "-0000.params")
    dec = Decoder(model.symbol, model.arg_params, 16, device="cpu")
    want = Decoder(get_transformer_lm(23, num_layers=1, embed_dim=16,
                                      num_heads=2), params, 16,
                   device="cpu").generate(np.array([[3, 1, 4]]), 4)
    assert torch.equal(dec.generate(np.array([[3, 1, 4]]), 4), want)
