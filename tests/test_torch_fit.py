"""LM training as users run it, the port against the JAX package, on the
CPU: ``SoftmaxCELoss`` and ``loss_layout="ce"``, ``NDArrayIter``,
``ParallelTrainer.fit`` (metrics on the host and on the device,
callbacks, eval data), ``prefetch``, and checkpoints: whole
(``.params``/``.states``) and sharded, within each package and across
the two, with crash-resume.

Tolerances (f32 on both sides, sums in other orders): the loss head's
values and gradients at rtol 1e-5, atol 1e-6; trained parameters at rtol
2e-4, atol 2e-5 (``tests/test_parallel.py``'s trainer tolerance); metric
values within 1e-5 of each other; what the port does twice from the same
state (a resume, a prefetched run), bitwise. 1-layer LMs and small MLPs,
module-scoped where shared.
"""
import logging
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import io as jax_io
from mxnet_tpu import lr_scheduler as jax_lrs
from mxnet_tpu import metric as jax_metric
from mxnet_tpu import model as jax_model
from mxnet_tpu import parallel as jax_par
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.ops import registry as jax_reg
from mxnet_tpu.parallel import checkpoint as jax_ckpt

import mxnet_tpu_torch.symbol as S
from mxnet_tpu_torch import callback as T_cb
from mxnet_tpu_torch import io as T_io
from mxnet_tpu_torch import lr_scheduler as T_lrs
from mxnet_tpu_torch import metric as T_metric
from mxnet_tpu_torch import model as T_model
from mxnet_tpu_torch import telemetry as T_tele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.ops import registry as reg
from mxnet_tpu_torch.parallel import ParallelTrainer, integer_semantic_inputs
from mxnet_tpu_torch.parallel import checkpoint as T_ckpt

TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)

VOCAB, B, T, NBATCH = 40, 2, 16, 3
LM = dict(num_layers=1, embed_dim=16, num_heads=2, loss_layout="ce")
# the GPT-3 recipe at toy size: AdamW (beta2 0.95, wd 0.1), warmup then
# cosine decay to a tenth, global-norm clip 1.0
ADAMW = dict(learning_rate=6e-3, beta1=0.9, beta2=0.95, epsilon=1e-8,
             wd=0.1, rescale_grad=1.0 / (B * T))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# -- SoftmaxCELoss and loss_layout="ce" ------------------------------------

CE_CASES = [  # (use_ignore, grad_scale, a label out of range)
    (False, 1.0, False),
    (True, 1.0, False),
    (False, 0.5, True),
    (True, 2.0, True),
]


@pytest.mark.parametrize("use_ignore,scale,out_of_range", CE_CASES)
def test_softmax_ce_loss_matches_jax(use_ignore, scale, out_of_range):
    """The per-row loss (labels clipped) and the data gradient (softmax -
    onehot) * grad_scale, masked at ignore_label, whatever the head
    gradient (here random); the label gets none."""
    rng = np.random.RandomState(int(use_ignore) + 2 * int(out_of_range))
    data = (3 * rng.randn(10, 7)).astype(np.float32)
    label = rng.randint(0, 7, (10,)).astype(np.float32)
    label[1] = 2.0  # the ignored class appears
    if out_of_range:
        label[3] = 7.0
    head = rng.randn(10).astype(np.float32)
    kw = dict(use_ignore=use_ignore, grad_scale=scale, ignore_label=2)
    jspec = jax_reg.get("SoftmaxCELoss")
    jp = jspec.parse_params(kw)
    out_j, vjp = jax.vjp(
        lambda d: jspec.forward(jp, [d, jnp.asarray(label)], [], True,
                                None)[0][0], jnp.asarray(data))
    (grad_j,) = vjp(jnp.asarray(head))
    spec = reg.get("SoftmaxCELoss")
    d, lab = _t(data, True), _t(label, True)
    out_t = spec.forward(spec.parse_params(kw), [d, lab], [], True,
                         None)[0][0]
    assert out_t.dtype == torch.float32 and out_t.shape == (10,)
    out_t.backward(_t(head))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(grad_j), **TOL)
    assert lab.grad is None


def test_softmax_ce_loss_bf16_logits_give_f32_loss():
    rng = np.random.RandomState(5)
    data = torch.from_numpy(rng.randn(6, 11).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 11, (6,)).astype(np.int64))
    spec = reg.get("SoftmaxCELoss")
    p = spec.parse_params({})
    d16 = data.to(torch.bfloat16).requires_grad_(True)
    out = spec.forward(p, [d16, label], [], True, None)[0][0]
    assert out.dtype == torch.float32
    want = torch.nn.functional.cross_entropy(d16.detach().float(), label,
                                             reduction="none")
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), **TOL)
    out.sum().backward()
    assert d16.grad.dtype == torch.bfloat16


def test_ce_layout_builds_the_jax_symbol():
    kw = dict(num_layers=2, embed_dim=16, num_heads=2, loss_layout="ce")
    with JaxNames():
        js = jax_lm(VOCAB, **kw)
    with TorchNames():
        ts = get_transformer_lm(VOCAB, **kw)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    assert ts.list_arguments() == js.list_arguments()
    targ, tout, _ = ts.infer_shape(**shapes)
    jarg, jout, _ = js.infer_shape(**shapes)
    assert targ == [tuple(s) for s in jarg]
    assert tout == [tuple(s) for s in jout] == [(B * T,)]
    assert integer_semantic_inputs(ts) == {"data", "softmax_label"}
    with pytest.raises(ValueError, match="'ce'"):
        get_transformer_lm(VOCAB, loss_layout="bogus")


def _lm_setup(lm_kw=LM, seed=0, nbatch=NBATCH):
    jsym = jax_lm(VOCAB, **lm_kw)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    arg_shapes, _, _ = jsym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    init = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(jsym.list_arguments(), arg_shapes)
            if n not in shapes}
    # an order-1 Markov chain: each token has 2 successors
    succ = rng.randint(0, VOCAB, (VOCAB, 2))
    seq = np.empty(nbatch * B * T + 1, np.int64)
    seq[0] = 0
    for i in range(1, seq.size):
        seq[i] = succ[seq[i - 1], rng.randint(2)]
    data = seq[:-1].reshape(nbatch * B, T).astype(np.float32)
    label = seq[1:].reshape(nbatch * B, T).astype(np.float32)
    return jsym, shapes, init, data, label


def _port_trainer(lm_kw=LM, optimizer="adamw", params=None, seed=0,
                  **kw):
    _, shapes, init, _, _ = _lm_setup(lm_kw)
    tr = ParallelTrainer(get_transformer_lm(VOCAB, **lm_kw), shapes,
                         optimizer=optimizer,
                         optimizer_params=dict(params or ADAMW),
                         device="cpu", seed=seed, **kw)
    return tr.init_params(init)


def test_ce_and_flat_layouts_take_the_same_step():
    """SoftmaxCELoss's gradient is SoftmaxOutput's: one f32 AdamW step
    through "ce" moves every parameter as one through "flat"."""
    _, _, _, data, label = _lm_setup()
    batch = {"data": data[:B], "softmax_label": label[:B]}
    deltas = []
    for layout in ("ce", "flat"):
        tr = _port_trainer(dict(LM, loss_layout=layout))
        before = {n: v.clone() for n, v in tr.params.items()}
        out = tr.step(batch)[0]
        assert out.shape == ((B * T,) if layout == "ce" else (B * T, VOCAB))
        deltas.append({n: tr.params[n] - before[n] for n in before})
    for n in deltas[0]:
        np.testing.assert_allclose(deltas[0][n].numpy(),
                                   deltas[1][n].numpy(), err_msg=n,
                                   rtol=1e-6, atol=1e-9)


# -- NDArrayIter -----------------------------------------------------------

ITER_CASES = [("pad", False), ("discard", False), ("roll_over", False),
              ("pad", True)]


@pytest.mark.parametrize("handle,shuffle", ITER_CASES)
def test_ndarray_iter_matches_jax(handle, shuffle):
    """Batches, pads, provide_data/label and roll_over across epochs equal
    the JAX package's on the same arrays (shuffle: numpy's global
    generator, seeded alike)."""
    rng = np.random.RandomState(0)
    x = rng.randn(10, 3).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    np.random.seed(7)
    ti = T_io.NDArrayIter(torch.from_numpy(x), y, batch_size=4,
                          shuffle=shuffle, last_batch_handle=handle)
    np.random.seed(7)
    ji = jax_io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                            last_batch_handle=handle)
    assert ti.provide_data == ji.provide_data
    assert ti.provide_label == ji.provide_label
    for _ in range(3):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in ti]
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in ji]
        assert len(got) == len(want)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp
        ti.reset()
        ji.reset()


def test_ndarray_iter_dict_inputs_and_copies():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    it = T_io.NDArrayIter({"a": x, "b": x * 2}, batch_size=3)
    assert [n for n, _ in it.provide_data] == ["a", "b"]
    assert it.provide_label == []
    b = next(it)
    b.data[0][:] = -1  # a copy: the iterator's rows stay as they were
    it.reset()
    np.testing.assert_array_equal(next(it).data[0].asnumpy(), x[:3])
    with pytest.raises(ValueError, match="batch_size"):
        T_io.NDArrayIter(x, batch_size=7)


# -- fit ---------------------------------------------------------------------

def _mlp(nclass=3, S_=S):
    data = S_.Variable("data")
    fc = S_.FullyConnected(data=data, name="fc", num_hidden=nclass)
    return S_.SoftmaxOutput(data=fc, name="softmax")


def _linear_problem(n=256, nclass=3, seed=42):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 16).astype(np.float32)
    w_true = rng.randn(16, nclass).astype(np.float32)
    return x, np.argmax(x @ w_true, axis=1).astype(np.float32)


def _mlp_trainer(nclass=3, lr=0.5):
    tr = ParallelTrainer(_mlp(nclass), {"data": (64, 16),
                                        "softmax_label": (64,)},
                         optimizer="sgd",
                         optimizer_params={"learning_rate": lr},
                         device="cpu", seed=1)
    prng = np.random.RandomState(5)
    return tr.init_params({"fc_weight": prng.uniform(
        -0.1, 0.1, (nclass, 16)).astype("f"),
        "fc_bias": np.zeros((nclass,), np.float32)})


def test_fit_converges():
    """tests/test_parallel.py:165's oracle: a linear problem to > 0.9."""
    x, y = _linear_problem(512)
    it = T_io.NDArrayIter(x, y, batch_size=64)
    tr = _mlp_trainer()
    tr.fit(it, num_epoch=10)
    it.reset()
    correct = total = 0
    for b in it:
        out = tr.forward({"data": b.data[0], "softmax_label": b.label[0]})
        correct += int((out[0].argmax(1) == b.label[0]._tensor.long()).sum())
        total += b.label[0].shape[0]
    assert correct / total > 0.9
    assert tr.last_train_metric[0] == "accuracy" \
        and tr.last_train_metric[1] > 0.85


@pytest.mark.parametrize("metric", ["acc", "topk", "ce"])
def test_fit_device_metric_equals_host_metric(metric):
    """tests/test_parallel.py:1174 and :1206: the device accumulator
    reports the host metric's value."""
    x, y = _linear_problem(256, nclass=6, seed=7)
    make = {"acc": T_metric.Accuracy,
            "topk": lambda: T_metric.TopKAccuracy(top_k=2),
            "ce": T_metric.CrossEntropy}[metric]
    got = []
    for device_metric in (True, False):
        tr = _mlp_trainer(nclass=6)
        tr.fit(T_io.NDArrayIter(x, y, batch_size=64), num_epoch=2,
               eval_metric=make(), device_metric=device_metric)
        got.append(tr.last_train_metric)
    assert got[0][0] == got[1][0]
    assert abs(got[0][1] - got[1][1]) < 1e-5, got


def test_fit_device_metric_refusals_and_ce_warning(caplog):
    x, y = _linear_problem(64)
    tr = _mlp_trainer()
    with pytest.raises(MXNetError, match="device_metric=True supports"):
        tr.fit(T_io.NDArrayIter(x, y, batch_size=64), eval_metric="mse",
               device_metric=True)
    with pytest.raises(MXNetError, match="top-k accuracy with k=3"):
        tr.fit(T_io.NDArrayIter(x, y, batch_size=64),
               eval_metric=T_metric.TopKAccuracy(3), device_metric=True)
    # a raw-score head (tests/test_parallel.py:1318): rows sum far from 1
    raw = ParallelTrainer(S.FullyConnected(data=S.Variable("data"),
                                           name="fc", num_hidden=3),
                          {"data": (64, 16), "softmax_label": (64,)},
                          optimizer_params={"learning_rate": 0.0},
                          device="cpu")
    raw.init_params({"fc_weight": np.zeros((3, 16), np.float32),
                     "fc_bias": np.full((3,), 5.0, np.float32)})
    with caplog.at_level(logging.WARNING):
        raw.fit(T_io.NDArrayIter(x, y, batch_size=64),
                eval_metric=T_metric.CrossEntropy(), device_metric=True)
    assert any("probability outputs" in r.message for r in caplog.records)


def test_fit_callbacks_eval_data_and_telemetry(tmp_path):
    x, y = _linear_problem(256)
    tr = _mlp_trainer()
    seen, epochs = [], []
    prefix = str(tmp_path / "cb")
    T_tele.reset()
    tr.fit(T_io.NDArrayIter(x, y, batch_size=64),
           eval_data=T_io.NDArrayIter(x[:128], y[:128], batch_size=64),
           num_epoch=2,
           batch_end_callback=[lambda p: seen.append((p.epoch, p.nbatch)),
                               T_cb.Speedometer(64, frequent=2),
                               T_cb.ProgressBar(4),
                               T_cb.log_train_metric(2)],
           epoch_end_callback=[lambda e, s, a, x_: epochs.append(e),
                               T_cb.do_checkpoint(prefix)])
    assert seen == [(e, i) for e in range(2) for i in range(4)]
    assert epochs == [0, 1]
    assert T_model.latest_checkpoint(prefix) == 2
    snap = T_tele.snapshot("train.")["train"]
    assert snap["steps"] == 8
    assert snap["compiles"] == 1
    assert snap["step_ms"]["count"] == 8
    assert snap["h2d_bytes"] == 8 * 64 * 17 * 4
    assert snap["input_wait_ms"]["count"] == 8
    assert snap["device_wait_ms"]["count"] == 8


def test_prefetch_equals_direct_steps():
    """tests/test_parallel.py:640: the prefetched batches are the same
    batches in the same order; the parameters end bitwise equal."""
    rng = np.random.RandomState(0)
    host = [{"data": rng.randn(64, 16).astype(np.float32),
             "softmax_label": rng.randint(0, 3, (64,)).astype(np.float32)}
            for _ in range(5)]
    results = []
    for use_prefetch in (False, True):
        tr = _mlp_trainer()
        if use_prefetch:
            staged = list(tr.prefetch(host, depth=2))
            assert len(staged) == 5
            for b in staged:
                tr.step(b)
        else:
            for b in host:
                tr.step(b)
        results.append(tr._flat.clone())
    assert torch.equal(results[0], results[1])
    assert list(_mlp_trainer().prefetch([])) == []


@pytest.fixture(scope="module")
def lm_fit_runs():
    """The recipe (AdamW, warmup + cosine, clip 1.0, "ce") fitted for 2
    epochs by the JAX trainer and by the port's, from the same weights,
    with the Loss metric on the device."""
    jsym, shapes, init, data, label = _lm_setup()
    sched = dict(max_update=2 * NBATCH, final_lr=6e-4, warmup_steps=2)
    jtr = jax_par.ParallelTrainer(
        jsym, shapes, optimizer="adamw", mesh=jax_par.data_parallel_mesh(1),
        optimizer_params=dict(ADAMW,
                              lr_scheduler=jax_lrs.CosineScheduler(**sched)),
        clip_grad_norm=1.0)
    jtr.init_params({k: mx.nd.array(v) for k, v in init.items()})
    jtr.fit(jax_io.NDArrayIter(data, label, batch_size=B), num_epoch=2,
            eval_metric=jax_metric.Loss(), device_metric=True)
    tr = _port_trainer(params=dict(
        ADAMW, lr_scheduler=T_lrs.CosineScheduler(**sched)),
        clip_grad_norm=1.0)
    losses = []
    tr.fit(T_io.NDArrayIter(data, label, batch_size=B), num_epoch=2,
           eval_metric=T_metric.Loss(), device_metric=True,
           epoch_end_callback=lambda e, s, a, x: losses.append(
               tr.last_train_metric[1]))
    return jtr, tr, losses


def test_fit_lm_recipe_matches_jax(lm_fit_runs):
    jtr, tr, losses = lm_fit_runs
    want, _ = jtr.get_params()
    got, _ = tr.get_params()
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].asnumpy(),
                                   err_msg=n, **PARAM_TOL)
    assert tr.last_train_metric[0] == jtr.last_train_metric[0] == "loss"
    np.testing.assert_allclose(tr.last_train_metric[1],
                               jtr.last_train_metric[1], rtol=1e-5)
    assert losses[1] < losses[0], losses
    assert tr._t == jtr._t == 2 * NBATCH


# -- whole checkpoints ------------------------------------------------------

def _mlp_params(sym, seed=0):
    shapes = {"data": (10, 20), "softmax_label": (10,)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def test_save_checkpoint_cleans_stale_tmp_and_latest_is_anchored(tmp_path):
    """tests/test_train.py:239: a dead writer's ``.params.tmp`` goes; an
    in-flight ``.tmp`` and another prefix's file do not count."""
    sym = _mlp(5)
    arg = _mlp_params(sym)
    prefix = str(tmp_path / "cp")
    stale = prefix + "-0001.params.tmp"
    with open(stale, "wb") as f:
        f.write(b"half-written garbage from a dead writer")
    T_model.save_checkpoint(prefix, 1, sym, arg, {})
    assert not os.path.exists(stale)
    with open(prefix + "-0002.params.tmp", "wb") as f:
        f.write(b"in-flight")
    with open(str(tmp_path / "cp-b-cp-0007.params"), "wb") as f:
        f.write(b"another prefix")
    assert T_model.latest_checkpoint(prefix) == 1
    assert jax_model.latest_checkpoint(prefix) == 1
    _, loaded, _ = T_model.load_checkpoint(prefix, 1)
    for n in arg:
        assert torch.equal(loaded[n]._tensor, arg[n])
    assert T_model.latest_checkpoint(str(tmp_path / "none")) is None


def test_checkpoint_updater_states_round_trip(tmp_path):
    """tests/test_train.py:267: an Adam updater's blob through
    ``save_checkpoint(optimizer_states=)`` and ``load_optimizer_states``
    (structure, update counts), and a fresh updater continues bitwise."""
    from mxnet_tpu_torch import optimizer as T_opt
    sym = _mlp(5)
    arg = _mlp_params(sym)
    updater = T_opt.get_updater(T_opt.create("adam", learning_rate=0.01))
    for _ in range(3):
        for i, (n, w) in enumerate(sorted(arg.items())):
            updater(i, torch.full(w.shape, 0.1), w)
    blob = updater.get_states()
    blob["format"] = "updater"
    prefix = str(tmp_path / "opt")
    T_model.save_checkpoint(prefix, 3, sym, arg, {}, optimizer_states=blob)
    for load in (T_model.load_optimizer_states,
                 jax_model.load_optimizer_states):
        loaded = load(prefix, 3)
        assert loaded["format"] == "updater"
        assert loaded["update_count"] == blob["update_count"]
        for i, st in blob["states"].items():
            assert type(loaded["states"][i]) is type(st)
    up2 = T_opt.get_updater(T_opt.create("adam", learning_rate=0.01))
    up2.set_states(T_model.load_optimizer_states(prefix, 3))
    w1 = {n: v.clone() for n, v in arg.items()}
    for i, (n, w) in enumerate(sorted(arg.items())):
        updater(i, torch.full(w.shape, 0.1), w)
        up2(i, torch.full(w.shape, 0.1), w1[n])
    for n in arg:
        assert torch.equal(w1[n], arg[n]), n


def test_save_checkpoint_removes_stale_states(tmp_path):
    """tests/test_train.py:315: a states-less save removes a ``.states``
    an earlier run left at that epoch, but keeps one this process
    published."""
    sym = _mlp(5)
    arg = _mlp_params(sym)
    prefix = str(tmp_path / "cp")
    stale = prefix + "-0002.states"
    with open(stale, "wb") as f:
        pickle.dump({"format": "updater", "states": {}}, f)
    T_model.save_checkpoint(prefix, 2, sym, arg, {})
    assert not os.path.exists(stale)
    assert T_model.load_optimizer_states(prefix, 2) is None
    T_model.save_checkpoint(prefix, 3, sym, arg, {},
                            optimizer_states={"step": 3})
    T_model.save_checkpoint(prefix, 3, sym, arg, {})
    assert T_model.load_optimizer_states(prefix, 3) == {"step": 3}


def test_do_checkpoint_async_write_equals_sync(tmp_path):
    """tests/test_train.py:117: the async callback's files equal the
    synchronous ones, and the snapshot is taken at the call."""
    sym = _mlp(5)
    arg = _mlp_params(sym)
    sync, asyn = str(tmp_path / "s"), str(tmp_path / "a")
    cb = T_cb.do_checkpoint(asyn, async_write=True)
    for epoch in range(3):
        T_cb.do_checkpoint(sync)(epoch, sym, arg, {})
        cb(epoch, sym, arg, {})
        want = {n: v.clone() for n, v in arg.items()}
        for v in arg.values():
            v.add_(1.0)  # the next "epoch" moves the weights
        cb.finalize()
        _, got, _ = T_model.load_checkpoint(asyn, epoch + 1)
        for n in want:
            assert torch.equal(got[n]._tensor, want[n])
        with open(sync + "-%04d.params" % (epoch + 1), "rb") as f, \
                open(asyn + "-%04d.params" % (epoch + 1), "rb") as g:
            assert f.read() == g.read()


def _fit_with_checkpoints(prefix, epochs=2):
    """The recipe fitted for ``epochs`` epochs, an epoch-end callback
    saving ``.params`` and ``.states`` and a sharded checkpoint."""
    _, _, _, data, label = _lm_setup()
    tr = _port_trainer(params=dict(ADAMW, lr_scheduler=T_lrs.CosineScheduler(
        max_update=2 * NBATCH, final_lr=6e-4, warmup_steps=2)),
        clip_grad_norm=1.0)

    def save(epoch, symbol, arg, aux):
        T_model.save_checkpoint(prefix, epoch + 1, symbol, arg, aux,
                                optimizer_states=tr.get_optimizer_states())
        tr.save_sharded_checkpoint("%s-sharded-%d" % (prefix, epoch + 1))

    tr.fit(T_io.NDArrayIter(data, label, batch_size=B), num_epoch=epochs,
           eval_metric="loss", device_metric=True, epoch_end_callback=save)
    return tr, data, label


def test_fit_resumes_bitwise_from_whole_and_sharded_checkpoints(tmp_path):
    """Crash-resume: a fresh trainer resumes epoch 1 from
    ``latest_checkpoint``'s ``.params`` and ``.states`` (or from the
    sharded checkpoint) and its parameters after the epoch equal the
    uninterrupted run's bitwise."""
    prefix = str(tmp_path / "lm")
    full, data, label = _fit_with_checkpoints(prefix)
    os.remove(prefix + "-0002.params")  # "crashed" before epoch 2's save
    assert T_model.latest_checkpoint(prefix) == 1
    for how in ("whole", "sharded"):
        tr = _port_trainer(params=dict(
            ADAMW, lr_scheduler=T_lrs.CosineScheduler(
                max_update=2 * NBATCH, final_lr=6e-4, warmup_steps=2)),
            clip_grad_norm=1.0, seed=123)
        if how == "whole":
            _, arg, aux = T_model.load_checkpoint(prefix, 1)
            tr.init_params(arg, aux)
            tr.set_optimizer_states(T_model.load_optimizer_states(prefix, 1))
        else:
            assert tr.resume_sharded_checkpoint(prefix + "-sharded-1") \
                == NBATCH
        assert tr._t == NBATCH
        tr.fit(T_io.NDArrayIter(data, label, batch_size=B), num_epoch=1,
               eval_metric="loss", device_metric=True)
        assert torch.equal(tr._flat, full._flat), how
        for a, b in zip(tr._state.buffers(), full._state.buffers()):
            assert torch.equal(a, b), how


# -- optimizer state and sharded checkpoints across the packages -------------

@pytest.fixture(scope="module")
def two_steps():
    """The JAX and the port's trainer, AdamW from the same weights, 2
    steps each on the same batches; their states after them; and the
    third batch. A test puts a trainer back to its state with
    :func:`_reset` (the JAX trainer keeps its compiled step)."""
    jsym, shapes, init, data, label = _lm_setup()
    batches = [{"data": data[i * B:(i + 1) * B],
                "softmax_label": label[i * B:(i + 1) * B]}
               for i in range(NBATCH)]
    jtr = jax_par.ParallelTrainer(
        jsym, shapes, optimizer="adamw", mesh=jax_par.data_parallel_mesh(1),
        optimizer_params=dict(ADAMW))
    jtr.init_params({k: mx.nd.array(v) for k, v in init.items()})
    tr = _port_trainer()
    for b in batches[:2]:
        jtr.step(b)
        tr.step(b)
    snaps = {id(x): (x.get_params(), x.get_optimizer_states())
             for x in (jtr, tr)}
    return jtr, tr, batches[2], snaps


def _reset(trainer, snaps):
    (arg, aux), blob = snaps[id(trainer)]
    trainer.init_params(arg, aux)
    trainer.set_optimizer_states(blob)
    return trainer


def _next_step_params(trainer, batch):
    trainer.step(batch)
    got, _ = trainer.get_params()
    return {n: (v.numpy() if isinstance(v, torch.Tensor) else v.asnumpy())
            for n, v in got.items()}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_states_blob_crosses_the_packages(two_steps, tmp_path, direction):
    """A ``.states``/``.params`` checkpoint of one package's trainer sets
    the other's, whose next step equals the writer's next step. The JAX
    blob's ``rng`` is not read by the port, nor the port's ``torch_rng``
    by the JAX package."""
    jtr, tr, batch, snaps = two_steps
    src = _reset(jtr if direction == "jax_to_port" else tr, snaps)
    prefix = str(tmp_path / "x")
    arg, aux = src.get_params()
    (jax_model if src is jtr else T_model).save_checkpoint(
        prefix, 2, src.symbol, arg, aux,
        optimizer_states=src.get_optimizer_states())
    want = _next_step_params(src, batch)
    loader = T_model if src is jtr else jax_model
    _, arg2, aux2 = loader.load_checkpoint(prefix, 2)
    blob = loader.load_optimizer_states(prefix, 2)
    assert ("rng" in blob) == (src is jtr)
    assert ("torch_rng" in blob) == (src is tr)
    # the destination: a fresh port trainer, or the JAX trainer itself
    dst = _port_trainer(seed=99) if src is jtr else jtr
    dst.init_params(arg2, aux2)
    dst.set_optimizer_states(blob)
    assert dst._t == 2
    got = _next_step_params(dst, batch)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **PARAM_TOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_checkpoint_crosses_the_packages(two_steps, tmp_path,
                                                 direction):
    """The same files: a sharded checkpoint of one package's trainer loads
    in the other's ``load_sharded`` (the JAX side on a one-device mesh),
    restores its trainer, and the next steps agree."""
    jtr, tr, batch, snaps = two_steps
    src = _reset(jtr if direction == "jax_to_port" else tr, snaps)
    prefix = str(tmp_path / "sh")
    src.save_sharded_checkpoint(prefix)
    want = _next_step_params(src, batch)
    if src is jtr:
        flat, step, _ = T_ckpt.load_sharded(prefix)
        assert step == 2 and flat["opt/embed_weight/1"].shape == \
            (VOCAB, LM["embed_dim"])
        dst = ParallelTrainer(tr.symbol, tr.input_shapes, optimizer="adamw",
                              optimizer_params=dict(ADAMW), device="cpu")
    else:
        flat, step, _ = jax_ckpt.load_sharded(
            prefix, jax_par.data_parallel_mesh(1))
        assert step == 2 and "rng/0" in flat
        dst = jtr
    assert T_ckpt.latest_step(prefix) == jax_ckpt.latest_step(prefix) == 2
    dst.restore_sharded_checkpoint(prefix)
    assert dst._t == 2
    got = _next_step_params(dst, batch)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **PARAM_TOL)


def test_sharded_checkpoint_async_and_resume_probe(tmp_path):
    """tests/test_parallel.py:1076 and :1109: ``async_write`` snapshots
    at the call (a later step does not leak into the files); only a
    COMPLETE checkpoint resumes; an incomplete one leaves the trainer as
    it is."""
    tr = _mlp_trainer()
    x, y = _linear_problem(64)
    batch = {"data": x, "softmax_label": y}
    tr.step(batch)
    prefix = str(tmp_path / "a")
    assert tr.resume_sharded_checkpoint(prefix) is None
    snap = tr._flat.clone()
    finalize = tr.save_sharded_checkpoint(prefix, async_write=True)
    tr.step(batch)  # moves the weights while the writer may still run
    finalize()
    flat, step, _ = T_ckpt.load_sharded(prefix)
    assert step == 1
    got = torch.cat([flat[n].reshape(-1) for n in tr.param_names])
    assert torch.equal(got, snap)
    fresh = _mlp_trainer()
    assert fresh.resume_sharded_checkpoint(prefix) == 1
    assert torch.equal(fresh._flat, snap) and fresh._t == 1
    os.remove(prefix + "-shards-p0.npz")
    assert T_ckpt.latest_step(prefix) is None
    assert _mlp_trainer().resume_sharded_checkpoint(prefix) is None
    with open(prefix + "-manifest.json", "w") as f:
        f.write("{not json")
    assert T_ckpt.latest_step(prefix) is None
