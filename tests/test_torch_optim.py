"""The port's optimizers, schedulers, initializers and metrics against the
JAX package's, on the CPU.

* Each of the nine optimizers (SGD with momentum, ccSGD, Adam, AdamW,
  AdaFactor factored with a first moment and unfactored, AdaGrad,
  RMSProp, AdaDelta, Test), imperative (``update()``) and functional
  (``parallel.optim.make_functional``, the trainers' path, with the
  learning rate and the update count as 0-dim tensors), takes 3 steps
  from the same numpy weights and gradients as the JAX package's:
  weights and state leaves within rtol 1e-6 (atol 1e-7: elements that
  pass near zero). SGLD's noise is the port's own draw (the JAX package
  folds PRNG keys), so SGLD is held by its moments: the deterministic
  part within the same tolerance, the noise of standard deviation
  sqrt(lr) and mean 0 within 5 standard errors.
* ``set_lr_mult`` scales one index's step; ``get_updater``'s states go
  port -> JAX and JAX -> port through the pickled blob, and the next
  step matches.
* ``CosineScheduler``/``PolyScheduler`` equal the JAX package's exactly,
  with its refusals; ``Load`` and ``Mixed`` are exact, ``Orthogonal`` and
  ``MSRAPrelu`` are held by their properties (orthogonal rows or columns
  times the scale; the MSRA fan rule's standard deviation).
* Every metric on the same inputs (torch tensors on the port's side,
  NDArrays on the JAX side) equals the JAX package's within 1e-6.
"""
import math
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import initializer as jax_init
from mxnet_tpu import lr_scheduler as jax_lrs
from mxnet_tpu import metric as jax_metric
from mxnet_tpu import optimizer as jax_opt
from mxnet_tpu.parallel.optim import make_functional as jax_functional

from mxnet_tpu_torch import initializer as T_init
from mxnet_tpu_torch import lr_scheduler as T_lrs
from mxnet_tpu_torch import metric as T_metric
from mxnet_tpu_torch import optimizer as T_opt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.optim import FlatOptState, make_functional

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(6, 5), (5,)]

# (name, kwargs): every optimizer of the JAX package but SGLD
OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 clip_gradient=0.8, rescale_grad=0.5)),
    ("ccsgd", dict(learning_rate=0.1)),
    ("adam", dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5)),
    ("adamw", dict(learning_rate=0.01, beta2=0.95, wd=0.1,
                   clip_gradient=1.0)),
    ("adafactor", dict(learning_rate=0.01, beta1=0.9, wd=0.01)),
    ("adafactor", dict(learning_rate=0.01, factored=False,
                       scale_by_param=False)),
    ("adagrad", dict(learning_rate=0.05, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01)),
    ("adadelta", dict(wd=0.01, rescale_grad=2.0)),
    ("test", dict(rescale_grad=0.3)),
]
IDS = ["%s-%d" % (n, i) for i, (n, _) in enumerate(OPTIMIZERS)]


def _draws(seed, steps=3):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(steps)]
    return ws, gs


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _flat_leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat_leaves(s)]
    return [state]


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=IDS)
def test_imperative_update_matches_jax(name, kw):
    ws, gs = _draws(0)
    jo, to = jax_opt.create(name, **kw), T_opt.create(name, **kw)
    jw = [mx.nd.array(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    for step in gs:
        for i, g in enumerate(step):
            jo.update(i, jw[i], mx.nd.array(g), js[i])
            to.update(i, tw[i], torch.from_numpy(g), ts[i])
    for i in range(len(SHAPES)):
        np.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(),
                                   err_msg="weight %d" % i, **TOL)
        jl, tl = _flat_leaves(js[i]), _flat_leaves(ts[i])
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    assert to.num_update == jo.num_update
    assert to._index_update_count == jo._index_update_count


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=IDS)
def test_functional_update_matches_jax(name, kw):
    """The trainers' adapters, lr and t as 0-dim f32 tensors, against the
    JAX adapters jitted with f32 lr and int32 t (as its trainer runs
    them)."""
    ws, gs = _draws(1)
    jinit, jupdate = jax_functional(jax_opt.create(name, **kw))
    tinit, tupdate = make_functional(T_opt.create(name, **kw))
    jupd = jax.jit(jupdate)
    key = jax.random.PRNGKey(0)
    jw = [jnp.asarray(w) for w in ws]
    js = [jinit(w) for w in jw]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    ts = [tinit(w) for w in tw]
    for k, step in enumerate(gs):
        lr = 0.01 * (k + 1)
        for i, g in enumerate(step):
            jw[i], js[i] = jupd(jw[i], jnp.asarray(g), js[i],
                                jnp.float32(lr), jnp.int32(k + 1), key)
        tupdate(tw, [torch.from_numpy(g) for g in step], ts,
                torch.tensor(lr, dtype=torch.float32),
                torch.tensor(float(k + 1)), None)
    for i in range(len(SHAPES)):
        np.testing.assert_allclose(tw[i].numpy(), np.asarray(jw[i]),
                                   err_msg="weight %d" % i, **TOL)
        jl = jax.tree_util.tree_leaves(js[i])
        assert len(jl) == len(ts[i])
        for a, b in zip(ts[i], jl):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("functional", [False, True])
def test_sgld_by_its_moments(functional):
    """The deterministic part ``w - lr/2 (rescale g + wd w)`` equals the
    JAX package's SGD-like arithmetic; the rest is N(0, lr) noise."""
    lr, wd, n = 0.04, 0.01, 20000
    rng = np.random.RandomState(2)
    w0 = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    opt = T_opt.create("sgld", learning_rate=lr, wd=wd, rescale_grad=0.5)
    w = torch.from_numpy(w0.copy())
    gen = torch.Generator().manual_seed(3)
    if functional:
        _, update = make_functional(opt)
        update([w], [torch.from_numpy(g)], [()],
               torch.tensor(lr), torch.tensor(1.0), gen)
    else:
        torch.manual_seed(3)
        opt.update(0, w, torch.from_numpy(g), opt.create_state(0, w))
    det = w0 - np.float32(lr / 2) * (np.float32(0.5) * g
                                     + np.float32(wd) * w0)
    noise = w.numpy() - det
    assert abs(noise.mean()) < 5 * math.sqrt(lr / n)
    assert abs(noise.std() / math.sqrt(lr) - 1) < 5 / math.sqrt(2 * n)
    # the same generator state gives the same draws: the noise is exactly
    # sqrt(lr) times a standard normal from it
    gen2 = torch.Generator().manual_seed(3)
    if not functional:
        torch.manual_seed(3)
    z = torch.randn(n, generator=gen2 if functional else None)
    np.testing.assert_allclose(noise, (math.sqrt(lr) * z).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_flat_state_layout_and_reload():
    """``FlatOptState``: the elementwise optimizers' state as flat buffers
    (one update over the whole parameter buffer equals updating each
    weight), AdaFactor's per weight; ``load`` copies into the same
    buffers and refuses another optimizer's leaves."""
    names, shapes = ["a_weight", "b_bias"], [(6, 5), (5,)]
    ws, gs = _draws(4, steps=2)
    for name, kw in (("adam", {}), ("adafactor", dict(beta1=0.9))):
        opt = T_opt.create(name, learning_rate=0.01, **kw)
        flat = torch.cat([torch.from_numpy(w).reshape(-1) for w in ws])
        st = FlatOptState(opt, names, shapes, flat)
        assert st.per_weight == (name == "adafactor")
        ptrs = [b.data_ptr() for b in st.buffers()]
        ref = [torch.from_numpy(w.copy()) for w in ws]
        init, update = make_functional(T_opt.create(name, learning_rate=0.01,
                                                    **kw))
        rs = [init(r) for r in ref]
        for k, step in enumerate(gs):
            grad = torch.cat([torch.from_numpy(g).reshape(-1) for g in step])
            st.update(flat, grad, 0.01, float(k + 1))
            for r, g, s in zip(ref, step, rs):
                update([r], [torch.from_numpy(g)], [s], 0.01, float(k + 1))
        for v, r in zip(st.views(flat), ref):
            np.testing.assert_allclose(v.numpy(), r.numpy(), **TOL)
        leaves = st.by_name()
        assert [len(leaves[n]) for n in names] == \
            ([2, 2] if name == "adam" else [3, 2])
        saved = {n: [x.numpy().copy() for x in ls]
                 for n, ls in leaves.items()}
        st.reset(flat)
        assert all(float(b.abs().sum()) == 0 for b in st.buffers())
        st.load(saved)
        assert [b.data_ptr() for b in st.buffers()] == ptrs
        for n in names:
            for x, y in zip(st.by_name()[n], saved[n]):
                np.testing.assert_array_equal(x.numpy(), y)
        with pytest.raises(MXNetError, match="different optimizer"):
            st.load({n: v[:1] for n, v in saved.items()})


def test_set_lr_mult_scales_one_index():
    for mod in (T_opt, jax_opt):
        opt = mod.create("sgd", learning_rate=0.1)
        opt.set_lr_mult({1: 0.0, 2: 2.0})
        assert opt._get_lr(1) == 0.0 and opt._get_lr(2) == 0.2 \
            and opt._get_lr(0) == 0.1
    opt = T_opt.create("sgd", learning_rate=0.1)
    opt.set_lr_scale({0: 0.5})
    w = torch.ones(3)
    opt.update(0, w, torch.ones(3), None)
    np.testing.assert_allclose(w.numpy(), 0.95, rtol=1e-7)
    frozen = torch.ones(3)
    opt.set_lr_mult({1: 0.0})
    opt.update(1, frozen, torch.ones(3), None)
    assert torch.equal(frozen, torch.ones(3))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_updater_states_cross_the_packages(direction):
    """A ``get_updater`` blob pickled by one package restores the other's
    updater, and both take the same next step."""
    ws, gs = _draws(5, steps=3)
    kw = dict(learning_rate=0.01, wd=0.01)
    src_mod, dst_mod = (T_opt, jax_opt) if direction == "port_to_jax" \
        else (jax_opt, T_opt)

    def weights(mod, vals):
        # copies: a JAX array may alias the numpy memory it came from
        return [torch.from_numpy(v.copy()) if mod is T_opt
                else mx.nd.array(v.copy()) for v in vals]

    def grad(mod, g):
        return torch.from_numpy(g) if mod is T_opt else mx.nd.array(g)

    src = src_mod.get_updater(src_mod.create("adam", **kw))
    sw = weights(src_mod, ws)
    for step in gs[:2]:
        for i, g in enumerate(step):
            src(i, grad(src_mod, g), sw[i])
    blob = pickle.loads(pickle.dumps(src.get_states()))
    assert all(isinstance(x, np.ndarray)
               for st in blob["states"].values() for x in st)
    dst = dst_mod.get_updater(dst_mod.create("adam", **kw))
    dst.set_states(blob)
    dw = weights(dst_mod, [_np(w) if src_mod is jax_opt else w.numpy()
                           for w in sw])
    for i, g in enumerate(gs[2]):
        src(i, grad(src_mod, g), sw[i])
        dst(i, grad(dst_mod, g), dw[i])
    for a, b in zip(sw, dw):
        np.testing.assert_allclose(_np(a) if src_mod is jax_opt
                                   else a.numpy(),
                                   _np(b) if dst_mod is jax_opt
                                   else b.numpy(), **TOL)
    assert dst.optimizer.num_update == src.optimizer.num_update == 3


def test_create_refuses_an_unknown_optimizer():
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        T_opt.create("lamb")
    assert isinstance(T_opt.create("adamw"), T_opt.Adam)
    assert sorted(T_opt.Optimizer.opt_registry) == \
        sorted(jax_opt.Optimizer.opt_registry)


# -- schedulers ----------------------------------------------------------

SCHEDULERS = [
    ("cosine", dict(max_update=100, final_lr=0.01, warmup_steps=10)),
    ("cosine", dict(max_update=48, final_lr=6e-5, warmup_steps=4,
                    warmup_begin_lr=1e-5)),
    ("cosine", dict(max_update=7)),
    ("poly", dict(max_update=10, power=1.0)),
    ("poly", dict(max_update=30, power=2.0, final_lr=0.001)),
]


@pytest.mark.parametrize("kind,kw", SCHEDULERS)
def test_schedulers_match_jax(kind, kw):
    cls = {"cosine": "CosineScheduler", "poly": "PolyScheduler"}[kind]
    ts, js = getattr(T_lrs, cls)(**kw), getattr(jax_lrs, cls)(**kw)
    ts.base_lr = js.base_lr = 6e-4
    assert [ts(i) for i in range(0, 120)] == [js(i) for i in range(0, 120)]


def test_scheduler_refusals_and_optimizer_plumbing():
    for cls, bad in (("CosineScheduler", dict(max_update=0)),
                     ("CosineScheduler", dict(max_update=5, warmup_steps=5)),
                     ("PolyScheduler", dict(max_update=0))):
        with pytest.raises(ValueError) as got:
            getattr(T_lrs, cls)(**bad)
        with pytest.raises(ValueError) as want:
            getattr(jax_lrs, cls)(**bad)
        assert str(got.value) == str(want.value)
    sched = T_lrs.CosineScheduler(max_update=50)
    opt = T_opt.create("sgd", learning_rate=0.1, lr_scheduler=sched)
    assert sched.base_lr == 0.1 and opt._get_lr(0) == 0.1


# -- initializers --------------------------------------------------------

def test_load_and_mixed_match_jax(tmp_path):
    from mxnet_tpu_torch import ndarray as T_nd
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    path = str(tmp_path / "p.params")
    T_nd.save(path, {"arg:fc_weight": w})
    gen = torch.Generator().manual_seed(0)
    for src in (path, {"fc_weight": w}, {"arg:fc_weight": torch.from_numpy(w)}):
        t = torch.zeros(4, 3)
        T_init.Load(src)("fc_weight", t, gen)
        j = mx.nd.zeros((4, 3))
        jax_init.Load(path)("fc_weight", j)
        np.testing.assert_array_equal(t.numpy(), j.asnumpy())
    b = torch.full((3,), 5.0)
    T_init.Load({"fc_weight": w}, default_init=T_init.Uniform())(
        "fc_bias", b, gen)
    assert torch.all(b == 0)
    with pytest.raises(ValueError, match="Cannot Initialize"):
        T_init.Load({"fc_weight": w})("fc_bias", torch.zeros(3), gen)
    with pytest.raises(ValueError, match="Shape mismatch"):
        T_init.Load({"fc_weight": w})("fc_weight", torch.zeros(3, 4), gen)
    mixed = T_init.Mixed([".*bias", ".*"], [T_init.Load({"x_bias": np.ones(
        3, np.float32)}), T_init.Normal(0.5)])
    jmixed = jax_init.Mixed([".*bias", ".*"], [jax_init.Load(
        {"x_bias": mx.nd.ones((3,))}), jax_init.Normal(0.5)])
    t, j = torch.zeros(3), mx.nd.zeros((3,))
    mixed("x_bias", t, gen)
    jmixed("x_bias", j)
    np.testing.assert_array_equal(t.numpy(), j.asnumpy())
    t = torch.zeros(200, 50)
    mixed("x_weight", t, gen)
    assert abs(float(t.std()) - 0.5) < 0.02
    with pytest.raises(ValueError, match="did not match"):
        T_init.Mixed(["a"], [T_init.Normal()])("b_weight", t, gen)


@pytest.mark.parametrize("shape,rand_type", [((8, 20), "uniform"),
                                             ((20, 8), "normal"),
                                             ((6, 2, 3, 3), "uniform")])
def test_orthogonal_properties(shape, rand_type):
    gen = torch.Generator().manual_seed(1)
    t = torch.zeros(shape)
    T_init.Orthogonal(scale=1.5, rand_type=rand_type)("c_weight", t, gen)
    m = t.reshape(shape[0], -1).double() / 1.5
    small = min(m.shape)
    gram = m @ m.T if m.shape[0] == small else m.T @ m
    np.testing.assert_allclose(gram.numpy(), np.eye(small), atol=1e-5)
    t2 = torch.zeros(shape)
    T_init.Orthogonal(scale=1.5, rand_type=rand_type)(
        "c_weight", t2, torch.Generator().manual_seed(1))
    assert torch.equal(t, t2)


@pytest.mark.parametrize("factor_type,slope", [("avg", 0.25), ("in", 0.0),
                                               ("out", 1.0)])
def test_msra_prelu_fan_rule(factor_type, slope):
    shape = (64, 32, 3, 3)
    t = torch.zeros(shape)
    T_init.MSRAPrelu(factor_type, slope)("c_weight", t,
                                         torch.Generator().manual_seed(2))
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    want = math.sqrt(2.0 / (1 + slope ** 2) / factor)
    assert abs(float(t.std()) / want - 1) < 0.03
    assert abs(float(t.mean())) < 3 * want / math.sqrt(t.numel())
    j = jax_init.MSRAPrelu(factor_type, slope)
    assert (j.magnitude, j.factor_type, j.rnd_type) == \
        (T_init.MSRAPrelu(factor_type, slope).magnitude, factor_type,
         "gaussian")


# -- metrics -------------------------------------------------------------

def _metric_inputs():
    rng = np.random.RandomState(3)
    probs = rng.dirichlet(np.ones(5), 12).astype(np.float32)
    labels = rng.randint(0, 5, 12).astype(np.float32)
    binary = rng.dirichlet(np.ones(2), 12).astype(np.float32)
    blabels = rng.randint(0, 2, 12).astype(np.float32)
    reg = rng.randn(12, 1).astype(np.float32)
    rlabels = rng.randn(12).astype(np.float32)
    return probs, labels, binary, blabels, reg, rlabels


METRICS = ["acc", "f1", "mae", "mse", "rmse", "ce", "loss",
           "top_k_accuracy", "torch", "custom"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name):
    probs, labels, binary, blabels, reg, rlabels = _metric_inputs()
    if name == "custom":
        def feval(l, p):
            return float(np.abs(l.ravel() - p.argmax(1)).mean())
        tm, jm = T_metric.np(feval), jax_metric.np(feval)
    else:
        tm, jm = T_metric.create(name), jax_metric.create(name)
        if name == "top_k_accuracy":
            tm, jm = T_metric.TopKAccuracy(3), jax_metric.TopKAccuracy(3)
    p, l_ = {"f1": (binary, blabels), "mae": (reg, rlabels),
             "mse": (reg, rlabels), "rmse": (reg, rlabels)}.get(
                 name, (probs, labels))
    for half in (slice(0, 6), slice(6, 12)):
        tm.update([torch.from_numpy(l_[half])], [torch.from_numpy(p[half])])
        jm.update([mx.nd.array(l_[half])], [mx.nd.array(p[half])])
    tn, tv = tm.get()
    jn, jv = jm.get()
    assert tn == jn and tm.num_inst == jm.num_inst
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    # numpy inputs and a bf16 tensor read the same way
    again = T_metric.create(tm) if name != "custom" else None
    assert again is tm or again is None


def test_metric_refusals_and_helpers():
    probs, labels, *_ = _metric_inputs()
    with pytest.raises(MXNetError, match="length mismatch"):
        T_metric.Accuracy().update([labels], [probs, probs])
    with pytest.raises(MXNetError, match="meaningless"):
        T_metric.TopKAccuracy(5).update([labels], [probs])
    with pytest.raises(MXNetError, match="binary"):
        T_metric.F1().update([labels], [probs])
    with pytest.raises(ValueError, match="Metric must be"):
        T_metric.create("bleu")
    with pytest.raises(ValueError, match="does not match"):
        T_metric.check_label_shapes([1, 2], [1])
    T_metric.check_label_shapes(np.zeros(3), np.zeros(3), shape=1)
    m = T_metric.Loss()
    m.update([None], [torch.tensor([1.0, 3.0, 5.0], dtype=torch.bfloat16)])
    assert m.get() == ("loss", 3.0)
    m.update(None, [np.array([7.0], np.float32)])
    assert m.get()[1] == 4.0
    assert np.isnan(T_metric.Accuracy().get()[1])
