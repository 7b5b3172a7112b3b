"""The PyTorch port's SequenceParallelTrainer against the JAX package's.

A 1-layer LM with ``impl="ring"`` or ``"ring_striped"`` on a dp=2 x sp=4
mesh (the port's over ``["cpu"] * 8``, JAX's on its 8 virtual CPU
devices), from the same numpy weights and batch, as
``tests/test_parallel.py``'s SP trainer test sets it up: the parameters
after 2 SGD-momentum steps at rtol 2e-4 / atol 2e-5 (that test's
tolerance) and the per-token losses at rtol 1e-5; with the learned
``pos_embed`` sharded over sp, with rope, and with GQA.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jax_par
from mxnet_tpu.models import get_transformer_lm as jax_lm

from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm

VOCAB, B, T = 12, 4, 16
SGD = {"learning_rate": 0.2, "momentum": 0.9, "rescale_grad": 1.0 / B}
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
VARIANTS = {
    "learned": dict(embed_dim=8, num_heads=2),
    "rope": dict(embed_dim=8, num_heads=2, pos_encoding="rope"),
    "gqa": dict(embed_dim=16, num_heads=4, num_kv_heads=2),
}


def _setup(lm_kw):
    rng = np.random.RandomState(0)
    data = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    label = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    jsym = jax_lm(VOCAB, num_layers=1, **lm_kw)
    arg_shapes, _, _ = jsym.infer_shape(**shapes)
    prng = np.random.RandomState(3)
    init = {n: prng.uniform(-0.1, 0.1, s).astype("f")
            for n, s in zip(jsym.list_arguments(), arg_shapes)
            if n not in shapes}
    return shapes, init, {"data": data, "softmax_label": label}


def _jax_run(impl, lm_kw, steps=2):
    shapes, init, batch = _setup(lm_kw)
    tr = jax_par.SequenceParallelTrainer(
        jax_lm(VOCAB, num_layers=1, impl=impl, **lm_kw), shapes,
        jax_par.build_mesh({"dp": 2, "sp": 4}), optimizer="sgd",
        optimizer_params=dict(SGD))
    tr.init_params({k: mx.nd.array(v) for k, v in init.items()})
    losses = [float(tr.step(batch)) for _ in range(steps)]
    return {k: v.asnumpy() for k, v in tr.get_params().items()}, losses


def _port_trainer(impl, lm_kw, mesh_axes=None, **kw):
    shapes, init, batch = _setup(lm_kw)
    mesh = par.build_mesh(mesh_axes or {"dp": 2, "sp": 4}, ["cpu"] * 8)
    tr = par.SequenceParallelTrainer(
        get_transformer_lm(VOCAB, num_layers=1, impl=impl, **lm_kw), shapes,
        mesh, optimizer="sgd", optimizer_params=dict(SGD), **kw)
    tr.init_params(init)
    return tr, init, batch


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("impl", ["ring", "ring_striped"])
def test_sp_trainer_matches_jax(impl, variant):
    lm_kw = VARIANTS[variant]
    want, want_losses = _jax_run(impl, lm_kw)
    tr, init, batch = _port_trainer(impl, lm_kw)
    losses = [float(tr.step(batch)) for _ in range(2)]
    got = tr.get_params()
    assert set(got) == set(want)
    if variant == "learned":
        assert tuple(got["pos_embed"].shape) == (T, lm_kw["embed_dim"])
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n], err_msg=n,
                                   **PARAM_TOL)
        assert not np.allclose(got[n].numpy(), init[n]) \
            or n.endswith("_beta"), n
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[1] < losses[0]


def test_sp_trainer_striped_equals_contiguous_ring():
    """The two ring layouts compute the same attention: after 2 steps the
    striped trainer's parameters equal the contiguous ring's."""
    a, _, batch = _port_trainer("ring", VARIANTS["learned"])
    b, _, _ = _port_trainer("ring_striped", VARIANTS["learned"])
    for _ in range(2):
        a.step(batch)
        b.step(batch)
    pa, pb = a.get_params(), b.get_params()
    for n in pa:
        np.testing.assert_allclose(pb[n].numpy(), pa[n].numpy(), err_msg=n,
                                   **PARAM_TOL)


def test_sp_trainer_sp_only_mesh_and_default_init():
    """dp=1 x sp=4 over 4 ranks; the default Uniform(0.05) draw is seeded,
    the sharded pos_embed has the global rows, the loss falls."""
    shapes, _, batch = _setup(VARIANTS["learned"])
    symbol = get_transformer_lm(VOCAB, num_layers=1, impl="ring_striped",
                                **VARIANTS["learned"])
    mesh = par.build_mesh({"dp": 1, "sp": 4}, ["cpu"] * 4)
    a, b = (par.SequenceParallelTrainer(symbol, shapes, mesh, seed=5)
            .init_params() for _ in range(2))
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    w = a.params["layer0_ffn1_weight"]
    assert w.abs().max() <= 0.05 and w.std() > 0.01
    assert a._global_param_shape("pos_embed") == (T, 8)
    assert a.optimizer.rescale_grad == 1.0 / (B * T)
    losses = [float(a.step(batch)) for _ in range(4)]
    assert losses[-1] < losses[0], losses


def test_sp_trainer_dropout_streams_are_per_rank_and_seeded():
    lm_kw = dict(VARIANTS["learned"], dropout=0.3)
    runs = []
    for seed in (1, 1, 2):
        tr, _, batch = _port_trainer("ring_striped", lm_kw, seed=seed)
        runs.append([float(tr.step(batch)) for _ in range(2)])
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_sp_trainer_refusals():
    shapes, _, _ = _setup(VARIANTS["learned"])
    symbol = get_transformer_lm(VOCAB, num_layers=1, impl="ring",
                                **VARIANTS["learned"])
    with pytest.raises(MXNetError, match="'dp' and 'sp'"):
        par.SequenceParallelTrainer(
            symbol, shapes, par.build_mesh({"sp": 4}, ["cpu"] * 4))
    mesh = par.build_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8)
    with pytest.raises(MXNetError, match="not divisible"):
        par.SequenceParallelTrainer(symbol, {"data": (3, T),
                                             "softmax_label": (3, T)}, mesh)
    bn = sym.SoftmaxOutput(data=sym.BatchNorm(data=sym.Variable("data"),
                                              name="bn"), name="softmax")
    with pytest.raises(MXNetError, match="aux states"):
        par.SequenceParallelTrainer(bn, {"data": (2, 4)}, mesh)
    tr = par.SequenceParallelTrainer(symbol, shapes, mesh)
    with pytest.raises(MXNetError, match="param pos_embed"):
        tr.init_params({"pos_embed": np.zeros((T // 4, 8), np.float32)})


def _adam_pair(lm_kw, opt="adam"):
    """The JAX and port SP trainers from the same weights, with ``opt``."""
    shapes, init, batch = _setup(lm_kw)
    params = {"learning_rate": 1e-2, "rescale_grad": 1.0 / B}
    jtr = jax_par.SequenceParallelTrainer(
        jax_lm(VOCAB, num_layers=1, impl="ring", **lm_kw), shapes,
        jax_par.build_mesh({"dp": 2, "sp": 4}), optimizer=opt,
        optimizer_params=dict(params))
    jtr.init_params({k: mx.nd.array(v) for k, v in init.items()})
    ttr = par.SequenceParallelTrainer(
        get_transformer_lm(VOCAB, num_layers=1, impl="ring", **lm_kw),
        shapes, par.build_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8),
        optimizer=opt, optimizer_params=dict(params))
    ttr.init_params(init)
    return jtr, ttr, batch


def _assert_sp_params(got, want):
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].asnumpy(),
                                   err_msg=n, **PARAM_TOL)


def test_sp_trainer_adam_matches_jax():
    """Adam's bias correction reads the 1-based update count: the first
    step is finite (the JAX package's regression,
    tests/test_parallel.py:436) and 2 steps equal the JAX trainer's."""
    jtr, ttr, batch = _adam_pair(VARIANTS["learned"])
    for _ in range(2):
        jl, tl = float(jtr.step(batch)), float(ttr.step(batch))
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_sp_params(ttr.get_params(), jtr.get_params())
    assert [len(v) for v in ttr.opt_state.values()] == [2] * len(
        ttr.param_names)


def _sp(lm_kw, optimizer, optimizer_params, seed=0):
    shapes, init, batch = _setup(lm_kw)
    tr = par.SequenceParallelTrainer(
        get_transformer_lm(VOCAB, num_layers=1, impl="ring", **lm_kw),
        shapes, par.build_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8),
        optimizer=optimizer, optimizer_params=dict(optimizer_params),
        seed=seed)
    return tr.init_params(init), batch


def test_sp_trainer_sgld_noise_is_seeded():
    """SGLD on the one f32 copy: the noise comes from the trainer's seeded
    generator (two trainers of one seed agree, another seed differs) and
    moves the parameters off the noiseless step."""
    runs = []
    for seed in (4, 4, 5):
        tr, batch = _sp(VARIANTS["learned"], "sgld",
                        {"learning_rate": 1e-3}, seed=seed)
        for _ in range(2):
            assert np.isfinite(float(tr.step(batch)))
        runs.append(tr._flat.clone())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all()


@pytest.mark.parametrize("opt", ["sgd", "adam", "sgld"])
def test_sp_sharded_checkpoint_round_trip(tmp_path, opt):
    """Save after one step; a fresh trainer restores (the sharded
    pos_embed, the optimizer state and the generators of dropout and
    SGLD's noise included) and its next steps equal the uninterrupted
    run's bitwise (tests/test_parallel.py:604)."""
    lm_kw = dict(VARIANTS["learned"], dropout=0.2)
    params = dict(SGD) if opt == "sgd" else {"learning_rate": 1e-2}
    tr, batch = _sp(lm_kw, opt, params)
    tr.step(batch)
    prefix = str(tmp_path / "sp")
    tr.save_sharded_checkpoint(prefix)
    want = [float(tr.step(batch)) for _ in range(2)]
    fresh = par.SequenceParallelTrainer(
        tr.symbol, tr.input_shapes, tr.mesh, optimizer=opt,
        optimizer_params=dict(params), seed=9)
    fresh.restore_sharded_checkpoint(prefix)
    assert fresh._t == 1
    got = [float(fresh.step(batch)) for _ in range(2)]
    assert got == want
    assert torch.equal(fresh._flat, tr._flat)
    for a, b in zip(fresh._state.buffers(), tr._state.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sp_sharded_checkpoint_crosses_the_packages(tmp_path, direction):
    """An Adam SP checkpoint written by one package (the JAX package's
    pos_embed and its moments in four row shards over sp) restores in the
    other's trainer, whose next step equals the writer's next step."""
    jtr, ttr, batch = _adam_pair(VARIANTS["learned"])
    jtr.step(batch)
    ttr.step(batch)
    prefix = str(tmp_path / "sp")
    src, dst = (jtr, ttr) if direction == "jax_to_port" else (ttr, jtr)
    src.save_sharded_checkpoint(prefix)
    src.step(batch)
    if direction == "jax_to_port":
        fresh = par.SequenceParallelTrainer(
            ttr.symbol, ttr.input_shapes, ttr.mesh, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2,
                              "rescale_grad": 1.0 / B})
    else:
        fresh = jax_par.SequenceParallelTrainer(
            jtr.symbol, jtr.input_shapes, jtr.mesh, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2,
                              "rescale_grad": 1.0 / B})
    fresh.restore_sharded_checkpoint(prefix)
    assert fresh._t == 1
    fresh.step(batch)
    got, want = fresh.get_params(), src.get_params()
    for n in want:
        g = got[n].numpy() if isinstance(got[n], torch.Tensor) \
            else got[n].asnumpy()
        w = want[n].numpy() if isinstance(want[n], torch.Tensor) \
            else want[n].asnumpy()
        np.testing.assert_allclose(g, w, err_msg=n, **PARAM_TOL)
