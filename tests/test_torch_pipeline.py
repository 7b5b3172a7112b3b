"""The port's pipeline parallelism against the JAX package's, on the CPU.

Each test mirrors a pipeline oracle of ``tests/test_parallel.py`` (named
after it) on the same inputs, made from a numpy seed: the port's
``PipelineTrainer`` on a ``["cpu"] * n`` mesh against the JAX package's
one-device ``ParallelTrainer`` on the untagged model (the oracle the JAX
tests use), parameters after the same steps at the JAX tests'
tolerance, rtol 2e-4 / atol 2e-5 (2e-5 / 2e-6 where the JAX test holds
two pipeline forms to each other; 1e-5 / 1e-6 for remat). The tagged LM's
``tojson()`` is the JAX package's. 1F1B's bound on activation memory is
read as a count: the most boundary inputs a stage holds at once is
``2S - 1`` whatever the number of microbatches.
"""
import collections
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import P as JP
from mxnet_tpu.parallel.compat import shard_map
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import collectives as coll

TOL = dict(rtol=2e-4, atol=2e-5)


def _mesh(axes):
    return par.build_mesh(axes, ["cpu"] * int(np.prod(list(axes.values()))))


def _lm_batch(vocab, B, T, seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, vocab, (B, T)).astype(np.float32),
            "softmax_label": rng.randint(0, vocab, (B, T)
                                         ).astype(np.float32)}


def _init(sym, shapes, seed, scale=0.1):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-scale, scale, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _jax_ref(jsym, init, batch, steps, opt):
    tr = jpar.ParallelTrainer(jsym, {k: v.shape for k, v in batch.items()},
                              optimizer="sgd",
                              mesh=jpar.data_parallel_mesh(1),
                              optimizer_params=opt)
    tr.init_params({k: jmx.nd.array(v.copy()) for k, v in init.items()})
    for _ in range(steps):
        outs = tr.step(batch)
    got, _ = tr.get_params()
    return {k: v.asnumpy() for k, v in got.items()}, outs


def _pipe(sym, batch, init, mesh, steps, opt, **kw):
    B = next(iter(batch.values())).shape[0]
    pp = par.PipelineTrainer(
        sym, {k: v.shape for k, v in batch.items()}, mesh, optimizer="sgd",
        optimizer_params=dict(opt, rescale_grad=1.0 / B), **kw)
    pp.init_params({k: v.copy() for k, v in init.items()})
    for _ in range(steps):
        out = pp.step(batch)
    return pp, out


def _close(got, want, **tol):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(want[n]),
                                   err_msg=n, **(tol or TOL))


SGD = {"learning_rate": 0.2, "momentum": 0.9}


@pytest.fixture(scope="module")
def lm2():
    """The 2-layer LM of test_pipeline_trainer_matches_single_device and
    the JAX package's one-device step on it (2 steps)."""
    vocab, B, T, E = 11, 8, 12, 16
    batch = _lm_batch(vocab, B, T, 0)
    shapes = {k: v.shape for k, v in batch.items()}
    kw = dict(num_layers=2, embed_dim=E, num_heads=2, impl="dense")
    init = _init(get_transformer_lm(vocab, **kw), shapes, 3)
    want, _ = _jax_ref(jax_lm(vocab, **kw), init, batch, 2, SGD)
    staged = get_transformer_lm(vocab, pipeline_stages=2, **kw)
    return dict(batch=batch, init=init, want=want, staged=staged, B=B)


def test_tagged_lm_tojson_is_the_jax_package_s():
    for stages, layers in ((2, 2), (4, 12), (2, 3)):
        kw = dict(num_layers=layers, embed_dim=16, num_heads=2,
                  pipeline_stages=stages)
        with JaxNames():
            want = jax_lm(29, **kw).tojson()
        with TorchNames():
            got = get_transformer_lm(29, **kw).tojson()
        assert got == want, (stages, layers)


def test_pipeline_spmd():
    """4 stages of y = x @ w_s equal the sequential product and the JAX
    helper under shard_map."""
    n_stage, M, mb, d = 4, 6, 2, 8
    rng = np.random.RandomState(3)
    ws = rng.randn(n_stage, d, d).astype(np.float32) * 0.3
    x = rng.randn(M, mb, d).astype(np.float32)
    mesh = jpar.build_mesh({"pp": n_stage})

    def jrun(w, xb):
        out = jpar.pipeline_spmd(lambda p, v: v @ p[0], w, xb,
                                 axis_name="pp")
        return jnp.asarray(jpar.collectives.psum(out, "pp"))

    want = np.asarray(shard_map(jrun, mesh=mesh, in_specs=(JP("pp"), JP()),
                                out_specs=JP(), check_vma=False)(
        jnp.asarray(ws), jnp.asarray(x)))
    outs = par.pipeline_spmd(lambda p, v: v @ p[0],
                             [torch.from_numpy(ws[s:s + 1])
                              for s in range(n_stage)],
                             torch.from_numpy(x), axis_name="pp")
    assert all(float(o.abs().sum()) == 0 for o in outs[:-1])
    got = coll.psum(outs)[0].numpy()
    expect = x
    for s in range(n_stage):
        expect = expect @ ws[s]
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pipeline_trainer_matches_single_device(lm2):
    pp, out = _pipe(lm2["staged"], lm2["batch"], lm2["init"],
                    _mesh({"pp": 2}), 2, SGD, num_microbatches=4)
    assert out.shape[0] == lm2["B"]
    _close(pp.get_params(), lm2["want"])


def test_pipeline_partition_validation():
    data = mx.symbol.Variable("data")
    fc = mx.symbol.FullyConnected(data=data, name="fc", num_hidden=4)
    out = mx.symbol.SoftmaxOutput(data=fc, name="softmax")
    with pytest.raises(MXNetError, match="ctx_group"):
        par.partition_stages(out)
    with mx.AttrScope(ctx_group="stage0"):
        a = mx.symbol.FullyConnected(data=data, name="a", num_hidden=4)
    with mx.AttrScope(ctx_group="stage1"):
        b = mx.symbol.FullyConnected(data=a, name="b", num_hidden=4)
    with mx.AttrScope(ctx_group="stage2"):
        c = mx.symbol.SoftmaxOutput(data=b + a, name="softmax")
    with pytest.raises(MXNetError, match="skips stages"):
        par.partition_stages(c)
    with mx.AttrScope(ctx_group="stage1"):
        d = mx.symbol.SoftmaxOutput(data=b, name="softmax")
    with pytest.raises(MXNetError, match="mesh wants 3"):
        par.partition_stages(d, 3)
    nodes, bounds, _ = par.partition_stages(d, 2)
    assert [len(s) for s in nodes] == [4, 5] and bounds[0][0].name == "a"
    with pytest.raises(MXNetError, match="1f1b"):
        par.PipelineTrainer(d, {"data": (4, 4), "softmax_label": (4,)},
                            _mesh({"pp": 2}), schedule="1f1b",
                            param_placement="replicated")
    with pytest.raises(MXNetError, match="'pp' axis"):
        par.PipelineTrainer(d, {"data": (4, 4), "softmax_label": (4,)},
                            _mesh({"dp": 2}))


def test_pipeline_unequal_stages():
    """3 blocks over 2 stages (unequal parameter sets)."""
    vocab, B, T, E = 7, 4, 8, 8
    batch = _lm_batch(vocab, B, T, 1)
    shapes = {k: v.shape for k, v in batch.items()}
    kw = dict(num_layers=3, embed_dim=E, num_heads=2, impl="dense")
    init = _init(get_transformer_lm(vocab, **kw), shapes, 5)
    opt = {"learning_rate": 0.1}
    want, _ = _jax_ref(jax_lm(vocab, **kw), init, batch, 1, opt)
    pp, _ = _pipe(get_transformer_lm(vocab, pipeline_stages=2, **kw),
                  batch, init, _mesh({"pp": 2}), 1, opt, num_microbatches=2)
    assert len(pp._flat_meta[0]) != len(pp._flat_meta[1])
    _close(pp.get_params(), want)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_dp_pp_matches_single_device(schedule):
    vocab, B, T, E = 9, 8, 8, 8
    batch = _lm_batch(vocab, B, T, 2)
    shapes = {k: v.shape for k, v in batch.items()}
    kw = dict(num_layers=2, embed_dim=E, num_heads=2, impl="dense")
    init = _init(get_transformer_lm(vocab, **kw), shapes, 6)
    want, _ = _jax_ref(jax_lm(vocab, **kw), init, batch, 2, SGD)
    pp, out = _pipe(get_transformer_lm(vocab, pipeline_stages=2, **kw),
                    batch, init, _mesh({"dp": 2, "pp": 2}), 2, SGD,
                    num_microbatches=2, schedule=schedule)
    assert out.shape[0] == B
    _close(pp.get_params(), want)


def test_pipeline_multi_head():
    def build(pkg):
        data = pkg.symbol.Variable("data")
        fc1 = pkg.symbol.FullyConnected(data=data, name="fc1",
                                        num_hidden=16)
        r1 = pkg.symbol.Activation(data=fc1, act_type="relu", name="r1")
        with pkg.AttrScope(ctx_group="stage1"):
            fc2 = pkg.symbol.FullyConnected(data=r1, name="fc2",
                                            num_hidden=5)
            loss = pkg.symbol.SoftmaxOutput(data=fc2, name="softmax")
            probe = pkg.symbol.BlockGrad(data=fc2, name="probe")
        grouped = pkg.symbol.Group([loss, probe])
        for n in grouped._topo():
            if not n.is_var and n.attrs.get("ctx_group") is None:
                n.attrs["ctx_group"] = "stage0"
        return grouped

    B = 8
    rng = np.random.RandomState(3)
    batch = {"data": rng.randn(B, 12).astype(np.float32),
             "softmax_label": rng.randint(0, 5, (B,)).astype(np.float32)}
    sym = build(mx)
    init = _init(sym, {k: v.shape for k, v in batch.items()}, 4, 0.2)
    want, ref_outs = _jax_ref(build(jmx), init, batch, 2, SGD)
    pp, outs = _pipe(sym, batch, init, _mesh({"pp": 2}), 2, SGD,
                     num_microbatches=4)
    assert isinstance(outs, list) and len(outs) == 2
    _close(pp.get_params(), want)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(ref_outs[1]),
                               **TOL)


def _rank_bytes(pp, r):
    """Bytes of parameters and optimizer state pp rank ``r`` holds."""
    if pp.param_placement == "stage":
        ts = [pp.params["rows"][r]] + pp.opt_state["rows"][r].buffers()
        for n in pp.params["big"]:
            ts += [pp.params["big"][n][r]] \
                + pp.opt_state["big"][n][r].buffers()
    else:
        ts = [pp._flats[r]] + pp.opt_state[r].buffers()
    return sum(t.numel() * t.element_size() for t in ts)


def test_pipeline_per_stage_placement_memory_and_values(lm2):
    pp_s, _ = _pipe(lm2["staged"], lm2["batch"], lm2["init"],
                    _mesh({"pp": 2}), 2, SGD, num_microbatches=4)
    pp_r, _ = _pipe(lm2["staged"], lm2["batch"], lm2["init"],
                    _mesh({"pp": 2}), 2, SGD, num_microbatches=4,
                    param_placement="replicated")
    assert _rank_bytes(pp_s, 0) < 0.75 * _rank_bytes(pp_r, 0)
    _close(pp_s.get_params(), pp_r.get_params(), rtol=2e-5, atol=2e-6)
    _close(pp_r.get_params(), lm2["want"])


def test_pipeline_remat_matches_no_remat(lm2, monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    pp_r, _ = _pipe(lm2["staged"], lm2["batch"], lm2["init"],
                    _mesh({"pp": 2}), 2, SGD, num_microbatches=4)
    assert pp_r.remat
    pp_n, _ = _pipe(lm2["staged"], lm2["batch"], lm2["init"],
                    _mesh({"pp": 2}), 2, SGD, num_microbatches=4,
                    remat=False)
    _close(pp_r.get_params(), pp_n.get_params(), rtol=1e-5, atol=1e-6)
    with pytest.warns(UserWarning, match="inherent"):
        par.PipelineTrainer(lm2["staged"],
                            {k: v.shape for k, v in lm2["batch"].items()},
                            _mesh({"pp": 2}), schedule="1f1b", remat=True)


def test_pipeline_1f1b_matches_gpipe():
    """On pp=4 with the embedding and head pp-sharded (pp_shard_min_size
    64), and on dp=2 x pp=2 with dropout (1F1B's recompute replays the
    forward's masks)."""
    vocab, B, T, E = 11, 16, 12, 16
    batch = _lm_batch(vocab, B, T, 0)
    shapes = {k: v.shape for k, v in batch.items()}
    staged = get_transformer_lm(vocab, num_layers=4, embed_dim=E,
                                num_heads=2, impl="dense",
                                pipeline_stages=4)
    init = _init(staged, shapes, 3)
    runs = [_pipe(staged, batch, init, _mesh({"pp": 4}), 2, SGD,
                  num_microbatches=8, schedule=s, pp_shard_min_size=64)
            for s in ("gpipe", "1f1b")]
    assert runs[0][0]._big_meta
    assert runs[0][1].shape[0] == B
    _close(runs[1][0].get_params(), runs[0][0].get_params(), rtol=2e-5,
           atol=2e-6)
    np.testing.assert_allclose(runs[1][1].numpy(), runs[0][1].numpy(),
                               rtol=2e-5, atol=2e-6)
    staged2 = get_transformer_lm(vocab, num_layers=2, embed_dim=E,
                                 num_heads=2, impl="dense", dropout=0.2,
                                 pipeline_stages=2)
    init2 = _init(staged2, shapes, 4)
    got = [_pipe(staged2, batch, init2, _mesh({"dp": 2, "pp": 2}), 2, SGD,
                 num_microbatches=4, schedule=s)[0].get_params()
           for s in ("gpipe", "1f1b")]
    _close(got[1], got[0], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("M", [4, 32])
def test_pipeline_1f1b_activation_memory_bounded(M):
    """1F1B holds at most 2S - 1 boundary inputs per stage, whatever M."""
    vocab, T, E, S = 11, 8, 8, 2
    staged = get_transformer_lm(vocab, num_layers=2, embed_dim=E,
                                num_heads=2, impl="dense",
                                pipeline_stages=S)
    batch = _lm_batch(vocab, M, T, 4)
    pp, _ = _pipe(staged, batch, _init(staged, {k: v.shape for k, v
                                                in batch.items()}, 1),
                  _mesh({"pp": S}), 1, {"learning_rate": 0.1},
                  num_microbatches=M, schedule="1f1b")
    assert pp.max_in_flight == min(M, 2 * S - 1)


def test_pipeline_pp_sharded_big_params():
    vocab, B, T, E = 257, 8, 12, 16
    batch = _lm_batch(vocab, B, T, 1)
    shapes = {k: v.shape for k, v in batch.items()}
    sym = get_transformer_lm(vocab, num_layers=2, embed_dim=E, num_heads=2,
                             impl="dense", pipeline_stages=2)
    init = _init(sym, shapes, 3)
    mesh = _mesh({"pp": 2})
    pp_s, _ = _pipe(sym, batch, init, mesh, 2, SGD, num_microbatches=4)
    big = {m[0] for m in pp_s._big_meta}
    assert "embed_weight" in big and "lm_head_weight" in big
    # each rank stores half of the embedding
    assert pp_s.params["big"]["embed_weight"][0].numel() * 2 >= vocab * E
    pp_r, _ = _pipe(sym, batch, init, mesh, 2, SGD, num_microbatches=4,
                    param_placement="replicated")
    _close(pp_s.get_params(), pp_r.get_params(), rtol=2e-5, atol=2e-6)
    pp_pad, _ = _pipe(sym, batch, init, mesh, 2, SGD, num_microbatches=4,
                      pp_shard_min_size=None)
    assert not pp_pad._big_meta
    _close(pp_pad.get_params(), pp_r.get_params(), rtol=2e-5, atol=2e-6)
    assert len(pp_s.stage_param_bytes) == 2
    assert sum(pp_s.stage_param_bytes) >= 4 * vocab * E


def test_pipeline_imbalanced_memory_and_warning():
    def imbalanced():
        data = mx.symbol.Variable("data")
        with mx.AttrScope(ctx_group="stage0"):
            big = mx.symbol.FullyConnected(data=data, name="bigfc",
                                           num_hidden=512)
            a = mx.symbol.Activation(data=big, act_type="relu", name="a0")
        with mx.AttrScope(ctx_group="stage1"):
            small = mx.symbol.FullyConnected(data=a, name="smallfc",
                                             num_hidden=4)
            return mx.symbol.SoftmaxOutput(data=small, name="softmax")

    sym = imbalanced()
    rng = np.random.RandomState(0)
    batch = {"data": rng.randn(8, 32).astype(np.float32),
             "softmax_label": rng.randint(0, 4, (8,)).astype(np.float32)}

    def run(**kw):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            pp = par.PipelineTrainer(
                sym, {k: v.shape for k, v in batch.items()},
                _mesh({"pp": 2}), num_microbatches=4, optimizer="sgd",
                param_placement="stage",
                optimizer_params={"learning_rate": 0.1}, **kw)
            msgs = [str(w.message) for w in rec]
        pp.init_params()
        pp.step(batch)
        return pp, msgs

    pp_s, msgs_s = run()
    assert pp_s._big_meta
    assert not any("imbalanced" in m for m in msgs_s), msgs_s
    pp_pad, msgs_p = run(pp_shard_min_size=None)
    assert any("imbalanced" in m for m in msgs_p), msgs_p
    assert any("per-stage bytes" in m for m in msgs_p), msgs_p
    assert _rank_bytes(pp_s, 0) < 0.7 * _rank_bytes(pp_pad, 0)


def _compare_recomputes(pp, counts):
    """Wrap ``pp._stage`` so each 1F1B recompute (the call with grad on)
    is held against the outputs its forward (under no_grad) gave: adds
    the elements that differ to ``counts[0]`` and those compared to
    ``counts[1]``. A stage's backwards run in its forwards' order."""
    kept = collections.defaultdict(collections.deque)
    real = pp._stage

    def stage(s, x, inputs, params, gen, is_train=True):
        y, o = real(s, x, inputs, params, gen, is_train)
        vals = [y] if o is None else list(o)
        if not torch.is_grad_enabled():
            kept[s].append(vals)
            return y, o
        for a, f in zip(vals, kept[s].popleft()):
            counts[0] += (a.detach() != f).sum()
            counts[1] += f.numel()
        return y, o

    pp._stage = stage


def test_pipeline_recompute_replays_forward_draws():
    """With dropout, 1F1B's recompute of every stage gives the outputs its
    forward gave (each element compared), and GPipe under remat equals
    GPipe without it bit for bit: the recomputes take the forward's draws
    from its ``DrawTape`` and leave the generators as a plain step does."""
    vocab, B, T, E = 11, 8, 12, 16
    batch = _lm_batch(vocab, B, T, 2)
    shapes = {k: v.shape for k, v in batch.items()}
    staged = get_transformer_lm(vocab, num_layers=2, embed_dim=E,
                                num_heads=2, impl="dense", dropout=0.3,
                                pipeline_stages=2)
    init = _init(staged, shapes, 5)
    pp = par.PipelineTrainer(staged, shapes, _mesh({"pp": 2}),
                             optimizer="sgd", optimizer_params=SGD,
                             num_microbatches=4, schedule="1f1b")
    pp.init_params({k: v.copy() for k, v in init.items()})
    counts = torch.zeros(2, dtype=torch.int64)
    _compare_recomputes(pp, counts)
    for _ in range(2):
        pp.step(batch)
    assert int(counts[0]) == 0
    assert int(counts[1]) > 0
    runs = [_pipe(staged, batch, init, _mesh({"pp": 2}), 2, SGD,
                  num_microbatches=4, remat=r)[0].get_params()
            for r in (False, True)]
    assert set(runs[0]) == set(runs[1])
    for n, v in runs[0].items():
        assert np.array_equal(np.asarray(runs[1][n]), np.asarray(v)), n
