"""The port's public callables take the JAX package's parameters, by name
and in order, so that a call written for one package binds the same way
in the other. The port's own parameters (``device``) may follow them, and
only keyword-only. A parameter the port accepts but has not implemented
yet raises its "later slice" ``MXNetError`` when set to anything but the
default. Small 1-layer models, on the CPU.
"""
import inspect

import numpy as np
import pytest
import torch

import mxnet_tpu.model as jax_model
import mxnet_tpu.optimizer as jax_opt
from mxnet_tpu.models import transformer as jax_transformer
from mxnet_tpu.ops import pallas_kernels as jax_kernels
from mxnet_tpu.parallel import decode as jax_decode
from mxnet_tpu.parallel import graph as jax_graph
from mxnet_tpu.parallel import ring as jax_ring
from mxnet_tpu.parallel import sp as jax_sp
from mxnet_tpu.parallel import trainer as jax_trainer
from mxnet_tpu.serving import engine as jax_engine

import mxnet_tpu_torch.model as tmodel
import mxnet_tpu_torch.optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.initializer import Uniform
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.ops import kernels as tkernels
from mxnet_tpu_torch.parallel import decode as tdecode
from mxnet_tpu_torch.parallel import graph as tgraph
from mxnet_tpu_torch.parallel import ring as tring
from mxnet_tpu_torch.parallel import sp as tsp
from mxnet_tpu_torch.parallel import trainer as ttrainer
from mxnet_tpu_torch.serving import engine as tengine

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
    ("make_graph_fn", jax_graph.make_graph_fn, tgraph.make_graph_fn),
    ("striped_ring_attention", jax_ring.striped_ring_attention,
     tring.striped_ring_attention),
] + [(name, getattr(jax_kernels, name), getattr(tkernels, name))
     for name in ("flash_attention", "striped_pair_attention",
                  "fused_linear", "fused_conv_bn_act", "matmul_stats",
                  "paged_attention", "quant_matmul",
                  "fused_decode_attention")]


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
    with pytest.raises(MXNetError, match="later slice"):
        tdecode.Decoder(symbol, params, T, None, None, 8, device="cpu")


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


ENGINE_UNPORTED = [
    ("stage_depth", 3),
    ("overload", "shed"), ("round_timeout_ms", 100.0),
    ("slo_ttft_ms", 50.0), ("slo_cadence_ms", 5.0), ("slo_target", 0.9),
    ("flight_recorder", 16), ("capture_dir", "cap"),
    ("capture_mb", 8), ("tp", 2), ("mesh", object()), ("ep", 2),
    ("engine_id", "e0"), ("migrated_from", "e1"), ("role", "prefill"),
    ("handoff_dtype", "int8")]


@pytest.mark.parametrize("param,value", ENGINE_UNPORTED,
                         ids=[p for p, _ in ENGINE_UNPORTED])
def test_engine_unported_parameters_raise(decoder, param, value):
    with pytest.raises(MXNetError, match="later slice"):
        tengine.InferenceEngine(decoder, **{param: value})


def _lm_unported(kw):
    return lambda lm: get_transformer_lm(VOCAB, num_layers=1, embed_dim=16,
                                         num_heads=2, **kw)


def _save(tmp_path, lm):
    symbol, _, params = lm
    tmodel.save_checkpoint(str(tmp_path / "m"), 0, symbol,
                           {k: torch.from_numpy(v) for k, v in params.items()},
                           {}, optimizer_states={"momentum": 0})


OTHER_UNPORTED = {
    "pipeline_stages": _lm_unported(dict(pipeline_stages=2)),
    "moe_top_k": _lm_unported(dict(moe_top_k=2)),
    "num_experts": _lm_unported(dict(num_experts=4)),
    "cache_block": lambda lm: tdecode.Decoder(lm[0], lm[2], T,
                                              cache_block=128, device="cpu"),
    "attn_impl_dense": lambda lm: tdecode.Decoder(
        lm[0], lm[2], T, attn_impl="dense", device="cpu"),
    "trainer_mesh": lambda lm: ttrainer.ParallelTrainer(
        lm[0], lm[1], "sgd", object(), device="cpu"),
    "trainer_remat": lambda lm: ttrainer.ParallelTrainer(
        lm[0], lm[1], remat=True, device="cpu"),
}


@pytest.mark.parametrize("case", sorted(OTHER_UNPORTED))
def test_other_unported_parameters_raise(lm, case):
    with pytest.raises(MXNetError, match="later slice"):
        OTHER_UNPORTED[case](lm)


def test_save_checkpoint_optimizer_states_raise(tmp_path, lm):
    with pytest.raises(MXNetError, match="later slice"):
        _save(tmp_path, lm)
    assert not list(tmp_path.iterdir())


# the engine's view of the reuse and speculation parameters:
# (prefix_cache_mb, prefill_chunk, spec_k, draft, the draft decoder)
def _resolved(eng):
    return (eng.prefix_cache_mb, eng.prefill_chunk, eng.spec_k,
            eng.spec_draft, eng._draft_dec)


SERVING_ENV = ("MXNET_SERVING_PREFIX_CACHE_MB", "MXNET_SERVING_PREFILL_CHUNK",
               "MXNET_SERVING_SPEC_K", "MXNET_SERVING_DRAFT")


@pytest.fixture
def jax_engine_defaults(monkeypatch):
    """What the JAX engine resolves the reuse and speculation parameters
    to, under the current environment (a 1-layer LM of its own)."""
    import jax.numpy as jnp
    from mxnet_tpu.name import NameManager

    with NameManager():
        sym = jax_transformer.get_transformer_lm(VOCAB, num_layers=1,
                                                 embed_dim=16, num_heads=2)
    arg_shapes, _, _ = sym.infer_shape(data=(1, T), softmax_label=(1, T))
    params = {n: jnp.zeros(s, jnp.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}

    def resolve():
        return _resolved(jax_engine.InferenceEngine(
            jax_decode.Decoder(sym, params, T, cache_block=None), 2))
    return resolve


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
