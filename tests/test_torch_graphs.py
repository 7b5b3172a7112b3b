"""The port's compiled-program layer (``mxnet_tpu_torch.parallel.program``)
against the JAX package's contracts, on the CPU.

* The serving engine runs every request mix through one decode program
  and one prefill program per used bucket: after a mixed workload (three
  buckets, greedy and sampled requests, one that stops on EOS)
  ``tests/check_utils.py``'s ``assert_compile_contract`` passes on the
  port's engine, and its ``compile_counts`` equals the JAX engine's on the
  same workload.
* The buffers a CUDA graph captures keep their addresses: the engine's
  slot state, caches and program operands across rounds and admissions;
  the trainer's flat parameters, optimizer state, aux states, learning
  rate and input buffers across ``step``, ``multi_step`` and
  ``set_params``.
* ``multi_step(batch, 5)`` equals five ``step()`` calls bitwise under a
  ``FactorScheduler``, and the JAX package's ``multi_step`` on
  ``tests/test_parallel.py``'s MLP at rtol 2e-4, atol 2e-5 (the
  tolerance ``tests/test_torch_train.py`` holds the port's trainer to
  against the JAX trainer: f32 on both sides, sums in other orders).
* The device sampler is a pure function of (seed, position): equal inputs
  give equal tokens whatever shares the batch, greedy rows are the
  argmax, and token frequencies over many positions match the softmax
  probabilities (a chi-square statistic below the 0.999 quantile of its
  distribution).

1-2 layer models, module-scoped.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jax_lrs
from mxnet_tpu import parallel as jax_par
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import InferenceEngine as JaxEngine

import mxnet_tpu_torch.symbol as S
from mxnet_tpu_torch import lr_scheduler as T_lrs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder, ParallelTrainer
from mxnet_tpu_torch.parallel.decode import sample_tokens, uniform_draw
from mxnet_tpu_torch.parallel.program import Program
from mxnet_tpu_torch.serving import InferenceEngine

from check_utils import assert_compile_contract

VOCAB, MAX_LEN, BUCKETS = 53, 32, (4, 8, 16)
CFG = dict(num_layers=2, embed_dim=32, num_heads=4)
# the prefix cache and chunked prefill off, as in the JAX engine below
ENGINE = dict(slots=2, prefill_buckets=BUCKETS, steps_per_round=2,
              weight_dtype="int8", matmul_impl="fused", prefix_cache_mb=0,
              prefill_chunk=0)
# (prompt length, max_tokens, temperature, seed): every bucket, slot
# reuse, greedy and sampled requests; request EOS_REQUEST stops on EOS
REQUESTS = [(3, 6, 0.0, 0), (7, 9, 0.0, 0), (12, 5, 0.8, 7),
            (4, 8, 1.3, 2), (16, 6, 0.0, 0), (1, 4, 0.9, 11)]
EOS_REQUEST = 1
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
# the 0.999 quantile of the chi-square distribution with 5 degrees of
# freedom (scipy.stats.chi2.ppf(0.999, 5))
CHI2_999_DOF5 = 20.515


@pytest.fixture(scope="module")
def lm():
    with JaxNames():
        js = jax_lm(VOCAB, **CFG)
    with TorchNames():
        ts = torch_lm(VOCAB, **CFG)
    shapes, _, _ = js.infer_shape(data=(1, MAX_LEN),
                                  softmax_label=(1, MAX_LEN))
    rng = np.random.RandomState(11)
    params = {}
    for n, s in zip(js.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.randn(*s)
        elif len(s) == 2 and n != "pos_embed":
            v = 1.5 * rng.randn(*s) / np.sqrt(s[1])
        else:
            v = 0.1 * rng.randn(*s)
        params[n] = v.astype(np.float32)
    prompts = [rng.randint(0, VOCAB, (p,)) for p, _, _, _ in REQUESTS]
    return js, ts, params, prompts


@pytest.fixture(scope="module")
def port_decoder(lm):
    _, ts, params, _ = lm
    return Decoder(ts, params, max_len=MAX_LEN, attn_impl="paged",
                   weight_dtype="int8", matmul_impl="fused", device="cpu")


def _submit_all(engine, prompts, eos_id):
    return [engine.submit(p, max_tokens=n, temperature=t, seed=sd,
                          eos_id=eos_id if i == EOS_REQUEST else None)
            for i, (p, (_, n, t, sd)) in enumerate(zip(prompts, REQUESTS))]


def _engine_buffers(engine):
    bufs = list(engine._state())
    for entry in engine._caches + engine._stage:
        bufs.extend(entry)
    for prog in engine._programs.values():
        bufs.extend(prog.operands.values())
    return [b.data_ptr() for b in bufs]


@pytest.fixture(scope="module")
def served(lm, port_decoder):
    """The mixed workload through the port's engine, the data pointers of
    its buffers after the first admission and at the end, and the EOS id
    (the third token of request EOS_REQUEST's offline greedy stream)."""
    prompts = lm[3]
    eos_id = int(port_decoder.generate(prompts[EOS_REQUEST][None], 3)[
        0, len(prompts[EOS_REQUEST]) + 2])
    eng = InferenceEngine(port_decoder, **ENGINE)
    handles = _submit_all(eng, prompts, eos_id)
    eng.step()
    first = _engine_buffers(eng)
    while not eng.idle:
        eng.step()
    return eng, handles, first, eos_id


def test_engine_compile_contract(served):
    eng, handles, _, _ = served
    cc = assert_compile_contract(eng)
    assert cc == {"decode": 1, "verify": 0,
                  "prefill": {b: 1 for b in BUCKETS}, "copy": {}}
    assert all(h.done for h in handles)
    assert handles[EOS_REQUEST].retire_reason == "eos"
    assert eng.stats["prefills"] == len(REQUESTS)
    assert eng.stats["steps"] > len(eng._programs)


def test_engine_compile_counts_equal_jax(lm, served):
    js, _, params, prompts = lm
    eng, _, _, eos_id = served
    jeng = JaxEngine(
        JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                   max_len=MAX_LEN, cache_block=None),
        attn_impl="paged", **ENGINE)
    _submit_all(jeng, prompts, eos_id)
    jeng.serve_forever()
    assert eng.compile_counts == jeng.compile_counts


def test_engine_buffers_keep_their_addresses(served):
    """Slot state, caches and the prefill operands are where the first
    round left them after every later round and admission (the programs
    built later append theirs at the end)."""
    eng, _, first, _ = served
    assert _engine_buffers(eng)[:len(first)] == first
    assert len(_engine_buffers(eng)) > len(first)


def test_engine_sampled_streams_follow_seed_and_position(lm, port_decoder):
    """A sampled request's stream depends on its seed: alone or beside
    others it is the same; another seed gives another stream; a greedy
    request beside sampled ones equals its offline greedy stream."""
    prompts = lm[3]
    alone = InferenceEngine(port_decoder, **ENGINE)
    r = alone.submit(prompts[2], max_tokens=8, temperature=1.5, seed=3)
    other = alone.submit(prompts[2], max_tokens=8, temperature=1.5, seed=4)
    while not alone.idle:
        alone.step()
    busy = InferenceEngine(port_decoder, **ENGINE)
    g = busy.submit(prompts[0], max_tokens=6)
    busy.submit(prompts[3], max_tokens=5, temperature=0.7, seed=9)
    r2 = busy.submit(prompts[2], max_tokens=8, temperature=1.5, seed=3)
    while not busy.idle:
        busy.step()
    assert r.tokens == r2.tokens and len(r.tokens) == 8
    assert r.tokens != other.tokens
    ref = port_decoder.generate(prompts[0][None], 6)[0, len(prompts[0]):]
    assert g.tokens == ref.tolist()


@pytest.mark.parametrize("kw", [dict(ops=np.zeros(3, np.int64)),
                                dict(nope=np.zeros(4, np.int64))])
def test_program_refuses_misshapen_operands(kw):
    prog = Program(lambda: None, {"ops": torch.zeros(4, dtype=torch.int64)},
                   name="p")
    with pytest.raises(MXNetError, match="p: "):
        prog(**kw)


def test_program_logs_one_build_and_runs_over_its_buffers():
    log = []
    buf = torch.zeros(3)
    acc = torch.zeros(3)

    def fn():
        acc.add_(buf)
        return acc

    prog = Program(fn, {"x": buf}, mutable=[acc], tag=("t", 3), log=log)
    for i in range(3):
        out = prog(x=np.full(3, i + 1.0, np.float32))
    assert log == [("t", 3)]
    assert out is acc and buf.data_ptr() == prog.operands["x"].data_ptr()
    assert acc.tolist() == [6.0, 6.0, 6.0]
    prog._run_eager(x=torch.ones(3))
    assert acc.tolist() == [7.0, 7.0, 7.0] and log == [("t", 3)]


# -- the device sampler -------------------------------------------------------

def test_sampler_is_a_function_of_seed_and_position():
    rng = np.random.RandomState(0)
    row = torch.from_numpy(rng.randn(1, 40).astype(np.float32))
    logits = torch.cat([row, torch.from_numpy(
        rng.randn(5, 40).astype(np.float32)), row])
    temp = torch.tensor([0.9, 1.0, 0.0, 2.0, 0.5, 0.0, 0.9])
    seed = torch.tensor([5, 1, 2, 3, 4, 9, 5])
    pos = torch.tensor([17, 3, 3, 3, 3, 8, 17], dtype=torch.int32)
    got = sample_tokens(logits, temp, uniform_draw(seed, pos))
    assert got[0] == got[6]
    # alone, the first row draws the same token
    assert sample_tokens(row, temp[:1],
                         uniform_draw(seed[:1], pos[:1]))[0] == got[0]
    greedy = temp == 0
    assert torch.equal(got[greedy], logits[greedy].argmax(-1))
    # the uniform draws differ across seeds and across positions
    u = uniform_draw(torch.tensor([5, 5, 6, 2 ** 40 + 5]),
                     torch.tensor([17, 18, 17, 17]))
    assert len(set(u.tolist())) == 4 and bool(((u > 0) & (u < 1)).all())


def test_sampler_frequencies_match_softmax():
    """6000 positions of one seed over a fixed 6-token row at temperature
    0.7: the chi-square statistic of the token counts against
    softmax(logits / 0.7) stays below its 0.999 quantile."""
    n, logits = 6000, torch.tensor([1.0, 0.2, -0.5, 0.7, 0.0, -1.5])
    probs = torch.softmax(logits / 0.7, -1).double()
    got = sample_tokens(logits.expand(n, 6), torch.full((n,), 0.7),
                        uniform_draw(torch.tensor(12345), torch.arange(n)))
    counts = torch.bincount(got, minlength=6).double()
    chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
    assert chi2 < CHI2_999_DOF5, (chi2, counts.tolist())


# -- the trainer's step program ----------------------------------------------

def _conv_bn_net(sym):
    data = sym.Variable("data")
    x = sym.Convolution(data=data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                        name="conv")
    x = sym.BatchNorm(data=x, name="bn")
    x = sym.Activation(data=x, act_type="relu", name="relu")
    x = sym.FullyConnected(data=sym.Flatten(data=x), num_hidden=10,
                           name="fc")
    return sym.SoftmaxOutput(data=x, name="softmax")


def _mlp(sym):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data=data, name="fc1", num_hidden=32)
    act = sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(data=act, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(data=fc2, name="softmax")


def _mlp_setup():
    """tests/test_parallel.py's test_multi_step_matches_steps: its MLP,
    batch and initial weights."""
    rng = np.random.RandomState(3)
    batch = {"data": rng.randn(16, 64).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (16,)).astype(np.float32)}
    shapes = {k: v.shape for k, v in batch.items()}
    jsym = _mlp(mx.symbol)
    arg_shapes, _, _ = jsym.infer_shape(**shapes)
    init_rng = np.random.RandomState(7)
    init = {n: init_rng.uniform(-0.07, 0.07, s).astype("f")
            for n, s in zip(jsym.list_arguments(), arg_shapes)
            if n not in shapes}
    return jsym, shapes, batch, init


def _port_mlp_trainer(shapes, init):
    # a fresh scheduler per trainer: FactorScheduler is stateful
    sched = T_lrs.FactorScheduler(step=2, factor=0.5)
    tr = ParallelTrainer(
        _mlp(S), shapes, optimizer="sgd", seed=11,
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                          "lr_scheduler": sched}, device="cpu")
    return tr.init_params(init)


def test_multi_step_equals_steps_bitwise():
    _, shapes, batch, init = _mlp_setup()
    looped = _port_mlp_trainer(shapes, init)
    for _ in range(5):
        looped.step(batch)
    fused = _port_mlp_trainer(shapes, init)
    assert fused.multi_step(batch, 5) is None
    assert fused._t == looped._t == 5
    assert fused._lr.item() == looped._lr.item() == np.float32(0.025)
    want, _ = looped.get_params()
    got, _ = fused.get_params()
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_multi_step_matches_jax():
    jsym, shapes, batch, init = _mlp_setup()
    sched = jax_lrs.FactorScheduler(step=2, factor=0.5)
    jtr = jax_par.ParallelTrainer(
        jsym, shapes, optimizer="sgd", mesh=jax_par.data_parallel_mesh(1),
        seed=11, optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                   "lr_scheduler": sched})
    jtr.init_params({n: mx.nd.array(v) for n, v in init.items()})
    jtr.multi_step(batch, 5)
    want, _ = jtr.get_params()
    tr = _port_mlp_trainer(shapes, init)
    tr.multi_step(batch, 5)
    got, _ = tr.get_params()
    assert tr._t == jtr._t == 5
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].asnumpy(),
                                   err_msg=n, **PARAM_TOL)


def test_trainer_buffers_keep_their_addresses():
    shapes = {"data": (4, 3, 6, 6), "softmax_label": (4,)}
    rng = np.random.RandomState(0)
    batch = {"data": rng.randn(*shapes["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (4,)).astype(np.int32)}
    tr = ParallelTrainer(_conv_bn_net(S), shapes, optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9},
                         seed=1, device="cpu")
    tr.step(batch)

    def ptrs():
        bufs = [tr._flat, tr._lr, tr._tdev] + tr._state.buffers() \
            + list(tr.aux) \
            + list(tr._program.operands.values())
        return [b.data_ptr() for b in bufs]

    first, prog = ptrs(), tr._program
    aux0 = [a.clone() for a in tr.aux]
    out = tr.step(batch)
    tr.multi_step(batch, 3)
    assert not torch.equal(aux0[0], tr.aux[0])   # the moving mean moved
    arg, aux = tr.get_params()
    tr.set_params(arg, aux)
    assert tr._t == 0
    tr.step(batch)
    assert ptrs() == first and tr._program is prog
    # the outputs of a step are copies that later steps leave alone
    assert out[0].data_ptr() not in first
    assert len(tr.params) == 6 and tr.params["conv_weight"].data_ptr() \
        == tr._flat.data_ptr()


def test_trainer_step_refuses_another_batch_shape():
    _, shapes, batch, init = _mlp_setup()
    tr = _port_mlp_trainer(shapes, init)
    tr.step(batch)
    with pytest.raises(MXNetError, match="shape"):
        tr.step({k: v[:8] for k, v in batch.items()})
    with pytest.raises(MXNetError, match="missing input"):
        tr.multi_step({"data": batch["data"]}, 2)
