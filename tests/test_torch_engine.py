"""The slice as a whole: the port's ``InferenceEngine`` against the JAX
package's.

Both engines serve the same 2-layer LM (seeded numpy weights) in the
configuration the port serves on the card — paged attention, int8
weights, ``matmul_impl="fused"`` — in f32, with 2 slots so that later
requests reuse freed slots, prompts spread over three prefill buckets and
one request that stops on EOS. Greedy token streams must be EQUAL: the
two run the same quantized arithmetic (the JAX package's Pallas kernels
under the interpreter, the port's plain versions), and the logits of
this LM are far from ties.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import InferenceEngine as JaxEngine

from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import InferenceEngine

VOCAB, MAX_LEN, BUCKETS = 53, 32, (4, 8, 16)
CFG = dict(num_layers=2, embed_dim=32, num_heads=4)
ENGINE = dict(slots=2, prefill_buckets=BUCKETS, steps_per_round=2,
              weight_dtype="int8", matmul_impl="fused")
# (prompt length, max_tokens): every bucket, slot reuse, a budget that
# runs into max_len, and one request (index 1) that stops on EOS
REQUESTS = [(3, 6), (7, 9), (12, 5), (4, 8), (16, 20), (1, 4)]
EOS_REQUEST = 1


def _init(rng, name, shape):
    """Fan-in-scaled weights, gains near 1 (varied greedy streams)."""
    if name.endswith("_gamma"):
        v = 1.0 + 0.1 * rng.randn(*shape)
    elif len(shape) == 2 and name != "pos_embed":
        v = 1.5 * rng.randn(*shape) / np.sqrt(shape[1])
    else:
        v = 0.1 * rng.randn(*shape)
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def lm():
    with JaxNames():
        js = jax_lm(VOCAB, **CFG)
    with TorchNames():
        ts = torch_lm(VOCAB, **CFG)
    shapes, _, _ = js.infer_shape(data=(1, MAX_LEN),
                                  softmax_label=(1, MAX_LEN))
    rng = np.random.RandomState(11)
    params = {n: _init(rng, n, s)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    prompts = [rng.randint(0, VOCAB, (p,)) for p, _ in REQUESTS]
    return js, ts, params, prompts


@pytest.fixture(scope="module")
def port_decoder(lm):
    _, ts, params, _ = lm
    return Decoder(ts, params, max_len=MAX_LEN, attn_impl="paged",
                   weight_dtype="int8", matmul_impl="fused", device="cpu")


@pytest.fixture(scope="module")
def eos_id(lm, port_decoder):
    """The third token of request EOS_REQUEST's offline greedy stream."""
    prompt = lm[3][EOS_REQUEST]
    out = port_decoder.generate(prompt[None], 3)
    return int(out[0, len(prompt) + 2])


def _serve_port(engine, prompts, eos_id):
    handles = [engine.submit(p, max_tokens=n,
                             eos_id=eos_id if i == EOS_REQUEST else None)
               for i, (p, (_, n)) in enumerate(zip(prompts, REQUESTS))]
    done = []
    while not engine.idle:
        done.extend(engine.step())
    return handles, done


def test_engine_streams_equal_jax(lm, port_decoder, eos_id):
    js, _, params, prompts = lm
    jeng = JaxEngine(
        JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                   max_len=MAX_LEN, cache_block=None),
        prefix_cache_mb=0, prefill_chunk=0, attn_impl="paged", **ENGINE)
    jreqs = [jeng.submit(p, max_tokens=n,
                         eos_id=eos_id if i == EOS_REQUEST else None)
             for i, (p, (_, n)) in enumerate(zip(prompts, REQUESTS))]
    jeng.serve_forever()
    teng = InferenceEngine(port_decoder, **ENGINE)
    treqs, done = _serve_port(teng, prompts, eos_id)
    assert sorted(r.id for r in done) == list(range(len(REQUESTS)))
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.result(), j.result())
        assert t.retire_reason == j.retire_reason
    assert treqs[EOS_REQUEST].retire_reason == "eos"
    assert treqs[EOS_REQUEST].tokens[-1] == eos_id
    assert len(treqs[EOS_REQUEST].tokens) == 3
    # the request that runs into max_len stops at the cache's end
    assert len(treqs[4].tokens) == MAX_LEN - 16
    assert teng.stats["prefills"] == len(REQUESTS)


def test_engine_streams_equal_offline_generate(lm, port_decoder):
    """Slot reuse, bucket padding and batching leave each greedy stream
    what the offline decoder emits for the request alone."""
    prompts = lm[3]
    eng = InferenceEngine(port_decoder, **ENGINE)
    handles, _ = _serve_port(eng, prompts, None)
    for h, p in zip(handles, prompts):
        ref = port_decoder.generate(p[None], len(h.tokens))[0, len(p):]
        assert ref.tolist() == h.tokens
        assert h.retire_reason == "length"


def test_engine_over_float_decoder_and_checkpoint(lm, tmp_path):
    """from_checkpoint builds the same engine as a hand-built decoder,
    and an engine over a float decoder quantizes its own copy."""
    _, ts, params, prompts = lm
    prefix = str(tmp_path / "lm")
    tmodel.save_checkpoint(prefix, 0, ts, params, {})
    a = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, attn_impl="paged", device="cpu",
        **ENGINE)
    fdec = Decoder(ts, params, max_len=MAX_LEN, device="cpu")
    b = InferenceEngine(fdec, **ENGINE)
    assert a.matmul_impl == b.matmul_impl == "fused"
    assert a.weight_bytes == b.weight_bytes
    assert fdec.weight_dtype == "float"
    ha, _ = _serve_port(a, prompts[:3], None)
    hb, _ = _serve_port(b, prompts[:3], None)
    assert [h.tokens for h in ha] == [h.tokens for h in hb]


def test_sampled_streams_do_not_depend_on_schedule(lm, port_decoder):
    prompts = lm[3]
    alone = InferenceEngine(port_decoder, **ENGINE)
    r = alone.submit(prompts[2], max_tokens=6, temperature=0.8, seed=7)
    while not alone.idle:
        alone.step()
    busy = InferenceEngine(port_decoder, **ENGINE)
    for p in prompts[:2]:
        busy.submit(p, max_tokens=5)
    r2 = busy.submit(prompts[2], max_tokens=6, temperature=0.8, seed=7)
    busy.submit(prompts[3], max_tokens=4, temperature=1.3, seed=1)
    while not busy.idle:
        busy.step()
    assert r.tokens == r2.tokens and len(r.tokens) == 6


@pytest.mark.parametrize("bad", [
    dict(prompt=np.zeros((2, 3), np.int64)), dict(prompt=[]),
    dict(prompt=[0.5, 1.0]), dict(prompt=np.zeros(MAX_LEN, np.int64)),
    dict(prompt=np.zeros(17, np.int64)), dict(max_tokens=0),
    dict(eos_id=-1), dict(eos_id=[1]), dict(temperature=-1.0),
    dict(temperature=float("nan"))])
def test_submit_validation(port_decoder, bad):
    eng = InferenceEngine(port_decoder, **ENGINE)
    kw = dict(prompt=[1, 2, 3], max_tokens=3)
    kw.update(bad)
    with pytest.raises(MXNetError):
        eng.submit(**kw)
    assert eng.queued() == 0 and eng.idle


def test_max_queue_backpressure(port_decoder):
    eng = InferenceEngine(port_decoder, max_queue=2, **ENGINE)
    eng.submit([1, 2], max_tokens=2)
    eng.submit([3], max_tokens=2)
    with pytest.raises(MXNetError, match="queue is full"):
        eng.submit([4], max_tokens=2)
    assert eng.queued() == 2
    eng.step()                  # both admitted: the queue drains
    assert eng.queued() == 0
    eng.submit([4], max_tokens=2)
    done = []
    while not eng.idle:
        done.extend(eng.step())
    assert len(done) == 3 and all(r.done for r in done)


@pytest.mark.parametrize("kw", [dict(slots=0), dict(steps_per_round=0),
                                dict(prefill_buckets=(8, 4)),
                                dict(prefill_buckets=(64,)),
                                dict(attn_impl="dense"),
                                dict(matmul_impl="cutlass"),
                                dict(weight_dtype="int4")])
def test_engine_rejects(port_decoder, kw):
    args = dict(ENGINE)
    args.update(kw)
    with pytest.raises(MXNetError):
        InferenceEngine(port_decoder, **args)


def test_device_none_without_cuda_raises(lm):
    _, ts, params, _ = lm
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    with pytest.raises(MXNetError, match="CUDA"):
        Decoder(ts, params, max_len=MAX_LEN)
    with pytest.raises(MXNetError, match="CUDA"):
        tmodel.params_from_numpy(params, None)
