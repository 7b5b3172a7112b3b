"""The port's paged ``Decoder`` against the JAX package's.

A small LM — 2 layers, E=64, 4 heads with learned positions (here) and
its grouped-query rope variant (``test_torch_decode_gqa.py``) — gets the
same seeded numpy weights in both packages. In f32 the prefill logits agree
within atol 1e-4 (the projections and the attention sum in other
orders; the logits are O(1)) and greedy ``generate`` emits the same
tokens, for ``weight_dtype`` in {float, int8} x ``matmul_impl`` in
{pallas, fused}: on the CPU the port runs the kernels' plain versions,
the JAX package its Pallas kernels under the interpreter.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.parallel import Decoder

VOCAB, MAX_LEN, PROMPT, STEPS = 61, 32, 7, 12
MODELS = {
    "learned": dict(num_layers=2, embed_dim=64, num_heads=4),
    "gqa_rope": dict(num_layers=2, embed_dim=64, num_heads=4,
                     num_kv_heads=2, pos_encoding="rope"),
}
CONFIGS = [("float", "pallas", None), ("float", "fused", None),
           ("int8", "pallas", None), ("int8", "fused", None),
           ("int8", "pallas", "int8")]


def _init(rng, name, shape):
    """Fan-in-scaled weights, gains near 1: a random LM whose greedy
    streams vary (a flat uniform draw collapses them onto one token)."""
    if name.endswith("_gamma"):
        v = 1.0 + 0.1 * rng.randn(*shape)
    elif len(shape) == 2 and name != "pos_embed":
        v = 1.5 * rng.randn(*shape) / np.sqrt(shape[1])
    else:
        v = 0.1 * rng.randn(*shape)
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg in MODELS.items():
        with JaxNames():
            js = jax_lm(VOCAB, **cfg)
        with TorchNames():
            ts = torch_lm(VOCAB, **cfg)
        shapes, _, _ = js.infer_shape(data=(1, MAX_LEN),
                                      softmax_label=(1, MAX_LEN))
        rng = np.random.RandomState(4)
        params = {n: _init(rng, n, s)
                  for n, s in zip(js.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        prompt = rng.randint(0, VOCAB, (2, PROMPT)).astype(np.int32)
        out[name] = (js, ts, params, prompt)
    return out


def _pair(models, model, wd, mm, cache):
    js, ts, params, prompt = models[model]
    jd = JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                    max_len=MAX_LEN, attn_impl="paged", cache_block=None,
                    weight_dtype=wd, matmul_impl=mm, cache_dtype=cache)
    td = Decoder(ts, params, max_len=MAX_LEN, attn_impl="paged",
                 weight_dtype=wd, matmul_impl=mm, cache_dtype=cache,
                 device="cpu")
    return jd, td, prompt


def check_against_jax(models, model, wd, mm, cache):
    jd, td, prompt = _pair(models, model, wd, mm, cache)
    jl, _ = jd.prefill(jd.init_cache(2), prompt)
    tl, _ = td.prefill(td.init_cache(2), prompt)
    assert tl.shape == (2, PROMPT, VOCAB) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    jg = np.asarray(jd.generate(prompt, STEPS))
    tg = td.generate(prompt, STEPS).numpy()
    np.testing.assert_array_equal(tg, jg)
    assert len(set(tg[:, PROMPT:].ravel().tolist())) > 3


@pytest.mark.parametrize("wd,mm,cache", CONFIGS,
                         ids=["-".join(filter(None, c)) for c in CONFIGS])
def test_decoder_matches_jax(models, wd, mm, cache):
    check_against_jax(models, "learned", wd, mm, cache)


def test_fused_path_is_taken_only_when_eligible(models):
    """The fused kernel serves single-token steps of quantized weights on
    a float cache (the JAX package's rule); prefill chunks, float weights
    and an int8 cache go through paged_attention."""
    js, ts, params, prompt = models["learned"]
    calls = []
    orig = kernels.fused_decode_attention_plain

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    kernels.fused_decode_attention_plain = spy
    try:
        for wd, cache, want in (("int8", None, True), ("float", None, False),
                                ("int8", "int8", False)):
            d = Decoder(ts, params, max_len=MAX_LEN, weight_dtype=wd,
                        matmul_impl="fused", cache_dtype=cache,
                        device="cpu")
            calls.clear()
            caches = d.init_cache(2)
            _, caches = d.prefill(caches, prompt)
            assert not calls
            d.step(caches, PROMPT, torch.zeros(2, dtype=torch.int64))
            assert bool(calls) == want, (wd, cache)
            assert len(calls) == (2 if want else 0)
    finally:
        kernels.fused_decode_attention_plain = orig


def test_step_matches_generate(models):
    _, ts, params, prompt = models["gqa_rope"]
    d = Decoder(ts, params, max_len=MAX_LEN, weight_dtype="int8",
                matmul_impl="fused", device="cpu")
    want = d.generate(prompt, 4)
    caches = d.init_cache(2)
    logits, caches = d.prefill(caches, prompt)
    tok = logits[:, -1].argmax(-1)
    got = [tok]
    for i in range(3):
        logits, caches = d.step(caches, PROMPT + i, tok)
        tok = logits.argmax(-1)
        got.append(tok)
    assert torch.equal(torch.stack(got, 1), want[:, PROMPT:])


def test_sampled_generate_follows_its_generator(models):
    _, ts, params, prompt = models["learned"]
    d = Decoder(ts, params, max_len=MAX_LEN, device="cpu")
    runs = [d.generate(prompt, 6, rng=torch.Generator().manual_seed(s),
                       temperature=1.0)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, PROMPT + 6)


def test_bf16_compute_dtype(models):
    _, ts, params, prompt = models["learned"]
    d = Decoder(ts, params, max_len=MAX_LEN, compute_dtype="bfloat16",
                weight_dtype="int8", matmul_impl="fused", device="cpu")
    caches = d.init_cache(2)
    assert caches[0][0].dtype == torch.bfloat16
    logits, _ = d.prefill(caches, prompt)
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("kw", [
    dict(attn_impl="dense"), dict(matmul_impl="triton"),
    dict(weight_dtype="int2"), dict(cache_dtype="int32"),
    dict(max_len=MAX_LEN + 1)])
def test_decoder_rejects(models, kw):
    _, ts, params, _ = models["learned"]
    args = dict(max_len=MAX_LEN, device="cpu")
    args.update(kw)
    with pytest.raises(MXNetError):
        Decoder(ts, params, **args)


def test_decoder_rejects_unported_graphs(models):
    _, ts, params, _ = models["learned"]
    with pytest.raises(MXNetError, match="missing"):
        Decoder(ts, {k: v for k, v in params.items()
                     if k != "lm_head_weight"}, max_len=MAX_LEN,
                device="cpu")
    with TorchNames():
        win = torch_lm(VOCAB, num_layers=1, embed_dim=16, num_heads=2,
                       window=4)
    with pytest.raises(MXNetError, match="windowed"):
        Decoder(win, {}, max_len=8, device="cpu")


def test_device_none_without_cuda_raises(models):
    _, ts, params, _ = models["learned"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    with pytest.raises(MXNetError, match="CUDA"):
        Decoder(ts, params, max_len=MAX_LEN)
