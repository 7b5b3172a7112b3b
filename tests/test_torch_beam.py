"""``Decoder.beam_search`` on the port against the JAX package's.

A small LM (2 layers, E=16, 2 heads, vocab 11, max_len 12) gets the same
seeded numpy weights in both packages. The port's beam search (an eager
loop over a folded [B*K] batch, the cache rows following their parents)
returns the JAX sequences exactly and scores within 1e-5 (f32), with and
without ``eos_id`` and ``length_penalty``, at a beam wider than the
vocabulary, over the paged, dense and windowed (int8 ring) reads. Ties
break as ``lax.top_k`` breaks them: frozen beams tie at ``-1e30``.
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
from mxnet_tpu_torch.parallel import Decoder

VOCAB, T, P, STEPS = 11, 12, 3, 6
TOL = 1e-5


def _lm(**extra):
    cfg = dict(num_layers=2, embed_dim=16, num_heads=2, **extra)
    with JaxNames():
        js = jax_lm(VOCAB, impl="dense", **cfg)
    with TorchNames():
        ts = torch_lm(VOCAB, **cfg)
    shapes, _, _ = js.infer_shape(data=(1, T), softmax_label=(1, T))
    rng = np.random.RandomState(13)
    params = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return js, ts, params


@pytest.fixture(scope="module")
def lms():
    plain = _lm()
    return {"plain": plain, "window": _lm(window=4)}


@pytest.fixture(scope="module")
def prompt():
    return np.random.RandomState(5).randint(0, VOCAB, (2, P))


def _pair(lms, model, **kw):
    js, ts, params = lms[model]
    jd = JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                    max_len=T, attn_impl="dense", cache_block=None,
                    cache_dtype=kw.get("cache_dtype"))
    return jd, Decoder(ts, params, max_len=T, device="cpu", **kw)


def _eos(jd, prompt):
    """The token the best beam emits at the second step: an EOS that
    finishes beams mid-search."""
    seqs, _ = jd.beam_search(prompt, STEPS, beam_size=3)
    return int(np.asarray(seqs)[0, 0, P + 1])


SEARCHES = [("paged", 3, False, 0.0), ("paged", 3, True, 0.0),
            ("paged", 4, True, 1.0), ("paged", VOCAB + 2, True, 0.0),
            ("dense", 3, True, 0.6), ("window", 4, True, 0.0)]


@pytest.mark.parametrize("read,beam,eos,lp", SEARCHES,
                         ids=["%s-k%d-%s-lp%g" % (r, b, "eos" if e else "noeos",
                                                  lp)
                              for r, b, e, lp in SEARCHES])
def test_beam_search_matches_jax(lms, prompt, read, beam, eos, lp):
    """Sequences equal and scores within 1e-5 of the JAX dense decoder's
    beam search (the paged and dense reads compute the same attention;
    the windowed LM with an int8 ring against JAX's int8 ring)."""
    kw = {"paged": dict(attn_impl="paged"),
          "dense": dict(attn_impl="dense", cache_block=4),
          "window": dict(cache_dtype="int8")}[read]
    jd, td = _pair(lms, "window" if read == "window" else "plain", **kw)
    eos_id = _eos(jd, prompt) if eos else None
    js_, jsc = jd.beam_search(prompt, STEPS, beam, eos_id=eos_id,
                              length_penalty=lp)
    ts_, tsc = td.beam_search(prompt, STEPS, beam, eos_id=eos_id,
                              length_penalty=lp)
    assert ts_.shape == (2, beam, P + STEPS) and tsc.shape == (2, beam)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0,
                               atol=TOL)
    if eos:
        # some beam finished: EOS, then only pad zeros
        seqs = ts_.numpy()
        fin = [(b, i) for b in range(2) for i in range(beam)
               if eos_id in seqs[b, i, P:-1].tolist()]
        assert fin
    if beam > VOCAB:
        # one step: the beams past the vocabulary are the dead padding
        _, one = td.beam_search(prompt, 1, beam)
        np.testing.assert_allclose(one.numpy(), np.asarray(
            jd.beam_search(prompt, 1, beam)[1]), rtol=0, atol=TOL)
        assert (one.numpy()[:, VOCAB:] == np.float32(-1e30)).all()


def test_beam_size_one_is_greedy(lms, prompt):
    _, td = _pair(lms, "plain", attn_impl="paged")
    seqs, scores = td.beam_search(prompt, STEPS, beam_size=1)
    assert torch.equal(seqs[:, 0], td.generate(prompt, STEPS))
    assert torch.isfinite(scores).all()


def test_beam_search_refusals(lms, prompt):
    _, td = _pair(lms, "plain", attn_impl="paged")
    with pytest.raises(MXNetError, match="beam_size"):
        td.beam_search(prompt, 2, beam_size=0)
    with pytest.raises(MXNetError, match="num_steps"):
        td.beam_search(prompt, 0, beam_size=2)
    with pytest.raises(MXNetError, match="exceeds max_len"):
        td.beam_search(prompt, T, beam_size=2)
