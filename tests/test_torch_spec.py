"""The port's speculation against the JAX package's, on the CPU.

* ``mxnet_tpu_torch.serving.NgramDrafter`` (host-only) against
  ``mxnet_tpu.serving.NgramDrafter``: each case of
  ``tests/test_spec_ngram.py`` runs through both classes, with its
  assertions, and both give the same proposals; then seeded random
  contexts, appends, proposals of every length and state round-trips
  run through both, with equal proposals after every operation.
* ``Decoder.verify_step_slots`` and ``Decoder.draft_propose_slots``
  against the JAX functions on the same 2-layer LM (seeded numpy weights,
  float and int8 weights), the same caches (seeded numpy rows) and the
  same state, greedy: the emitted tokens, the new state and the drafts
  are EQUAL; the caches after the step agree within rtol 1e-5, atol 1e-5
  (f32 on both sides, sums in other orders). The drafts are built from
  the target's own choices so that one slot has all K accepted, one a
  mismatch after its first, one no draft, one stops on EOS inside the
  chain and one is not live.
* A sampled slot's verify tokens are the plain decode step's draws at the
  same positions (the port's draw is a function of seed and position).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import NgramDrafter as JaxDrafter

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.parallel.decode import sample_tokens, uniform_draw
from mxnet_tpu_torch.serving import NgramDrafter

SIDES = {"jax": (JaxDrafter, JaxError), "port": (NgramDrafter, MXNetError)}


# -- the cases of tests/test_spec_ngram.py, on either class ----------------

def case_proposal_follows_latest_suffix_match(D, Err):
    d = D([7, 8, 1, 2, 7, 8, 3, 4, 7, 8])
    d2 = D([5, 6, 9, 5, 6])
    out = [d.propose(2), d2.propose(8)]
    assert out == [[3, 4], [9, 5, 6, 9, 5, 6, 9, 5]]
    return out


def case_longer_suffix_preferred_over_shorter(D, Err):
    d = D([1, 2, 3, 9, 9, 3, 7, 2, 3], max_ngram=3)
    assert d.propose(1) == [9]
    return [d.propose(1)]


def case_prompt_output_boundary_overlap(D, Err):
    d = D([4, 5, 6, 1])
    for t in [4, 5]:
        d.append(t)
    assert d.propose(2) == [6, 1]
    return [d.propose(2)]


def case_periodic_tail_self_overlap(D, Err):
    out = [D([9, 1, 2, 1, 2]).propose(3), D([0, 7, 7, 7]).propose(4)]
    assert out == [[1, 2, 1], [7, 7, 7, 7]]
    return out


def case_k_longer_than_history_and_degenerate_contexts(D, Err):
    out = [D([]).propose(4), D([3]).propose(4), D([3, 3]).propose(0),
           D([3, 3]).propose(4), D([1, 2, 3, 4, 5]).propose(4)]
    assert out == [[], [], [], [3, 3, 3, 3], []]
    return out


def case_repeated_suffixes_pick_latest_match(D, Err):
    d = D([1, 7, 1, 8, 1, 9, 1], max_ngram=1)
    assert d.propose(1) == [9]
    return [d.propose(1)]


def case_determinism_and_append_extend(D, Err):
    ctx = [2, 4, 2, 4, 2]
    a = D(ctx)
    b = D(ctx[:3])
    b.extend(ctx[3:])
    assert len(a) == len(b) == 5
    out = []
    for _ in range(3):
        out.append((a.propose(4), b.propose(4)))
        assert out[-1] == ([4, 2, 4, 2], [4, 2, 4, 2])
    return out


def case_snapshot_restore_round_trip(D, Err):
    import json
    d = D([5, 1, 5, 1], max_ngram=2, min_ngram=2)
    st = json.loads(json.dumps(d.state()))
    d2 = D.from_state(st)
    assert d2.propose(3) == d.propose(3) == [5, 1, 5]
    assert d2.max_ngram == 2 and d2.min_ngram == 2
    d2.append(9)
    assert len(d2) == len(d) + 1
    return [st, d2.propose(3)]


def case_min_max_ngram_validation_and_bounds(D, Err):
    with pytest.raises(Err, match="min_ngram"):
        D([], min_ngram=0)
    with pytest.raises(Err, match="min_ngram"):
        D([], min_ngram=3, max_ngram=2)
    out = [D([1, 2, 3, 2], min_ngram=1).propose(1),
           D([1, 2, 3, 2], min_ngram=2).propose(1)]
    assert out == [[3], []]
    return out


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_drafter_case_equals_jax(name):
    assert CASES[name](*SIDES["port"]) == CASES[name](*SIDES["jax"])


def _replay(D, seed, n=300):
    """A seeded stream of appends, proposals (k 0..6) and JSON state
    round-trips over a 3-token alphabet (so suffixes recur); returns every
    proposal and state."""
    import json
    rng = np.random.RandomState(seed)
    lo = int(rng.randint(1, 3))
    d = D([int(t) for t in rng.randint(0, 3, rng.randint(0, 6))],
          max_ngram=lo + int(rng.randint(0, 3)), min_ngram=lo)
    trace = []
    for _ in range(n):
        r = rng.rand()
        if r < 0.5:
            d.append(int(rng.randint(0, 3)))
            trace.append(len(d))
        elif r < 0.95:
            trace.append(d.propose(int(rng.randint(0, 7))))
        else:
            d = D.from_state(json.loads(json.dumps(d.state())))
            trace.append(d.state())
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_random_streams_equal_jax(seed):
    got, want = _replay(NgramDrafter, seed), _replay(JaxDrafter, seed)
    assert got == want
    assert any(isinstance(t, list) and t for t in got)


# -- verify and draft steps against the JAX functions ------------------------

VOCAB, MAX_LEN, K = 53, 32, 3
CFG = dict(num_layers=2, embed_dim=32, num_heads=4)
# slot positions (head token at pos): all accepted, mismatch after one,
# no draft, EOS inside the chain, not live
POS = [5, 11, 7, 14, 9]
S = len(POS)
RTOL = ATOL = 1e-5


def _init(rng, name, shape):
    """Fan-in-scaled weights, gains near 1 (varied greedy choices)."""
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
    rng = np.random.RandomState(3)
    params = {n: _init(rng, n, s)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return js, ts, params


@pytest.fixture(scope="module", params=["float", "int8"])
def decoders(request, lm):
    js, ts, params = lm
    kw = dict(weight_dtype=request.param,
              matmul_impl="fused" if request.param == "int8" else "dense")
    jdec = JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                      max_len=MAX_LEN, cache_block=None, attn_impl="paged",
                      **kw)
    tdec = Decoder(ts, params, max_len=MAX_LEN, device="cpu", **kw)
    return jdec, tdec


def _cache_rows(tdec, seed):
    """Seeded cache contents for every slot, numpy, in the decoder's
    layout (K/V near the scale the LM writes)."""
    rng = np.random.RandomState(seed)
    return [tuple(rng.randn(*b.shape).astype(np.float32) * 0.5 for b in e)
            for e in tdec.init_cache(S)]


def _jax_cache(rows):
    return [tuple(jnp.asarray(b) for b in e) for e in rows]


def _port_cache(rows):
    return [tuple(torch.from_numpy(b.copy()) for b in e) for e in rows]


def _port_state(tok, live, eos, last, temp=None, seeds=None):
    temp = torch.zeros(S) if temp is None else torch.tensor(temp)
    seeds = torch.arange(S) if seeds is None else torch.tensor(seeds)
    uniform = uniform_draw(seeds[:, None], torch.arange(MAX_LEN)[None])
    return (torch.tensor(POS, dtype=torch.int32),
            torch.tensor(tok, dtype=torch.int64), torch.tensor(live),
            temp.to(torch.float32), uniform,
            torch.tensor(eos, dtype=torch.int64),
            torch.tensor(last, dtype=torch.int32))


def _jax_state(tok, live, eos, last):
    return (jnp.asarray(POS, jnp.int32), jnp.asarray(tok, jnp.int32),
            jnp.asarray(live), jnp.zeros((S,), jnp.float32),
            jnp.zeros((S, 2), jnp.uint32), jnp.asarray(eos, jnp.int32),
            jnp.asarray(last, jnp.int32))


def _port_verify(tdec, rows, state, drafts, dlen):
    return tdec.verify_step_slots(
        tdec._params, tdec._aux, _port_cache(rows), state,
        torch.tensor(drafts, dtype=torch.int64),
        torch.tensor(dlen, dtype=torch.int64))


def _chains(tdec, rows, tok):
    """Each slot's greedy continuation of K+1 tokens from its head, by
    verify steps that learn one token a round (a slot whose drafts are
    its own choices so far emits one more each time)."""
    live = [True] * S
    eos = [-1] * S
    last = [MAX_LEN - 1] * S
    known = [[] for _ in range(S)]
    for _ in range(K + 1):
        drafts = np.zeros((S, K), np.int64)
        dlen = np.zeros(S, np.int64)
        for s in range(S):
            n = min(len(known[s]), K)
            drafts[s, :n] = known[s][:n]
            dlen[s] = n
        _, _, out = _port_verify(tdec, rows, _port_state(tok, live, eos,
                                                         last),
                                 drafts, dlen)
        for s in range(S):
            got = [int(t) for t in out[:, s] if t >= 0]
            known[s] = got if len(got) > len(known[s]) else known[s]
    return known


@pytest.fixture(scope="module")
def verify_case(decoders):
    """Caches, heads, state and drafts that take every branch of the
    accepted-prefix loop."""
    _, tdec = decoders
    rows = _cache_rows(tdec, 7)
    tok = [3, 17, 29, 41, 8]
    chain = _chains(tdec, rows, tok)
    assert all(len(c) == K + 1 for c in chain)
    drafts = np.zeros((S, K), np.int64)
    dlen = np.array([K, K, 0, K, 2], np.int64)
    drafts[0] = chain[0][:K]                         # all accepted
    drafts[1] = chain[1][:K]
    drafts[1, 1] = (chain[1][1] + 1) % VOCAB          # mismatch at 1
    drafts[3] = chain[3][:K]                         # EOS at chain[3][1]
    drafts[4] = chain[4][:K]
    eos = [-1, -1, -1, chain[3][1], -1]
    live = [True, True, True, True, False]
    last = [MAX_LEN - 1] * S
    return rows, tok, live, eos, last, drafts, dlen, chain


def test_verify_step_equals_jax(decoders, verify_case):
    jdec, tdec = decoders
    rows, tok, live, eos, last, drafts, dlen, chain = verify_case
    jc, jst, jout = jdec.verify_step_slots(
        jdec._params, jdec._aux, _jax_cache(rows),
        _jax_state(tok, live, eos, last), jnp.asarray(drafts, jnp.int32),
        jnp.asarray(dlen, jnp.int32), impl="paged")
    tc, tst, tout = _port_verify(tdec, rows, _port_state(tok, live, eos,
                                                         last),
                                 drafts, dlen)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    for i in (0, 1, 2):             # pos, tok, live
        np.testing.assert_array_equal(tst[i].numpy(), np.asarray(jst[i]))
    for je, te in zip(jc, tc):
        for jb, tb in zip(je, te):
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                                       rtol=RTOL, atol=ATOL)
    out = tout.numpy()
    assert list(out[:, 0]) == chain[0]                    # K + 1 emitted
    assert list(out[:, 1]) == chain[1][:2] + [-1, -1]     # mismatch at 1
    assert list(out[:, 2]) == chain[2][:1] + [-1] * K     # no draft
    assert list(out[:, 3]) == chain[3][:2] + [-1, -1]     # EOS emitted
    assert list(out[:, 4]) == [-1] * (K + 1)              # not live
    assert tst[0].tolist() == [p + e for p, e in zip(POS, (4, 2, 1, 2, 0))]
    assert tst[2].tolist() == [True, True, True, False, False]


def test_verify_step_sampled_draws_follow_position(decoders, verify_case):
    """A sampled slot without drafts emits what a plain one-token step
    draws at the same position; with its own draws as drafts it emits
    them all."""
    _, tdec = decoders
    rows, tok, live, eos, last, _, _, _ = verify_case
    temp = [0.0, 1.3, 0.0, 0.8, 0.0]
    state = _port_state(tok, [True] * S, [-1] * S, last, temp,
                        seeds=[1, 2, 3, 4, 5])
    logits, _ = tdec._run_slots(tdec._params, tdec._aux, _port_cache(rows),
                                state[0], state[1][:, None])
    plain = sample_tokens(logits[:, 0], state[3],
                          state[4].gather(1, state[0].long()[:, None] + 1
                                          )[:, 0])
    zeros = np.zeros((S, K), np.int64)
    _, _, out = _port_verify(tdec, rows, state, zeros, np.zeros(S, np.int64))
    assert out[0].tolist() == plain.tolist()
    # learn each slot's own K + 1 draws, then feed them back as drafts
    known = [[int(plain[s])] for s in range(S)]
    for _ in range(K):
        d = np.zeros((S, K), np.int64)
        for s in range(S):
            d[s, :len(known[s])] = known[s][:K]
        _, _, out = _port_verify(tdec, rows, state, d,
                                 np.array([min(len(k), K) for k in known]))
        known = [[int(t) for t in out[:, s] if t >= 0] for s in range(S)]
    d = np.array([k[:K] for k in known], np.int64)
    _, st, out = _port_verify(tdec, rows, state, d, np.full(S, K))
    assert (out.numpy() >= 0).all() and st[0].tolist() == \
        [p + K + 1 for p in POS]


@pytest.mark.parametrize("pending", [[1, 4, 2, 3, 1], [4, 4, 4, 4, 4]],
                         ids=["ragged", "full"])
def test_draft_propose_equals_jax(decoders, pending):
    """The draft program's catch-up (``clen`` valid tokens of W = K+1 at
    each slot's draft position) and its K-1 greedy steps."""
    jdec, tdec = decoders
    rows = _cache_rows(tdec, 11)
    rng = np.random.RandomState(5)
    catchup = rng.randint(0, VOCAB, (S, K + 1))
    clen = np.array(pending, np.int64)
    pos = np.array(POS, np.int32)
    jc, jd = jdec.draft_propose_slots(
        jdec._params, jdec._aux, _jax_cache(rows), jnp.asarray(pos),
        jnp.asarray(catchup, jnp.int32), jnp.asarray(clen, jnp.int32), K,
        impl="paged")
    tc, td = tdec.draft_propose_slots(
        tdec._params, tdec._aux, _port_cache(rows), torch.from_numpy(pos),
        torch.from_numpy(catchup), torch.from_numpy(clen), K)
    assert td.shape == (S, K)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for je, te in zip(jc, tc):
        for jb, tb in zip(je, te):
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                                       rtol=RTOL, atol=ATOL)
