"""Specialists dying, and what crosses the wire, on the port against the
JAX package: a 2P+2D fleet losing one specialist mid-wave (a decode
replica killed mid-round, a prefill replica blackholed, a prefill replica
drained) keeps every stream byte-identical to an uninterrupted unified
run with zero failed requests, and the engines that stayed specialists
keep their role contracts. On the port a migrated request re-enters
through a prefill specialist, which prefills its prompt and hands its
recorded tokens on for the decode side to regenerate (the port's
``Request`` says why a re-prefill of them would not do); the JAX engine
prefills prompt and tokens. So both packages are held to the same
outcomes, not the same rounds.

Then the port's own questions: a fresh handoff resumes after its first
token and regenerates nothing, a resumed one regenerates exactly its
recorded tokens, and a sampled request through 1P+1D draws what it draws
on one unified engine (the decode side rebuilds the draws from the seed;
within the port: the two packages draw differently).

The LM is the JAX suite's (1 layer, vocab 17, E=16, 2 heads, max_len 16,
seeded numpy weights, f32).
"""
import collections

import numpy as np
import pytest

import jax.numpy as jnp

from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import engine as jax_engine
from mxnet_tpu.serving import fleet as jax_fleet
from mxnet_tpu.testing import faults as jax_faults

from mxnet_tpu_torch import telemetry as port_tele
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import engine as port_engine
from mxnet_tpu_torch.serving import fleet as port_fleet
from mxnet_tpu_torch.testing import faults as port_faults

from check_utils import assert_compile_contract

pytestmark = pytest.mark.faults

VOCAB, T = 17, 16
CFG = dict(num_layers=1, embed_dim=16, num_heads=2)
ENG = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0.0042,
           max_queue=8)
FLEET = dict(timeout_ms=40, max_retries=3, backoff_ms=1, heartbeat_ms=1e6)

Side = collections.namedtuple(
    "Side", "name engine fleet faults tele mkdec")


@pytest.fixture(scope="module")
def lm():
    with JaxNames():
        js = jax_lm(VOCAB, impl="dense", **CFG)
    with TorchNames():
        ts = torch_lm(VOCAB, **CFG)
    shapes, _, _ = js.infer_shape(data=(2, T), softmax_label=(2, T))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_dec():
        return JaxDecoder(js, jparams, max_len=T, cache_block=None)

    def port_dec():
        return Decoder(ts, params, max_len=T, device="cpu")
    return {"jax": Side("jax", jax_engine, jax_fleet, jax_faults, jax_tele,
                        jax_dec),
            "port": Side("port", port_engine, port_fleet, port_faults,
                         port_tele, port_dec),
            "oracle": JaxDecoder(js, jparams, max_len=T)}


def _mkeng(side, **kw):
    cfg = dict(ENG)
    cfg.update(kw)
    return side.engine.InferenceEngine(side.mkdec(), **cfg)


def _mkfleet(side, roles, eng_kw=None, **kw):
    engines = [_mkeng(side, role=r, **(eng_kw or {})) for r in roles]
    cfg = dict(FLEET)
    cfg.update(kw)
    return side.fleet.FleetRouter(engines, **cfg), engines


_ORACLE = {}


def _oracle(lm, prompt, n):
    prompt = np.asarray(prompt)
    n = min(n, T - len(prompt))
    key = (prompt.tobytes(), n)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(lm["oracle"].generate(
            prompt[None], num_steps=n))[0, len(prompt):].tolist()
    return _ORACLE[key]


def _both(lm, scenario):
    """Run ``scenario(side)`` (it returns its handles and router) on both
    packages; assert equal tokens and retire reasons and equal router
    stats but its rounds. Returns {name: (handles, router)}."""
    out = {n: scenario(lm[n]) for n in ("jax", "port")}
    (jh, jr), (ph, pr) = out["jax"], out["port"]
    assert [(h.retire_reason, list(h.tokens)) for h in ph] == \
        [(h.retire_reason, list(h.tokens)) for h in jh]
    if jr is not None:
        js, ps = dict(jr.stats), dict(pr.stats)
        js.pop("steps", None)
        ps.pop("steps", None)
        assert ps == js
    return out


def _assert_clean(*engines):
    for e in engines:
        if e._prefix is not None:
            assert e._prefix.pinned == 0, e.engine_id
        assert len(e._free) == e.slots, e.engine_id


def _assert_role_contracts(prefills, decodes):
    for e in prefills:
        assert_compile_contract(e, decode=0, verify=0)
    for e in decodes:
        assert_compile_contract(e, prefill={}, copy="once")


@pytest.mark.parametrize("fault", ["kill_decode", "blackhole_prefill",
                                   "drain_prefill"])
def test_specialist_death_in_2p2d_stays_byte_identical(lm, fault):
    """A 2P+2D fleet loses one specialist mid-wave (a decode replica
    killed mid-round, a prefill replica blackholed, a prefill replica
    drained): every stream equals an uninterrupted unified run's, zero
    failed, and the engines that stayed specialists keep their role
    contracts (no decode program on a prefill engine: on the port a
    migrated request prefills its prompt there and its recorded tokens
    are regenerated on a decode engine)."""
    rng = np.random.RandomState(41)
    # prompt + budget within the largest bucket: a JAX prefill specialist
    # re-prefills a migrated request's prompt AND emitted tokens, and a
    # package past the largest bucket never delivers there
    cases = [(rng.randint(0, VOCAB, (int(n),)), 6)
             for n in rng.randint(2, 4, size=6)]

    def scenario(side):
        fleet, engines = _mkfleet(
            side, ("prefill", "prefill", "decode", "decode"),
            heartbeat_ms=0, heartbeat_misses=2)
        fi = side.faults.FaultInjector()
        with fleet:
            hs = [fleet.submit(p, max_tokens=m) for p, m in cases]
            for _ in range(3):
                fleet.step()
            if fault == "kill_decode":
                victim = max((e for e in engines if e.role == "decode"),
                             key=lambda e: len(e._active))
                assert victim._active
                with fi.fleet_kill_replica(victim.engine_id):
                    fleet.step()
            elif fault == "blackhole_prefill":
                victim = engines[0]
                with fi.fleet_heartbeat_blackhole(victim.engine_id, n=2):
                    fleet.step()
                    fleet.step()
            else:
                victim = engines[0]
                fleet.drain(victim)
            fleet.serve_forever()
            assert victim._closed
            assert fleet.stats["failovers" if fault != "drain_prefill"
                               else "drains"] == 1
            for h, (p, m) in zip(hs, cases):
                assert h.retire_reason in ("length", "eos")
                assert list(h.result()) == _oracle(lm, p, m)
            live = [e for e in engines if not e._closed]
            _assert_clean(*live)
            _assert_role_contracts(
                [e for e in live if e.role == "prefill"],
                [e for e in live if e.role == "decode"])
            if side.name == "port" and fault == "kill_decode":
                # the migrated requests went through a prefill
                # specialist and regenerated their tokens on a decode one
                assert fleet.stats["migrated_requests"] > 0
                assert sum(e.stats["handoffs_out"] for e in live
                           if e.role == "prefill") > len(cases)
        return hs, None
    _both(lm, scenario)


def test_fresh_handoff_regenerates_nothing_and_sampling_crosses(lm):
    """A fresh package's request resumes AFTER its first token with
    nothing to regenerate (``_replay`` 0, every later token emitted and
    counted); a resumed request's package carries its recorded tokens for
    the decode side to regenerate (``_replay`` = all but the pending one,
    none emitted again). A sampled request through 1P+1D equals the same
    request on one unified engine (draws rebuilt from the seed on the
    decode side; within the port)."""
    side = lm["port"]
    p = np.random.RandomState(43).randint(0, VOCAB, (6,))
    ep, ed = _mkeng(side, role="prefill"), _mkeng(side, role="decode")
    ep.submit(p, max_tokens=6)
    ep.step()
    (pkg,) = ep.take_handoffs()
    t0 = ed.stats["tokens"]
    req = ed.admit_handoff(pkg.payload())
    pkg.resolve()
    assert req._replay == 0 and req.resumed == 1
    ed.serve_forever()
    assert list(req.tokens) == _oracle(lm, p, 6)
    assert ed.stats["tokens"] - t0 == 5
    want = _oracle(lm, p, 6)
    ep.submit(p, max_tokens=6, _resume_tokens=want[:4])
    ep.step()
    (pkg,) = ep.take_handoffs()
    pl = pkg.payload()
    assert pl["prefill_len"] == len(p) and pl["tokens"] == want[:4]
    t0 = ed.stats["tokens"]
    req = ed.admit_handoff(pl)
    pkg.resolve()
    assert req._replay == 3 and req.resumed == 4
    ed.serve_forever()
    assert list(req.tokens) == want and ed.stats["tokens"] - t0 == 2
    # sampling identity across the wire
    uni = _mkeng(side)
    ref = uni.submit(p, max_tokens=8, temperature=0.9, seed=5)
    uni.serve_forever()
    fleet = side.fleet.FleetRouter([ep, ed], **FLEET)
    with fleet:
        h = fleet.submit(p, max_tokens=8, temperature=0.9, seed=5)
        fleet.serve_forever()
        assert list(h.tokens) == list(ref.tokens)
        assert len(set(ref.tokens)) > 1
    _assert_clean(ep, ed)
    uni.close()
