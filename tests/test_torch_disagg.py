"""Disaggregated prefill/decode on the port, against the JAX package: every
scenario of ``tests/test_serving_disagg.py`` — the role knob, the transfer
codec, an engine-level handoff, 1P1D and 2P2D fleets, a retried delivery,
the decode side's death and the unified fallback, a prefix-pool hit that
ships no rows, the int8 handoff — run the same way on both packages'
engines and routers.

The two must agree on each request's tokens and retire reason (both equal
the JAX offline ``Decoder.generate``), on every engine's ``stats`` and
``compile_counts``, on the router's ``stats`` and on the ``serving.*`` and
``fleet.*`` counter deltas of each package's own registry. Free slots and
prefix pins come back on both sides of every handoff, and the per-role
compile contracts hold (``check_utils.assert_compile_contract``). The
port's int8 payload (q and scale) equals the JAX ``pack_rows`` bit for bit
on the same rows, f32 and bf16, and its ``native`` payload is the rows bit
for bit.

The LM is the JAX suite's (1 layer, vocab 17, E=16, 2 heads, max_len 16,
seeded numpy weights, f32), carried across by the existing conversion; the
JAX engines serve the JAX suite's default attention (the port serves
``"paged"``: greedy tokens are the same).
"""
import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import engine as jax_engine
from mxnet_tpu.serving import fleet as jax_fleet
from mxnet_tpu.serving import handoff as jax_handoff
from mxnet_tpu.testing import faults as jax_faults

from mxnet_tpu_torch import telemetry as port_tele
from mxnet_tpu_torch.base import MXNetError as PortError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import engine as port_engine
from mxnet_tpu_torch.serving import fleet as port_fleet
from mxnet_tpu_torch.serving import handoff as port_handoff
from mxnet_tpu_torch.testing import faults as port_faults

from check_utils import assert_compile_contract

pytestmark = pytest.mark.faults

VOCAB, T = 17, 16
CFG = dict(num_layers=1, embed_dim=16, num_heads=2)
ENG = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0.0042,
           max_queue=8)
FLEET = dict(timeout_ms=40, max_retries=3, backoff_ms=1, heartbeat_ms=1e6)

Side = collections.namedtuple(
    "Side", "name engine fleet faults tele error handoff mkdec")


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
                        JaxError, jax_handoff, jax_dec),
            "port": Side("port", port_engine, port_fleet, port_faults,
                         port_tele, PortError, port_handoff, port_dec),
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


def _counters(side):
    return {n: m.value for n, m in list(side.tele._state.metrics.items())
            if n.split(".")[0] in ("serving", "fleet")
            and m.kind == "counter"}


def _both(lm, scenario):
    """Run ``scenario(side)`` on the JAX package, then the port's. It
    returns ``(handles, engines, router or None)``. Asserts that the two
    agree on each handle's retire reason and tokens, every engine's stats
    and compile_counts, the router's stats and the counter deltas.
    Returns {side name: (handles, engines, router, counter delta)}."""
    out = {}
    for name in ("jax", "port"):
        side = lm[name]
        c0 = _counters(side)
        hs, engines, router = scenario(side)
        c1 = _counters(side)
        out[name] = (hs, engines, router,
                     {k: v - c0.get(k, 0) for k, v in c1.items()
                      if v - c0.get(k, 0)})
    (jh, je, jr, jc), (ph, pe, pr, pc) = out["jax"], out["port"]
    assert [(h.retire_reason, list(h.tokens)) for h in ph] == \
        [(h.retire_reason, list(h.tokens)) for h in jh]
    for j, p in zip(je, pe):
        assert p.stats == j.stats, (p.stats, j.stats)
        assert p.compile_counts == j.compile_counts
    if jr is not None:
        assert dict(pr.stats) == dict(jr.stats)
    assert pc == {k: jc[k] for k in pc}, \
        {k: (pc[k], jc.get(k)) for k in set(pc) | set(jc)
         if pc.get(k) != jc.get(k)}
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


def test_role_knob_validation(lm, monkeypatch):
    """Unknown roles and handoff dtypes refused, the env default honored,
    narrowing refused (only widening to unified), a decode specialist
    refuses every submit, a prefill specialist refuses admit_handoff —
    both packages, the same messages. On the port a tensor-parallel
    prefill specialist builds, ep > 1 over this dense LM is the JAX
    refusal (no MoE node to shard) and a mesh must be a parallel.Mesh."""
    for name in ("jax", "port"):
        side = lm[name]
        with pytest.raises(side.error, match="role must be"):
            _mkeng(side, role="draining")
        monkeypatch.setenv("MXNET_SERVING_ROLE", "decode")
        e = _mkeng(side)
        assert e.role == "decode"
        assert e.health()["role"] == "decode"
        e.close()
        monkeypatch.delenv("MXNET_SERVING_ROLE")
        monkeypatch.setenv("MXNET_SERVING_HANDOFF_DTYPE", "int8")
        e = _mkeng(side, role="prefill")
        assert e.handoff_dtype == "int8"
        e.close()
        monkeypatch.delenv("MXNET_SERVING_HANDOFF_DTYPE")
        with pytest.raises(side.error, match="handoff_dtype"):
            _mkeng(side, role="prefill", handoff_dtype="fp8")
        ep = _mkeng(side, role="prefill")
        ed = _mkeng(side, role="decode")
        try:
            with pytest.raises(side.error, match="widen"):
                ep.set_role("decode")
            with pytest.raises(side.error, match="role='decode'"):
                ed.submit(np.arange(3), max_tokens=2)
            with pytest.raises(side.error, match="role='decode'"):
                ed.submit(np.arange(3), max_tokens=2, _resume_tokens=(1,))
            with pytest.raises(side.error, match="role='prefill'"):
                ep.admit_handoff({"id": "nope"})
            ep.set_role("unified")
            assert ep.role == "unified"
            ep.set_role("unified")
        finally:
            ep.close()
            ed.close()
    e = _mkeng(lm["port"], role="prefill", tp=2)
    assert e.tp == 2 and e._geometry()["tp"] == 2
    e.close()
    for kw, match in ((dict(ep=2), "needs a MoE decoder"),
                      (dict(mesh=object()), "parallel.Mesh")):
        with pytest.raises(PortError, match=match):
            _mkeng(lm["port"], **kw)


def _jax_leaf(t):
    """A port row leaf as the numpy array the JAX export would hand
    ``pack_rows`` (bf16 as ml_dtypes bfloat16)."""
    if t.dtype == torch.bfloat16:
        return np.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t.numpy()


def _assert_int8_equal(ptree, jtree):
    pl = [x for e in ptree for x in e]
    jl = [x for e in jtree for x in e]
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        assert isinstance(p, port_handoff._Quant)
        np.testing.assert_array_equal(p.q.numpy(), np.asarray(j.q))
        assert p.scale.shape == np.asarray(j.scale).shape
        np.testing.assert_array_equal(p.scale.numpy().view(np.int32),
                                      np.asarray(j.scale).view(np.int32))


def test_pack_rows_codec_against_jax():
    """The transfer codec alone, against the JAX one on the same rows:
    native is bit-exact (bf16 too), int8 quantizes each float leaf over
    every axis but axis 0 and passes integer leaves through — q and scale
    bitwise equal to the JAX ``pack_rows``', byte counts equal — and
    unpacks within the quantization step; a zero leaf survives; unknown
    dtypes are refused."""
    rng = np.random.RandomState(7)
    rows = {"k": rng.randn(4, 64).astype(np.float32),
            "v": rng.randn(4, 64).astype(np.float32),
            "pos": np.arange(4, dtype=np.int32)}
    prow = {k: torch.from_numpy(v) for k, v in rows.items()}
    native, n_native = port_handoff.pack_rows(prow, "native")
    _, jn_native = jax_handoff.pack_rows(rows, "native")
    assert n_native == jn_native
    back = port_handoff.unpack_rows(native, prow)
    for k in rows:
        np.testing.assert_array_equal(back[k].numpy(), rows[k])
    q, n_q = port_handoff.pack_rows(prow, "int8")
    jq, jn_q = jax_handoff.pack_rows(rows, "int8")
    assert n_q == jn_q
    _assert_int8_equal([(q["k"], q["v"])], [(jq["k"], jq["v"])])
    assert q["pos"] is prow["pos"] or torch.equal(q["pos"], prow["pos"])
    deq = port_handoff.unpack_rows(q, prow)
    jdeq = jax_handoff.unpack_rows(jq, rows)
    for k in ("k", "v"):
        np.testing.assert_array_equal(deq[k].numpy(), jdeq[k])
        tol = np.abs(rows[k]).max(axis=-1, keepdims=True) / 127.0
        assert np.all(np.abs(deq[k].numpy() - rows[k]) <= tol + 1e-6)
    z, _ = port_handoff.pack_rows({"k": torch.zeros(2, 3)}, "int8")
    assert torch.equal(port_handoff.unpack_rows(
        z, {"k": torch.zeros(2, 3)})["k"], torch.zeros(2, 3))
    # an exported [1, P, H, D] leaf: ONE scale a leaf, as JAX computes;
    # bf16 rows (no numpy dtype on the port side) bitwise too
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(3)
        tree = [(torch.randn(1, 8, 2, 8, generator=g).to(dt),
                 torch.randn(1, 8, 2, 8, generator=g).to(dt))]
        pq, pn = port_handoff.pack_rows(tree, "int8")
        jq, jn = jax_handoff.pack_rows(
            [tuple(_jax_leaf(x) for x in e) for e in tree], "int8")
        assert pn == jn
        _assert_int8_equal(pq, jq)
        assert pq[0][0].scale.numel() == 1
        pnat, pnn = port_handoff.pack_rows(tree, "native")
        assert pnn == sum(x.numel() * x.element_size() for x in tree[0])
        assert all(torch.equal(a, b) for a, b in zip(pnat[0], tree[0]))
    with pytest.raises(PortError, match="int8"):
        port_handoff.pack_rows(prow, "fp4")


def _package(eng, prompt, n):
    """Submit on a prefill engine and step until its package is out."""
    eng.submit(prompt, max_tokens=n)
    for _ in range(40):
        eng.step()
        pkgs = eng.take_handoffs()
        if pkgs:
            return pkgs
    raise AssertionError("no handoff package")


def test_engine_level_handoff_byte_identity(lm):
    """The handoff WITHOUT the router: a prefill specialist exports a
    package, a decode specialist admits it, and the stream equals offline
    generate; a second resolve raises; both sides drain clean and keep
    their role contracts — on both packages, with equal stats. The port's
    exported int8 payload equals the JAX ``pack_rows`` of the same rows
    bitwise."""
    p = np.random.RandomState(11).randint(0, VOCAB, (6,))
    rows = {}

    def scenario(side):
        ep = _mkeng(side, role="prefill")
        ed = _mkeng(side, role="decode")
        pkg = _package(ep, p, 5)[0]
        payload = pkg.payload()
        assert payload["prefill_len"] == len(p)
        assert len(payload["tokens"]) == 1
        assert payload["rows"] is not None
        assert ep.health()["handoffs_waiting"] == 0
        rows[side.name] = payload["rows"]
        req = ed.admit_handoff(payload)
        assert ed.admit_handoff(payload) is req        # exactly once
        pkg.resolve()
        with pytest.raises(side.error, match="twice"):
            pkg.resolve()
        ed.serve_forever()
        assert req.done and req.retire_reason == "length"
        assert list(req.tokens) == _oracle(lm, p, 5)
        _assert_clean(ep, ed)
        _assert_role_contracts([ep], [ed])
        assert ep.stats["handoffs_out"] == 1
        assert ed.stats["handoffs_in"] == 1
        for e in (ep, ed):
            e.close()
        return [req], [ep, ed], None
    _both(lm, scenario)
    # the same f32 rows on both sides (the prefill arithmetic agrees to
    # float rounding): the port's int8 payload against JAX's pack_rows of
    # the port's own exported rows, bitwise
    prow = rows["port"]
    assert len(prow) == 1 and prow[0][0].shape == (1, 8, 2, 8)
    for e, j in zip(prow, rows["jax"]):
        for a, b in zip(e, j):
            np.testing.assert_allclose(a[:, :len(p)].numpy(),
                                       np.asarray(b)[:, :len(p)],
                                       rtol=1e-5, atol=1e-6)
    pq, _ = port_handoff.pack_rows(prow, "int8")
    jq, _ = jax_handoff.pack_rows(
        [tuple(x.numpy() for x in e) for e in prow], "int8")
    _assert_int8_equal(pq, jq)


CASES = ((4, 3), (6, 4), (3, 2), (7, 5))


@pytest.mark.parametrize("roles", [("prefill", "decode"),
                                   ("prefill", "prefill", "decode",
                                    "decode")], ids=["1p1d", "2p2d"])
def test_fleet_1p1d_and_2p2d_byte_identity(lm, roles):
    """The same prompt set through a 1P+1D and a 2P+2D fleet retires
    byte-identical to offline generate on both packages, every prompt
    placed on a prefill replica and every package delivered to a decode
    replica; pins and slots clean; per-role contracts."""
    rng = np.random.RandomState(5)
    cases = [(rng.randint(0, VOCAB, (n,)), m) for n, m in CASES]

    def scenario(side):
        fleet, engines = _mkfleet(side, roles)
        with fleet:
            hs = [fleet.submit(p, max_tokens=m) for p, m in cases]
            fleet.serve_forever()
            for h, (p, m) in zip(hs, cases):
                assert list(h.result()) == _oracle(lm, p, m)
            assert fleet.stats["handoffs"] == len(cases)
            assert fleet.stats["handoff_bytes"] > 0
            _assert_clean(*engines)
            pre = [e for e in engines if e.role == "prefill"]
            dco = [e for e in engines if e.role == "decode"]
            assert sum(e.stats["handoffs_out"] for e in pre) == len(cases)
            assert sum(e.stats["handoffs_in"] for e in dco) == len(cases)
            _assert_role_contracts(pre, dco)
        return hs, engines, fleet
    _both(lm, scenario)


def test_handoff_retry_dedup_admits_once(lm):
    """A dropped delivery retries the SAME package and the decode side
    admits it exactly once; no failover."""
    p = np.random.RandomState(13).randint(0, VOCAB, (5,))

    def scenario(side):
        fleet, (ep, ed) = _mkfleet(side, ("prefill", "decode"))
        fi = side.faults.FaultInjector()
        with fleet:
            with fi.fleet_handoff_failures(ed.engine_id, n=1):
                h = fleet.submit(p, max_tokens=4)
                fleet.serve_forever()
            assert ("handoff_fail", ed.engine_id) in fi.log
            assert list(h.result()) == _oracle(lm, p, 4)
            assert ed.stats["handoffs_in"] == 1
            assert fleet.stats["failovers"] == 0
            _assert_clean(ep, ed)
            _assert_role_contracts([ep], [ed])
        return [h], [ep, ed], fleet
    _both(lm, scenario)


def test_decode_death_falls_back_to_unified(lm):
    """The channel budget exhausts, the decode replica fails over, the
    prefill specialist widens to unified and serves the package out of its
    own pool: byte-identical, pins and slots clean."""
    p = np.random.RandomState(17).randint(0, VOCAB, (6,))

    def scenario(side):
        fleet, (ep, ed) = _mkfleet(side, ("prefill", "decode"),
                                   max_retries=0)
        fi = side.faults.FaultInjector()
        with fleet:
            with fi.fleet_handoff_failures(ed.engine_id, n=2):
                h = fleet.submit(p, max_tokens=5)
                fleet.serve_forever()
            assert list(h.result()) == _oracle(lm, p, 5)
            assert fleet.stats["failovers"] == 1
            assert fleet.stats["role_promotions"] == 1
            assert ep.role == "unified"
            assert fleet.replica_ids(live_only=True) == [ep.engine_id]
            _assert_clean(ep)
            assert ep.compile_counts["decode"] == 1
            assert_compile_contract(ep)
        ed.close()
        return [h], [ep, ed], fleet
    _both(lm, scenario)


def test_pool_hit_skips_transfer(lm):
    """The first delivery parks the prefill in the decode replica's pool;
    a repeat of the prompt ships identity only (``handoff_pool_hits``,
    zero new bytes, a prefix hit on the decode side)."""
    p = np.random.RandomState(19).randint(0, VOCAB, (6,))

    def scenario(side):
        fleet, (ep, ed) = _mkfleet(side, ("prefill", "decode"))
        with fleet:
            h1 = fleet.submit(p, max_tokens=4)
            fleet.serve_forever()
            first = fleet.stats["handoff_bytes"]
            assert first > 0 and fleet.stats["handoff_pool_hits"] == 0
            h2 = fleet.submit(p.copy(), max_tokens=4)
            fleet.serve_forever()
            assert fleet.stats["handoffs"] == 2
            assert fleet.stats["handoff_pool_hits"] == 1
            assert fleet.stats["handoff_bytes"] == first
            want = _oracle(lm, p, 4)
            assert list(h1.result()) == want == list(h2.result())
            assert ed.stats["prefix_hits"] >= 1
            _assert_clean(ep, ed)
            _assert_role_contracts([ep], [ed])
        return [h1, h2], [ep, ed], fleet
    _both(lm, scenario)


def test_int8_handoff_quarters_f32_wire_bytes(lm):
    """``handoff_dtype="int8"`` on the exporting engine ships ~a quarter of
    the f32 bytes (int8 values and one f32 scale a leaf) and, at this toy
    scale, still decodes byte-identically; the byte counts equal the JAX
    fleet's."""
    p = np.random.RandomState(23).randint(0, VOCAB, (6,))
    sizes = {}
    for dtype in ("native", "int8"):
        def scenario(side):
            fleet, engines = _mkfleet(side, ("prefill", "decode"),
                                      eng_kw={"handoff_dtype": dtype})
            with fleet:
                h = fleet.submit(p, max_tokens=4)
                fleet.serve_forever()
                assert list(h.result()) == _oracle(lm, p, 4)
                sizes[dtype] = fleet.stats["handoff_bytes"]
                _assert_clean(*engines)
            return [h], engines, fleet
        _both(lm, scenario)
    assert 0 < sizes["int8"] < 0.35 * sizes["native"], sizes


def test_close_frees_only_what_the_engine_owns(lm):
    """Replicas over ONE decoder: closing one (a drain, a failover) leaves
    its peers' weights — the decoder's — alive and bit-identical, and the
    peer keeps serving equal streams."""
    side = lm["port"]
    dec = side.mkdec()
    snap = {k: v.clone() for k, v in dec._params.items()}
    a = side.engine.InferenceEngine(dec, role="prefill", **ENG)
    b = side.engine.InferenceEngine(dec, role="decode", **ENG)
    c = side.engine.InferenceEngine(dec, **ENG)
    fleet = side.fleet.FleetRouter([a, b, c], **FLEET)
    p = np.random.RandomState(29).randint(0, VOCAB, (5,))
    with fleet:
        h = fleet.submit(p, max_tokens=6)
        fleet.serve_forever()
        fleet.drain(a)
        fleet.drain(b)
        assert a._closed and b._closed and a._caches is None
        h2 = fleet.submit(p, max_tokens=6)
        fleet.serve_forever()
        assert list(h.result()) == list(h2.result()) == _oracle(lm, p, 6)
    for k, v in dec._params.items():
        assert torch.equal(v, snap[k]), k
