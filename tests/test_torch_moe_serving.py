"""Expert-parallel MoE serving on the port, on the CPU: the engine's ``ep``.

The LM is ``tests/test_serving_quant.py``'s MoE flavour (1 layer, vocab
17, E=16, 2 heads, max_len 16) with 4 experts and top-2 routing, seeded
numpy weights, int8 weights in the engine's own copy. The oracle is the
JAX package's int8 ``ep=1`` engine and its offline quantized decoder:
greedy streams at ``ep=1``, ``ep=2``, ``ep=4`` and ``ep=2, tp=2`` on
``["cpu"] * n`` equal them token for token (on the host a rank's products
round by their width, so the logits are not bitwise ep=1's; the streams
are). Then the construction
refusals with the JAX messages, the placement (each rank's gate and
stacks one allocation of X/ep experts, values and scales), the geometry
through snapshot, capture and replay in both packages, and the KV handoff
beside an ep=2 engine.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import engine as jax_engine

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.model import save_checkpoint
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder, build_mesh, model_parallel_mesh
from mxnet_tpu_torch.serving import capture as port_capture
from mxnet_tpu_torch.serving import engine as port_engine
from mxnet_tpu_torch.serving import replay as port_replay
from mxnet_tpu_torch.serving.quant import QuantizedTensor

from check_utils import assert_compile_contract

VOCAB, T = 17, 16
CFG = dict(num_layers=1, embed_dim=16, num_heads=2, num_experts=4,
           moe_top_k=2)
ENG = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0,
           weight_dtype="int8")
CASES = [(3, 5), (4, 4), (2, 6), (7, 5), (5, 8)]
MOE_INPUTS = ("layer0_gate_weight", "layer0_expert_w1", "layer0_expert_b1",
              "layer0_expert_w2", "layer0_expert_b2")

Engine = port_engine.InferenceEngine


@pytest.fixture(scope="module")
def lm():
    with JaxNames():
        js = jax_lm(VOCAB, impl="dense", **CFG)
    with TorchNames():
        ts = torch_lm(VOCAB, **CFG)
        plain = torch_lm(VOCAB, num_layers=1, embed_dim=16, num_heads=2)
    shapes, _, _ = js.infer_shape(data=(2, T), softmax_label=(2, T))
    rng = np.random.RandomState(2)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    pshapes, _, _ = plain.infer_shape(data=(2, T), softmax_label=(2, T))
    pparams = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
               for n, s in zip(plain.list_arguments(), pshapes)
               if n not in ("data", "softmax_label")}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    cases = [(rng.randint(0, VOCAB, (p,)), n) for p, n in CASES]
    jeng = jax_engine.InferenceEngine(
        JaxDecoder(js, jparams, max_len=T, cache_block=None), **ENG)
    jrs = [jeng.submit(p, max_tokens=n) for p, n in cases]
    jeng.serve_forever()
    oracle = JaxDecoder(js, jparams, max_len=T, cache_block=None,
                        weight_dtype="int8")
    want = [r.result().tolist() for r in jrs]
    for (p, n), w in zip(cases, want):
        assert w == np.asarray(oracle.generate(
            p[None], num_steps=n))[0, len(p):].tolist()
    return {"jsym": js, "jparams": jparams, "symbol": ts, "params": params,
            "plain": (plain, pparams), "cases": cases, "want": want}


def _dec(lm, **kw):
    return Decoder(lm["symbol"], lm["params"], max_len=T, device="cpu",
                   **kw)


def _engine(lm, **kw):
    return Engine(_dec(lm), **dict(ENG, **kw))


def _serve(eng, cases):
    rs = [eng.submit(p, max_tokens=n) for p, n in cases]
    eng.serve_forever()
    return [r.result().tolist() for r in rs]


def _assert_placement(eng, ep):
    """Every MoE input a list of ep shards of X/ep experts, each rank's
    values and scales in allocations no other rank shares."""
    for name in MOE_INPUTS:
        shards = eng._params[name]
        assert isinstance(shards, list) and len(shards) == ep, name
        leaves = [[s.q, s.scale] if isinstance(s, QuantizedTensor) else [s]
                  for s in shards]
        for rank in leaves:
            for t in rank:
                assert t.shape[0] == 4 // ep and t.is_contiguous()
        ptrs = [{t.untyped_storage().data_ptr() for t in rank}
                for rank in leaves]
        for a in range(ep):
            for b in range(a + 1, ep):
                assert not ptrs[a] & ptrs[b], name
    w1 = eng._params["layer0_expert_w1"]
    assert all(isinstance(s, QuantizedTensor) and s.q.dtype == torch.int8
               for s in w1)


@pytest.mark.parametrize("kw", [dict(), dict(ep=2), dict(ep=2, tp=2),
                                dict(ep=4)],
                         ids=["ep1", "ep2", "ep2_tp2", "ep4"])
def test_ep_streams_equal_the_jax_engine(lm, kw):
    """Each degree's greedy streams equal the JAX ep=1 engine's (and its
    offline int8 decoder's), with its compile counts; the shards and the
    mesh are as asked, the weight bytes do not depend on the degree."""
    eng = _engine(lm, matmul_impl="pallas", **kw)
    assert _serve(eng, lm["cases"]) == lm["want"]
    assert_compile_contract(eng, copy={})
    ep = kw.get("ep", 1)
    assert eng.ep == ep and eng._geometry()["ep"] == ep
    if ep > 1:
        _assert_placement(eng, ep)
        assert eng._mesh.shape == {"expert": ep, "model": kw.get("tp", 1)}
    assert eng.weight_bytes == _engine(lm).weight_bytes
    eng.close()


def test_ep2_reuse_gauntlet_equals_ep1(lm):
    """The prefix pool, 3-token prefill pieces and n-gram speculation at
    ep=2: streams, prefix hits and accepted drafts equal ep=1's."""
    rng = np.random.RandomState(5)
    base = rng.randint(0, VOCAB, (7,))
    cases = [(base, 3), (base[:4].copy(), 6), (rng.randint(0, VOCAB, (10,)),
                                                3),
             (base.copy(), 3), (np.array([0, 3, 3]), 12)]
    kw = dict(prefix_cache_mb=0.01, prefill_chunk=3, draft="ngram",
              spec_k=3)
    one, two = _engine(lm, **kw), _engine(lm, ep=2, **kw)
    assert _serve(one, cases) == _serve(two, cases)
    for k in ("prefix_hits", "spec_accepted", "spec_drafted"):
        assert one.stats[k] == two.stats[k], k
    assert one.stats["prefix_hits"] >= 1 and one.stats["spec_accepted"] >= 1
    assert one.compile_counts == two.compile_counts


REFUSALS = {
    "ep0": (dict(ep=0), "ep must be >= 1"),
    "no_moe": (dict(ep=2, plain=True), "needs a MoE decoder"),
    "ep3": (dict(ep=3), "must divide num_experts=4"),
    "no_expert_axis": (dict(ep=2, mesh="model2"), "disagrees"),
    "expert_axis_size": (dict(ep=2, mesh="expert4"), "disagrees"),
    "distinct_devices": (dict(ep=2, mesh="cuda01"), "later slice"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_ep_refusals(lm, case):
    """Each refusal raises at construction with the JAX message (the
    distinct-device mesh with the port's "later slice")."""
    kw, match = REFUSALS[case]
    kw = dict(kw)
    meshes = {"model2": lambda: model_parallel_mesh(2, devices=["cpu"] * 2),
              "expert4": lambda: build_mesh({"expert": 4, "model": 1},
                                            ["cpu"] * 4),
              "cuda01": lambda: build_mesh({"expert": 2, "model": 1},
                                           ["cuda:0", "cuda:1"])}
    if isinstance(kw.get("mesh"), str):
        kw["mesh"] = meshes[kw["mesh"]]()
    if kw.pop("plain", False):
        sym, params = lm["plain"]
        dec = Decoder(sym, params, max_len=T, device="cpu")
    else:
        dec = _dec(lm)
    with pytest.raises(MXNetError, match=match):
        Engine(dec, **dict(ENG, **kw))


def test_ep_env_default_and_mesh(lm, monkeypatch):
    """``MXNET_SERVING_EP`` is the default degree; an explicit composed
    mesh gives the ranks; the JAX refusal of a plain LM reads the same
    from both packages."""
    monkeypatch.setenv("MXNET_SERVING_EP", "2")
    eng = _engine(lm)
    assert eng.ep == 2 and len(eng._params["layer0_expert_w2"]) == 2
    monkeypatch.delenv("MXNET_SERVING_EP")
    mesh = build_mesh({"expert": 2, "model": 1}, ["cpu"] * 2)
    eng = _engine(lm, mesh=mesh, ep=2)
    assert eng._mesh is mesh and eng.tp == 1
    assert _serve(eng, lm["cases"][:2]) == lm["want"][:2]


def test_snapshots_carry_ep_across_packages(lm):
    """A port ep=2 snapshot 3 rounds in restores at ep=1 through
    ``overrides`` and at its own ep; a JAX ep=2 snapshot (its geometry
    ``ep: 2``) restores on the port at ep=2. Every stream equals the JAX
    engine's."""
    eng = _engine(lm, ep=2)
    rs = [eng.submit(p, max_tokens=n) for p, n in lm["cases"]]
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    assert snap["engine"]["ep"] == 2
    for over in (dict(ep=1), dict()):
        e2, handles = Engine.restore(snap, _dec(lm), **over)
        assert e2.ep == over.get("ep", 2)
        e2.serve_forever()
        assert [handles[r.id].result().tolist() for r in rs] == lm["want"]
        e2.close()
    e2, handles = Engine.restore(
        snap, _dec(lm), mesh=model_parallel_mesh(2, devices=["cpu"] * 2))
    assert (e2.ep, e2.tp) == (1, 2)
    e2.serve_forever()
    assert [handles[r.id].result().tolist() for r in rs] == lm["want"]

    jeng = jax_engine.InferenceEngine(
        JaxDecoder(lm["jsym"], lm["jparams"], max_len=T, cache_block=None),
        ep=2, **ENG)
    jrs = [jeng.submit(p, max_tokens=n) for p, n in lm["cases"]]
    jsnap = jeng.snapshot()
    assert jsnap["engine"]["ep"] == 2
    e3, handles = Engine.restore(jsnap, _dec(lm))
    assert e3.ep == 2 and isinstance(e3._params["layer0_gate_weight"], list)
    e3.serve_forever()
    assert [handles[r.id].result().tolist() for r in jrs] == lm["want"]


def test_capture_replays_at_its_ep(lm, tmp_path):
    """A capture of an ep=2 engine records ``ep: 2``; ``build_engine``
    rebuilds it at ep=2 (and at ep=1 by override), and the replay
    verifies clean; the CLI replays it from a checkpoint on the host."""
    eng = _engine(lm, ep=2, capture_dir=str(tmp_path / "cap"))
    _serve(eng, lm["cases"])
    eng.close()
    cap = port_capture.load_capture(eng.capture.path)
    assert cap["engine"]["ep"] == 2
    for over, want in ((dict(), 2), (dict(ep=1), 1)):
        rep = port_replay.build_engine(cap, _dec(lm), capture_dir=None,
                                       **over)
        assert rep.ep == want
        out = port_replay.replay(cap, rep, verify=True)
        assert not out["mismatches"], out
    prefix = str(tmp_path / "m")
    save_checkpoint(prefix, 0, lm["symbol"],
                    {k: torch.from_numpy(v) for k, v in lm["params"].items()},
                    {})
    assert port_replay.main([eng.capture.path, "--checkpoint", prefix,
                             "--max-len", str(T), "--device", "cpu",
                             "--verify", "--tp", "2"]) == 0


def test_handoff_beside_an_ep2_engine(lm):
    """The KV cache does not depend on ep: an ep=2 prefill specialist's
    packages admitted by an ep=1 decode specialist, and an ep=1 prefill
    specialist's by an ep=2 decode specialist, give the JAX engine's
    streams."""
    for pre_kw, dec_kw in ((dict(ep=2), dict()), (dict(), dict(ep=2))):
        pre = _engine(lm, role="prefill", **pre_kw)
        dco = _engine(lm, role="decode", **dict(dec_kw, slots=8))
        reqs = []
        for p, n in lm["cases"]:
            pre.submit(p, max_tokens=n)
            pkgs = []
            for _ in range(40):
                pre.step()
                pkgs = pre.take_handoffs()
                if pkgs:
                    break
            for pkg in pkgs:
                reqs.append(dco.admit_handoff(pkg.payload()))
                pkg.resolve()
        dco.serve_forever()
        assert [list(r.tokens) for r in reqs] == lm["want"]
        assert pre.stats["handoffs_out"] == dco.stats["handoffs_in"] == 5
        pre.close()
        dco.close()
