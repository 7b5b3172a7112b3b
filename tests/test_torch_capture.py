"""Traffic capture and replay on the port, against the JAX package: the
cases of ``tests/test_serving_replay.py`` but tensor parallelism — the
capture's header and migration provenance, ``replay --verify`` clean with
speculation off and at another round geometry, onto int8 weights, recorded
pacing, a crash cycle's second capture, the size bound and torn lines —
and the two packages' captures crossing over: a JAX capture replayed on
the port's engine and a port capture on the JAX engine through the
unchanged ``tools/replay_serving.replay``, both ``verify``-clean, and each
package's file loading in the other's ``load_capture``.

The capture source serves the JAX suite's gauntlet (speculation on, a
one-slot prefix pool, chunked prefill, a prompt beyond the largest
bucket) on both packages' engines: the two agree on every request's tokens
and retire reason, on ``stats``, ``compile_counts`` and the ``serving.*``
counter deltas, and their captures record the same submits and retires.
Then ``python -m mxnet_tpu_torch.serving.replay`` is driven through its
``main`` on a saved checkpoint, a 2-replica rolling restart included.

The LM is the JAX suite's (1 layer, vocab 17, E=16, 2 heads, max_len 16,
seeded numpy weights, f32).
"""
import collections
import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import capture as jax_capture
from mxnet_tpu.serving import engine as jax_engine

from mxnet_tpu_torch import telemetry as port_tele
from mxnet_tpu_torch.base import MXNetError as PortError
from mxnet_tpu_torch.model import save_checkpoint
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import capture as port_capture
from mxnet_tpu_torch.serving import engine as port_engine
from mxnet_tpu_torch.serving import replay as port_replay

from check_utils import assert_compile_contract

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import replay_serving as jax_replay  # noqa: E402

VOCAB, T = 17, 16
CFG = dict(num_layers=1, embed_dim=16, num_heads=2)
# the JAX suite's capture source: speculation on, a one-slot pool, chunks
CAP_CFG = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0.0021,
               prefill_chunk=3, draft="ngram", spec_k=3)

Side = collections.namedtuple(
    "Side", "name engine capture replay tele error mkdec")


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
    return {"jax": Side("jax", jax_engine, jax_capture, jax_replay,
                        jax_tele, JaxError, jax_dec),
            "port": Side("port", port_engine, port_capture, port_replay,
                         port_tele, PortError, port_dec),
            "oracle": JaxDecoder(js, jparams, max_len=T),
            "symbol": ts, "params": params}


_ORACLE = {}


def _oracle(lm, prompt, n):
    prompt = np.asarray(prompt)
    n = min(n, T - len(prompt))
    key = (prompt.tobytes(), n)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(lm["oracle"].generate(
            prompt[None], num_steps=n))[0, len(prompt):].tolist()
    return _ORACLE[key]


def _workload(rng):
    """The JAX suite's gauntlet: prefix hits, eviction, chunk boundaries,
    a prompt beyond the largest bucket, a draft-accepting prompt."""
    base = rng.randint(0, VOCAB, (7,))
    return [
        (base, 3),
        (base[:4].copy(), 6),
        (np.concatenate([base[:4], rng.randint(0, VOCAB, (3,))]), 3),
        (rng.randint(0, VOCAB, (2,)), 5),
        (base.copy(), 3),
        (rng.randint(0, VOCAB, (10,)), 3),
        (np.array([0, 3, 3]), 13),
    ]


def _counters(side):
    return {n: m.value for n, m in list(side.tele._state.metrics.items())
            if n.startswith("serving.") and m.kind == "counter"}


def _record(lm, side, cap_dir):
    """Serve the gauntlet on a capturing engine, then a crash cycle
    (snapshot mid-flight, close, restore on the carried capture_dir)."""
    c0 = _counters(side)
    eng = side.engine.InferenceEngine(side.mkdec(), capture_dir=cap_dir,
                                      **CAP_CFG)
    rng = np.random.RandomState(11)
    cases = _workload(rng)
    handles = [eng.submit(p, max_tokens=n) for p, n in cases]
    assert len(eng.serve_forever()) == len(cases)
    assert_compile_contract(eng)
    stats = dict(eng.stats)
    counters = {k: v - c0.get(k, 0) for k, v in _counters(side).items()}
    cc = eng.compile_counts
    p_cut = rng.randint(0, VOCAB, (4,))
    cut = eng.submit(p_cut, max_tokens=6)
    for _ in range(20):
        eng.step()
        if len(cut.tokens) >= 2:
            break
    emitted = len(cut.tokens)
    assert 0 < emitted < 6
    snap = eng.snapshot()
    assert snap["engine"]["capture_dir"] == cap_dir
    path1 = eng.capture.path
    eng.close()
    eng2, resumed = side.engine.InferenceEngine.restore(snap, side.mkdec())
    assert eng2.capture.enabled and eng2.capture.path != path1
    eng2.serve_forever()
    assert list(resumed[cut.id].result()) == _oracle(lm, p_cut, 6)
    path2 = eng2.capture.path
    eng2.close()
    return {"dir": cap_dir, "path": path1, "path2": path2, "cases": cases,
            "handles": handles, "cut": cut, "emitted": emitted,
            "p_cut": p_cut, "stats": stats, "counters": counters,
            "cc": cc}


@pytest.fixture(scope="module")
def captured(lm, tmp_path_factory):
    return {name: _record(lm, lm[name], str(tmp_path_factory.mktemp(name)))
            for name in ("jax", "port")}


def test_capture_equals_jax_capture(lm, captured):
    """The gauntlet on both packages: equal tokens and reasons (each
    equal to offline generate), stats, compile_counts and serving.*
    counter deltas; the two captures hold the same submits (the sampling
    identity included) and retires, and the header every knob
    ``build_engine`` needs."""
    j, p = captured["jax"], captured["port"]
    assert [(h.retire_reason, list(h.tokens)) for h in p["handles"]] == \
        [(h.retire_reason, list(h.tokens)) for h in j["handles"]]
    for h, (prompt, n) in zip(p["handles"], p["cases"]):
        assert list(h.tokens) == _oracle(lm, prompt, n)
    assert p["stats"] == j["stats"]
    assert p["cc"] == j["cc"]
    assert p["counters"] == {k: j["counters"].get(k, 0)
                             for k in p["counters"]}
    caps = {n: port_capture.load_capture(captured[n]["path"])
            for n in ("jax", "port")}
    keys = ("id", "prompt", "max_tokens", "temperature", "seed")
    assert [{k: s[k] for k in keys} for s in caps["port"]["submits"]] == \
        [{k: s[k] for k in keys} for s in caps["jax"]["submits"]]
    assert {i: (r["reason"], r["tokens"])
            for i, r in caps["port"]["retires"].items()} == \
        {i: (r["reason"], r["tokens"])
         for i, r in caps["jax"]["retires"].items()}
    geo = caps["port"]["engine"]
    assert geo["slots"] == 2 and geo["prefill_chunk"] == 3
    assert geo["draft"] == "ngram" and geo["spec_k"] == 3
    assert geo["max_len"] == T and geo["role"] == "unified"
    assert set(geo) == set(caps["jax"]["engine"])
    ts = [s["t"] for s in caps["port"]["submits"]]
    assert ts == sorted(ts) and all(t >= 0 for t in ts)
    cut = p["cut"]
    rec = caps["port"]["retires"][cut.id]
    assert rec["reason"] == "closed" and len(rec["tokens"]) == p["emitted"]
    for h in p["handles"]:
        assert caps["port"]["retires"][h.id]["ttft_ms"] > 0


def test_capture_header_records_migration_provenance(captured):
    for name in ("jax", "port"):
        c1 = port_capture.load_capture(captured[name]["path"])
        c2 = port_capture.load_capture(captured[name]["path2"])
        assert c1["engine"]["engine_id"]
        assert c1["engine"]["migrated_from"] is None
        assert c2["engine"]["migrated_from"] == c1["engine"]["engine_id"]
        assert c2["engine"]["engine_id"] != c1["engine"]["engine_id"]


@pytest.fixture(scope="module")
def replay_spec_off(lm, captured):
    cap = port_capture.load_capture(captured["port"]["path"])
    eng = port_replay.build_engine(cap, lm["port"].mkdec(), draft="off")
    return eng, port_replay.replay(cap, eng, timing="max", verify=True)


def test_replay_verify_spec_off_byte_identical(captured, replay_spec_off):
    eng, report = replay_spec_off
    assert report["verified"] == len(captured["port"]["cases"])
    assert report["verified_prefix"] == 1          # the crash-cut one
    assert report["mismatches"] == [] and report["verify_skipped"] == 0
    assert report["verify_mode"] == "exact"
    assert_compile_contract(eng, verify=0)
    assert report["recorded"]["ttft_p50_ms"] > 0
    assert report["requests"] == report["replayed"]
    assert not eng.capture.enabled                 # no re-capture


def test_replay_verify_different_round_geometry(lm, captured):
    cap = port_capture.load_capture(captured["port"]["path"])
    eng = port_replay.build_engine(cap, lm["port"].mkdec(),
                                   steps_per_round=2, prefix_cache_mb=0)
    assert eng.steps_per_round == 2 and eng._prefix is None
    report = port_replay.replay(cap, eng, timing="max", verify=True)
    assert report["verified"] == len(captured["port"]["cases"])
    assert report["verified_prefix"] == 1 and report["mismatches"] == []
    assert_compile_contract(eng, copy={})


def test_replay_verify_weight_dtype_int8(lm, captured):
    """The float capture onto int8 weights: verify switches to the prefix
    mode by itself, and this workload agrees in full."""
    cap = port_capture.load_capture(captured["port"]["path"])
    eng = port_replay.build_engine(cap, lm["port"].mkdec(),
                                   weight_dtype="int8")
    assert eng.weight_dtype == "int8"
    report = port_replay.replay(cap, eng, timing="max", verify=True)
    assert report["verify_mode"] == "prefix"
    assert report["mismatches"] == []
    assert report["verified_prefix"] == len(captured["port"]["cases"]) + 1
    assert report["verified"] == 0
    assert_compile_contract(eng)


def test_replay_recorded_timing_paces_arrivals(captured, replay_spec_off,
                                               monkeypatch):
    """``recorded`` holds the second submit until the captured 0.25 s have
    passed (the engine steps in between); ``max`` submits both before its
    first step. Zero new programs."""
    eng, _ = replay_spec_off
    events = []
    submit, step = eng.submit, eng.step

    def logged_submit(*a, **kw):
        events.append("submit")
        return submit(*a, **kw)

    def logged_step():
        events.append("step")
        return step()
    monkeypatch.setattr(eng, "submit", logged_submit)
    monkeypatch.setattr(eng, "step", logged_step)
    cap = port_capture.load_capture(captured["port"]["path"])
    rng = np.random.RandomState(3)
    sub = [{"kind": "submit", "t": t, "id": "pace-%d" % i,
            "prompt": rng.randint(0, VOCAB, (4,)).tolist(),
            "max_tokens": 2, "temperature": 0.0, "seed": i}
           for i, t in enumerate((0.0, 0.25))]
    cap2 = {"engine": cap["engine"], "version": 1, "submits": sub,
            "retires": {}}
    log_len = len(eng._compile_log)
    rep = port_replay.replay(cap2, eng, timing="recorded")
    assert rep["wall_s"] >= 0.25 and rep["replayed"] == 2
    first = events.index("submit")
    assert "step" in events[first:events.index("submit", first + 1)]
    del events[:]
    rep_max = port_replay.replay(cap2, eng, timing="max")
    assert rep_max["replayed"] == 2 and events[:2] == ["submit", "submit"]
    assert len(eng._compile_log) == log_len
    with pytest.raises(ValueError, match="timing"):
        port_replay.replay(cap2, eng, timing="bogus")
    with pytest.raises(ValueError, match="verify_mode"):
        port_replay.replay(cap2, eng, verify_mode="bogus")


def test_crash_cycle_second_capture_resumes(lm, captured):
    """The restored engine's capture holds the resubmit with the pre-crash
    tokens as resume_tokens and the completed continuation — on both
    packages, the same records."""
    recs = {}
    for name in ("jax", "port"):
        c = captured[name]
        assert c["path2"] != c["path"]
        assert os.path.dirname(c["path2"]) == c["dir"]
        cap2 = port_capture.load_capture(c["path2"])
        cut = c["cut"]
        sub = {s["id"]: s for s in cap2["submits"]}[cut.id]
        assert sub["resume_tokens"] == \
            [int(t) for t in cut.tokens[:c["emitted"]]]
        ret = cap2["retires"][cut.id]
        assert ret["reason"] in ("eos", "length")
        assert ret["tokens"] == _oracle(lm, c["p_cut"], 6)
        recs[name] = (sub["resume_tokens"], ret["tokens"])
    assert recs["port"] == recs["jax"]


class _FakeReq:
    """Just what CaptureStream reads."""

    def __init__(self, rid, prompt=(1, 2, 3), tokens=(), resumed=0):
        self.id = rid
        self.prompt = np.asarray(prompt, np.int64)
        self.max_tokens = 4
        self.eos_id = None
        self.temperature = 0.0
        self.seed = 7
        self.deadline_ms = None
        self.ttft_deadline_ms = None
        self.resumed = resumed
        self.tokens = list(tokens)
        self.t_submit = 100.0
        self.t_first = 100.5
        self.t_done = 101.0
        self.retire_reason = "length"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_capture_stream_size_bound_and_terminal_retires(tmp_path, writer):
    """Past the byte budget new submits are skipped (counted); the retire
    of a captured submit always lands, that of a skipped one never; the
    two packages' streams write the same bytes and each loads in the
    other's loader."""
    mod = {"jax": jax_capture, "port": port_capture}[writer]
    path = str(tmp_path / "cap.jsonl")
    st = mod.CaptureStream(path, max_bytes=400, header={"slots": 1})
    st._t0 = 0.0
    st.submit(_FakeReq("a"))
    for i in range(50):
        st.submit(_FakeReq("fill-%d" % i))
    assert st.skipped > 0
    ids = {json.loads(line)["id"] for line in open(path)
           if '"submit"' in line}
    assert "a" in ids and len(ids) < 51
    st.retire(_FakeReq("a", tokens=(5, 6)))
    st.retire(_FakeReq("fill-49", tokens=(9,)))
    st.close()
    for loader in (jax_capture.load_capture, port_capture.load_capture):
        cap = loader(path)
        assert cap["retires"]["a"]["tokens"] == [5, 6]
        assert "fill-49" not in cap["retires"]
        assert len(cap["submits"]) == len(ids)
    other = {"jax": port_capture, "port": jax_capture}[writer]
    path2 = str(tmp_path / "cap2.jsonl")
    st2 = other.CaptureStream(path2, max_bytes=400, header={"slots": 1})
    st2._t0 = 0.0
    st2.submit(_FakeReq("a"))
    for i in range(50):
        st2.submit(_FakeReq("fill-%d" % i))
    st2.retire(_FakeReq("a", tokens=(5, 6)))
    st2.close()
    with open(path2) as f2:
        lines2 = f2.read().splitlines()
    with open(path) as f1:
        assert f1.read().splitlines()[:len(lines2)] == lines2


def test_capture_loader_torn_line_and_validation(tmp_path):
    path = str(tmp_path / "cap.jsonl")
    st = port_capture.CaptureStream(path, max_bytes=1 << 20,
                                    header={"slots": 1})
    st._t0 = 0.0
    st.submit(_FakeReq("x"))
    st.retire(_FakeReq("x", tokens=(1,)))
    st.close()
    with open(path, "a") as f:
        f.write('{"kind": "submit", "t": 9, "id": "to')     # torn
    for loader in (port_capture.load_capture, jax_capture.load_capture):
        cap = loader(path)
        assert len(cap["submits"]) == 1 and "x" in cap["retires"]
    lines = open(path).read().splitlines()
    bad = str(tmp_path / "bad.jsonl")
    open(bad, "w").write("\n".join([lines[0], "not json", lines[1]]))
    with pytest.raises(PortError, match="unparseable"):
        port_capture.load_capture(bad)
    nohdr = str(tmp_path / "nohdr.jsonl")
    open(nohdr, "w").write(lines[1] + "\n")
    with pytest.raises(PortError, match="header"):
        port_capture.load_capture(nohdr)
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").write("")
    with pytest.raises(PortError, match="empty"):
        port_capture.load_capture(empty)
    with pytest.raises(PortError, match="CAPTURE_MB"):
        port_capture.CaptureStream.open(str(tmp_path), 0, {"slots": 1}, 0.0)
    st2 = port_capture.CaptureStream(str(tmp_path / "iso.jsonl"), 1 << 20,
                                     {"slots": 1})
    st2._t0 = 0.0
    st2.submit(_FakeReq(object()))           # unserializable id
    assert st2.skipped == 1 and st2.enabled

    class _BoomFile:
        def write(self, s):
            raise OSError("disk full")

        def flush(self):
            pass

        def close(self):
            pass

    st2._f = _BoomFile()
    st2.submit(_FakeReq("ok-id"))
    assert not st2.enabled
    st2.submit(_FakeReq("after"))
    st2.close()
    off = port_capture.CaptureStream.open(None, None, {"slots": 1}, 0.0)
    assert not off.enabled
    off.submit(_FakeReq("y"))
    off.retire(_FakeReq("y"))
    off.close()


def test_capture_dir_env_default_and_engine_knobs(lm, tmp_path,
                                                  monkeypatch):
    """``MXNET_SERVING_CAPTURE_DIR`` arms capture, ``capture_mb`` bounds
    it, ``snapshot()`` carries the directory, and a file that is not a
    directory is refused — as on the JAX engine."""
    side = lm["port"]
    monkeypatch.setenv("MXNET_SERVING_CAPTURE_DIR", str(tmp_path / "env"))
    eng = side.engine.InferenceEngine(side.mkdec(), slots=2,
                                      prefill_buckets=(4, 8),
                                      capture_mb=0.001)
    assert eng.capture.enabled and eng.capture.max_bytes == 1048
    assert eng.snapshot()["engine"]["capture_dir"] == str(tmp_path / "env")
    eng.close()
    monkeypatch.delenv("MXNET_SERVING_CAPTURE_DIR")
    afile = tmp_path / "afile"
    afile.write_text("x")
    with pytest.raises(PortError, match="not a directory"):
        side.engine.InferenceEngine(side.mkdec(), capture_dir=str(afile))


def test_jax_capture_replays_on_port_and_port_capture_on_jax(lm, captured):
    """A JAX capture verifies clean on the port's engine (its attention
    read becomes the port's paged one), and a port capture on the JAX
    engine through the unchanged ``tools/replay_serving.replay``."""
    jcap = jax_capture.load_capture(captured["jax"]["path"])
    n = len(captured["jax"]["cases"])
    eng = port_replay.build_engine(jcap, lm["port"].mkdec())
    rep = port_replay.replay(jcap, eng, timing="max", verify=True)
    assert rep["mismatches"] == [] and rep["verified"] == n
    assert rep["verified_prefix"] == 1
    assert_compile_contract(eng)
    pcap = jax_capture.load_capture(captured["port"]["path"])
    jeng = jax_replay.build_engine(pcap, lm["jax"].mkdec(),
                                   attn_impl="dense")
    rep = jax_replay.replay(pcap, jeng, timing="max", verify=True)
    assert rep["mismatches"] == [] and rep["verified"] == n
    assert rep["verified_prefix"] == 1


def test_replay_cli(lm, captured, tmp_path, capsys):
    """``python -m mxnet_tpu_torch.serving.replay``'s ``main`` on a saved
    checkpoint: verify clean, then through a 2-replica fleet with a rolling
    restart (zero failed), then on a tp=2 engine (``--tp 2``, two ranks on
    the host), verify clean."""
    prefix = str(tmp_path / "lm")
    save_checkpoint(prefix, 0, lm["symbol"], lm["params"], {})
    path = captured["port"]["path"]
    base = [path, "--checkpoint", prefix, "--device", "cpu", "--timing",
            "max", "--verify"]
    assert port_replay.main(base) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["mismatches"] == [] and rep["captured_role"] == "unified"
    assert rep["verified"] == len(captured["port"]["cases"])
    assert port_replay.main(base + ["--replicas", "2",
                                    "--rolling-restart"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["mismatches"] == []
    assert rep["fleet"]["drains"] == 2
    assert rep["fleet"].get("failovers", 0) == 0
    assert port_replay.main(base + ["--tp", "2"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["mismatches"] == [] and rep["overrides"]["tp"] == 2
    assert rep["verified"] == len(captured["port"]["cases"])
