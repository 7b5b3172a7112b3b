"""The mixture-of-experts LM on the port against the JAX package, on the CPU.

``MoEFFN`` (soft and top-k routing, the tie rule, the refusal, gradients
of every input), its expert-parallel form over rank shards, the MoE LM's
symbol and one trainer step, checkpoints in both directions, the
quantized expert stacks (bitwise JAX's), ``moe_ffn_forward`` with the
plain and the kernel hook, ``MXNET_QUANT_GROUP``/``MXNET_QUANT_CHUNK``,
and ``Decoder.generate`` on a MoE LM with float, int8 and int4 weights.

Inputs are drawn from numpy seeds and go through both packages. The JAX
side runs as its own tests run it on the CPU (its ``quant_matmul`` in
interpret mode); the port's wrappers run their plain versions, as CPU
tensors take them. Tolerances (f32 on both sides, which sum in other
orders): the op at rtol/atol 1e-5 (1e-4/1e-5 against the numpy oracle, the
JAX test's); the expert-parallel form at 1e-6 of ep=1's (the host's
products over a rank's experts round by their width); decoder logits at
2e-5; trainer deltas within 1e-3 of JAX's by per-tensor norm.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jax_par
from mxnet_tpu.model import load_checkpoint as jax_load
from mxnet_tpu.model import save_checkpoint as jax_save
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.models import transformer as jax_transformer
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.ops import registry as jax_reg
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import quant as jax_quant

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.model import (load_checkpoint, params_from_numpy,
                                   save_checkpoint)
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.ops import attention as tattention
from mxnet_tpu_torch.ops import registry as reg
from mxnet_tpu_torch.parallel import Decoder, ParallelTrainer
from mxnet_tpu_torch.serving import quant

TOL = dict(rtol=1e-5, atol=1e-5)
B, T, E, X, H = 2, 3, 8, 4, 16


def _op_inputs(seed, zero_gate=False):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, E).astype(np.float32),
            np.zeros((X, E), np.float32) if zero_gate
            else rng.randn(X, E).astype(np.float32),
            (rng.randn(X, H, E) * 0.1).astype(np.float32),
            (rng.randn(X, H) * 0.1).astype(np.float32),
            (rng.randn(X, E, H) * 0.1).astype(np.float32),
            (rng.randn(X, E) * 0.1).astype(np.float32)]


def _numpy_oracle(ins, k):
    """``tests/test_parallel.py``'s oracle: the k largest gates of each
    token (the lower index first among equals), renormalized."""
    x, gate_w, w1, b1, w2, b2 = ins
    logits = np.einsum("bte,xe->btx", x, gate_w)
    out = np.zeros(x.shape, np.float64)
    for b in range(x.shape[0]):
        for t in range(x.shape[1]):
            order = np.argsort(-logits[b, t], kind="stable")[:k or X]
            kept = logits[b, t, order]
            gs = np.exp(kept - kept.max())
            gs /= gs.sum()
            for g_, xi in zip(gs, order):
                hpre = np.maximum(w1[xi] @ x[b, t] + b1[xi], 0)
                out[b, t] += g_ * (w2[xi] @ hpre + b2[xi])
    return out


def _port_op(ins, k, grad=False):
    spec = reg.get("MoEFFN")
    p = spec.parse_params({"num_experts": X, "hidden": H, "top_k": k})
    tins = [torch.from_numpy(a.copy()).requires_grad_(grad) for a in ins]
    return spec.forward(p, tins, [], False, None)[0][0], tins


def _jax_op(ins, k):
    spec = jax_reg.get("MoEFFN")
    p = spec.parse_params({"num_experts": X, "hidden": H, "top_k": k})
    return lambda *xs: spec.forward(p, list(xs), [], False, None)[0][0]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_moe_op_and_gradients_match_jax(k):
    """Soft (k=0) and top-k routing: the forward against the JAX op and
    the numpy oracle, and the gradients of sum(out * g) with respect to
    all six inputs against ``jax.grad``."""
    ins = _op_inputs(k)
    g = np.random.RandomState(9).randn(B, T, E).astype(np.float32)
    f = _jax_op(ins, k)
    out_j, grads_j = jax.value_and_grad(
        lambda *xs: jnp.sum(f(*xs) * g), argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in ins])
    out_t, tins = _port_op(ins, k, grad=True)
    np.testing.assert_allclose(out_t.detach().numpy(),
                               np.asarray(f(*[jnp.asarray(a) for a in ins])),
                               **TOL)
    np.testing.assert_allclose(out_t.detach().numpy(), _numpy_oracle(ins, k),
                               rtol=1e-4, atol=1e-5)
    (out_t * torch.from_numpy(g)).sum().backward()
    assert np.isclose((out_t.detach().numpy() * g).sum(), float(out_j),
                      rtol=1e-5)
    for i, (a, gj) in enumerate(zip(tins, grads_j)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj),
                                   err_msg="input %d" % i, **TOL)


def test_moe_ties_route_to_exactly_k_lowest_indices():
    """An all-zero gate ties every logit: exactly k experts carry weight,
    experts 0..k-1 at 1/k each (``tests/test_parallel.py``'s tie case); a
    partial tie keeps the lower indices among the equal ones."""
    k = 2
    ins = _op_inputs(1, zero_gate=True)
    out, _ = _port_op(ins, k)
    x, _, w1, b1, w2, b2 = ins
    ref = np.zeros((B, T, E))
    for b in range(B):
        for t in range(T):
            for xi in range(k):
                h = np.maximum(w1[xi] @ x[b, t] + b1[xi], 0)
                ref[b, t] += (w2[xi] @ h + b2[xi]) / k
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(_jax_op(ins, k)(
            *[jnp.asarray(a) for a in ins])), **TOL)
    p = {"num_experts": 5, "top_k": 2}
    logits = torch.tensor([[[1.0, 3.0, 1.0, 3.0, 3.0]]])
    gates = tattention._moe_gates(p, logits)[0, 0]
    assert (gates > 0).tolist() == [False, True, False, True, False]
    gates = tattention._moe_gates(p, torch.tensor([[[2.0, 1.0, 1.0, 1.0,
                                                     0.5]]]))[0, 0]
    assert (gates > 0).tolist() == [True, True, False, False, False]


@pytest.mark.parametrize("k", [1, 2, 5, 7])
def test_top_k_mask_is_the_stable_sort(k):
    """The routing mask keeps exactly the first k of a stable descending
    sort of each row, on logits with many ties (integers in [0, 3)), and
    equals ``lax.top_k``'s indices in the JAX op's one-hot form."""
    logits = np.random.RandomState(k).randint(0, 3, (64, 8)).astype(
        np.float32)
    gates = tattention._moe_gates({"num_experts": 8, "top_k": k},
                                  torch.from_numpy(logits))
    kept = (gates > 0).numpy()
    order = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    want = np.zeros_like(kept)
    np.put_along_axis(want, order, True, axis=-1)
    assert np.array_equal(kept, want)
    _, idx = jax.lax.top_k(jnp.asarray(logits), k)
    assert np.array_equal(np.sort(np.asarray(idx), -1), np.sort(order, -1))


def test_moe_top_k_at_least_num_experts_raises():
    ins = _op_inputs(2)
    with pytest.raises(MXNetError, match="top_k=4 must be < num_experts=4"):
        _port_op(ins, X)
    with pytest.raises(mx.base.MXNetError,
                       match="top_k=4 must be < num_experts=4"):
        _jax_op(ins, X)(*[jnp.asarray(a) for a in ins])


@pytest.mark.parametrize("n,k", [(2, 2), (4, 1), (2, 0)])
def test_moe_expert_parallel_over_rank_shards(n, k):
    """``ep=("expert", n)``: the gate and the stacks as n rank shards on
    ``["cpu"] * n``: the output within 1e-6 of ep=1's (the combine is the
    same reduction, but the host's products over a rank's experts round
    by their width), on rank 0's device, and its gradients reach every
    shard. A shard count that is not n raises."""
    ins = _op_inputs(3 + n + k)
    want, _ = _port_op(ins, k)
    p = {"num_experts": X, "hidden": H, "top_k": k}
    shards = [[torch.from_numpy(c.copy()).requires_grad_(True)
               for c in np.split(a, n)] for a in ins[1:]]
    x = torch.from_numpy(ins[0])
    got = tattention.moe_ffn_math(p, [x] + shards, ep=("expert", n))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    got.sum().backward()
    assert all(s.grad is not None for ss in shards for s in ss)
    with pytest.raises(MXNetError, match="list of 3 rank shards"):
        tattention.moe_ffn_math(p, [x] + shards, ep=("expert", 3))


# -- the LM symbol, training and checkpoints ---------------------------------

VOCAB = 29
LM = dict(num_layers=2, embed_dim=16, num_heads=2, num_experts=4,
          moe_top_k=2)


def _lm_pair(**kw):
    kw = dict(LM, **kw)
    with JaxNames():
        js = jax_lm(VOCAB, impl="dense", **kw)
    with TorchNames():
        ts = get_transformer_lm(VOCAB, **kw)
    return js, ts


def _lm_params(sym, t, seed=0):
    shapes, _, _ = sym.infer_shape(data=(2, t), softmax_label=(2, t))
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


@pytest.mark.parametrize("kw", [dict(), dict(moe_top_k=0),
                                dict(pos_encoding="rope", num_kv_heads=1)],
                         ids=["top2", "soft", "rope_gqa"])
def test_moe_lm_symbol_matches_jax(kw):
    """Argument names, order and shapes equal the JAX package's; the
    nodes are ``moe_transformer_block``'s; ``ep_rules`` are JAX's."""
    js, ts = _lm_pair(**kw)
    assert ts.list_arguments() == js.list_arguments()
    shapes = {"data": (2, 8), "softmax_label": (2, 8)}
    assert ts.infer_shape(**shapes)[0] == \
        [tuple(s) for s in js.infer_shape(**shapes)[0]]
    moe = [n for n in ts._topo() if not n.is_var
           and n.spec.name == "MoEFFN"]
    assert [n.name for n in moe] == ["layer0_moe", "layer1_moe"]
    assert moe[0].params == {"num_experts": 4, "hidden": 64,
                             "top_k": kw.get("moe_top_k", 2)}
    assert [(r, tuple(s)) for r, s in ttransformer.ep_rules()] == \
        [(r, tuple(s)) for r, s in jax_transformer.ep_rules()]


def _deltas(before, after):
    return {k: np.asarray(after[k], np.float64) - before[k] for k in before}


def test_moe_trainer_step_matches_jax():
    """One f32 SGD-momentum step of the 2-layer top-2 MoE LM from the same
    numpy weights: every parameter's delta within 1e-3 of the JAX
    trainer's by per-tensor norm (and the gate and the stacks moved)."""
    js, ts = _lm_pair()
    t = 8
    shapes = {"data": (2, t), "softmax_label": (2, t)}
    init = _lm_params(js, t, seed=4)
    rs = np.random.RandomState(5)
    batch = {"data": rs.randint(0, VOCAB, (2, t)).astype(np.int32),
             "softmax_label": rs.randint(0, VOCAB, (2, t)).astype(np.int32)}
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    jt = jax_par.ParallelTrainer(js, shapes, optimizer="sgd",
                                 mesh=jax_par.data_parallel_mesh(1),
                                 optimizer_params=dict(sgd))
    jt.init_params({k: mx.nd.array(v) for k, v in init.items()})
    jt.step(batch)
    want = _deltas(init, {k: v.asnumpy()
                          for k, v in jt.get_params()[0].items()})
    tt = ParallelTrainer(ts, shapes, optimizer="sgd",
                         optimizer_params=dict(sgd), device="cpu")
    tt.init_params(params_from_numpy(init, "cpu", symbol=ts,
                                     input_shapes=shapes))
    tt.step(batch)
    got = _deltas(init, {k: v.numpy() for k, v in tt.get_params()[0].items()})
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 1e-3 * max(np.linalg.norm(want[k]), 1e-12), k
    for k in ("layer0_gate_weight", "layer1_expert_w1", "layer0_expert_w2"):
        assert np.linalg.norm(want[k]) > 0, k


def test_moe_checkpoints_load_in_both_packages(tmp_path):
    """The rank-3 stacks and the [X, E] gates cross unchanged: a JAX
    checkpoint loads in the port (and ``params_from_numpy`` checks its
    shapes against the symbol), the port's loads in the JAX package."""
    js, ts = _lm_pair()
    init = _lm_params(js, 8, seed=6)
    jax_save(str(tmp_path / "j"), 0, js,
             {k: mx.nd.array(v) for k, v in init.items()}, {})
    sym, args, _ = load_checkpoint(str(tmp_path / "j"), 0)
    assert sym.list_arguments() == ts.list_arguments()
    placed = params_from_numpy({k: v.asnumpy() for k, v in args.items()},
                               "cpu", symbol=ts,
                               input_shapes={"data": (1, 8)})
    for k, v in init.items():
        assert np.array_equal(placed[k].numpy(), v), k
    assert placed["layer0_expert_w2"].shape == (4, 16, 64)
    save_checkpoint(str(tmp_path / "t"), 0, ts,
                    {k: torch.from_numpy(v) for k, v in init.items()}, {})
    _, jargs, _ = jax_load(str(tmp_path / "t"), 0)
    for k, v in init.items():
        assert np.array_equal(jargs[k].asnumpy(), v), k
    bad = dict(init, layer0_gate_weight=np.zeros((3, 16), np.float32))
    with pytest.raises(MXNetError, match="layer0_gate_weight"):
        params_from_numpy(bad, "cpu", symbol=ts,
                          input_shapes={"data": (1, 8)})


# -- quantization ------------------------------------------------------------

def test_quantized_weight_names_on_a_moe_symbol():
    """The gate and both stacks join the set (JAX
    ``tests/test_serving_quant.py``'s selection), the biases do not: the
    same set as the JAX package's."""
    js, ts = _lm_pair(num_layers=1)
    names = quant.quantized_weight_names(ts._topo())
    assert names == jax_quant.quantized_weight_names(js._topo())
    assert {"layer0_gate_weight", "layer0_expert_w1",
            "layer0_expert_w2"} <= names
    assert not any("_b1" in n or "_b2" in n or "bias" in n
                   for n in names)


@pytest.mark.parametrize("bits,group", [(8, None), (4, None), (4, 8)])
def test_quantized_stacks_bitwise_jax(bits, group):
    """``quantize_tensor`` on the rank-3 stacks and the gate: values (or
    packed nibbles) and scales bitwise the JAX package's, one scale a
    ``[X, out]`` row (int8) or a group of it (int4)."""
    ins = _op_inputs(7)
    for w in (ins[1], ins[2], ins[4]):
        got = quant.quantize_tensor(torch.from_numpy(w), bits=bits,
                                    group=group)
        want = jax_quant.quantize_tensor(jnp.asarray(w), bits=bits,
                                         group=group)
        assert np.array_equal(got.q.numpy(), np.asarray(want.q))
        assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
        assert got.group == want.group
        assert got.scale.shape[:w.ndim - 1] == w.shape[:-1]


def _quantized_ins(ins, bits):
    return ([torch.from_numpy(ins[0])]
            + [quant.quantize_tensor(torch.from_numpy(a), bits=bits)
               if j in (1, 2, 4) else torch.from_numpy(a)
               for j, a in enumerate(ins) if j]), \
        ([jnp.asarray(ins[0])]
         + [jax_quant.quantize_tensor(jnp.asarray(a), bits=bits)
            if j in (1, 2, 4) else jnp.asarray(a)
            for j, a in enumerate(ins) if j])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("hook", ["plain", "kernel"])
def test_moe_ffn_forward_matches_jax(bits, hook):
    """``moe_ffn_forward`` on quantized gate and stacks, top-2: with
    ``mm=None`` (the chunked plain products) and with the kernel hook (the
    port's ``quant_matmul`` wrapper, its plain version on CPU tensors;
    the JAX package's ``quant_matmul`` in interpret mode), against the JAX
    function on the same quantized weights."""
    from mxnet_tpu.ops import pallas_kernels as jk
    from mxnet_tpu_torch.ops import kernels as tk

    ins = _op_inputs(8 + bits)
    tins, jins = _quantized_ins(ins, bits)
    p = {"num_experts": X, "hidden": H, "top_k": 2}
    tmm = jmm = None
    if hook == "kernel":
        def tmm(x, qt):
            out = tk.quant_matmul(x.reshape(-1, x.shape[-1]), qt.q, qt.scale,
                                  bits=qt.bits, group=qt.group)
            return out.reshape(tuple(x.shape[:-1]) + (qt.q.shape[0],))

        def jmm(x, qt):
            out = jk.quant_matmul(x.reshape(-1, x.shape[-1]), qt.q, qt.scale,
                                  bits=qt.bits, group=qt.group)
            return out.reshape(x.shape[:-1] + (qt.q.shape[0],))
    got = quant.moe_ffn_forward(p, tins, mm=tmm)
    want = jax_quant.moe_ffn_forward(p, jins, mm=jmm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fp, _ = _port_op(ins, 2)
    assert np.abs(got.numpy() - fp.numpy()).max() < (0.02 if bits == 8
                                                     else 0.2)


def test_kernel_slice_copies_a_misaligned_expert():
    """The kernel's 16-byte loads: an expert of a stack whose experts are
    16-byte multiples apart is a view of the stack; one whose offset is
    not is copied into its own allocation, never handed over misaligned
    and never diverted to the plain product."""
    ok = quant.quantize_tensor(torch.randn(4, 8, 32))
    assert quant._kernel_slice(ok, 1).q.data_ptr() == ok.q[1].data_ptr()
    odd = quant.quantize_tensor(torch.randn(4, 3, 6))    # 18 bytes apart
    for i in range(4):
        w = quant._kernel_slice(odd, i)
        assert w.q.data_ptr() % 16 == 0
        assert torch.equal(w.q, odd.q[i]) and torch.equal(w.scale,
                                                          odd.scale[i])


GROUP_ENV = [("", 16, 16, None), ("4", 16, 4, None),
             ("6", 16, None, "MXNET_QUANT_GROUP=6 must be a positive even "
              "divisor of the contraction axis \\(16 here\\)")]


@pytest.mark.parametrize("env,n,want,err", GROUP_ENV,
                         ids=["unset", "4", "6"])
def test_quant_group_env_as_jax(monkeypatch, env, n, want, err):
    """``MXNET_QUANT_GROUP`` sets ``resolve_group``'s group (unset: the
    auto pick), a non-divisor raises JAX's message; an explicit group
    wins over it."""
    monkeypatch.setenv("MXNET_QUANT_GROUP", env)
    if err is None:
        assert quant.resolve_group(n) == jax_quant.resolve_group(n) == want
        assert quant.resolve_group(n, 2) == jax_quant.resolve_group(n, 2)
        return
    for fn, exc in ((quant.resolve_group, MXNetError),
                    (jax_quant.resolve_group, mx.base.MXNetError)):
        with pytest.raises(exc, match=err):
            fn(n)


CHUNK_ENV = [("", 64, 8), ("0", 64, 8), ("16", 64, 16), ("64", 64, None),
             ("200", 64, None), ("7", 64, "must divide"),
             ("x", 64, "not an integer")]


@pytest.mark.parametrize("env,f,want", CHUNK_ENV,
                         ids=[c[0] or "unset" for c in CHUNK_ENV])
def test_quant_chunk_env_as_jax(monkeypatch, env, f, want):
    """``MXNET_QUANT_CHUNK``: 0 or unset the auto pick, a divisor that
    chunk, one >= F whole (None), anything else raises JAX's message; the
    chunked plain product equals the whole one bitwise."""
    monkeypatch.setenv("MXNET_QUANT_CHUNK", env)
    if isinstance(want, str):
        for fn, exc in ((quant.resolve_chunk, MXNetError),
                        (jax_quant.resolve_chunk, mx.base.MXNetError)):
            with pytest.raises(exc, match=want):
                fn(f)
        return
    assert quant.resolve_chunk(f) == jax_quant.resolve_chunk(f) == want
    qt = quant.quantize_tensor(torch.randn(f, 32, generator=torch.Generator(
        ).manual_seed(f)))
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    got = quant.scale_fused_matmul(x, qt)
    monkeypatch.setenv("MXNET_QUANT_CHUNK", "0")
    assert torch.equal(got, quant.scale_fused_matmul(x, qt))


# -- the decoder --------------------------------------------------------------

DEC_T = 16


@pytest.fixture(scope="module")
def moe_lm():
    js, ts = _lm_pair(moe_top_k=2, num_experts=3)
    params = _lm_params(js, DEC_T, seed=2)
    return js, ts, params


@pytest.mark.parametrize("wd", ["float", "int8", "int4"])
def test_generate_on_a_moe_lm_matches_jax(moe_lm, wd):
    """``Decoder.generate`` on the 2-layer top-2 MoE LM (3 experts):
    greedy tokens equal the JAX decoder's at ``matmul_impl="dense"`` and
    ``"pallas"`` (the kernel hook, plain here), and the prompt's logits
    within 2e-5; quantized, the stacks are ``QuantizedTensor``s (JAX
    ``tests/test_decode.py`` and ``tests/test_serving_quant.py``'s MoE
    cases)."""
    js, ts, params = moe_lm
    prompt = np.random.RandomState(3).randint(0, VOCAB, (2, 4))
    jd = JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                    max_len=DEC_T, cache_block=None, weight_dtype=wd)
    want = np.asarray(jd.generate(prompt, num_steps=8))
    jl, _ = jd._run(jd._params, jd._aux, jd.init_cache(2), 0,
                    jnp.asarray(prompt))
    for mm in ("dense", "pallas"):
        td = Decoder(ts, params, max_len=DEC_T, weight_dtype=wd,
                     matmul_impl=mm, device="cpu")
        if wd != "float":
            assert isinstance(td._params["layer0_expert_w2"],
                              quant.QuantizedTensor)
        assert np.array_equal(td.generate(prompt, 8).numpy(), want), mm
        tl, _ = td._run(td._params, td._aux, td.init_cache(2), 0,
                        torch.as_tensor(prompt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                                   atol=2e-5)
