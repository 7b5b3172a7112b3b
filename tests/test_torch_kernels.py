"""The PyTorch port's serving kernels against the JAX package's.

Each case makes its inputs with numpy from a seed, runs them through the
JAX function (the Pallas kernel under the interpreter, as the JAX tests
run it on the CPU) and through the port's wrapper on CPU tensors, which
takes the plain PyTorch version. Tolerance: f32 on both sides, rtol and
atol 1e-5 — the two sum in other orders (and the plain attention uses one
softmax where the Pallas kernel streams), so the results agree to a few
ulps, not bitwise. The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.serving.quant import quantize_tensor as jax_quantize

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as K

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qweights(rng, f, e, bits, group):
    """JAX-quantized weights as numpy (the same bytes go to both sides)."""
    w = rng.uniform(-0.5, 0.5, (f, e)).astype(np.float32)
    qt = jax_quantize(jnp.asarray(w), bits=bits, group=group)
    return np.asarray(qt.q), np.asarray(qt.scale), qt.group


# -- paged_attention ----------------------------------------------------------

def _paged_cases():
    """(quant, h, kv, c, d, l, pos, block_k): decode reads and short chunks
    at L=32 (ids where-c-h-kv-quant), then chunks of the sizes the chunk
    entry takes on the card: ragged (C=100), at an offset (pos 300, C=128,
    L=512) and GQA at C=64."""
    cases = []
    for where in ("start", "end"):
        for c in (1, 4):
            for h, kv in ((4, 4), (4, 2)):
                for quant in (False, True):
                    pos = [0, 1] if where == "start" else [32 - c, 32 - c - 3]
                    cases.append(pytest.param(
                        quant, h, kv, c, 8, 32, pos, 8,
                        id="%s-%d-%d-%d-%s" % (where, c, h, kv,
                                               "int8" if quant else "float")))
    cases += [
        pytest.param(False, 4, 2, 100, 16, 128, [0, 28], None,
                     id="ragged-100-4-2-float"),
        pytest.param(False, 4, 4, 128, 16, 512, [300, 384], None,
                     id="offset-128-4-4-float"),
        pytest.param(False, 6, 2, 64, 16, 128, [0, 64], None,
                     id="gqa-64-6-2-float")]
    return cases


@pytest.mark.parametrize("quant,h,kv,c,d,l_,pos,block_k", _paged_cases())
def test_paged_attention_matches_jax(quant, h, kv, c, d, l_, pos, block_k):
    s_ = 2
    rng = np.random.RandomState(10 * c + h + kv)
    pos = np.array(pos, np.int32)
    q = rng.randn(s_, c, h, d).astype(np.float32)
    kw_j, kw_t = {}, {}
    if quant:
        k = rng.randint(-127, 128, (s_, l_, kv, d)).astype(np.int8)
        v = rng.randint(-127, 128, (s_, l_, kv, d)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (s_, l_, kv)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (s_, l_, kv)).astype(np.float32)
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=_t(ks), v_scale=_t(vs))
    else:
        k = rng.randn(s_, l_, kv, d).astype(np.float32)
        v = rng.randn(s_, l_, kv, d).astype(np.float32)
    want = pk.paged_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(pos),
                              block_k=block_k, **kw_j)
    got = K.paged_attention(_t(q), _t(k), _t(v), _t(pos), **kw_t)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
@pytest.mark.parametrize("cache", list(_CACHE_DTYPES))
@pytest.mark.parametrize("c", [1, 5, 15, 16, 64, 100, 256])
def test_paged_entry_takes_the_chunk_for_bf16_chunks(q_dtype, cache, c):
    """A bf16 q over a bf16 or an int8 cache with C >= 16 goes to the
    chunk entry; decode reads and short chunks (C < 16) to the decode
    entry whatever the dtypes; longer chunks with an f32 q or cache to the
    scalar one."""
    if c < 16:
        want = "paged_attention_decode"
    elif q_dtype == torch.bfloat16 and cache in ("bf16", "int8"):
        want = "paged_attention_chunk"
    else:
        want = "paged_attention"
    assert K.paged_entry(q_dtype, _CACHE_DTYPES[cache], c, 64) == want


@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 96, 128])
def test_paged_entry_takes_the_chunk_for_tensor_core_head_dims(d):
    want = "paged_attention_chunk" if d in (16, 32, 64, 128) \
        else "paged_attention"
    assert K.paged_entry(torch.bfloat16, torch.bfloat16, 64, d) == want


def _refuse_library(monkeypatch):
    def refuse(entry):
        raise AssertionError("a CPU call reached the kernels' library (%s)"
                             % entry)
    monkeypatch.setattr(K, "_lib", refuse)


def test_chunk_entry_is_registered_and_cpu_calls_run_plain(monkeypatch):
    """The chunk entry is a C entry of paged_attention.cu with its own
    argument types and launch counter; a bf16 chunk on the CPU runs the
    plain version and never loads the kernels."""
    assert K.ENTRIES["paged_attention"] == ("paged_attention",
                                            "paged_attention_chunk",
                                            "paged_attention_decode")
    assert K.SOURCE["paged_attention_chunk"] == "paged_attention"
    assert len(K._ARGTYPES["paged_attention_chunk"]) == 16
    assert "paged_attention_chunk" in K.launch_counts()
    _refuse_library(monkeypatch)
    K.reset_launch_counts()
    q = torch.randn(2, 16, 4, 16).to(torch.bfloat16)
    kc = torch.randn(2, 48, 2, 16).to(torch.bfloat16)
    pos = torch.tensor([0, 30], dtype=torch.int32)
    assert K.paged_entry(q.dtype, kc.dtype, 16, 16) == "paged_attention_chunk"
    out = K.paged_attention(q, kc, kc, pos)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, K.paged_attention_plain(q, kc, kc, pos))
    assert not any(K.launch_counts().values())


@pytest.mark.parametrize("case", ["q_f32", "cache_int8", "head_dim_8",
                                  "cache_view"])
def test_paged_chunk_rejects(case, monkeypatch):
    """The chunk entry takes only what the route gives it and raises on
    anything else, before any launch."""
    _refuse_library(monkeypatch)
    q = torch.randn(1, 16, 4, 16).to(torch.bfloat16)
    k = torch.randn(1, 32, 4, 16).to(torch.bfloat16)
    pos = torch.tensor([0], dtype=torch.int32)
    if case == "q_f32":
        q = q.float()
    elif case == "cache_int8":
        k = k.to(torch.int8)
    elif case == "head_dim_8":
        q, k = q[..., :8].contiguous(), k[..., :8].contiguous()
    elif case == "cache_view":
        k = torch.randn(1, 32, 8, 16).to(torch.bfloat16)[:, :, ::2]
    with pytest.raises(MXNetError):
        K._paged_chunk(q, k, k, pos, 0.25)


# -- quant_matmul ---------------------------------------------------------------

@pytest.mark.parametrize("bits,group", [(8, None), (4, 2), (4, 16)],
                         ids=["int8", "int4-g2", "int4-g16"])
@pytest.mark.parametrize("m,e,f", [(1, 16, 37), (3, 32, 100),
                                   (7, 64, 200)])
def test_quant_matmul_matches_jax(bits, group, m, e, f):
    rng = np.random.RandomState(m + f)
    q, s, g = _qweights(rng, f, e, bits, group)
    x = rng.randn(m, e).astype(np.float32)
    want = pk.quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                           bits=bits, group=g, block_f=f)
    got = K.quant_matmul(_t(x), _t(q), _t(s), bits=bits, group=g)
    assert got.shape == (m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- fused_decode_attention -----------------------------------------------------

@pytest.mark.parametrize("bits,group", [(8, None), (4, 16)],
                         ids=["int8", "int4"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
def test_fused_decode_attention_matches_jax(bits, group, rope, h, kv):
    s_, d, l_ = 3, 8, 16
    e = h * d
    fq = e + 2 * kv * d
    rng = np.random.RandomState(bits + h + kv)
    wq, sq, g = _qweights(rng, fq, e, bits, group)
    wo, so, _ = _qweights(rng, e, e, bits, group)
    bq = rng.uniform(-0.1, 0.1, (fq,)).astype(np.float32)
    bo = rng.uniform(-0.1, 0.1, (e,)).astype(np.float32)
    x = rng.randn(s_, e).astype(np.float32)
    pos = np.array([0, 7, l_ - 1], np.int32)
    kc = rng.randn(s_, l_, kv, d).astype(np.float32)
    vc = rng.randn(s_, l_, kv, d).astype(np.float32)
    args = (x, pos, kc, vc, wq, sq, bq, wo, so, bo)
    kw = dict(heads=h, kv_heads=kv, bits=bits, group=g, rope=rope)
    want = pk.fused_decode_attention(*map(jnp.asarray, args), **kw)
    got = K.fused_decode_attention(*map(_t, args), **kw)
    for part, gt, wt in zip(("out", "k_new", "v_new"), got, want):
        assert gt.shape == wt.shape, part
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   err_msg=part, **TOL)


# -- the wrappers -----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor runs the plain version, which is not a launch."""
    rng = np.random.RandomState(0)
    q, s, _ = _qweights(rng, 24, 16, 8, None)
    x = _t(rng.randn(5, 16).astype(np.float32))
    K.reset_launch_counts()
    got = K.quant_matmul(x, _t(q), _t(s))
    want = K.quant_matmul_plain(x, _t(q), _t(s))
    assert torch.equal(got, want)
    qa = torch.randn(2, 1, 4, 8)
    kc = torch.randn(2, 16, 4, 8)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    assert torch.equal(K.paged_attention(qa, kc, kc, pos),
                       K.paged_attention_plain(qa, kc, kc, pos))
    assert K.launch_counts() == dict.fromkeys(K.SOURCE, 0)
    assert set(K.KERNELS) == {"paged_attention", "quant_matmul",
                              "fused_decode_attention", "flash_attention",
                              "striped_pair_attention", "fused_linear",
                              "matmul_stats"}


def test_bf16_inputs_on_cpu():
    """bf16 activations (the engine's compute dtype) go through and come
    back in bf16, or in the requested out_dtype."""
    rng = np.random.RandomState(1)
    q, s, _ = _qweights(rng, 12, 16, 8, None)
    x = torch.randn(3, 16).to(torch.bfloat16)
    assert K.quant_matmul(x, _t(q), _t(s)).dtype == torch.bfloat16
    assert K.quant_matmul(x, _t(q), _t(s),
                          out_dtype=torch.float32).dtype == torch.float32
    qa = torch.randn(1, 3, 2, 8).to(torch.bfloat16)
    kc = torch.randn(1, 8, 2, 8).to(torch.bfloat16)
    out = K.paged_attention(qa, kc, kc, torch.tensor([2], dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == qa.shape


@pytest.mark.parametrize("case", [
    "x_rank", "x_int", "q_width", "q_dtype", "scale_shape", "bits",
    "int4_group", "mixed_device"])
def test_quant_matmul_rejects(case):
    rng = np.random.RandomState(2)
    q, s, _ = _qweights(rng, 8, 16, 8, None)
    q, s = _t(q), _t(s)
    x = torch.randn(2, 16)
    kw = {}
    if case == "x_rank":
        x = torch.randn(2, 2, 16)
    elif case == "x_int":
        x = torch.ones(2, 16, dtype=torch.int32)
    elif case == "q_width":
        q = q[:, :8].contiguous()
    elif case == "q_dtype":
        q = q.to(torch.int32)
    elif case == "scale_shape":
        s = s[:4]
    elif case == "bits":
        kw = dict(bits=3)
    elif case == "int4_group":
        q4, s4, _ = _qweights(rng, 8, 16, 4, 4)
        q, s, kw = _t(q4), _t(s4), dict(bits=4, group=3)
    elif case == "mixed_device":
        s = s.to("meta")
    with pytest.raises(MXNetError):
        K.quant_matmul(x, q, s, **kw)


@pytest.mark.parametrize("case", ["pos_dtype", "pos_shape", "kv_heads",
                                  "scales_alone", "scale_shape", "q_dtype",
                                  "cache_dtype"])
def test_paged_attention_rejects(case):
    q = torch.randn(2, 1, 4, 8)
    k = torch.randn(2, 16, 2, 8)
    v = torch.randn(2, 16, 2, 8)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    kw = {}
    if case == "pos_dtype":
        pos = pos.long()
    elif case == "pos_shape":
        pos = pos[:1]
    elif case == "kv_heads":
        k = v = torch.randn(2, 16, 3, 8)
    elif case == "scales_alone":
        kw = dict(k_scale=torch.ones(2, 16, 2))
    elif case == "scale_shape":
        k = v = torch.zeros(2, 16, 2, 8, dtype=torch.int8)
        kw = dict(k_scale=torch.ones(2, 16), v_scale=torch.ones(2, 16))
    elif case == "q_dtype":
        q = q.to(torch.float16)
    elif case == "cache_dtype":
        k = v = torch.zeros(2, 16, 2, 8, dtype=torch.int8)
    with pytest.raises(MXNetError):
        K.paged_attention(q, k, v, pos, **kw)


@pytest.mark.parametrize("case", ["heads", "wqkv_rows", "cache_dtype",
                                  "odd_head_dim", "bits_mismatch"])
def test_fused_decode_attention_rejects(case):
    rng = np.random.RandomState(3)
    h, kv, d, s_, l_ = 4, 2, 8, 2, 16
    e = h * d
    wq, sq, _ = _qweights(rng, e + 2 * kv * d, e, 8, None)
    wo, so, _ = _qweights(rng, e, e, 8, None)
    args = [torch.randn(s_, e), torch.tensor([0, 4], dtype=torch.int32),
            torch.randn(s_, l_, kv, d), torch.randn(s_, l_, kv, d),
            _t(wq), _t(sq), torch.zeros(e + 2 * kv * d), _t(wo), _t(so),
            torch.zeros(e)]
    kw = dict(heads=h, kv_heads=kv)
    if case == "heads":
        kw["heads"] = 3
    elif case == "wqkv_rows":
        args[4], args[5] = args[4][:e], args[5][:e]
    elif case == "cache_dtype":
        args[2] = args[3] = torch.zeros(s_, l_, kv, d, dtype=torch.int8)
    elif case == "odd_head_dim":
        args[2] = args[3] = torch.randn(s_, l_, kv, 7)
    elif case == "bits_mismatch":
        kw["bits"] = 4
        kw["group"] = 4
    with pytest.raises(MXNetError):
        K.fused_decode_attention(*args, **kw)


def test_default_paged_block_k_matches_jax():
    for n in (8, 16, 24, 40, 64, 96, 128, 1000, 1024, 7, 13):
        assert K.default_paged_block_k(n) == pk.default_paged_block_k(n)


def test_unpack4_sign_extends_every_nibble():
    u = torch.arange(256, dtype=torch.int32).to(torch.uint8)[None]
    out = K.unpack4(u)[0].reshape(256, 2)
    vals = lambda n: n - 16 if n >= 8 else n        # noqa: E731
    assert out[:, 0].tolist() == [float(vals(b & 15)) for b in range(256)]
    assert out[:, 1].tolist() == [float(vals(b >> 4)) for b in range(256)]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6dq_mmaILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6dq_mmaILi64EEvv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 8 bytes cumulative stack size, 400 \
bytes cmem[0]
ptxas info    : Compiling entry function '_Z7dkv_mmaILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z7dkv_mmaILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
"""


def test_parse_ptxas_names_each_function_and_its_spills():
    rows = K.parse_ptxas(PTXAS_LOG)
    assert rows == [
        {"function": "_Z6dq_mmaILi64EEvv", "registers": 255,
         "spill_stores": 12, "spill_loads": 16},
        {"function": "_Z7dkv_mmaILi64EEvv", "registers": 168,
         "spill_stores": 0, "spill_loads": 0},
        {"function": "_Z6helperv", "registers": None, "spill_stores": 4,
         "spill_loads": 4}]
    assert K.parse_ptxas("nvcc warning : nothing compiled\n") == []
