"""The port's weight quantization against the JAX package's.

``quantize_tensor`` (int8 values, packed int4 nibbles, f32 scales),
``pack_int4``/``unpack_int4``, ``resolve_group`` and ``resolve_chunk``
must be BITWISE equal to the JAX package's on the same f32 weights: a
checkpoint quantized by either package serves the same bytes.
``scale_fused_matmul`` (the plain product of ``matmul_impl="dense"``)
agrees within 1e-5: the two sum in another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.serving import quant as jq

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import quant as tq


def _weight(seed, shape, zero_row=None):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if zero_row is not None:
        w[zero_row] = 0.0
    return w


@pytest.mark.parametrize("shape", [(5, 16), (64, 48), (3, 7, 32)])
def test_quantize_int8_bitwise(shape):
    w = _weight(sum(shape), shape, zero_row=1)
    j = jq.quantize_tensor(jnp.asarray(w))
    t = tq.quantize_tensor(torch.from_numpy(w))
    assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))
    assert t.shape == tuple(j.shape) and t.nbytes == j.nbytes


@pytest.mark.parametrize("group", [None, 2, 4, 16])
@pytest.mark.parametrize("shape", [(6, 32), (9, 64)])
def test_quantize_int4_bitwise(shape, group):
    w = _weight(shape[0] + (group or 0), shape, zero_row=2)
    j = jq.quantize_tensor(jnp.asarray(w), bits=4, group=group)
    t = tq.quantize_tensor(torch.from_numpy(w), bits=4, group=group)
    assert t.bits == j.bits == 4 and t.group == j.group
    assert t.q.dtype == torch.uint8 and t.q.shape == tuple(j.q.shape)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))


def test_quantize_bf16_weight_matches():
    """A bf16 weight quantizes from its f32 value on both sides and keeps
    bf16 as its dequantization target."""
    w = _weight(4, (8, 16))
    tw = torch.from_numpy(w).to(torch.bfloat16)
    jw = jnp.asarray(tw.float().numpy()).astype(jnp.bfloat16)
    j, t = jq.quantize_tensor(jw), tq.quantize_tensor(tw)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


def test_pack_unpack_all_nibbles():
    vals = np.array([[v, u] for v in range(-8, 8) for u in range(-8, 8)],
                    np.int32).reshape(1, -1)               # 256 pairs
    tp = tq.pack_int4(torch.from_numpy(vals))
    jp = np.asarray(jq.pack_int4(jnp.asarray(vals)))
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert sorted(set(tp.numpy().ravel().tolist())) == list(range(256))
    tu = tq.unpack_int4(tp)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(jq.unpack_int4(jp)))
    np.testing.assert_array_equal(tu.numpy(), vals)


def test_resolve_group_bitwise():
    for n in (2, 6, 8, 12, 24, 48, 96, 128, 192, 768, 3072, 1000):
        assert tq.resolve_group(n) == jq.resolve_group(n)
        for g in (2, 4, 8, 16, 32):
            if n % g == 0:
                assert tq.resolve_group(n, g) == jq.resolve_group(n, g)
    for n, g in ((7, None), (12, 5), (12, 3), (12, 0), (16, 32)):
        with pytest.raises(MXNetError):
            tq.resolve_group(n, g)
        with pytest.raises(Exception):
            jq.resolve_group(n, g)


def test_resolve_chunk_bitwise():
    for f in (1, 7, 8, 16, 24, 37, 64, 100, 256, 768, 2304, 3072, 32000,
              2048, 4096):
        assert tq.resolve_chunk(f) == jq.resolve_chunk(f), f


@pytest.mark.parametrize("bits,group", [(8, None), (4, 8)])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_scale_fused_matmul_matches(bits, group, lead):
    w = _weight(7, (64, 32))
    x = np.random.RandomState(8).randn(*lead, 32).astype(np.float32)
    j = jq.scale_fused_matmul(jnp.asarray(x),
                              jq.quantize_tensor(jnp.asarray(w), bits=bits,
                                                 group=group))
    t = tq.scale_fused_matmul(torch.from_numpy(x),
                              tq.quantize_tensor(torch.from_numpy(w),
                                                 bits=bits, group=group))
    assert tuple(t.shape) == lead + (64,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


def test_embedding_rows_matches():
    w = _weight(9, (20, 16))
    idx = np.array([[0, 3, 19], [7, 7, 1]], np.int32)
    j = jq.embedding_rows(jq.quantize_tensor(jnp.asarray(w)),
                          jnp.asarray(idx))
    t = tq.embedding_rows(tq.quantize_tensor(torch.from_numpy(w)),
                          torch.from_numpy(idx))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_quantize_params_and_names_match(tiny_lm_pair):
    (jsym, tsym), params = tiny_lm_pair
    from mxnet_tpu_torch.serving.quant import quantized_weight_names
    jnames = jq.quantized_weight_names(jsym._topo())
    tnames = quantized_weight_names(tsym._topo())
    assert jnames == tnames and "embed_weight" in tnames
    assert not any(n.endswith(("_bias", "_gamma", "_beta", "pos_embed"))
                   for n in tnames)
    tp = tq.quantize_params({k: torch.from_numpy(v)
                             for k, v in params.items()}, tnames, bits=4,
                            row_quant={"embed_weight"})
    jp = jq.quantize_params({k: jnp.asarray(v) for k, v in params.items()},
                            jnames, bits=4, row_quant={"embed_weight"})
    for k in params:
        if k in tnames:
            assert tp[k].bits == jp[k].bits
            np.testing.assert_array_equal(tp[k].q.numpy(),
                                          np.asarray(jp[k].q))
        else:
            assert tp[k] is not None and not isinstance(tp[k],
                                                        tq.QuantizedTensor)


def test_quantize_rejects():
    with pytest.raises(MXNetError):
        tq.quantize_tensor(torch.ones(4))
    with pytest.raises(MXNetError):
        tq.quantize_tensor(torch.ones(4, 4), bits=3)


@pytest.fixture(scope="module")
def tiny_lm_pair():
    from mxnet_tpu.models import get_transformer_lm as jlm
    from mxnet_tpu.name import NameManager as JNM
    from mxnet_tpu_torch.models import get_transformer_lm as tlm
    from mxnet_tpu_torch.name import NameManager as TNM
    with JNM():
        js = jlm(31, num_layers=1, embed_dim=16, num_heads=2)
    with TNM():
        ts = tlm(31, num_layers=1, embed_dim=16, num_heads=2)
    shapes, _, _ = js.infer_shape(data=(1, 8), softmax_label=(1, 8))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return (js, ts), params
