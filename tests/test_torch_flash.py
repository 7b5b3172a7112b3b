"""The PyTorch port's training kernels against the JAX package's.

``flash_attention`` and ``fused_linear``: each case makes its inputs with
numpy from a seed and runs them through the JAX function (the Pallas
kernels under the interpreter, as ``tests/test_pallas.py`` runs them on
the CPU, with 16-row blocks so that T=40 pads) and through the port's
wrapper on CPU tensors, which takes the plain PyTorch version: forward,
and the gradients of ``sum(out * w)`` for a fixed random ``w``.
Tolerance: f32 on both sides, rtol and atol 1e-5 — the two sum in other
orders (the Pallas kernel streams its softmax over key blocks, the plain
version takes one softmax), so they agree to a few ulps, not bitwise. The
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as K

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _assert_close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


# -- flash_attention ------------------------------------------------------

FLASH_CASES = [  # (T, causal, window)
    (32, False, 0),
    (32, True, 0),
    (40, True, 0),     # pads to 48 in the Pallas kernels
    (40, False, 0),
    (40, True, 7),
    (40, True, 1),     # each query sees only itself
]


def _flash_inputs(t, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, t, 3, 8).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("t,causal,window", FLASH_CASES)
def test_flash_attention_matches_jax(t, causal, window):
    q, k, v, w = _flash_inputs(t, t + 3 * causal + window)

    def jax_loss(q_, k_, v_):
        o = pk.flash_attention(q_, k_, v_, causal=causal, window=window,
                               block_q=16, block_k=16, interpret=True)
        return jnp.sum(o * w), o

    (_, o_j), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o_t = K.flash_attention(qt, kt, vt, causal=causal, window=window)
    (o_t * _t(w)).sum().backward()
    _assert_close(o_t, o_j, "o")
    for name, a, b in zip("qkv", (qt.grad, kt.grad, vt.grad), g_j):
        _assert_close(a, b, "d" + name)


@pytest.mark.parametrize("t,causal,window", FLASH_CASES)
def test_flash_plain_backward_matches_autograd(t, causal, window):
    """The plain dQ/dK/dV recompute formulas (the kernels' arithmetic)
    against autograd through the plain forward."""
    q, k, v, w = (_t(a, True) for a in _flash_inputs(t, 7 * t + window))
    o, lse = K.flash_attention_fwd_plain(q, k, v, causal, None, window)
    (o * w.detach()).sum().backward()
    dq, dk, dv = K.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(),
        w.detach(), causal, None, window)
    for name, a, b in zip("qkv", (dq, dk, dv), (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg="d" + name,
                                   **TOL)


def test_flash_lse_is_the_row_logsumexp():
    q, k, v, _ = (_t(a) for a in _flash_inputs(40, 1))
    _, lse = K.flash_attention_fwd(q, k, v, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                      float("-inf"))
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, -1).reshape(6, 40).numpy(),
                               **TOL)


def test_flash_attention_bf16_plain_matches_f32():
    """bf16 inputs: the plain version computes in f32 from the bf16
    values and rounds the result once (to within one bf16 ulp, 2^-8
    relative)."""
    q, k, v, _ = _flash_inputs(40, 2)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    o = K.flash_attention(qb, kb, vb, causal=True)
    want = K.flash_attention(qb.float(), kb.float(), vb.float(), causal=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-6)


def test_flash_attention_rejects_bad_windows_and_shapes():
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError):
        K.flash_attention(q, q, q, causal=True, window=-1)
    with pytest.raises(ValueError):
        K.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(MXNetError):
        K.flash_attention(q, torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8))
    with pytest.raises(MXNetError):
        K.flash_attention(q, q.double(), q)


# -- fused_linear ---------------------------------------------------------

@pytest.mark.parametrize("act", ["linear", "relu", "sigmoid", "tanh",
                                 "gelu"])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_linear_matches_jax(act, bias):
    rng = np.random.RandomState(len(act) + 10 * bias)
    m, kd, n = 20, 24, 36
    x = rng.randn(m, kd).astype(np.float32)
    w = (rng.randn(n, kd) / np.sqrt(kd)).astype(np.float32)  # [N, K]
    b = rng.randn(n).astype(np.float32) * 0.3
    g = rng.randn(m, n).astype(np.float32)

    def jax_loss(x_, w_, b_):
        out = pk.fused_linear(x_, w_.T, b_, act, interpret=True)
        return jnp.sum(out * g), out

    bj = jnp.asarray(b) if bias else jnp.zeros((n,), jnp.float32)
    (_, out_j), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), bj)
    xt, wt = _t(x, True), _t(w, True)
    bt = _t(b, True) if bias else None
    out_t = K.fused_linear(xt, wt, bt, act)
    (out_t * _t(g)).sum().backward()
    _assert_close(out_t, out_j, "out")
    _assert_close(xt.grad, g_j[0], "dx")
    _assert_close(wt.grad, g_j[1], "dw")
    if bias:
        _assert_close(bt.grad, g_j[2], "db")


def test_fused_linear_scale_epilogue():
    """The per-column ``scale`` input (the folded BatchNorm scale the conv
    path will pass): ``act(scale * (x @ w^T) + b)``."""
    rng = np.random.RandomState(5)
    x, w = _t(rng.randn(7, 5).astype(np.float32)), \
        _t(rng.randn(3, 5).astype(np.float32))
    b, s = _t(rng.randn(3).astype(np.float32)), \
        _t(rng.randn(3).astype(np.float32))
    got = K.fused_linear_fwd(x, w, b, "tanh", scale=s)
    np.testing.assert_allclose(got.numpy(),
                               torch.tanh(s * (x @ w.t()) + b).numpy(), **TOL)


def test_fused_linear_rejects_bad_inputs():
    x = torch.zeros(4, 6)
    with pytest.raises(MXNetError):
        K.fused_linear(x, torch.zeros(3, 6), None, "softrelu")
    with pytest.raises(MXNetError):
        K.fused_linear(x, torch.zeros(3, 5))
    with pytest.raises(MXNetError):
        K.fused_linear(x, torch.zeros(3, 6), torch.zeros(4))


def test_training_entries_are_counted_per_entry():
    """The flash source exports three C entries, each with its own launch
    counter; the plain versions on the CPU launch nothing."""
    assert K.ENTRIES["flash_attention"] == (
        "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
    assert set(K.launch_counts()) == set(K.SOURCE)
    assert set(K.SOURCE.values()) == set(K.KERNELS)
    K.reset_launch_counts()
    q = torch.zeros(1, 4, 1, 8, requires_grad=True)
    K.flash_attention(q, q, q, causal=True).sum().backward()
    K.fused_linear(torch.zeros(2, 3), torch.zeros(4, 3), None, "relu")
    assert not any(K.launch_counts().values())
