"""The PyTorch port's ring attention, collectives and meshes against the
JAX package's.

``striped_pair_attention`` (its plain version, which CPU tensors run, and
its autograd backward from the cotangents of both outputs) against the
JAX kernel under the Pallas interpreter, at every ring position pair;
``blockwise_attention``, ``ring_attention``, ``striped_ring_attention``
and ``ring_self_attention`` on port meshes over ``["cpu"] * n`` against
JAX's on its virtual CPU devices (values and gradients); the collectives
against ``tests/test_parallel.py``'s cases and ``shard_map``;
``MultiHeadAttention``'s blockwise and ring impls.

Tolerances: f32 on both sides, sums in other orders: rtol 1e-5 / atol
1e-5 for one hop and for blockwise attention, rtol 2e-4 / atol 2e-5 for
the rings and their gradients (``tests/test_parallel.py``'s ring
tolerance); collectives move values exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import parallel as jax_par
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops import registry as jax_reg
from mxnet_tpu.parallel import collectives as jax_coll
from mxnet_tpu.parallel.compat import shard_map

from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops import registry as reg
from mxnet_tpu_torch.parallel import collectives as coll

HOP_TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# -- one hop: striped_pair_attention ------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("c,d", [(8, 8), (8, 16), (13, 8), (13, 16)])
def test_striped_pair_plain_matches_jax(n, c, d):
    """Every (q_off, k_off) of a ring of n: o and lse of the forward, and
    dq/dk/dv from a random g_o and a nonzero g_lse through jax.vjp of the
    Pallas kernel (interpreted) and the port's autograd backward."""
    bh = 3
    rng = np.random.RandomState(100 * n + 10 * c + d)

    def jax_hop(q, k, v, qo, ko, go, gl):
        (o, lse), vjp = jax.vjp(
            lambda a, b, cc: pk.striped_pair_attention(
                a, b, cc, qo, ko, n_stride=n), q, k, v)
        return o, lse, vjp((go, gl))

    jax_hop = jax.jit(jax_hop)
    for qo in range(n):
        for ko in range(n):
            q, k, v, go = (rng.randn(bh, c, d).astype(np.float32)
                           for _ in range(4))
            gl = rng.randn(bh, c, 1).astype(np.float32)
            o_j, lse_j, grads_j = jax_hop(q, k, v, np.int32(qo),
                                          np.int32(ko), go, gl)
            tq, tk, tv = (_t(a, True) for a in (q, k, v))
            o, lse = K.striped_pair_attention(tq, tk, tv, qo, ko,
                                              n_stride=n)
            ((o * _t(go)).sum() + (lse * _t(gl)).sum()).backward()
            tag = "n=%d q_off=%d k_off=%d" % (n, qo, ko)
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j),
                                       err_msg="o " + tag, **HOP_TOL)
            np.testing.assert_allclose(lse.detach().numpy(),
                                       np.asarray(lse_j),
                                       err_msg="lse " + tag, **HOP_TOL)
            for name, a, gj in zip("qkv", (tq, tk, tv), grads_j):
                np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj),
                                           err_msg="d%s %s" % (name, tag),
                                           **HOP_TOL)


def test_striped_pair_empty_rows_and_causal_case():
    """k_off > q_off leaves row 0 without a visible key: o = 0 and
    lse = -1e30, not NaN; n = 1 is causal flash attention."""
    rng = np.random.RandomState(5)
    q, k, v = (_t(rng.randn(2, 9, 8).astype(np.float32)) for _ in range(3))
    o, lse = K.striped_pair_attention_plain(q, k, v, 0, 2, 4)
    assert torch.all(o[:, 0] == 0) and torch.all(lse[:, 0, 0] == -1e30)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    o1, lse1 = K.striped_pair_attention_plain(q, k, v, 0, 0, 1)
    fo, flse = K.flash_attention_fwd_plain(q[:, :, None], k[:, :, None],
                                           v[:, :, None], causal=True)
    np.testing.assert_allclose(o1.numpy(), fo[:, :, 0].numpy(), **HOP_TOL)
    np.testing.assert_allclose(lse1[..., 0].numpy(), flse.numpy(),
                               **HOP_TOL)


def test_striped_pair_refuses_bad_offsets():
    x = torch.zeros(1, 8, 8)
    for qo, ko, n in ((4, 0, 4), (0, -1, 4), (0, 0, 0)):
        with pytest.raises(MXNetError, match="ring positions"):
            K.striped_pair_attention(x, x, x, qo, ko, n_stride=n)


# -- meshes ---------------------------------------------------------------------

def test_build_mesh_shapes_and_repeated_devices():
    m = par.build_mesh({"dp": 2, "sp": -1}, ["cpu"] * 8)
    assert m.shape == {"dp": 2, "sp": 4} and list(m.shape) == ["dp", "sp"]
    assert m.devices.shape == (2, 4) and m.size == 8
    assert all(d == torch.device("cpu") for d in m.devices.ravel())
    assert par.data_parallel_mesh(3, devices=["cpu"] * 4).shape == {"dp": 3}
    assert par.model_parallel_mesh(2, devices=["cpu"] * 4).shape == \
        {"model": 2}
    with pytest.raises(MXNetError, match="at most one"):
        par.build_mesh({"a": -1, "b": -1}, ["cpu"] * 4)
    with pytest.raises(MXNetError, match="needs 8 devices"):
        par.build_mesh({"dp": 8}, ["cpu"] * 4)
    with pytest.raises(MXNetError, match="tp=5"):
        par.model_parallel_mesh(5, devices=["cpu"] * 4)


def test_mesh_defaults_to_cuda_and_never_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is on it")
    for call in (lambda: par.build_mesh({"sp": 1}), par.local_mesh,
                 par.data_parallel_mesh, par.model_parallel_mesh):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()


def test_partition_spec():
    assert tuple(par.P("sp", None)) == ("sp", None) and par.P() == ()
    assert "sp" in par.P("sp", None) and repr(par.P("sp")) == "P('sp')"


# -- collectives ----------------------------------------------------------------

def _jax_mesh(**axes):
    return jax_par.build_mesh(axes)


def test_collectives_broadcast_ring_bucketed():
    """tests/test_parallel.py's case on 8 ranks: broadcast of rank 3's
    value, a one-hop ring rotation, and bucketed_psum equal to per-tensor
    psum whatever the packing; then the port's lists against it."""
    mesh = _jax_mesh(dp=8)
    x = np.arange(8, dtype=np.float32)

    def f(xs):
        r = jax_coll.axis_index("dp").astype(np.float32)
        b = jax_coll.broadcast(r * 10.0, "dp", root=3)
        ring = jax_coll.ring_exchange(xs, "dp", shift=1)
        grads = {"a": xs * 2.0, "b": jnp.ones((3,)) * r,
                 "c": xs.reshape(1, 1) + r}
        red = jax_coll.bucketed_psum(grads, "dp", bucket_bytes=8)
        return b, ring, red["a"], red["b"], red["c"]

    jb, jring, ja, jbb, jc = jax.jit(shard_map(
        f, mesh=mesh, in_specs=JP("dp"),
        out_specs=(JP(), JP("dp"), JP(), JP(), JP()),
        check_vma=False))(x)
    xs = [torch.tensor([v]) for v in x]
    rs = [torch.tensor(float(r)) for r in range(8)]
    b = coll.broadcast([r * 10.0 for r in rs], root=3)
    ring = coll.ring_exchange(xs, shift=1)
    grads = [{"a": xv * 2.0, "b": torch.ones(3) * r,
              "c": xv.reshape(1, 1) + r} for xv, r in zip(xs, rs)]
    red = coll.bucketed_psum(grads, bucket_bytes=8)
    ref = coll.psum([g["c"] for g in grads])
    for rank in range(8):
        assert b[rank].item() == float(np.asarray(jb))
        assert red[rank]["c"].item() == ref[rank].item()
        np.testing.assert_array_equal(red[rank]["a"].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(red[rank]["b"].numpy(),
                                      np.asarray(jbb))
        np.testing.assert_array_equal(red[rank]["c"].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(torch.cat(ring).numpy(), np.asarray(jring))


COLLECTIVE_CASES = {
    # name: (jax body on a local [2, 4, 3] shard, port on the shard list)
    "psum": (lambda z: jax.lax.psum(z, "sp"), coll.psum),
    "all_gather": (lambda z: jax_coll.all_gather(z, "sp", axis=1),
                   lambda zs: coll.all_gather(zs, axis=1)),
    "all_gather_untiled": (
        lambda z: jax_coll.all_gather(z, "sp", axis=0, tiled=False)[:, 0],
        lambda zs: [g[:, 0] for g in coll.all_gather(zs, axis=0,
                                                     tiled=False)]),
    "reduce_scatter": (
        lambda z: jax_coll.reduce_scatter(z, "sp", scatter_dimension=1),
        lambda zs: coll.reduce_scatter(zs, scatter_dimension=1)),
    "all_to_all": (lambda z: jax.lax.all_to_all(z, "sp", 1, 1),
                   lambda zs: coll.all_to_all(zs, 1, 1)),
    "all_to_all_tiled": (
        lambda z: jax.lax.all_to_all(z, "sp", 1, 2, tiled=True),
        lambda zs: coll.all_to_all(zs, 1, 2, tiled=True)),
    "ppermute": (lambda z: jax.lax.ppermute(z, "sp", [(0, 2), (2, 1),
                                                       (1, 3)]),
                 lambda zs: coll.ppermute(zs, [(0, 2), (2, 1), (1, 3)])),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVE_CASES))
def test_collective_matches_shard_map(name):
    """Each collective over 4 ranks on local [2, 4, 3] shards, against the
    JAX collective under shard_map (outputs concatenated along dim 0)."""
    jfn, tfn = COLLECTIVE_CASES[name]
    x = np.random.RandomState(1).randn(8, 4, 3).astype(np.float32)
    want = np.asarray(jax.jit(shard_map(
        jfn, mesh=_jax_mesh(sp=4), in_specs=JP("sp"), out_specs=JP("sp"),
        check_vma=False))(x))
    got = tfn(list(_t(x).chunk(4)))
    assert coll.axis_size(got) == 4
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_collectives_differentiate():
    """The backward of a rotation is the reverse rotation, that of psum a
    psum: gradients through the list collectives by autograd."""
    xs = [torch.full((2,), float(i), requires_grad=True) for i in range(4)]
    out = coll.ring_exchange(xs, shift=1)
    sum(o * (j + 1) for j, o in enumerate(out)).sum().backward()
    assert [x.grad[0].item() for x in xs] == [2.0, 3.0, 4.0, 1.0]
    ys = [torch.ones(3, requires_grad=True) for _ in range(4)]
    sum(s.sum() * (j + 1) for j, s in enumerate(coll.psum(ys))).backward()
    assert all(y.grad.tolist() == [10.0] * 3 for y in ys)
    assert coll.barrier(ys)[2].item() == 0.0


# -- rings ------------------------------------------------------------------------

def _qkvw(seed, b=2, t=32, h=2, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def _jax_grads(fn, q, k, v, w):
    out, vjp = jax.vjp(jax.jit(fn), *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _port_grads(fn, q, k, v, w):
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    out = fn(tq, tk, tv)
    (out * _t(w)).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in (tq, tk, tv)]


def _assert_same(got, want, tol):
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **tol)
    for name, a, b in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(a, b, err_msg="d" + name, **tol)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 7)])
def test_blockwise_attention_matches_jax(causal, window):
    q, k, v, w = _qkvw(3, t=45)
    kw = dict(causal=causal, block_size=16, window=window)
    want = _jax_grads(lambda a, b, c: jax_par.blockwise_attention(
        a, b, c, **kw), q, k, v, w)
    got = _port_grads(lambda a, b, c: par.blockwise_attention(a, b, c, **kw),
                      q, k, v, w)
    _assert_same(got, want, HOP_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(causal):
    q, k, v, w = _qkvw(4)
    jmesh = _jax_mesh(sp=4)
    want = _jax_grads(lambda a, b, c: jax_par.ring_attention(
        a, b, c, jmesh, causal=causal), q, k, v, w)
    mesh = par.build_mesh({"sp": 4}, ["cpu"] * 4)
    got = _port_grads(lambda a, b, c: par.ring_attention(
        a, b, c, mesh, causal=causal), q, k, v, w)
    _assert_same(got, want, RING_TOL)


@pytest.mark.parametrize("n,t", [(4, 32), (2, 26)])
def test_striped_ring_attention_matches_jax(n, t):
    """The striped ring (the pair kernel's plain version on each hop)
    against JAX's striped ring, and against dense causal attention."""
    q, k, v, w = _qkvw(5, t=t)
    jmesh = _jax_mesh(sp=n)
    want = _jax_grads(lambda a, b, c: jax_par.striped_ring_attention(
        a, b, c, jmesh), q, k, v, w)
    mesh = par.build_mesh({"sp": n}, ["cpu"] * n)
    got = _port_grads(lambda a, b, c: par.striped_ring_attention(
        a, b, c, mesh), q, k, v, w)
    _assert_same(got, want, RING_TOL)
    dense = _port_grads(lambda a, b, c: par.blockwise_attention(
        a, b, c, causal=True, block_size=t), q, k, v, w)
    _assert_same(got, dense, RING_TOL)


def test_striped_ring_at_batch_one():
    """B=1: the [B*H, C, D] hop layout is a view, not a copy, of the
    transposed shard; the ring hands the kernel contiguous rows. On the
    host the plain version takes strided rows as well."""
    q, k, v, w = _qkvw(8, b=1, t=16)
    mesh = par.build_mesh({"sp": 4}, ["cpu"] * 4)
    got = _port_grads(lambda a, b, c: par.striped_ring_attention(
        a, b, c, mesh), q, k, v, w)
    dense = _port_grads(lambda a, b, c: par.blockwise_attention(
        a, b, c, causal=True), q, k, v, w)
    _assert_same(got, dense, RING_TOL)
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 8, 16).astype(
        np.float32)).transpose(1, 2)
    o, lse = K.striped_pair_attention(x, x, x, 1, 0, n_stride=2)
    oc, lsec = K.striped_pair_attention(x.contiguous(), x.contiguous(),
                                        x.contiguous(), 1, 0, n_stride=2)
    torch.testing.assert_close(o, oc, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, lsec, rtol=1e-6, atol=1e-6)


def test_ring_attention_shards_the_batch_over_dp():
    q, k, v, w = _qkvw(6, b=4)
    jmesh = _jax_mesh(dp=2, sp=4)
    want = _jax_grads(lambda a, b, c: jax_par.striped_ring_attention(
        a, b, c, jmesh, batch_axis="dp"), q, k, v, w)
    mesh = par.build_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8)
    got = _port_grads(lambda a, b, c: par.striped_ring_attention(
        a, b, c, mesh, batch_axis="dp"), q, k, v, w)
    _assert_same(got, want, RING_TOL)


def test_ring_self_attention_matches_jax():
    rng = np.random.RandomState(7)
    b, t, e, h = 2, 16, 16, 4
    x = rng.randn(b, t, e).astype(np.float32)
    ws = [(rng.randn(e, e) / np.sqrt(e)).astype(np.float32)
          for _ in range(4)]
    want = np.asarray(jax_par.ring_self_attention(
        jnp.asarray(x), *map(jnp.asarray, ws), _jax_mesh(dp=2, sp=4),
        num_heads=h))
    got = par.ring_self_attention(_t(x), *map(_t, ws), par.build_mesh(
        {"dp": 2, "sp": 4}, ["cpu"] * 8), num_heads=h)
    np.testing.assert_allclose(got.numpy(), want, **RING_TOL)


# -- MultiHeadAttention ------------------------------------------------------------

def _mha_ins(seed, b=2, t=24, e=32, h=4, kv=0):
    kvh = kv or h
    f = e + 2 * kvh * (e // h)
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, e).astype(np.float32),
            (rng.randn(f, e) / np.sqrt(e)).astype(np.float32),
            rng.randn(f).astype(np.float32) * 0.1,
            (rng.randn(e, e) / np.sqrt(e)).astype(np.float32),
            rng.randn(e).astype(np.float32) * 0.1]


@pytest.mark.parametrize("kv,rope,window,causal", [
    (0, False, 0, True), (2, True, 0, True), (0, False, 5, True),
    (0, False, 0, False)])
def test_multihead_attention_blockwise_matches_jax(kv, rope, window, causal):
    ins = _mha_ins(kv + window, kv=kv)
    g = np.random.RandomState(11).randn(*ins[0].shape).astype(np.float32)
    kw = dict(num_heads=4, num_kv_heads=kv, impl="blockwise", rope=rope,
              window=window, causal=causal)
    jspec = jax_reg.get("MultiHeadAttention")
    jp = jspec.parse_params(kw)

    def jax_loss(*xs):
        out = jspec.forward(jp, list(xs), [], False, None)[0][0]
        return jnp.sum(out * g), out

    (_, out_j), grads_j = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, ins))
    spec = reg.get("MultiHeadAttention")
    tins = [_t(a, True) for a in ins]
    out = spec.forward(spec.parse_params(kw), tins, [], False, None)[0][0]
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **HOP_TOL)
    for i, (a, gj) in enumerate(zip(tins, grads_j)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj),
                                   err_msg="input %d" % i, **HOP_TOL)


def test_multihead_attention_ring_impls_refuse_as_jax_does():
    """Outside the SPMD walk the ring impls raise as the JAX package's do
    outside shard_map; a window is refused on the ring impls and
    ring_striped is causal-only, in both packages."""
    spec, jspec = reg.get("MultiHeadAttention"), \
        jax_reg.get("MultiHeadAttention")
    ins = _mha_ins(1)
    tins = [_t(a) for a in ins]
    jins = list(map(jnp.asarray, ins))
    for kw, match in ((dict(impl="ring"), "SequenceParallelTrainer"),
                      (dict(impl="ring_striped"), "SequenceParallelTrainer"),
                      (dict(impl="ring", window=4), "window"),
                      (dict(impl="ring_striped", window=4), "window"),
                      (dict(impl="ring_striped", causal=False),
                       "causal-only")):
        kw = dict(kw, num_heads=4)
        with pytest.raises(MXNetError, match=match):
            spec.forward(spec.parse_params(kw), tins, [], False, None)
        with pytest.raises(Exception, match=match):
            jspec.forward(jspec.parse_params(kw), jins, [], False, None)
        ranks = [tins] * 4
        if "window" in kw or not kw.get("causal", True):
            with pytest.raises(MXNetError, match=match):
                spec.forward_ranks(spec.parse_params(kw), ranks, False,
                                   [None] * 4)
