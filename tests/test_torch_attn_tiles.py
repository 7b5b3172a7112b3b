"""The attention kernels' tile walks against the JAX kernels' masks.

``mxnet_tpu_torch/ops/csrc/attention.cuh`` walks 64-row tiles: the
forward and dQ kernels visit key tiles ``key_range`` of a query tile, the
dK/dV kernel query tiles ``query_range`` of a key tile; ``full_tile`` says
a tile pair needs no mask, and ``visible`` is the mask. Here those four
functions are written out in Python, C++'s integer division (toward zero)
included, for the striped ring hop (``Mask::Striped``) and flash attention
(``Mask::Flash``), and held against the JAX package
(``mxnet_tpu/ops/pallas_kernels.py``):

* ``visible`` equals the mask the Pallas kernels build, for every (q, k);
* every visible pair lies in a tile pair that both backward walks visit
  (so no gradient term is skipped), and every tile pair ``full_tile``
  calls full is visible whole (so skipping its mask drops nothing);
* the walks' bounds equal the Pallas kernels' loop bounds at 64-row
  blocks (``_spair_dq_kernel``'s ``nkb``, ``_spair_dkv_kernel``'s ``lo``,
  ``_attn_dq_kernel``'s ``_window_lo`` and ``nkb``, ``_attn_dkv_kernel``'s
  ``lo`` and ``nqb``).

Cases: ring sizes n = 1, 2 and 4 with every (q_off, k_off) pair in every
order, at C = 100 (ragged: not a multiple of the tiles) and 256; flash
causal and non-causal, windowed, at ragged and unequal lengths.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax

from mxnet_tpu.ops import pallas_kernels as pk

TILE = 64  # attention.cuh FQ, BQ and BK


def _div(a, b):
    """C++'s int division: toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


# -- attention.cuh, written out ----------------------------------------------

def visible(s, qp, kp):
    """``visible<M>`` over arrays of query and key rows."""
    ok = (qp < s["Tq"]) & (kp < s["Tk"])
    if s["mask"] == "striped":
        return ok & (qp * s["n"] + s["q_off"] >= kp * s["n"] + s["k_off"])
    if s["causal"]:
        ok = ok & (qp >= kp)
    if s["window"]:
        ok = ok & (qp - kp < s["window"])
    return ok


def key_range(s, qi, bq=TILE, bk=TILE):
    hi = _div(s["Tk"] + bk - 1, bk)
    if s["mask"] == "striped":
        numer = ((qi + 1) * bq - 1) * s["n"] + s["q_off"] - s["k_off"]
        return 0, max(0, min(hi, _div(numer, bk * s["n"]) + 1))
    if s["causal"]:
        hi = min(hi, _div((qi + 1) * bq + bk - 1, bk))
    lo = max(0, _div(qi * bq - (s["window"] - 1), bk)) if s["window"] else 0
    return lo, hi


def query_range(s, kj, bq=TILE, bk=TILE):
    hi = _div(s["Tq"] + bq - 1, bq)
    if s["mask"] == "striped":
        lo = max(0, _div(kj * bk + (1 if s["k_off"] > s["q_off"] else 0),
                         bq))
        return lo, hi
    lo = _div(kj * bk, bq) if s["causal"] else 0
    if s["window"]:
        hi = min(hi, _div(kj * bk + bk - 1 + s["window"] - 1, bq) + 1)
    return lo, hi


def full_tile(s, q0, k0, bq=TILE, bk=TILE):
    """``full_tile<M>(q0, bq, k0, bk, s, 0, s.Tk)``, as the f32 kernels
    call it (dQ: the query tile and a key tile; dK/dV: a query tile and
    the key tile)."""
    if k0 + bk > s["Tk"]:
        return False
    if s["mask"] == "striped":
        return q0 * s["n"] + s["q_off"] >= (k0 + bk - 1) * s["n"] \
            + s["k_off"]
    ok = True
    if s["causal"]:
        ok = ok and q0 >= k0 + bk - 1
    if s["window"]:
        ok = ok and q0 + bq - 1 - k0 < s["window"]
    return ok


# -- the JAX kernels' masks and loop bounds ------------------------------------

def jax_mask(s):
    """The mask the Pallas kernels build over [Tq, Tk] (the dK/dV
    kernels' form, with the row bound)."""
    i32 = jnp.int32
    qpos = lax.broadcasted_iota(i32, (s["Tq"], s["Tk"]), 0)
    kpos = lax.broadcasted_iota(i32, (s["Tq"], s["Tk"]), 1)
    mask = (kpos < s["Tk"]) & (qpos < s["Tq"])
    if s["mask"] == "striped":
        ns = i32(s["n"])
        mask = mask & (qpos * ns + s["q_off"] >= kpos * ns + s["k_off"])
    else:
        if s["causal"]:
            mask = mask & (qpos >= kpos)
        if s["window"]:
            mask = mask & (qpos - kpos < i32(s["window"]))
    return np.asarray(mask)


def jax_key_range(s, qi):
    """The dQ kernel's loop over key blocks ``[lo, nkb)``."""
    i32 = jnp.int32
    bq = bk = TILE
    nkb = i32(-(-s["Tk"] // bk))
    qi = i32(qi)
    if s["mask"] == "striped":
        numer = ((qi + 1) * i32(bq) - 1) * i32(s["n"]) + s["q_off"] \
            - s["k_off"]
        nkb = jnp.maximum(jnp.minimum(nkb, lax.div(numer, i32(bk * s["n"]))
                                      + 1), i32(0))
        return 0, int(nkb)
    if s["causal"]:
        nkb = jnp.minimum(nkb, lax.div((qi + 1) * i32(bq) + i32(bk - 1),
                                       i32(bk)))
    lo = pk._window_lo(qi, bq, bk, s["window"]) if s["window"] else 0
    return int(lo), int(nkb)


def jax_query_range(s, ki):
    """The dK/dV kernel's loop over query blocks ``[lo, nqb)``."""
    i32 = jnp.int32
    bq = bk = TILE
    nqb = i32(-(-s["Tq"] // bq))
    ki = i32(ki)
    if s["mask"] == "striped":
        amin = ki * i32(bk) + (1 if s["k_off"] > s["q_off"] else 0)
        return int(jnp.maximum(lax.div(amin, i32(bq)), i32(0))), int(nqb)
    lo = lax.div(ki * i32(bk), i32(bq)) if s["causal"] else i32(0)
    if s["window"]:
        nqb = jnp.minimum(nqb, lax.div(ki * i32(bk)
                                       + i32(bk + s["window"] - 2), i32(bq))
                          + i32(1))
    return int(lo), int(nqb)


def _check(s):
    tq, tk = s["Tq"], s["Tk"]
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    # every row and key of the tiles, the padding past Tq and Tk included
    qp, kp = np.meshgrid(np.arange(nq * TILE), np.arange(nk * TILE),
                         indexing="ij")
    vis = visible(s, qp, kp)
    np.testing.assert_array_equal(vis[:tq, :tk], jax_mask(s))
    seen = vis | (qp >= tq)  # rows past Tq count as seeing
    krange = [key_range(s, qi) for qi in range(nq)]
    qrange = [query_range(s, kj) for kj in range(nk)]
    assert krange == [jax_key_range(s, qi) for qi in range(nq)]
    assert qrange == [jax_query_range(s, kj) for kj in range(nk)]
    for qi in range(nq):
        for kj in range(nk):
            tile = (slice(qi * TILE, (qi + 1) * TILE),
                    slice(kj * TILE, (kj + 1) * TILE))
            if vis[tile].any():
                # both backward walks visit the tile pair
                assert krange[qi][0] <= kj < krange[qi][1], (qi, kj)
                assert qrange[kj][0] <= qi < qrange[kj][1], (qi, kj)
            if full_tile(s, qi * TILE, kj * TILE):
                # every row sees every key of the tile, none past Tk
                assert seen[tile].all(), (qi, kj)
    return vis[:tq, :tk]


STRIPED = [(n, qo, ko, c) for n in (1, 2, 4) for qo in range(n)
           for ko in range(n) for c in (100, 256)]


@pytest.mark.parametrize("n,q_off,k_off,c", STRIPED,
                         ids=["n%d-q%d-k%d-C%d" % t for t in STRIPED])
def test_striped_tiles(n, q_off, k_off, c):
    s = dict(mask="striped", Tq=c, Tk=c, n=n, q_off=q_off, k_off=k_off)
    vis = _check(s)
    # row 0 sees no key when k_off > q_off: the hop's empty row
    assert vis[0].any() == (k_off <= q_off)


# (Tq, Tk, causal, window)
FLASH = [(100, 100, True, 0), (256, 256, True, 0), (200, 200, False, 0),
         (1000, 1000, True, 33), (300, 300, True, 64), (300, 300, True, 1),
         (200, 200, True, 130), (77, 77, True, 5), (100, 200, False, 0),
         (200, 100, False, 0), (200, 100, True, 0), (130, 257, True, 70)]


@pytest.mark.parametrize("tq,tk,causal,window", FLASH,
                         ids=["Tq%d-Tk%d-%s-w%d" % (a, b, "causal" if c
                                                    else "full", w)
                              for a, b, c, w in FLASH])
def test_flash_tiles(tq, tk, causal, window):
    _check(dict(mask="flash", Tq=tq, Tk=tk, causal=causal, window=window))
