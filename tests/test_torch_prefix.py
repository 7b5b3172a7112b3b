"""The port's prefix cache against the JAX package's, on the CPU.

* ``mxnet_tpu_torch.serving.PrefixCache`` (host-only) against
  ``mxnet_tpu.serving.PrefixCache``: each case of
  ``tests/test_prefix_cache.py`` runs through both classes, with its
  assertions, and both give the same observations (match lengths, the
  matched entries' tokens, slots and pins, eviction and insert counts,
  bytes in use, errors); then seeded random sequences of lookups,
  inserts, pins, releases and discards over a small alphabet run through
  both, with equal observations after every operation.
* ``Decoder.slot_prefix_rows`` / ``slot_write_prefix_rows`` against the
  JAX functions on the same float and int8 caches: the rows read, and the
  caches after a write, are equal (a copy changes no bit), with the slot
  as an int and as a device operand.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import PrefixCache as JaxPrefixCache

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import PrefixCache

SIDES = {"jax": (JaxPrefixCache, JaxError), "port": (PrefixCache, MXNetError)}


def _entry(e):
    return None if e is None else (e.tokens, e.slot, e.refs)


def _state(pc):
    return (len(pc), pc.bytes_used, pc.pinned, pc.evictions, pc.inserts,
            pc.insert_skipped,
            sorted(_entry(e) for e in pc.entries()))


# -- the cases of tests/test_prefix_cache.py, on either class --------------

def case_lookup_longest_prefix_and_miss(PC, Err):
    pc = PC(4, 1024)
    a = pc.insert((1, 2, 3, 4, 5))
    b = pc.insert((1, 2, 9))
    assert a.slot != b.slot and len(pc) == 2
    obs = []
    for q in ((1, 2, 3, 4, 5), (1, 2, 3, 7, 7, 7), (1, 2, 9, 9)):
        d, e = pc.lookup(q)
        obs.append((d, _entry(e)))
    assert obs[0][0] == 5 and obs[1][0] == 3 and obs[2][0] == 3
    d, e = pc.lookup((1, 2))
    assert d == 2 and e in (a, b)
    assert pc.lookup((8, 1, 2)) == (0, None)
    assert pc.lookup(()) == (0, None)
    return obs + [d, _state(pc)]


def case_insert_duplicate_returns_existing(PC, Err):
    pc = PC(4, 1024)
    a = pc.insert((4, 5, 6))
    assert pc.insert((4, 5, 6)) is a
    assert len(pc) == 1 and pc.inserts == 1
    assert pc.get((4, 5, 6)) is a and pc.get((4, 5)) is None
    return [_state(pc)]


def case_lru_eviction_order_and_touch(PC, Err):
    pc = PC(2, 1024)
    a = pc.insert((1, 1))
    b = pc.insert((2, 2))
    pc.lookup((1, 1))
    c = pc.insert((3, 3))
    assert pc.evictions == 1
    assert pc.get((2, 2)) is None and pc.get((1, 1)) is a
    assert pc.lookup((2, 2)) == (0, None)
    assert c.slot == b.slot
    d, e = pc.lookup((3, 3, 9))
    assert d == 2 and e is c
    return [_state(pc)]


def case_refcount_pins_against_eviction(PC, Err):
    pc = PC(1, 1024)
    a = pc.insert((1, 2))
    pc.acquire(a)
    assert pc.insert((3, 4)) is None
    assert pc.insert_skipped == 1 and pc.get((1, 2)) is a
    obs = [_state(pc)]
    pc.release(a)
    b = pc.insert((3, 4))
    assert b is not None and pc.get((1, 2)) is None
    assert pc.evictions == 1
    with pytest.raises(Err, match="release without acquire"):
        pc.release(a)
    return obs + [_state(pc)]


def case_eviction_prunes_only_the_unshared_suffix(PC, Err):
    pc = PC(2, 1024)
    pc.insert((1, 2, 3, 4))
    b = pc.insert((1, 2, 7))
    pc.lookup((1, 2, 7))
    pc.insert((9,))
    d, e = pc.lookup((1, 2, 3, 4))
    assert d == 2 and e is b
    d2, e2 = pc.lookup((1, 2, 7, 7))
    assert d2 == 3 and e2 is b
    return [d, d2, _state(pc)]


def case_byte_budget_accounting(PC, Err):
    pc = PC(3, 2048)
    assert pc.bytes_used == 0
    pc.insert((1,))
    pc.insert((2,))
    assert pc.bytes_used == 2 * 2048
    pc.insert((3,))
    pc.insert((4,))
    assert pc.bytes_used == 3 * 2048 and len(pc) == 3
    return [_state(pc)]


def case_validation(PC, Err):
    with pytest.raises(Err, match="capacity"):
        PC(0, 1024)
    pc = PC(4, 1024)
    with pytest.raises(Err, match="empty"):
        pc.insert(())
    return [_state(pc)]


def case_peek_and_discard(PC, Err):
    pc = PC(2, 64)
    a = pc.insert((5, 6, 7))
    ticks = pc.peek((5, 6, 1)), pc.peek((9,))
    pc.discard(a)
    pc.discard(a)                       # already gone: no-op
    assert pc.lookup((5, 6, 7)) == (0, None)
    return [ticks, _state(pc)]


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefix_cache_case_equals_jax(name):
    want = CASES[name](*SIDES["jax"])
    got = CASES[name](*SIDES["port"])
    assert got == want


def _random_ops(seed, n=400):
    """A seeded stream of cache operations over prompts from a 4-token
    alphabet (so prefixes collide), as ``(op, tokens)``."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        op = rng.choice(["lookup", "insert", "acquire", "release",
                         "discard", "peek", "get"],
                        p=[0.3, 0.3, 0.1, 0.1, 0.05, 0.1, 0.05])
        toks = tuple(int(t) for t in rng.randint(0, 4, rng.randint(1, 7)))
        ops.append((str(op), toks))
    return ops


def _replay(PC, Err, ops, capacity):
    """Run ``ops`` through one class; returns what each op returned and
    the cache's state after it. Pins taken by ``acquire`` are released
    by later ``release`` ops, oldest first."""
    pc = PC(capacity, 100)
    pins, trace = [], []
    for op, toks in ops:
        if op == "lookup":
            d, e = pc.lookup(toks)
            out = (d, _entry(e))
            if e is not None:
                pins.append(e)          # a later acquire pins the hit
        elif op == "insert":
            out = _entry(pc.insert(toks))
        elif op == "acquire":
            out = None
            if pins:
                pc.acquire(pins[-1])
                out = _entry(pins[-1])
        elif op == "release":
            held = [e for e in pins if e.refs > 0]
            out = None
            if held:
                pc.release(held[0])
                out = _entry(held[0])
        elif op == "discard":
            e = pc.get(toks)
            out = _entry(e)
            if e is not None and e.refs == 0:
                pc.discard(e)
        elif op == "peek":
            out = pc.peek(toks)
        else:
            out = _entry(pc.get(toks))
        trace.append((op, out, _state(pc)))
    return trace


@pytest.mark.parametrize("seed,capacity", [(0, 1), (1, 3), (2, 8)])
def test_random_operations_equal_jax(seed, capacity):
    ops = _random_ops(seed)
    want = _replay(*SIDES["jax"], ops, capacity)
    got = _replay(*SIDES["port"], ops, capacity)
    assert got == want
    # the stream exercised eviction and the pinned-pool refusal
    assert any(s[3] for _, _, s in got)


# -- the copy's row reads and writes ----------------------------------------

S_, L_, H_, D_ = 3, 12, 2, 4


def _caches(kind, seed):
    """Two attention nodes' cache buffers, numpy, seeded: float K/V, or
    int8 K/V with f32 row scales."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        if kind == "int8":
            out.append(tuple(
                rng.randint(-127, 128, shape).astype(np.int8)
                if len(shape) == 4 else
                rng.uniform(0.01, 0.1, shape).astype(np.float32)
                for shape in ((S_, L_, H_, D_), (S_, L_, H_),
                              (S_, L_, H_, D_), (S_, L_, H_))))
        else:
            out.append(tuple(rng.randn(S_, L_, H_, D_).astype(np.float32)
                             for _ in range(2)))
    return out


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("operand", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("length", [1, 5, L_])
def test_slot_prefix_rows_equal_jax(kind, operand, length):
    src, dst = 2, 0
    cache = _caches(kind, length)
    jc = [tuple(jnp.asarray(b) for b in e) for e in cache]
    tc = [tuple(torch.from_numpy(b.copy()) for b in e) for e in cache]
    slot = (lambda v: torch.tensor([v])) if operand else int
    jrows = JaxDecoder.slot_prefix_rows(jc, jnp.int32(src), length)
    trows = Decoder.slot_prefix_rows(tc, slot(src), length)
    for je, te in zip(jrows, trows):
        for jb, tb in zip(je, te):
            assert tuple(tb.shape) == jb.shape == (1, length) + jb.shape[2:]
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jc = JaxDecoder.slot_write_prefix_rows(jc, jnp.int32(dst), jrows)
    out = Decoder.slot_write_prefix_rows(tc, slot(dst), trows)
    assert out is tc
    for je, te, orig in zip(jc, tc, cache):
        for jb, tb, ob in zip(je, te, orig):
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
            # rows past the copy and the other slots are as they were
            np.testing.assert_array_equal(tb.numpy()[dst, length:],
                                          ob[dst, length:])
            np.testing.assert_array_equal(tb.numpy()[1:], ob[1:])
