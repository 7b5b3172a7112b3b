"""Host-side prefix cache bookkeeping for the serving engine.

Counterpart of ``mxnet_tpu/serving/prefix.py`` ``PrefixCache``, line for
line. The device side of prefix reuse is the engine's copy program, one
per bucket, over rows ``[0, bucket)`` of one cache slot
(``Decoder.slot_prefix_rows`` / ``slot_write_prefix_rows``); everything
POLICY lives here, as plain python the tests hold without a device:

* a **trie over token ids** maps a new prompt to the longest prefix
  some retained entry shares with it (every node on an entry's path
  carries the entry, so the deepest reachable node IS the longest
  match);
* each entry owns one **pool slot** — a reserved slot of the engine's
  cache buffers holding the K/V of the entry's prompt — and the pool is
  bounded by a **byte budget** (``slot_bytes`` per entry, ``capacity``
  slots total);
* eviction is **LRU over unpinned entries**: an entry is pinned
  (``refs > 0``) while a request that matched it is still mid-prefill.
  All-pinned means ``insert`` declines (returns None) rather than
  evicting a source someone still schedules against.

The cache stores PROMPT prefixes only (generated tokens never enter
the trie): prompt K/V rows are a pure function of the token ids, which
is what makes a cross-request copy exact.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["PrefixCache"]


class _Node:
    """One trie node: children by token id, plus every entry whose
    token path passes through this node (so any reachable node has a
    non-empty entry set — emptied subtrees are pruned on eviction)."""

    __slots__ = ("children", "entries")

    def __init__(self):
        self.children = {}
        self.entries = set()


class _Entry:
    __slots__ = ("tokens", "slot", "refs", "tick")

    def __init__(self, tokens, slot, tick):
        self.tokens = tokens        # tuple of python ints
        self.slot = slot            # pool slot index owning the rows
        self.refs = 0               # pin count (mid-prefill consumers)
        self.tick = tick            # LRU clock (bumped on every use)

    def __repr__(self):
        return ("_Entry(len=%d, slot=%d, refs=%d)"
                % (len(self.tokens), self.slot, self.refs))


class PrefixCache:
    """Refcounted-LRU prefix trie over ``capacity`` pool slots.

    ``slot_bytes`` is what one retained entry costs on device (one
    full cache slot — the engine computes it from its cache buffers);
    ``bytes_used`` reports the resident total.
    """

    def __init__(self, capacity, slot_bytes):
        capacity = int(capacity)
        if capacity < 1:
            raise MXNetError("PrefixCache: capacity must be >= 1 "
                             "(got %d); disable the cache instead"
                             % capacity)
        self.capacity = capacity
        self.slot_bytes = int(slot_bytes)
        self._root = _Node()
        self._by_tokens = {}                  # tokens tuple -> _Entry
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> 0,1,..
        self._tick = 0
        self.evictions = 0
        self.inserts = 0
        self.insert_skipped = 0

    # -- introspection ---------------------------------------------------
    def __len__(self):
        return len(self._by_tokens)

    @property
    def bytes_used(self):
        return len(self._by_tokens) * self.slot_bytes

    @property
    def pinned(self):
        """Total outstanding pins (sum of entry refcounts). Every
        engine error/cancel/deadline path must return this to its
        pre-request value — a leaked pin is a pool slot that can never
        be evicted again (eventual pool starvation); the fault tests
        assert it drains back to zero."""
        return sum(e.refs for e in self._by_tokens.values())

    def entries(self):
        """Snapshot of retained entries (tests/debugging)."""
        return list(self._by_tokens.values())

    def get(self, tokens):
        """The entry retaining exactly ``tokens``, or None (no LRU
        touch — this is an existence probe, not a use)."""
        return self._by_tokens.get(tuple(int(t) for t in tokens))

    def peek(self, tokens):
        """Longest retained prefix length of ``tokens`` WITHOUT an LRU
        touch or a pin — a placement probe, not a use (the JAX
        package's fleet router reads it off candidate replicas); the
        engine walks with :meth:`lookup` at admission and takes the hit
        itself."""
        node, depth = self._root, 0
        for t in tokens:
            child = node.children.get(int(t))
            if child is None:
                break
            node, depth = child, depth + 1
        return depth

    # -- lookup ----------------------------------------------------------
    def lookup(self, tokens):
        """Longest cached prefix of ``tokens``: returns
        ``(matched_len, entry)`` — the deepest trie node reachable and
        the most-recently-used entry passing through it — or
        ``(0, None)`` on a miss. Touches the matched entry's LRU
        clock. The caller decides how much of the match to USE (the
        engine clips to ``len(prompt) - 1`` so a full hit still
        prefills one real token for its logits) and must
        ``acquire``/``release`` around the time the entry's rows are
        scheduled against."""
        node, depth = self._root, 0
        for t in tokens:
            child = node.children.get(int(t))
            if child is None:
                break
            node, depth = child, depth + 1
        if depth == 0:
            return 0, None
        entry = max(node.entries, key=lambda e: e.tick)
        self._tick += 1
        entry.tick = self._tick
        return depth, entry

    # -- pinning ---------------------------------------------------------
    def acquire(self, entry):
        entry.refs += 1

    def release(self, entry):
        if entry.refs <= 0:
            raise MXNetError("PrefixCache: release without acquire on "
                             "%r" % (entry,))
        entry.refs -= 1

    # -- insert / evict --------------------------------------------------
    def insert(self, tokens):
        """Retain ``tokens``'s K/V (the caller copies the rows into
        ``entry.slot`` after this returns): allocates a pool slot,
        evicting the least-recently-used UNPINNED entry if the pool is
        full. Returns the new entry, the existing one when ``tokens``
        is already retained verbatim (LRU-touched, no copy needed), or
        None when every slot is pinned (the caller skips retention)."""
        tokens = tuple(int(t) for t in tokens)
        if not tokens:
            raise MXNetError("PrefixCache: cannot retain an empty "
                             "prefix")
        hit = self._by_tokens.get(tokens)
        if hit is not None:
            self._tick += 1
            hit.tick = self._tick
            return hit
        if not self._free and not self._evict_one():
            self.insert_skipped += 1
            return None
        slot = self._free.pop()
        self._tick += 1
        entry = _Entry(tokens, slot, self._tick)
        node = self._root
        node.entries.add(entry)
        for t in tokens:
            node = node.children.setdefault(t, _Node())
            node.entries.add(entry)
        self._by_tokens[tokens] = entry
        self.inserts += 1
        return entry

    def discard(self, entry):
        """Drop a retained entry whose device rows never materialized
        (a failed retention copy): without this, a later hit would
        serve garbage rows. No-op if the entry is already gone."""
        if self._by_tokens.get(entry.tokens) is entry:
            self._remove(entry)

    def _evict_one(self):
        victim = None
        for e in self._by_tokens.values():
            if e.refs == 0 and (victim is None or e.tick < victim.tick):
                victim = e
        if victim is None:
            return False
        self._remove(victim)
        self.evictions += 1
        return True

    def _remove(self, entry):
        del self._by_tokens[entry.tokens]
        self._free.append(entry.slot)
        # unlink along the path; prune the shallowest emptied subtree
        # (removing this entry empties a node iff it empties the whole
        # subtree below it — entries live on every node of their path)
        node = self._root
        node.entries.discard(entry)
        for t in entry.tokens:
            child = node.children[t]
            child.entries.discard(entry)
            if not child.entries:
                del node.children[t]
                break
            node = child
