"""Host-side paged KV pool manager: block allocation, prefix-cache trie,
sessions, copy-on-write forking and eviction — the port's own copy of
``repro/runtime/kv_pool.py`` (host-only numpy; the metrics-hub mirror is
left out with the hub).

The device side is one block pool per layer, leaves ``(N, block, ...)``
(``models/lm.py:init_kv_pool``), indexed by per-slot block tables
``(B, nbps)``; this module owns the host bookkeeping of those tables:

* **Reserved blocks.**  Block 0 (``NULL``) stays all-zeros and is the
  gather target of every unallocated lane of a seed table (a zero page
  reads exactly like a freshly zeroed cache).  Block 1 (``TRASH``) is the
  write-off target: dead and pending slots point their whole table row at
  it, so the decode step's unconditional KV write lands somewhere harmless.
  TRASH is never read for a live position.
* **Refcounts.**  ``refcount[b]`` counts logical holders: slot table rows
  and session chains.  The trie holds no reference: a committed block at
  refcount 0 parks in an LRU of evictable-but-matchable blocks.
* **Prefix trie.**  Committed blocks are keyed by a rolling chain hash
  (salt ‖ parent hash ‖ block tokens) over FULL blocks; the salt carries
  everything besides the tokens that determines a block's content (the
  sparse-prefill alphas).  Only prefill-origin blocks are committed:
  decode-written KV is not bitwise the prefill KV of the same tokens, so
  reply blocks live only in session chains.
* **Sessions.**  ``session_id -> (chain, history tokens, SLA tier)``, LRU
  capped and LRU evicted when the allocator runs dry.
* **Copy-on-write.**  ``ensure_writable``: a block about to be written must
  be exclusively owned and uncommitted; otherwise it is forked to a fresh
  block (the caller rewrites the content).
"""
from __future__ import annotations

import collections
import hashlib
from typing import Optional

import numpy as np


class PoolExhausted(RuntimeError):
    """The eviction cascade (free -> parked -> sessions) ran dry: every
    block holds a live reference."""


class KVPool:
    """Bookkeeping for one device block pool (``n_blocks`` total, including
    the two reserved blocks)."""

    NULL = 0
    TRASH = 1
    _RESERVED = 2

    def __init__(self, n_blocks: int, block_size: int,
                 max_sessions: int = 64, prefix_cache: bool = True):
        if n_blocks < self._RESERVED + 1:
            raise ValueError(
                f"pool needs > {self._RESERVED} blocks (null + trash + at "
                f"least one allocatable); got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.max_sessions = int(max_sessions)
        self.prefix_cache = bool(prefix_cache)
        self.refcount = np.zeros(n_blocks, np.int32)
        # pop() hands out the lowest id first
        self._free: list[int] = list(range(n_blocks - 1, self._RESERVED - 1,
                                           -1))
        self._trie: dict[bytes, int] = {}        # chain hash -> block id
        self._hash_of: dict[int, bytes] = {}     # committed id -> hash
        # committed blocks at refcount 0, evicted oldest-parked first
        self._lru: collections.OrderedDict[int, None] = \
            collections.OrderedDict()
        self.sessions: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self.stats = collections.Counter()

    # ------------------------------------------------------------ hashing --
    def block_hashes(self, salt: bytes, tokens: np.ndarray) -> list[bytes]:
        """Rolling chain hash per FULL block of ``tokens`` (a partial tail
        has none: it cannot be committed)."""
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        out: list[bytes] = []
        parent = b""
        for j in range(len(tokens) // self.block_size):
            blk = tokens[j * self.block_size:(j + 1) * self.block_size]
            parent = hashlib.sha1(salt + parent + blk.tobytes()).digest()
            out.append(parent)
        return out

    # --------------------------------------------------------- allocation --
    def alloc(self) -> int:
        """A fresh exclusively-owned block (refcount 1).  Reclaims parked
        committed blocks, then evicts LRU sessions; raises
        :class:`PoolExhausted` when every block holds a live reference."""
        while not self._free:
            if self._lru:
                bid, _ = self._lru.popitem(last=False)
                self._uncommit(bid)
                self._free.append(bid)
                self.stats["evicted_blocks"] += 1
            elif self.sessions:
                self._evict_session()
            else:
                raise PoolExhausted(
                    f"KV pool exhausted: {self.n_blocks} blocks all hold "
                    "live references (grow PagedKVConfig.pool_blocks or "
                    "admit fewer concurrent requests)")
        bid = self._free.pop()
        assert self.refcount[bid] == 0
        self.refcount[bid] = 1
        return bid

    def pressure(self) -> float:
        """Fraction of allocatable blocks the cascade could NOT hand out for
        free (free and parked blocks are headroom), in ``[0, 1]``."""
        allocatable = self.n_blocks - self._RESERVED
        headroom = len(self._free) + len(self._lru)
        return 1.0 - headroom / allocatable

    def _check_id(self, bid: int) -> int:
        """Reject NULL/TRASH (they hold no references) and ids outside the
        pool before they touch the refcount array."""
        b = int(bid)
        if b == self.NULL or b == self.TRASH:
            raise ValueError(
                f"reserved block id {b} (NULL/TRASH) holds no references")
        if not self._RESERVED <= b < self.n_blocks:
            raise ValueError(
                f"block id {b} out of range "
                f"[{self._RESERVED}, {self.n_blocks})")
        return b

    def incref(self, bid: int) -> None:
        bid = self._check_id(bid)
        if self.refcount[bid] == 0 and bid in self._lru:
            del self._lru[bid]       # revived from the evictable park
        self.refcount[bid] += 1

    def decref(self, bid: int) -> None:
        bid = self._check_id(bid)
        if self.refcount[bid] <= 0:
            raise RuntimeError(f"decref of unreferenced block {bid}")
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            if bid in self._hash_of:
                self._lru[bid] = None     # committed: park, stay matchable
            else:
                self._free.append(bid)

    release = decref

    def ensure_writable(self, bid: int) -> tuple[int, Optional[int]]:
        """Copy-on-write: returns ``(writable_id, src)``.  ``src is None``
        means ``bid`` was exclusively owned and uncommitted (write in
        place); otherwise a fresh fork was allocated, ``bid``'s reference
        dropped, and the caller rewrites the content."""
        bid = self._check_id(bid)
        if self.refcount[bid] == 1 and bid not in self._hash_of:
            return bid, None
        fresh = self.alloc()
        self.decref(bid)
        self.stats["cow_forks"] += 1
        return fresh, bid

    # -------------------------------------------------------- prefix trie --
    def match_prefix(self, salt: bytes, tokens: np.ndarray) -> list[int]:
        """Longest committed chain matching ``tokens``' full blocks."""
        if not self.prefix_cache:
            return []
        ids: list[int] = []
        for h in self.block_hashes(salt, tokens):
            bid = self._trie.get(h)
            if bid is None:
                break
            ids.append(bid)
        return ids

    def commit_chain(self, hashes: list[bytes], ids: list[int],
                     owned_from: int = 0) -> list[int]:
        """Commit a slot's prefill-origin full blocks into the trie, left to
        right, deduplicating against existing entries: on a duplicate the
        caller's reference moves to the canonical block, whose id is
        returned in its place.  Blocks below ``owned_from`` were adopted
        and pass through untouched.  Commitment stops at the first
        uncommitted parent (a chain with a hole is unreachable)."""
        out = list(ids)
        if not self.prefix_cache:
            return out
        chained = True   # parent continuity: walkable from the root
        for j, (h, bid) in enumerate(zip(hashes, ids)):
            if j < owned_from:
                chained = chained and (self._hash_of.get(bid) == h)
                continue
            if not chained:
                break
            have = self._trie.get(h)
            if have is not None and have != bid:
                self.incref(have)
                self.decref(bid)
                self.stats["dedup_blocks"] += 1
                out[j] = have
            elif have is None:
                self._trie[h] = bid
                self._hash_of[bid] = h
        return out

    def _uncommit(self, bid: int) -> None:
        h = self._hash_of.pop(bid, None)
        if h is not None and self._trie.get(h) == bid:
            del self._trie[h]

    # ------------------------------------------------------------ sessions --
    def lookup_session(self, sid: Optional[str]) -> Optional[dict]:
        if sid is None or sid not in self.sessions:
            return None
        self.sessions.move_to_end(sid)          # LRU bump
        return self.sessions[sid]

    def store_session(self, sid: str, chain: list[int], history: np.ndarray,
                      tier: str) -> None:
        """Retain a finished request's chain under ``sid`` (references
        transfer from the caller).  Replacing a session releases the old
        chain; the LRU cap evicts the oldest sessions."""
        old = self.sessions.pop(sid, None)
        self.sessions[sid] = {
            "chain": [int(b) for b in chain],
            "history": np.asarray(history, np.int32).copy(),
            "tier": tier,
        }
        if old is not None:
            for b in old["chain"]:
                self.decref(b)
        while len(self.sessions) > self.max_sessions:
            self._evict_session()

    def drop_session(self, sid: str) -> None:
        old = self.sessions.pop(sid, None)
        if old is not None:
            for b in old["chain"]:
                self.decref(b)

    def _evict_session(self) -> None:
        _, sess = self.sessions.popitem(last=False)
        for b in sess["chain"]:
            self.decref(b)
        self.stats["evicted_sessions"] += 1

    # ------------------------------------------------------------- metrics --
    def snapshot(self) -> dict:
        """Counters and occupancy, as the reference reports them."""
        return {
            "n_blocks": self.n_blocks,
            "free_blocks": len(self._free),
            "parked_blocks": len(self._lru),
            "committed_blocks": len(self._hash_of),
            "live_refs": int((self.refcount > 0).sum()),
            "sessions": len(self.sessions),
            "pressure": self.pressure(),
            **{k: int(v) for k, v in self.stats.items()},
        }

    def check_invariants(self) -> None:
        """Reserved blocks unreferenced and uncommitted; every block in
        exactly one of {free, parked, referenced}; the trie consistent."""
        assert self.refcount[self.NULL] == 0 and self.refcount[self.TRASH] == 0
        assert self.NULL not in self._hash_of and \
            self.TRASH not in self._hash_of
        free = set(self._free)
        parked = set(self._lru)
        assert not (free & parked)
        for b in range(self._RESERVED, self.n_blocks):
            rc = int(self.refcount[b])
            if b in free:
                assert rc == 0 and b not in self._hash_of
            elif b in parked:
                assert rc == 0 and b in self._hash_of
            else:
                assert rc > 0, f"leaked block {b}"
        for h, b in self._trie.items():
            assert self._hash_of.get(b) == h
