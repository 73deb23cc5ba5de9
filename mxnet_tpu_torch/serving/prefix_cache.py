"""Cross-request KV prefix cache over the paged pool.

Copied from ``mxnet_tpu/serving/prefix_cache.py`` (``PrefixCache`` :44),
which is backend-free.

A prompt is hashed in fixed C-token chunks with CHAINED digests (chunk i's
hash folds in chunk i-1's, so a hash names the whole prefix up to and
including its chunk), and each cached chunk holds its page frames at a pool
refcount. ``PagedKVDecoder.admit`` walks the chain, adopts every matched
chunk's frames at +1 ref (no recompute, no copy: the global slot axis makes
physical sharing legal), and chunk-prefills only the unmatched tail,
registering each fresh full chunk back into the index.

Eviction is LRU over LEAF entries only (an interior chunk's children would
become unreachable if it left first), on demand when the pool cannot serve
an allocation. Evicting an entry drops only the CACHE's reference: a frame
some lane still attends keeps its other holders.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

from .. import telemetry as _tm

__all__ = ["PrefixCache"]


class _Entry:
    __slots__ = ("frames", "parent", "children")

    def __init__(self, frames, parent):
        self.frames = list(frames)
        self.parent = parent     # parent chunk's hash (None for chunk 0)
        self.children = 0        # live child entries (0 == evictable leaf)


class PrefixCache:
    """LRU index of chained chunk hashes -> refcounted page frames."""

    def __init__(self, pool, chunk):
        self.pool = pool
        self.chunk = int(chunk)
        if self.chunk < 1:
            raise ValueError("prefix_cache: chunk must be >= 1")
        if self.chunk % pool.page_size:
            raise ValueError(
                "prefix_cache: chunk %d must be a multiple of the page size %d (cache "
                "entries own whole frames)" % (self.chunk, pool.page_size))
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._evictions = 0

    # ------------------------------------------------------------- hashing
    def chain_hashes(self, tokens):
        """Chained digests for every FULL chunk of ``tokens``:
        ``h[i] = md5(h[i-1] || chunk_i)`` over the chunk's int64 bytes. Two
        prompts share ``h[i]`` iff their first (i+1)*C tokens are equal."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
        n = toks.shape[0] // self.chunk
        hashes = []
        prev = b""
        for i in range(n):
            h = hashlib.md5(
                prev + toks[i * self.chunk:(i + 1) * self.chunk].tobytes()).hexdigest()
            hashes.append(h)
            prev = h.encode()
        return hashes

    # -------------------------------------------------------------- lookup
    def match(self, hashes):
        """Longest cached prefix of the hash chain. Returns
        ``(n_matched_chunks, flat_frames)``: the frames of every matched
        chunk in position order, NOT yet increfed (the adopting lane does
        that). Matched entries become the most recently used."""
        matched = 0
        frames = []
        for h in hashes:
            e = self._entries.get(h)
            if e is None:
                break
            self._entries.move_to_end(h)
            frames.extend(e.frames)
            matched += 1
        return matched, frames

    def insert(self, h, frames, parent=None):
        """Register a freshly computed chunk under its chain hash, taking the
        cache's OWN reference on each frame. ``parent`` (the previous
        chunk's hash, None for chunk 0) gains a child and stops being an
        evictable leaf. A hash already present keeps its entry."""
        if h in self._entries:
            self._entries.move_to_end(h)
            return
        e = _Entry(frames, parent)
        self._entries[h] = e
        if parent is not None and parent in self._entries:
            self._entries[parent].children += 1
        for f in e.frames:
            self.pool.incref(f)
        if _tm.enabled():
            _tm.gauge("serving.prefix_entries").set(len(self._entries))

    # ------------------------------------------------------------- eviction
    def evict_for(self, n):
        """Evict LRU leaf entries until the pool can serve ``n`` frames (or
        nothing evictable remains). Returns True when the pool can now
        allocate. Dropping an entry releases only the CACHE's reference."""
        while not self.pool.can_acquire(n):
            victim = None
            for h, e in self._entries.items():   # OrderedDict = LRU order
                if e.children == 0:
                    victim = h
                    break
            if victim is None:
                return False
            e = self._entries.pop(victim)
            if e.parent is not None and e.parent in self._entries:
                self._entries[e.parent].children -= 1
            self.pool.release(e.frames)
            self._evictions += 1
            if _tm.enabled():
                _tm.counter("serving.prefix_evictions").inc()
                _tm.gauge("serving.prefix_entries").set(len(self._entries))
        return True

    def stats(self):
        return {"entries": len(self._entries),
                "frames_held": sum(len(e.frames) for e in self._entries.values()),
                "evictions": self._evictions}
