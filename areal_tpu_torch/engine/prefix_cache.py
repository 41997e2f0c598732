"""Cross-request radix prefix cache over the paged KV pool (a copy of
``areal_tpu/engine/prefix_cache.py`` without its host spill tier).

A radix/trie index over TOKEN-ID prefixes whose nodes hold refcounted
blocks of the engine's paged pool (:mod:`areal_tpu_torch.models.paged`):
a new request first walks the tree, pins the longest matched prefix's
blocks, and enters the fill queue needing only the suffix prefilled.  A
multi-turn conversation re-sending its whole history, a retried request
and a group member arriving after its prompt's fill completed all reuse
the cached KV.

Design, as in the reference:

* **Blocks are the unit of sharing.**  A trie node covers exactly one
  FULL pool block (``page_size`` tokens), keyed by that block's token
  tuple.  Full blocks are append-frozen (a row never writes into a block
  it has written past), so sharing them by reference is safe while the
  donor row keeps decoding.  A row's one mutable block (its tail) is
  shared only by VALUE: a node may carry *partial tail entries* (block id
  and the token prefix it holds), and a match on one returns a
  copy-on-write instruction: the engine copies the block
  (:func:`~areal_tpu_torch.models.paged.copy_blocks`) and owns the copy.
  KV depends only on (token prefix, weights), so blocks cached by
  different donors along one path combine exactly.
* **The cache owns references, never blocks.**  It reaches the engine's
  allocator through two callbacks (``acquire``/``release``, the engine's
  ``_incref_blocks``/``_free_block_list``); eviction drops only the
  cache's own reference, so a prefix pinned by a live row is never
  recycled under it.
* **Deterministic.**  LRU order, eviction victims and capacity trims key
  on the engine's step counter and a monotone node sequence, never on
  wall time.
* **Weight swaps invalidate.**  Cached KV is valid only under the
  weights that computed it: ``flush()`` drops every entry and moves
  ``version`` so an insert of pre-swap KV is rejected.

Not ported: the host spill tier (``host_bytes_budget``, ``spill_fetch``,
``begin_restore``/``complete_restore``) and the fleet export walk; the
engine refuses a host budget.  :meth:`RadixPrefixCache.stats` keeps the
reference's keys, the host tier's at 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class PrefixMatch:
    """Result of a longest-prefix walk.

    ``blocks`` are the matched FULL blocks, in sequence order: the caller
    pins them (its own incref) before using them.  When ``tail_block`` is
    set, the walk also matched the first ``tail_tokens`` tokens of a
    partial tail (or of a full child block); the caller COPIES that block
    into one it owns, since the donor may still append to it.
    ``n_tokens`` is the whole matched prefix
    (``len(blocks) * page_size + tail_tokens``)."""

    blocks: List[int] = dataclasses.field(default_factory=list)
    n_tokens: int = 0
    tail_block: Optional[int] = None
    tail_tokens: int = 0


@dataclasses.dataclass
class _TailEntry:
    """A partially filled block cached by value: ``tokens`` are the block's
    valid prefix; a longer donor with the same first token replaces it."""

    block: int
    tokens: Tuple[int, ...]
    last_use: int = 0
    seq: int = 0


#: most cached partial tails per node, keyed by the tail's FIRST token:
#: several concurrent sessions shorter than ``page_size`` (all tail, at the
#: root) stay cached instead of replacing one another
TAILS_PER_NODE = 4


class _Node:
    """One full block of one cached sequence.  ``key`` is the block's
    ``page_size``-token tuple; children extend the prefix by one block."""

    __slots__ = ("key", "block", "children", "parent", "last_use", "seq",
                 "tails")

    def __init__(self, key, block, parent, last_use, seq):
        self.key: Tuple[int, ...] = key
        self.block: int = block
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent: Optional[_Node] = parent
        self.last_use: int = last_use
        self.seq: int = seq  # insertion order: deterministic LRU tie-break
        # first token -> cached partial tail (at most TAILS_PER_NODE)
        self.tails: Dict[int, _TailEntry] = {}


class RadixPrefixCache:
    """Block-granularity radix index over cached token prefixes.

    ``capacity_blocks`` caps how many pool blocks the cache may hold
    references to (the engine derives it from a pool fraction); ``0``
    disables insertion.  ``min_match_tokens`` suppresses matches shorter
    than the floor: pinning and copying a tail for a handful of cached
    tokens costs more than it saves."""

    def __init__(
        self,
        page_size: int,
        capacity_blocks: int,
        acquire: Callable[[List[int]], None],
        release: Callable[[List[int]], None],
        min_match_tokens: int = 1,
    ):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.capacity_blocks = max(0, int(capacity_blocks))
        self.min_match_tokens = max(1, int(min_match_tokens))
        self._acquire = acquire
        self._release = release
        self._root = _Node(key=(), block=-1, parent=None, last_use=0, seq=0)
        self._seq = 0
        self.version = 0
        self.blocks_held = 0
        # cumulative stats
        self.hits_total = 0
        self.misses_total = 0
        self.cached_tokens_total = 0
        self.insertions_total = 0
        self.evictions_total = 0
        self.flushes_total = 0

    # -- lookup -------------------------------------------------------------

    def match(
        self, tokens: Sequence[int], step: int, record: bool = True
    ) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``len(tokens) - 1``
        so at least one suffix token remains to prefill (the request's
        first output is sampled from the suffix fill's final logits).
        Touches every node on the path (LRU refresh).  Counts a hit iff the
        match clears ``min_match_tokens``; callers that may re-match the
        same request (a requeued admission retries every engine step) pass
        ``record=False`` and call :meth:`record` once the match is
        consumed, so the stats count served tokens, not attempts."""
        BS = self.page_size
        max_match = len(tokens) - 1
        node = self._root
        out = PrefixMatch()
        depth = 0
        while (depth + 1) * BS <= max_match:
            key = tuple(tokens[depth * BS : (depth + 1) * BS])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = step
            out.blocks.append(child.block)
            node = child
            depth += 1
        out.n_tokens = len(out.blocks) * BS
        # partial extension of the deepest matched node: one of its cached
        # partial tails, or the head of a FULL child block (a shorter or
        # diverging prompt reusing part of a longer cached sequence).  The
        # longest COMMON prefix counts: the caller's copy gets the whole
        # block and its suffix fill overwrites the positions past the
        # divergence
        rem = tokens[depth * BS :]
        limit = max_match - out.n_tokens
        if limit <= 0 or not rem:
            return self._counted(out, record)
        # only candidates sharing the FIRST remaining token can extend the
        # match: one compare per child instead of a prefix loop each
        first = rem[0]
        cands: List[Tuple[Tuple[int, ...], int, Optional[_Node]]] = []
        tail = node.tails.get(first)
        if tail is not None:
            cands.append((tail.tokens, tail.block, None))
        for child in node.children.values():
            if child.key[0] == first:
                cands.append((child.key, child.block, child))
        best_block, best_lcp, best_node = None, 0, None
        for t, blk, child in cands:
            n = min(len(t), limit)
            lcp = 0
            while lcp < n and rem[lcp] == t[lcp]:
                lcp += 1
            if lcp > best_lcp:  # strict: the first best (insertion order)
                best_block, best_lcp, best_node = blk, lcp, child
        if best_lcp > 0:
            out.tail_block = best_block
            out.tail_tokens = best_lcp
            out.n_tokens += best_lcp
            if best_node is not None:
                best_node.last_use = step
            else:
                tail.last_use = step
                node.last_use = step
        return self._counted(out, record)

    def _counted(self, out: PrefixMatch, record: bool) -> PrefixMatch:
        """``out`` if it clears the floor (counted as a hit when
        ``record``), else an empty match (counted as a miss)."""
        if out.n_tokens < self.min_match_tokens:
            if record:
                self.misses_total += 1
            return PrefixMatch()
        if record:
            self.hits_total += 1
            self.cached_tokens_total += out.n_tokens
        return out

    def record(self, m: PrefixMatch):
        """Count a match returned by ``match(..., record=False)`` that the
        caller consumed (its fill was built)."""
        if m.n_tokens > 0:
            self.hits_total += 1
            self.cached_tokens_total += m.n_tokens
        else:
            self.misses_total += 1

    # -- insertion ----------------------------------------------------------

    def insert(
        self,
        tokens: Sequence[int],
        blocks: Sequence[int],
        step: int,
        version: int,
    ) -> int:
        """Register a sequence's KV: ``blocks[i]`` holds tokens
        ``[i*page_size, (i+1)*page_size)``; a trailing partial block (when
        ``len(tokens)`` is not page-aligned) is cached as a tail entry.
        Where a path node already exists its block is kept (its KV is the
        same by construction) and only new segments take references.
        Returns the number of blocks newly referenced.  Inserts from a
        stale ``version`` (a swap raced the caller) are dropped."""
        if self.capacity_blocks <= 0 or version != self.version:
            return 0
        BS = self.page_size
        n_full = len(tokens) // BS
        tail_len = len(tokens) - n_full * BS
        if n_full + (1 if tail_len else 0) > len(blocks):
            n_full = min(n_full, len(blocks))
            tail_len = 0
        node = self._root
        added = 0
        for i in range(n_full):
            key = tuple(tokens[i * BS : (i + 1) * BS])
            # a tail cached while this block was still partial is subsumed
            # once the same prefix arrives full: drop it, or blocks_held
            # counts the physical block twice
            stale = node.tails.get(key[0])
            if stale is not None and key[: len(stale.tokens)] == stale.tokens:
                self._release([stale.block])
                del node.tails[key[0]]
                self.blocks_held -= 1
            child = node.children.get(key)
            if child is None:
                self._seq += 1
                child = _Node(
                    key=key, block=int(blocks[i]), parent=node,
                    last_use=step, seq=self._seq,
                )
                self._acquire([child.block])
                self.blocks_held += 1
                added += 1
                node.children[key] = child
            else:
                child.last_use = step
            node = child
        if tail_len:
            t = tuple(tokens[n_full * BS :])
            first = t[0]
            cur = node.tails.get(first)
            if cur is None or len(cur.tokens) < len(t):
                # a longer donor replaces a shorter same-first-token tail
                # (a same-length one is identical by construction);
                # different first tokens coexist up to TAILS_PER_NODE
                self._seq += 1
                self._acquire([int(blocks[n_full])])
                self.blocks_held += 1
                added += 1
                if cur is not None:
                    self._release([cur.block])
                    self.blocks_held -= 1
                node.tails[first] = _TailEntry(
                    block=int(blocks[n_full]), tokens=t,
                    last_use=step, seq=self._seq,
                )
                if len(node.tails) > TAILS_PER_NODE:
                    # deterministic LRU drop among the OTHER tails
                    k = min(
                        (f for f in node.tails if f != first),
                        key=lambda f: (
                            node.tails[f].last_use, node.tails[f].seq
                        ),
                    )
                    self._release([node.tails.pop(k).block])
                    self.blocks_held -= 1
                    self.evictions_total += 1
            else:
                cur.last_use = step
            node.last_use = step
        if added:
            self.insertions_total += 1
        # capacity trim: never evict what this very call touched
        if self.blocks_held > self.capacity_blocks:
            self.evict(
                self.blocks_held - self.capacity_blocks, protect_step=step
            )
        return added

    # -- eviction -----------------------------------------------------------

    def _evictable(self, protect_step: Optional[int]) -> List[_Node]:
        """Every node holding a block that may be reclaimed, LRU-first by
        (last_use, seq): a node carrying tail entries (one candidate per
        round: each selection drops its LRU tail), or a leaf node
        (evicting a node with children would orphan their prefix)."""
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if protect_step is not None and n.last_use >= protect_step:
                continue
            if n.tails:
                out.append(n)
                continue
            if n is self._root or n.children:
                continue
            out.append(n)
        out.sort(key=lambda n: (n.last_use, n.seq))
        return out

    def _evict_node(self, victim: _Node):
        """Drop ONE block from ``victim``: its LRU tail entry if it has
        one, else the node itself."""
        if victim.tails:
            k = min(
                victim.tails,
                key=lambda f: (
                    victim.tails[f].last_use, victim.tails[f].seq
                ),
            )
            self._release([victim.tails.pop(k).block])
        else:
            self._release([victim.block])
            del victim.parent.children[victim.key]
        self.blocks_held -= 1
        self.evictions_total += 1

    def evict(self, n_blocks: int, protect_step: Optional[int] = None) -> int:
        """Reclaim up to ``n_blocks`` blocks LRU-first, releasing the
        cache's references; returns how many were freed (0: nothing
        evictable).  One trie walk serves a round; a round's evictions can
        make parents evictable, so the walk repeats while short and
        progressing.  Only the cache's own reference is dropped: blocks
        pinned by live rows stay until those rows finish."""
        freed = 0
        while freed < n_blocks:
            cands = self._evictable(protect_step)
            if not cands:
                break
            for victim in cands[: n_blocks - freed]:
                self._evict_node(victim)
                freed += 1
        return freed

    def evict_one(self, protect_step: Optional[int] = None) -> bool:
        """Drop the single LRU cached block; False when nothing is
        evictable."""
        return self.evict(1, protect_step=protect_step) == 1

    def flush(self, new_version: Optional[int] = None):
        """Drop every entry (weight swap: all cached KV is stale) and move
        ``version`` (to ``new_version``, else +1) so inserts tagged with the
        pre-swap version are rejected."""
        blocks = self.held_blocks()
        if blocks:
            self._release(blocks)
        self._root.children.clear()
        self._root.tails.clear()
        self.blocks_held = 0
        self.version = (
            self.version + 1 if new_version is None else int(new_version)
        )
        self.flushes_total += 1

    # -- introspection ------------------------------------------------------

    def held_blocks(self) -> List[int]:
        """Every block the cache holds a reference to, one entry per
        reference (the engine's leak audit adds these to its rows')."""
        out = [t.block for t in self._root.tails.values()]
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            out.append(n.block)
            out.extend(t.block for t in n.tails.values())
        return out

    def __len__(self) -> int:
        return self.blocks_held

    def stats(self) -> Dict[str, int]:
        return dict(
            self.zero_stats(),
            hits_total=self.hits_total,
            misses_total=self.misses_total,
            cached_tokens_total=self.cached_tokens_total,
            insertions_total=self.insertions_total,
            evictions_total=self.evictions_total,
            flushes_total=self.flushes_total,
            blocks_held=self.blocks_held,
            version=self.version,
            min_match_tokens=self.min_match_tokens,
            capacity_blocks=self.capacity_blocks,
        )

    @staticmethod
    def zero_stats() -> Dict[str, int]:
        """The all-zero stats a cache-disabled engine reports (the keys of
        :meth:`stats`; those of the host tier, which is not ported, stay
        0 in both)."""
        return {
            "hits_total": 0,
            "misses_total": 0,
            "cached_tokens_total": 0,
            "insertions_total": 0,
            "evictions_total": 0,
            "flushes_total": 0,
            "blocks_held": 0,
            "version": 0,
            "spilled_blocks_total": 0,
            "restored_blocks_total": 0,
            "host_dropped_blocks_total": 0,
            "host_bytes_held": 0,
            "host_blocks_held": 0,
            "min_match_tokens": 0,
            "capacity_blocks": 0,
            "host_bytes_budget": 0,
        }
