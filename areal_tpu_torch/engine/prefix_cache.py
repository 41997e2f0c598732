"""Cross-request radix prefix cache over the paged KV pool (port of
``areal_tpu/engine/prefix_cache.py``).

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
  weights that computed it: ``flush()`` drops every entry in both tiers
  and moves ``version`` so an insert of pre-swap KV is rejected.

**Host spill tier** (``host_bytes_budget > 0``): a full-block node that
eviction picks SPILLS instead of dying: its KV is copied to host memory
(one batched ``spill_fetch``, the engine's
:func:`~areal_tpu_torch.models.paged.gather_blocks_host`, per
reclamation round) and its pool reference is released, while the node
stays in the trie.  A match that reaches spilled nodes returns them as
``restore_nodes``; the engine allocates blocks, scatters the payloads
back (:meth:`begin_restore` / :meth:`complete_restore`) and requeues the
admission, whose re-match the next engine step lands resident (a
restored node is usable from its ``ready_step``).  The host tier has a
byte budget (``block_bytes`` per block, the pool's real footprint: an
int8 pool's bytes plus its scales) and its own LRU: a new spill into a
full budget first trims a strictly LRU-older spilled leaf, and is
dropped if there is none.  On any root-to-leaf path resident nodes
precede spilled ones (a node spills only once none of its children is
resident), so a spilled chain restores top-down.  An insert that meets a
spilled node on its path adopts the donor's freshly computed block and
drops the host copy.  Not ported: the fleet export walk (``export_walk``,
peer prefix pulls; ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class PrefixMatch:
    """Result of a longest-prefix walk.

    ``blocks`` are the matched FULL blocks, in sequence order: the caller
    pins them (its own incref) before using them.  When ``tail_block`` is
    set, the walk also matched the first ``tail_tokens`` tokens of a
    partial tail (or of a full child block); the caller COPIES that block
    into one it owns, since the donor may still append to it.
    ``n_tokens`` is the whole matched prefix
    (``len(blocks) * page_size + tail_tokens``).

    Host tier: ``restore_nodes`` are spilled nodes that would extend the
    resident match by ``restore_tokens`` tokens once restored (the caller
    starts the restore and requeues); ``pending`` marks a node on the path
    whose restore is dispatched but not usable yet (the caller requeues
    without a new restore).  With either set, the fields above cover only
    the usable resident prefix and no tail was scanned."""

    blocks: List[int] = dataclasses.field(default_factory=list)
    n_tokens: int = 0
    tail_block: Optional[int] = None
    tail_tokens: int = 0
    restore_nodes: List["_Node"] = dataclasses.field(default_factory=list)
    restore_tokens: int = 0
    pending: bool = False


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
    ``page_size``-token tuple; children extend the prefix by one block.
    A ``spilled`` node holds its KV in ``host_kv`` (the engine's host
    payload) instead of a pool block; a restored node is usable from
    engine step ``ready_step``."""

    __slots__ = ("key", "block", "children", "parent", "last_use", "seq",
                 "tails", "spilled", "host_kv", "ready_step")

    def __init__(self, key, block, parent, last_use, seq):
        self.key: Tuple[int, ...] = key
        self.block: int = block
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent: Optional[_Node] = parent
        self.last_use: int = last_use
        self.seq: int = seq  # insertion order: deterministic LRU tie-break
        # first token -> cached partial tail (at most TAILS_PER_NODE)
        self.tails: Dict[int, _TailEntry] = {}
        self.spilled: bool = False
        self.host_kv: Optional[Tuple[Any, ...]] = None
        self.ready_step: int = 0


def _lru_key(n: _Node) -> Tuple[int, int]:
    return (n.last_use, n.seq)


def _insort_lru(cands: List[_Node], node: _Node):
    """Insert ``node`` into an LRU-sorted candidate list, keeping order
    (the host-trim list one reclamation round shares)."""
    bisect.insort(cands, node, key=_lru_key)


class RadixPrefixCache:
    """Block-granularity radix index over cached token prefixes.

    ``capacity_blocks`` caps how many pool blocks the cache may hold
    references to (the engine derives it from a pool fraction); ``0``
    disables insertion.  ``min_match_tokens`` suppresses matches shorter
    than the floor: pinning and copying a tail for a handful of cached
    tokens costs more than it saves.

    ``host_bytes_budget > 0`` turns on the host spill tier (see the module
    docstring): ``block_bytes`` is one block's storage footprint, the
    budget's unit, and ``spill_fetch(blocks)`` the engine's batched
    device-to-host gather, returning a tuple of per-block host tensors
    indexed ``[i] -> blocks[i]`` that the cache keeps without looking
    inside."""

    def __init__(
        self,
        page_size: int,
        capacity_blocks: int,
        acquire: Callable[[List[int]], None],
        release: Callable[[List[int]], None],
        min_match_tokens: int = 1,
        host_bytes_budget: int = 0,
        block_bytes: int = 0,
        spill_fetch: Optional[Callable[[List[int]], Tuple[Any, ...]]] = None,
    ):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.capacity_blocks = max(0, int(capacity_blocks))
        self.min_match_tokens = max(1, int(min_match_tokens))
        self._acquire = acquire
        self._release = release
        self.host_bytes_budget = max(0, int(host_bytes_budget))
        self.block_bytes = max(0, int(block_bytes))
        self._spill_fetch = spill_fetch
        self._root = _Node(key=(), block=-1, parent=None, last_use=0, seq=0)
        self._seq = 0
        self.version = 0
        self.blocks_held = 0
        self.host_bytes_held = 0
        self.host_blocks_held = 0
        # cumulative stats
        self.hits_total = 0
        self.misses_total = 0
        self.cached_tokens_total = 0
        self.insertions_total = 0
        self.evictions_total = 0
        self.flushes_total = 0
        self.spilled_blocks_total = 0
        self.restored_blocks_total = 0
        self.host_dropped_blocks_total = 0

    @property
    def _host_enabled(self) -> bool:
        return (
            self.host_bytes_budget > 0
            and self.block_bytes > 0
            and self._spill_fetch is not None
        )

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
        consumed, so the stats count served tokens, not attempts.

        A walk that reaches host-tier nodes returns a BLOCKED match
        (``restore_nodes`` or ``pending`` set, see :class:`PrefixMatch`)
        and records nothing: the caller requeues and matches again."""
        BS = self.page_size
        max_match = len(tokens) - 1
        node = self._root
        out = PrefixMatch()
        depth = 0
        blocked = False
        while (depth + 1) * BS <= max_match:
            key = tuple(tokens[depth * BS : (depth + 1) * BS])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = step
            if not blocked and not child.spilled and child.ready_step <= step:
                out.blocks.append(child.block)
            else:
                # the resident run ends at the first spilled or not yet
                # usable node; the rest counts as tokens a restore unlocks
                blocked = True
                if child.spilled:
                    out.restore_nodes.append(child)
                elif child.ready_step > step:
                    out.pending = True
                out.restore_tokens += BS
            node = child
            depth += 1
        out.n_tokens = len(out.blocks) * BS
        if blocked:
            # a restore is worth starting only when the whole match would
            # clear the floor
            if out.n_tokens + out.restore_tokens < self.min_match_tokens:
                if record:
                    self.misses_total += 1
                return PrefixMatch()
            return out
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
            # a spilled block has no pool block to copy from, and a
            # restoring one is not usable before its ready step
            if (child.key[0] == first and not child.spilled
                    and child.ready_step <= step):
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
        same by construction) and only new segments take references; a
        spilled node on the path adopts the donor's block and drops its
        host copy.  Returns the number of blocks newly referenced.
        Inserts from a stale ``version`` (a swap raced the caller) are
        dropped."""
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
            elif child.spilled:
                # the donor just computed this block on the device: adopt
                # it and drop the host copy (resident beats spilled)
                self._drop_host_payload(child)
                child.block = int(blocks[i])
                child.ready_step = 0
                self._acquire([child.block])
                self.blocks_held += 1
                added += 1
                child.last_use = step
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
        """Every node holding a pool block that may be reclaimed, LRU-first
        by (last_use, seq): a node carrying tail entries (one candidate per
        round: each selection drops its LRU tail), or a resident node none
        of whose children is resident (evicting a node with resident
        children would orphan their prefix; spilled children survive a
        spill of their parent, not its drop)."""
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
            if n is self._root or n.spilled:
                continue  # no pool block of its own
            if any(not c.spilled for c in n.children.values()):
                continue
            out.append(n)
        out.sort(key=_lru_key)
        return out

    def _drop_host_payload(self, node: _Node):
        """Release a node's host-tier accounting (its payload and flag).
        Keyed on ``spilled``: a victim marked mid-round counts its bytes
        before the batched gather lands, and releases them if trimmed in
        that window."""
        if node.spilled:
            node.spilled = False
            node.host_kv = None
            self.host_bytes_held -= self.block_bytes
            self.host_blocks_held -= 1

    def _drop_tails(self, n: _Node):
        if n.tails:
            self._release([t.block for t in n.tails.values()])
            self.blocks_held -= len(n.tails)
            self.evictions_total += len(n.tails)
            n.tails.clear()

    def _drop_node(self, victim: _Node):
        """Remove ``victim`` from the trie and release its pool block; its
        children (all spilled, by selection) lose their prefix with it, so
        the whole spilled subtree's payloads and tail blocks go too."""
        self._release([victim.block])
        self.blocks_held -= 1
        self.evictions_total += 1
        if victim.parent is not None:
            del victim.parent.children[victim.key]
        stack = list(victim.children.values())
        victim.children.clear()
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.spilled:
                self._drop_host_payload(n)
                self.host_dropped_blocks_total += 1
            else:  # unreachable by the selection rule
                self._release([n.block])
                self.blocks_held -= 1
                self.evictions_total += 1
            self._drop_tails(n)

    def _spilled_leaves_lru(self) -> List[_Node]:
        """Spilled nodes without children, LRU-first: the host tier's trim
        candidates (dropping one orphans nothing)."""
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.spilled and not n.children:
                out.append(n)
        out.sort(key=_lru_key)
        return out

    def _trim_host_one(
        self,
        before: Optional[Tuple[int, int]] = None,
        cands: Optional[List[_Node]] = None,
    ) -> bool:
        """Drop the LRU childless spilled node from the host tier; with
        ``before``, only one strictly older than that (last_use, seq) key
        (LRU across both tiers: a new spill never displaces a hotter host
        entry).  ``cands`` is the round's shared LRU list (entries are
        checked again before use, and a parent that became a childless
        spilled leaf is put back in).  True iff one was dropped."""
        if cands is None:
            cands = self._spilled_leaves_lru()
        while cands:
            victim = cands[0]
            if not (
                victim.spilled
                and not victim.children
                and victim.parent is not None
                and victim.parent.children.get(victim.key) is victim
            ):
                cands.pop(0)  # dropped or adopted since it was listed
                continue
            if before is not None and _lru_key(victim) >= before:
                return False
            cands.pop(0)
            self._drop_host_payload(victim)
            self.host_dropped_blocks_total += 1
            self._drop_tails(victim)
            parent = victim.parent
            del parent.children[victim.key]
            if parent.spilled and not parent.children:
                _insort_lru(cands, parent)
            return True
        return False

    def _spill_admissible(
        self, victim: _Node, cands: Optional[List[_Node]] = None
    ) -> bool:
        """May ``victim``'s block enter the host tier?  Yes while the
        budget has room; on a full budget only by trimming a strictly
        LRU-older spilled entry first."""
        if not self._host_enabled or victim.block < 0:
            return False
        while self.host_bytes_held + self.block_bytes > self.host_bytes_budget:
            if not self._trim_host_one(before=_lru_key(victim), cands=cands):
                return False
        return True

    def _evict_tail(self, victim: _Node):
        """Drop ``victim``'s LRU tail entry."""
        k = min(
            victim.tails,
            key=lambda f: (victim.tails[f].last_use, victim.tails[f].seq),
        )
        self._release([victim.tails.pop(k).block])
        self.blocks_held -= 1
        self.evictions_total += 1

    def evict(self, n_blocks: int, protect_step: Optional[int] = None) -> int:
        """Reclaim up to ``n_blocks`` pool blocks LRU-first, releasing the
        cache's references; returns how many were freed (0: nothing
        evictable).  With the host tier on, a full-block victim SPILLS: it
        is marked during selection, the round's victims are gathered to
        host memory in one ``spill_fetch``, and then their pool references
        are released.  Tail entries never spill (they are partial blocks
        held by value), and a victim the budget refuses is dropped.  One
        trie walk serves a round; a round's evictions can make parents
        evictable, so the walk repeats while short and progressing.  Only
        the cache's own reference is dropped: blocks pinned by live rows
        stay until those rows finish."""
        freed = 0
        spill_nodes: List[_Node] = []
        spill_blocks: List[int] = []
        # the round's host-trim LRU list, built at the first spill into a
        # full budget and kept up to date after that
        trim_cands: Optional[List[_Node]] = None
        while freed < n_blocks:
            cands = self._evictable(protect_step)
            if not cands:
                break
            for victim in cands[: n_blocks - freed]:
                if victim.tails:
                    self._evict_tail(victim)
                    freed += 1
                    continue
                if (
                    trim_cands is None
                    and self._host_enabled
                    and self.host_bytes_held + self.block_bytes
                    > self.host_bytes_budget
                ):
                    trim_cands = self._spilled_leaves_lru()
                if self._spill_admissible(victim, cands=trim_cands):
                    # marked now, so the next walk sees its parent as
                    # evictable; the payload comes with the batch below
                    victim.spilled = True
                    victim.ready_step = 0
                    spill_nodes.append(victim)
                    spill_blocks.append(victim.block)
                    self.host_bytes_held += self.block_bytes
                    self.host_blocks_held += 1
                    self.blocks_held -= 1
                    if trim_cands is not None and not victim.children:
                        _insort_lru(trim_cands, victim)
                else:
                    self._drop_node(victim)
                freed += 1
        if spill_nodes:
            payload = self._spill_fetch(spill_blocks)
            for i, node in enumerate(spill_nodes):
                if node.spilled:  # a later trim of this round may drop it
                    # per-block copies: a view would keep the round's
                    # whole gather buffer alive for one surviving block
                    node.host_kv = tuple(a[i].clone() for a in payload)
            self._release(spill_blocks)
            self.spilled_blocks_total += len(spill_nodes)
        return freed

    def evict_one(self, protect_step: Optional[int] = None) -> bool:
        """Drop the single LRU cached block; False when nothing is
        evictable."""
        return self.evict(1, protect_step=protect_step) == 1

    # -- host-tier restore --------------------------------------------------

    def begin_restore(self, nodes: Sequence[_Node]) -> List[Tuple[Any, ...]]:
        """The host payloads of ``nodes`` (a match's ``restore_nodes``), in
        order, for the engine's batched scatter."""
        for n in nodes:
            if not n.spilled or n.host_kv is None:
                raise RuntimeError("restore of a node that is not spilled")
        return [n.host_kv for n in nodes]

    def complete_restore(
        self, nodes: Sequence[_Node], blocks: Sequence[int], ready_step: int
    ):
        """Give restored ``nodes`` their pool ``blocks`` (the engine's
        references pass to the cache) and make them usable from engine
        step ``ready_step`` (the step after the restore's dispatch, so the
        requeued admission matches them resident)."""
        for node, blk in zip(nodes, blocks):
            self._drop_host_payload(node)
            node.block = int(blk)
            node.ready_step = int(ready_step)
        self.blocks_held += len(nodes)
        self.restored_blocks_total += len(nodes)
        if self.blocks_held > self.capacity_blocks:
            # never trim what this restore touched (the triggering match
            # stamped its path at ready_step - 1)
            self.evict(
                self.blocks_held - self.capacity_blocks,
                protect_step=int(ready_step) - 1,
            )

    def flush(self, new_version: Optional[int] = None):
        """Drop every entry in both tiers (weight swap: all cached KV is
        stale, host copies included) and move ``version`` (to
        ``new_version``, else +1) so inserts tagged with the pre-swap
        version are rejected."""
        blocks = [t.block for t in self._root.tails.values()]
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.spilled:
                self._drop_host_payload(n)
                self.host_dropped_blocks_total += 1
            else:
                blocks.append(n.block)
            blocks.extend(t.block for t in n.tails.values())
        if blocks:
            self._release(blocks)
        self._root.children.clear()
        self._root.tails.clear()
        self.blocks_held = 0
        if self.host_bytes_held or self.host_blocks_held:
            raise RuntimeError(
                f"host tier not empty after a flush: {self.host_blocks_held}"
                f" blocks, {self.host_bytes_held} bytes"
            )
        self.version = (
            self.version + 1 if new_version is None else int(new_version)
        )
        self.flushes_total += 1

    # -- introspection ------------------------------------------------------

    def held_blocks(self) -> List[int]:
        """Every pool block the cache holds a reference to, one entry per
        reference (the engine's leak audit adds these to its rows');
        spilled nodes hold none."""
        out = [t.block for t in self._root.tails.values()]
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if not n.spilled:
                out.append(n.block)
            out.extend(t.block for t in n.tails.values())
        return out

    def __len__(self) -> int:
        return self.blocks_held

    def stats(self) -> Dict[str, int]:
        return {
            "hits_total": self.hits_total,
            "misses_total": self.misses_total,
            "cached_tokens_total": self.cached_tokens_total,
            "insertions_total": self.insertions_total,
            "evictions_total": self.evictions_total,
            "flushes_total": self.flushes_total,
            "blocks_held": self.blocks_held,
            "version": self.version,
            # the host spill tier (all 0 while host_bytes_budget is 0)
            "spilled_blocks_total": self.spilled_blocks_total,
            "restored_blocks_total": self.restored_blocks_total,
            "host_dropped_blocks_total": self.host_dropped_blocks_total,
            "host_bytes_held": self.host_bytes_held,
            "host_blocks_held": self.host_blocks_held,
            "min_match_tokens": self.min_match_tokens,
            "capacity_blocks": self.capacity_blocks,
            "host_bytes_budget": self.host_bytes_budget,
        }

    @staticmethod
    def zero_stats() -> Dict[str, int]:
        """The all-zero stats a cache-disabled engine reports (the keys of
        :meth:`stats`)."""
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
