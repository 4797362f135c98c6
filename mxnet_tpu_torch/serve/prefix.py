"""Host-side radix index over token-block-granular KV cache rows.

A copy of ``mxnet_tpu/serve/prefix.py`` (pure host Python, no device
code): the prefix cache's bookkeeping half. The device half never changes
shape: KV rows live inside the engine's fixed-footprint
``(max_slots, max_seq, heads, head_dim)`` allocation, and this index
remembers *which* slot rows currently hold the KV of *which* token blocks.
Tokens are grouped into fixed-size blocks of ``serve.prefix_block`` tokens;
the block is the radix unit, so path compression is the block itself and a
diverging insert splits a shared path into a common prefix plus branches
(the classic radix-tree split, block-granular).

Disciplines the engine relies on:

- **Locations are (slot, row) pairs.** A node's KV lives at rows
  ``[row, row + block)`` of ``slot`` in every layer's cache. Blocks of one
  matched path may live in *different* slots; the whole matched path is
  copied by the gather at the top of the engine's suffix-prefill step (one
  dispatch an admission).
- **Ref-counting pins live prompts.** A request's own prompt blocks are
  acquired at admission and released at finish; refcount > 0 blocks are
  never evicted by the LRU, and a release below zero raises.
- **Slot reuse invalidates.** Admitting a new request into slot ``s``
  first drops every node whose KV lived in ``s`` (the rows are about to be
  overwritten) together with the node's whole subtree: a child's meaning
  depends on its ancestors being intact.
- **LRU eviction is leaf-only.** Capacity pressure evicts the
  least-recently-used refcount-0 *leaf* (evicting an interior node would
  orphan descendants whose prefix just vanished).
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["RadixIndex"]


class _Node:
    """One cached block: the trie edge label is the block's token tuple."""

    __slots__ = ("tokens", "slot", "row", "refs", "last_use", "parent",
                 "children", "alive")

    def __init__(self, tokens, slot, row, parent):
        self.tokens = tokens      # tuple of block-size token ids
        self.slot = slot          # cache slot holding the rows
        self.row = row            # first row of the block in that slot
        self.refs = 0
        self.last_use = 0
        self.parent = parent
        self.children = {}
        self.alive = True

    def __repr__(self):
        return (f"_Node(slot={self.slot}, row={self.row}, "
                f"refs={self.refs}, kids={len(self.children)})")


class RadixIndex:
    """Block-granular radix trie mapping token prefixes to KV rows.

    ``block`` is the tokens-per-block granularity; ``capacity`` bounds
    the number of indexed blocks (0 = unbounded — the engine's natural
    bound is ``max_slots * (max_seq // block)``).  All counters
    (``hits``/``misses``/``evictions``/``tokens_reused``) are plain
    ints the engine mirrors into telemetry.
    """

    def __init__(self, block, capacity=0):
        self.block = int(block)
        if self.block <= 0:
            raise MXNetError(f"prefix block size must be positive, "
                             f"got {block}")
        self.capacity = int(capacity)
        self._root = _Node((), None, None, None)
        self._size = 0
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_reused = 0

    def __len__(self):
        return self._size

    def _blocks(self, tokens):
        b = self.block
        n = len(tokens) // b
        return [tuple(tokens[i * b:(i + 1) * b]) for i in range(n)]

    # -- lookup ----------------------------------------------------------

    def match(self, tokens):
        """Longest cached block path covering a *strict* prefix of
        ``tokens`` -> list of nodes (possibly empty).  Strict: at least
        one token is always left for the suffix prefill, which must
        produce the next-token logits — a fully-cached prompt would
        have nothing to forward."""
        self._clock += 1
        path = []
        node = self._root
        covered = 0
        for blk in self._blocks(tokens):
            child = node.children.get(blk)
            if child is None or covered + self.block >= len(tokens):
                break
            child.last_use = self._clock
            path.append(child)
            covered += self.block
            node = child
        return path

    # -- mutation --------------------------------------------------------

    def insert(self, tokens, slot):
        """Index every full block of ``tokens`` as resident in ``slot``
        (block i at rows [i*block, (i+1)*block)).  Existing nodes are
        kept (their rows are just as valid; dedup keeps one canonical
        location per prefix) — a diverging suffix branches off the
        shared path.  Returns the full node path for the prompt, for
        :meth:`acquire`.  Stops early when capacity pressure cannot be
        relieved (every leaf pinned)."""
        self._clock += 1
        node = self._root
        path = []
        for i, blk in enumerate(self._blocks(tokens)):
            child = node.children.get(blk)
            if child is None:
                if self.capacity and self._size >= self.capacity:
                    if not self._evict_lru(protect=set(id(p) for p in path)):
                        break
                child = _Node(blk, int(slot), i * self.block, node)
                node.children[blk] = child
                self._size += 1
            child.last_use = self._clock
            path.append(child)
            node = child
        return path

    def acquire(self, path):
        """Pin every node of ``path`` (+1 ref) — held for the lifetime
        of the request whose slot the blocks live in."""
        for node in path:
            if node.alive:
                node.refs += 1

    def release(self, path):
        """Unpin (−1 ref).  Dead (already-evicted) nodes are skipped —
        ``evict_slot`` may race a request's finish in program order —
        but a live node driven below zero is a bookkeeping bug."""
        for node in path:
            if not node.alive:
                continue
            node.refs -= 1
            if node.refs < 0:
                raise MXNetError(
                    "prefix cache refcount went negative (double "
                    f"release) on {node!r}")

    def _drop(self, node):
        """Remove ``node`` and its whole subtree from the index."""
        if not node.alive:
            return
        if node.parent is not None and \
                node.parent.children.get(node.tokens) is node:
            del node.parent.children[node.tokens]
        stack = [node]
        while stack:
            n = stack.pop()
            if not n.alive:
                continue
            stack.extend(n.children.values())
            n.children.clear()
            n.alive = False
            self._size -= 1
            self.evictions += 1

    def evict_slot(self, slot):
        """Drop every node whose KV rows live in ``slot`` (the slot is
        being reused and its rows overwritten), subtrees included.
        Returns the number of blocks dropped."""
        before = self.evictions
        stack = [self._root]
        doomed = []
        while stack:
            n = stack.pop()
            for child in n.children.values():
                if child.slot == slot:
                    doomed.append(child)
                else:
                    stack.append(child)
        for n in doomed:
            self._drop(n)
        return self.evictions - before

    def evict_path(self, path):
        """Force-evict a matched path (the ``serve.prefix_evict`` chaos
        injection: the hot prefix vanishes between admission and
        prefill).  Dropping the shallowest node takes the rest of the
        path down with it.  Returns the number of blocks dropped."""
        if not path:
            return 0
        before = self.evictions
        self._drop(path[0])
        return self.evictions - before

    def _evict_lru(self, protect=()):
        """Evict the least-recently-used refcount-0 leaf not in
        ``protect``.  Returns True when a block was freed."""
        victim = None
        stack = [self._root]
        while stack:
            n = stack.pop()
            for child in n.children.values():
                stack.append(child)
                if (not child.children and child.refs == 0
                        and id(child) not in protect
                        and (victim is None
                             or child.last_use < victim.last_use)):
                    victim = child
        if victim is None:
            return False
        self._drop(victim)
        return True

    # -- engine helpers --------------------------------------------------

    def slot_heat(self, slot):
        """Newest ``last_use`` over the blocks indexed in ``slot`` (-1
        when none) — the engine prefers reusing the *coldest* free slot
        so hot cached prefixes survive longest."""
        heat = -1
        stack = [self._root]
        while stack:
            n = stack.pop()
            for child in n.children.values():
                stack.append(child)
                if child.slot == slot and child.last_use > heat:
                    heat = child.last_use
        return heat

    def stats(self):
        total = self.hits + self.misses
        return {
            "blocks": self._size,
            "block_tokens": self.block,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else None,
            "tokens_reused": self.tokens_reused,
            "evictions": self.evictions,
        }
