"""Paged KV-cache bookkeeping: refcounted block pool + prefix trie.

A copy of ``ray_tpu/serve/kv_cache.py``: the serving tier's memory manager
(vLLM's PagedAttention block manager role). Physical KV storage is a device
tensor of fixed-size token blocks (``models.init_cache_paged``); THIS
module is the host-side truth about who owns which block:

- :class:`BlockPool` — a refcounted free-list over the physical blocks.
  Admission claims blocks, not slots; a request holds one reference per
  table entry, the prefix cache holds one per trie node, and a block
  returns to the free list only when the last reference drops — which is
  exactly the leak-detection surface the chaos tests assert on (free
  count returns to baseline after a replica death).
- :class:`PrefixCache` — a hash trie keyed by FULL blocks of prompt
  tokens. Two requests whose prompts share a system prefix map the
  shared tokens to the SAME immutable physical blocks; only full blocks
  are ever shared, so shared blocks are never written (a capped match
  that reuses a partial tail block goes through copy-on-write instead —
  the pool's :meth:`BlockPool.need_cow` + the engine's device-side
  ``models.copy_kv_block``). Eviction is LRU over leaves whose only
  remaining reference is the trie's own.

Pure host-side data structures (no device state): unit-testable
without a mesh, and the engine stays the single owner of device arrays.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple


def prefix_key_digest(tokens: Sequence[int]) -> str:
    """Stable cross-process digest of one block's token tuple — the key
    replicas publish in their prefix digest and handles recompute from a
    request's first prompt block to route for affinity. Content-hashed
    (not id-based) so two replicas that independently cached the same
    system prompt advertise the SAME key."""
    raw = ",".join(str(int(t)) for t in tokens).encode()
    return hashlib.blake2b(raw, digest_size=8).hexdigest()


class KVCacheError(RuntimeError):
    """Invariant violation in block accounting (double free, foreign
    block) — always a bug, never load-dependent."""


class BlockPool:
    """Refcounted pool of physical KV block ids ``0..num_blocks-1``.

    ``alloc`` is all-or-nothing (admission must never half-claim), and
    every block's lifecycle is ref-based: allocation returns blocks at
    refcount 1; ``retain``/``release`` move them; refcount 0 returns the
    block to the free list. LIFO reuse keeps recently-touched device memory warm.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need >=1 block of >=1 tokens, got {num_blocks}x{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: List[int] = [0] * num_blocks

    # -- views -------------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, block_id: int) -> int:
        return self._ref[block_id]

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Table length covering ``n_tokens`` positions."""
        return -(-max(n_tokens, 0) // self.block_size)

    # -- lifecycle ---------------------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` blocks at refcount 1, or None (nothing claimed) if
        fewer than ``n`` are free — admission decides queue vs shed."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def retain(self, block_id: int) -> None:
        if self._ref[block_id] <= 0:
            raise KVCacheError(f"retain of free block {block_id}")
        self._ref[block_id] += 1

    def release(self, block_id: int) -> bool:
        """Drop one reference; True when the block returned to the free
        list (the caller held the last reference)."""
        r = self._ref[block_id]
        if r <= 0:
            raise KVCacheError(f"release of free block {block_id}")
        self._ref[block_id] = r - 1
        if r == 1:
            self._free.append(block_id)
            return True
        return False

    def release_all(self, block_ids: Sequence[int]) -> int:
        return sum(1 for b in block_ids if self.release(b))

    def need_cow(self, block_id: int) -> bool:
        """True when writing into ``block_id`` requires copy-on-write:
        someone else (another request or the prefix trie) also holds it."""
        return self._ref[block_id] > 1


class _TrieNode:
    __slots__ = ("key", "block_id", "children", "parent", "last_used",
                 "hit_weight")

    def __init__(self, key: Optional[Tuple[int, ...]],
                 block_id: Optional[int], parent: Optional["_TrieNode"]):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.last_used = 0.0
        # tokens reused through this ROOT child (only root children
        # accumulate weight — the digest ranks system prompts, and a
        # system prompt is identified by its first block)
        self.hit_weight = 0


class PrefixCache:
    """Hash trie mapping chains of FULL token blocks to physical blocks.

    ``match`` walks the prompt block-by-block and retains every matched
    block on behalf of the caller (the request's table references); the
    match is capped at ``len(tokens) - 1`` so at least one prompt token
    always runs through the model — its logits seed sampling. When the
    cap lands mid-block the tail block is returned as a copy-on-write
    source, never as a table entry.

    ``insert`` registers a finished request's full prompt blocks;
    existing chains are adopted as-is (no duplicate physical blocks for
    one prefix). ``evict`` reclaims LRU leaves whose only reference is
    the trie's.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self._root = _TrieNode(None, None, None)
        self._nodes = 0
        # lookup-level counters (the engine mirrors them into metrics)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return self._nodes

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        return [tuple(tokens[i * bs:(i + 1) * bs]) for i in range(n_full)]

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: Sequence[int]
              ) -> Tuple[List[int], int, Optional[int]]:
        """Longest shared prefix of ``tokens`` already cached.

        Returns ``(full_blocks, matched_tokens, cow_src)``:
        ``full_blocks`` are retained for the caller and usable as-is;
        ``matched_tokens`` counts reused positions (capped at
        ``len(tokens) - 1``); ``cow_src`` is a block id (also retained)
        whose first ``matched_tokens % block_size`` positions must be
        COPIED into a fresh block when the cap split a block — the caller
        releases it after the device copy.
        """
        node = self._root
        chain: List[_TrieNode] = []
        now = time.monotonic()
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = now
            chain.append(child)
            node = child
        if not chain:
            self.misses += 1
            return [], 0, None
        first_child = chain[0]
        matched = len(chain) * self.block_size
        cow_src: Optional[int] = None
        if matched >= len(tokens):
            # cap below the full prompt: the final matched block is only
            # partially reused -> copy-on-write source, not a table entry
            matched = len(tokens) - 1
            tail = chain.pop()
            if matched % self.block_size:
                cow_src = tail.block_id
                self.pool.retain(cow_src)
        blocks = [n.block_id for n in chain]
        for b in blocks:
            self.pool.retain(b)
        self.hits += 1
        self.hit_tokens += matched
        first_child.hit_weight += matched
        return blocks, matched, cow_src

    # -- registration ------------------------------------------------------

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int]) -> int:
        """Register a request's prompt: ``block_ids[i]`` holds tokens
        ``[i*bs, (i+1)*bs)``. Only full blocks are inserted; new nodes
        retain their block for the trie, existing nodes keep theirs (the
        request's duplicate block simply gets released by its owner).
        Returns how many NEW blocks the trie adopted."""
        node = self._root
        adopted = 0
        now = time.monotonic()
        for i, key in enumerate(self._chunks(tokens)):
            if i >= len(block_ids):
                break
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(key, block_ids[i], node)
                self.pool.retain(block_ids[i])
                node.children[key] = child
                self._nodes += 1
                adopted += 1
            child.last_used = now
            node = child
        return adopted

    # -- eviction ----------------------------------------------------------

    def _leaves(self) -> List[_TrieNode]:
        out: List[_TrieNode] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            if not kids and n is not self._root:
                out.append(n)
            stack.extend(kids)
        return out

    def evict(self, n_blocks: int) -> int:
        """Reclaim up to ``n_blocks`` physical blocks by dropping LRU
        leaves whose ONLY reference is the trie's (a leaf a live request
        still shares is pinned). Dropping a leaf may expose its parent;
        the scan repeats until satisfied or nothing is reclaimable."""
        reclaimed = 0
        while reclaimed < n_blocks:
            victims = [l for l in self._leaves()
                       if self.pool.refcount(l.block_id) == 1]
            if not victims:
                break
            victims.sort(key=lambda l: l.last_used)
            for leaf in victims:
                leaf.parent.children.pop(leaf.key, None)
                self._nodes -= 1
                if self.pool.release(leaf.block_id):
                    reclaimed += 1
                    self.evictions += 1
                if reclaimed >= n_blocks:
                    break
        return reclaimed

    def clear(self) -> int:
        """Drop every node (engine shutdown); returns blocks freed."""
        freed = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if self.pool.release(n.block_id):
                freed += 1
        self._root.children.clear()
        self._nodes = 0
        return freed

    def evictable_count(self) -> int:
        """Blocks reclaimable by :meth:`evict` RIGHT NOW: nodes whose
        whole subtree is only trie-referenced (eviction is leaf-first,
        so a node above a request-pinned block is stuck until the sharer
        releases). This is the capacity signal routing/autoscaling must
        add to the free count — a warm idle replica's pool reads ~full
        otherwise, which would steer traffic to cold replicas and drive
        autoscale runaway."""

        # iterative post-order (chains are one node per prompt block —
        # recursion would blow the stack on long-context configs):
        # a node is counted when its whole subtree is trie-only
        count = 0
        stack = [(n, False) for n in self._root.children.values()]
        free: Dict[int, bool] = {}          # id(node) -> subtree free?
        while stack:
            n, visited = stack.pop()
            if not visited:
                stack.append((n, True))
                stack.extend((c, False) for c in n.children.values())
                continue
            ok = (self.pool.refcount(n.block_id) == 1
                  and all(free[id(c)] for c in n.children.values()))
            free[id(n)] = ok
            if ok:
                count += 1
        return count

    def digest(self, top: int = 8) -> List[Tuple[str, int]]:
        """Top trie roots by hit-weight as ``(key_digest, weight)`` pairs
        — the cluster-wide prefix-affinity signal. One entry per resident
        ROOT child (≈ one per distinct system prompt). Roots that never
        produced a hit publish weight 0: a HELD root is routable — the
        tenant's first repeat request would hit it, so omitting cold
        entries scatters every session's opening requests across the
        fleet before affinity can converge. Hot roots sort first so the
        ``top`` cap sheds cold ones under pressure. Small and stable by
        construction: ``top`` entries of ~24 bytes ride every load
        report."""
        roots = sorted(self._root.children.values(),
                       key=lambda n: -n.hit_weight)
        return [(prefix_key_digest(n.key), n.hit_weight)
                for n in roots[:max(top, 0)]]

    def stats(self) -> Dict[str, int]:
        return {"nodes": self._nodes, "hits": self.hits,
                "misses": self.misses, "hit_tokens": self.hit_tokens,
                "evictions": self.evictions}
