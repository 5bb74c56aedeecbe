"""Block-space manager for the paged KV cache (port of
``repro.serving.block_pool``; pure Python, copied).

Host-side bookkeeping only: this module never touches device tensors. The
engine owns the physical pool (``lm.init_paged_cache``); this class owns
which physical block holds which logical block of which request.

Invariants (enforced by ``check_invariants``, exercised by property tests):

- Every physical block is either on the free list or has a refcount >= 1;
  the two sets partition ``range(num_blocks)`` at all times.
- A block's refcount equals the number of request tables that contain it,
  so ``sum(refcounts) == sum(len(table) for table in tables)``.
- Block tables are append-only per request until eviction: entries are
  only ever appended (``append_slot``) or swapped in place by copy-on-write;
  they shrink only when the whole request is freed or preempted.
- A block appears in the prefix registry only while its contents are
  immutable: registration is dropped the moment a sole owner is about to
  write into it, and copy-on-write redirects writers away from shared
  blocks, so registry hits always reference bit-identical KV rows.
- Prefix keys are the exact token prefix (a tuple), chained per block:
  block ``j`` of a prompt is registered under ``tokens[: min((j+1)*bs, n)]``,
  including the partial frontier block, so two identical prompts share
  every block and prompts diverging mid-block share every block before
  the divergent one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class BlockSpaceManager:
    """Refcounted pool of fixed-size KV blocks with prefix sharing.

    ``num_blocks`` counts *usable* blocks; the engine typically allocates
    one extra physical "trash" block (index ``num_blocks``) that masked
    scatter lanes write into — that block is never managed here.
    """

    num_blocks: int
    block_size: int
    share_prefix: bool = True

    _free: List[int] = field(default_factory=list)
    _ref: Dict[int, int] = field(default_factory=dict)
    _tables: Dict[int, List[int]] = field(default_factory=dict)
    _shared: Dict[int, int] = field(default_factory=dict)  # uid -> shared prefix blocks
    _key_to_block: Dict[Tuple[int, ...], int] = field(default_factory=dict)
    _block_to_key: Dict[int, Tuple[int, ...]] = field(default_factory=dict)

    # counters for stats()
    peak_used: int = 0
    alloc_count: int = 0  # fresh blocks handed out
    shared_hits: int = 0  # table entries satisfied by the prefix registry
    cow_count: int = 0
    preemptions: int = 0

    def __post_init__(self) -> None:
        if self.num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self._free = list(range(self.num_blocks))

    # -- capacity ---------------------------------------------------------

    def blocks_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def _match_prefix(self, prompt: Tuple[int, ...]) -> int:
        """Number of leading blocks of ``prompt`` already in the registry."""
        if not self.share_prefix:
            return 0
        n = 0
        for j in range(self.blocks_needed(len(prompt))):
            end = min((j + 1) * self.block_size, len(prompt))
            if prompt[:end] not in self._key_to_block:
                break
            n += 1
        return n

    def can_allocate(self, prompt: Sequence[int]) -> bool:
        prompt = tuple(prompt)
        need = self.blocks_needed(len(prompt)) - self._match_prefix(prompt)
        return need <= len(self._free)

    def admission_cap(self, prompts: Sequence[Sequence[int]]) -> int:
        """How many of ``prompts`` (FIFO order) fit in the current free pool.

        Pure estimate — no state is mutated. Intra-batch sharing between the
        candidate prompts themselves is ignored, so the cap is conservative.
        """
        free = len(self._free)
        cap = 0
        for prompt in prompts:
            prompt = tuple(prompt)
            need = self.blocks_needed(len(prompt)) - self._match_prefix(prompt)
            if need > free:
                break
            free -= need
            cap += 1
        return cap

    # -- registry ---------------------------------------------------------

    def _register(self, block: int, key: Tuple[int, ...]) -> None:
        if not self.share_prefix:
            return
        if key in self._key_to_block:
            return  # first writer wins; duplicates keep their private copy
        self._key_to_block[key] = block
        self._block_to_key[block] = key

    def _unregister(self, block: int) -> None:
        key = self._block_to_key.pop(block, None)
        if key is not None:
            del self._key_to_block[key]

    # -- lifecycle --------------------------------------------------------

    def allocate(self, uid: int, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Build ``uid``'s block table for ``prompt``.

        Returns ``(table, n_shared)`` where the first ``n_shared`` table
        entries are registry hits the engine must NOT rewrite during
        prefill (their KV rows are already populated and shared).
        """
        if uid in self._tables:
            raise KeyError(f"uid {uid} already has a block table")
        prompt = tuple(prompt)
        nb = self.blocks_needed(len(prompt))
        n_shared = self._match_prefix(prompt)
        if nb - n_shared > len(self._free):
            raise MemoryError(
                f"need {nb - n_shared} free blocks, have {len(self._free)}"
            )
        table: List[int] = []
        for j in range(n_shared):
            end = min((j + 1) * self.block_size, len(prompt))
            blk = self._key_to_block[prompt[:end]]
            self._ref[blk] += 1
            self.shared_hits += 1
            table.append(blk)
        for j in range(n_shared, nb):
            blk = self._free.pop(0)
            self._ref[blk] = 1
            self.alloc_count += 1
            end = min((j + 1) * self.block_size, len(prompt))
            self._register(blk, prompt[:end])
            table.append(blk)
        self._tables[uid] = table
        self._shared[uid] = n_shared
        self.peak_used = max(self.peak_used, self.used_blocks)
        return list(table), n_shared

    def append_slot(self, uid: int, position: int) -> Optional[Tuple[str, int, int]]:
        """Make position ``position`` of ``uid`` safely writable.

        Called once per request per decode step, *before* the decode write.
        Returns one of::

            ("inplace", block, block)  write lands in an existing private block
            ("alloc",   block, block)  a fresh block was appended to the table
            ("cow",     src,   dst)    engine must copy pool[src] -> pool[dst]
            None                       pool exhausted — caller must preempt

        Any block this request is about to write into leaves the prefix
        registry (or is replaced by a private copy), keeping registry hits
        immutable.
        """
        table = self._tables[uid]
        logical = position // self.block_size
        if logical > len(table):
            raise ValueError(
                f"uid {uid}: position {position} skips past table of {len(table)}"
            )
        if logical == len(table):
            if not self._free:
                return None
            blk = self._free.pop(0)
            self._ref[blk] = 1
            self.alloc_count += 1
            table.append(blk)
            self.peak_used = max(self.peak_used, self.used_blocks)
            return ("alloc", blk, blk)
        blk = table[logical]
        if self._ref[blk] > 1:
            if not self._free:
                return None
            dst = self._free.pop(0)
            self._ref[blk] -= 1
            self._ref[dst] = 1
            self.alloc_count += 1
            self.cow_count += 1
            table[logical] = dst
            if self._shared.get(uid, 0) > logical:
                self._shared[uid] = logical
            self.peak_used = max(self.peak_used, self.used_blocks)
            return ("cow", blk, dst)
        self._unregister(blk)
        return ("inplace", blk, blk)

    def table(self, uid: int) -> List[int]:
        return list(self._tables[uid])

    def shared_prefix_blocks(self, uid: int) -> int:
        return self._shared.get(uid, 0)

    def has_table(self, uid: int) -> bool:
        return uid in self._tables

    def free(self, uid: int) -> None:
        """Release all of ``uid``'s blocks (refcount-aware)."""
        for blk in self._tables.pop(uid):
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                del self._ref[blk]
                self._unregister(blk)
                self._free.append(blk)
        self._free.sort()
        self._shared.pop(uid, None)

    def preempt(self, uid: int) -> None:
        """Evict ``uid``'s blocks under pressure (recompute-style preemption)."""
        self.free(uid)
        self.preemptions += 1

    def truncate(self, uid: int, n_tokens: int) -> int:
        """Shrink ``uid``'s table to cover exactly ``n_tokens`` tokens.

        Speculative rollback: verify writes KV for all k+1 candidate
        positions, so a rejection can leave granted blocks past the
        accepted frontier.  Releases every table entry beyond
        ``blocks_needed(n_tokens)`` (refcount-aware) and returns how many
        entries were dropped — the engine trash-redirects that many table
        tail slots on device.  The kept frontier block may hold stale
        rows past the frontier; they are unreadable (validity admits only
        held <= position) and are overwritten in order as the request
        advances.
        """
        table = self._tables[uid]
        keep = self.blocks_needed(n_tokens) if n_tokens > 0 else 0
        dropped = len(table) - keep
        if dropped <= 0:
            return 0
        for blk in table[keep:]:
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                del self._ref[blk]
                self._unregister(blk)
                self._free.append(blk)
        del table[keep:]
        self._free.sort()
        if self._shared.get(uid, 0) > keep:
            self._shared[uid] = keep
        return dropped

    # -- invariants / stats ----------------------------------------------

    def check_invariants(self) -> None:
        live = set(self._ref)
        free = set(self._free)
        if live & free:
            raise AssertionError(f"blocks both live and free: {live & free}")
        if live | free != set(range(self.num_blocks)):
            raise AssertionError("free + live blocks do not partition the pool")
        if len(free) != len(self._free):
            raise AssertionError("duplicate entries on the free list")
        counts: Dict[int, int] = {}
        for table in self._tables.values():
            for blk in table:
                counts[blk] = counts.get(blk, 0) + 1
        if counts != self._ref:
            raise AssertionError(f"refcounts {self._ref} != table counts {counts}")
        for key, blk in self._key_to_block.items():
            if self._block_to_key.get(blk) != key:
                raise AssertionError("prefix registry maps are out of sync")
            if blk not in self._ref:
                raise AssertionError(f"registered block {blk} is not live")

    def stats(self) -> dict:
        total = self.alloc_count + self.shared_hits
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "used_blocks": self.used_blocks,
            "free_blocks": self.free_blocks,
            "peak_blocks": self.peak_used,
            "shared_blocks": sum(1 for r in self._ref.values() if r > 1),
            "shared_hits": self.shared_hits,
            "shared_ratio": self.shared_hits / total if total else 0.0,
            "cow_count": self.cow_count,
            "preemptions": self.preemptions,
        }
