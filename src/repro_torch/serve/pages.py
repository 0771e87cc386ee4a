"""Paged KV bookkeeping: fixed-size token pages + per-slot block tables.

The serving analogue of vLLM's block manager, kept — like `SlotPool` — as
pure host-side state so the invariants are unit-testable without jax.  The
device side (the actual K/V page pools, leading dim == n_pages) lives in the
engine; this module only decides WHICH physical page backs WHICH logical
(slot, token-range) and hands the engine int32 block tables to gather
through.

Pages are REFCOUNTED: a physical page may back the same logical token range
of several slots at once (prefix sharing — identical prompt prefixes map to
one set of pages, see `serve.memory.KVMemoryManager`).  A slot that must
WRITE into a page it shares first breaks the share with `cow()`
(copy-on-write): it gets a private page, the other readers keep the
original.  Freeing a table only returns pages whose refcount drops to zero.

Physical page 0 is reserved as the NULL page: it is never allocated, block
tables use it as the routing target for masked writes (inactive batch rows,
right-padded prompt tails), and every read through it is masked out by
position validity.  This makes the batched scatter/gather in the paged
decode step total — no branchy host-side row filtering on the hot path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NULL_PAGE = 0


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (bucketing helper: table widths, batch
    sizes, and draft-context lengths all bucket to powers of two so jit
    retrace counts stay logarithmic)."""
    p = 1
    while p < n:
        p *= 2
    return p


class PageError(RuntimeError):
    pass


class PageAllocator:
    """Allocator for a pool of `n_pages` physical pages of `page_size` tokens.

    Each slot owns an ordered block table: entry j backs token positions
    [j*page_size, (j+1)*page_size).  Pages carry a refcount (number of
    tables referencing them); alloc is O(1) pop, free is O(pages-of-slot)
    and returns only pages whose last reference just dropped.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved null page)")
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # pop() hands out low page ids first (1, 2, ...)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}  # slot -> ordered page ids
        self._ref: Dict[int, int] = {}  # page -> number of tables holding it
        # bumped on every table mutation, as in the JAX allocator, whose
        # overlapped engine binds a block table staged ahead of time only
        # while this counter is unchanged (this port's engine builds its
        # table at bind and does not read it)
        self.version = 0

    # --- capacity math ----------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return max(0, -(-int(n_tokens) // self.page_size))

    # --- alloc/free -------------------------------------------------------
    def alloc_slot(self, slot: int, n_tokens: int = 0) -> List[int]:
        """Open a block table for `slot` with capacity >= n_tokens."""
        if slot in self._tables:
            raise PageError(f"slot {slot} already has a block table")
        self._tables[slot] = []
        self.version += 1
        return self.ensure(slot, n_tokens)

    def ensure(self, slot: int, n_tokens: int) -> List[int]:
        """Grow slot's table to cover n_tokens; returns newly added pages."""
        if slot not in self._tables:
            raise PageError(f"slot {slot} has no block table")
        table = self._tables[slot]
        need = self.pages_for(n_tokens) - len(table)
        added: List[int] = []
        for _ in range(need):
            if not self._free:
                raise PageError(
                    f"page pool exhausted ({self.n_pages - 1} usable pages)")
            pg = self._free.pop()
            table.append(pg)
            self._ref[pg] = 1
            added.append(pg)
        if added:
            self.version += 1
        return added

    def share(self, slot: int, pages: Sequence[int]) -> None:
        """Append existing (already-referenced) pages to slot's table,
        bumping their refcounts — the prefix-sharing admission path.  The
        pages back the NEXT token positions of the slot's table, so sharing
        must happen before any exclusive tail pages are allocated."""
        if slot not in self._tables:
            raise PageError(f"slot {slot} has no block table")
        table = self._tables[slot]
        for pg in pages:
            if self._ref.get(pg, 0) <= 0:
                raise PageError(f"share of unreferenced page {pg}")
            if pg in table:
                raise PageError(f"page {pg} already in slot {slot}'s table")
            table.append(pg)
            self._ref[pg] += 1
            self.version += 1

    def _decref(self, pg: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        r = self._ref.get(pg)
        if r is None:
            raise PageError(f"decref of unreferenced page {pg}")
        if r > 1:
            self._ref[pg] = r - 1
            return False
        del self._ref[pg]
        self._free.append(pg)
        return True

    def free_slot(self, slot: int) -> List[int]:
        """Release the slot's table; returns the pages actually freed (last
        reference dropped).  Shared pages survive for their other readers."""
        if slot not in self._tables:
            raise PageError(f"free of slot {slot} with no block table")
        pages = self._tables.pop(slot)
        self.version += 1
        # push in reverse so the lowest ids are handed out again first, but
        # report freed pages in table order
        return [pg for pg in reversed(pages) if self._decref(pg)][::-1]

    def trim(self, slot: int, n_tokens: int) -> List[int]:
        """Shrink slot's table to cover exactly n_tokens, dropping the tail
        references.

        The speculative-decode rollback: pages allocated for draft tokens
        that verification then rejected go straight back to the free list.
        Returns the pages actually freed (possibly empty)."""
        if slot not in self._tables:
            raise PageError(f"trim of slot {slot} with no block table")
        table = self._tables[slot]
        keep = self.pages_for(n_tokens)
        dropped = table[keep:]
        del table[keep:]
        if dropped:
            self.version += 1
        return [pg for pg in reversed(dropped) if self._decref(pg)][::-1]

    def cow(self, slot: int, index: int) -> Tuple[int, int]:
        """Copy-on-write break: replace the SHARED page at table position
        `index` with a fresh private page.  Returns (old_page, new_page);
        the caller owns copying the device payload old -> new before any
        write lands in the new page.  The old page keeps its other readers.

        Always satisfiable when a share exists: a pool sized for exclusive
        worst-case occupancy has >= 1 free page whenever any page is shared.
        """
        if slot not in self._tables:
            raise PageError(f"cow of slot {slot} with no block table")
        table = self._tables[slot]
        if not 0 <= index < len(table):
            raise PageError(f"cow index {index} out of range for slot {slot}")
        old = table[index]
        if self._ref.get(old, 0) < 2:
            raise PageError(f"cow of exclusively-owned page {old}")
        if not self._free:
            raise PageError("page pool exhausted during cow break")
        new = self._free.pop()
        table[index] = new
        self._ref[new] = 1
        self._ref[old] -= 1
        self.version += 1
        return old, new

    # --- queries ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        """Physical pages in use (each shared page counted once)."""
        return (self.n_pages - 1) - self.n_free

    @property
    def n_logical(self) -> int:
        """Sum of table lengths — what exclusive ownership would cost."""
        return sum(len(t) for t in self._tables.values())

    @property
    def n_shared_extra(self) -> int:
        """Pages saved by sharing: logical references minus physical pages."""
        return self.n_logical - self.n_used

    def ref(self, pg: int) -> int:
        return self._ref.get(pg, 0)

    def occupancy(self) -> float:
        return self.n_used / (self.n_pages - 1)

    def table(self, slot: int) -> List[int]:
        return list(self._tables.get(slot, ()))

    def has_table(self, slot: int) -> bool:
        return slot in self._tables

    def n_pages_of(self, slot: int) -> int:
        return len(self._tables.get(slot, ()))

    def max_table_len(self) -> int:
        return max((len(t) for t in self._tables.values()), default=0)

    def table_array(self, n_slots: int, width: int,
                    only: Optional[Sequence[int]] = None) -> np.ndarray:
        """(n_slots, width) int32 block table; -1 marks absent pages.

        Row i is slot i's table (batch row == slot id in the engine's
        pool).  `only` restricts emitted rows to those slots (others stay
        all -1), letting the decode step bucket its table width to the
        ACTIVE slots even while a longer mid-prefill table exists.
        """
        out = np.full((n_slots, width), -1, np.int32)
        for slot in (self._tables if only is None else only):
            table = self._tables.get(slot)
            if table is None:
                raise PageError(f"slot {slot} has no block table")
            if slot >= n_slots:
                raise PageError(f"slot {slot} out of range for {n_slots} rows")
            if len(table) > width:
                raise PageError(
                    f"slot {slot} holds {len(table)} pages > table width {width}")
            out[slot, : len(table)] = table
        return out

    # --- defrag -----------------------------------------------------------
    def defrag(self) -> Optional[np.ndarray]:
        """Compact live pages into the lowest physical ids (slot order; a
        shared page moves ONCE, at its first table appearance).

        Returns `src` (n_pages,) int32 with new_pool[i] = old_pool[src[i]],
        or None when the layout is already compact.  The caller owns moving
        the device-side page payloads with this gather; tables here are
        rewritten in place.  Callers holding page ids outside the tables
        (e.g. a prefix index) must remap them through the returned map.
        """
        order = [NULL_PAGE]
        seen = {NULL_PAGE}
        for slot in sorted(self._tables):
            for pg in self._tables[slot]:
                if pg not in seen:  # shared pages appear in several tables
                    seen.add(pg)
                    order.append(pg)
        if order == list(range(len(order))):
            return None
        order.extend(p for p in range(self.n_pages) if p not in seen)
        src = np.asarray(order, np.int32)
        new_id = {old: new for new, old in enumerate(order)}
        self._tables = {s: [new_id[p] for p in t]
                        for s, t in self._tables.items()}
        self._ref = {new_id[p]: c for p, c in self._ref.items()}
        n_used = self.n_used
        self._free = list(range(self.n_pages - 1, n_used, -1))
        self.version += 1
        return src

    # --- invariants -------------------------------------------------------
    def check(self, live: Optional[Dict[int, int]] = None) -> None:
        """Full leak guard: structural + refcount invariants plus — when
        `live` maps each slot to its live token count — EXACT coverage:
        every live slot holds exactly `pages_for(tokens)` pages and no other
        slot holds any.  The engine calls this each tick under
        `debug_checks=True`, so a page kept for a rejected draft token, a
        refcount drifting from its true reader count, or a leak from an
        at-capacity finish fails the tick it happens."""
        self.check_invariants()
        if live is None:
            return
        if set(self._tables) != set(live):
            raise PageError(
                f"live slots {sorted(live)} != tables {sorted(self._tables)}")
        for slot, n_tokens in live.items():
            want = self.pages_for(n_tokens)
            got = len(self._tables[slot])
            if got != want:
                raise PageError(
                    f"slot {slot} holds {got} pages for {n_tokens} live "
                    f"tokens (want exactly {want}) — page leak or rollback "
                    f"miss")

    def check_invariants(self) -> None:
        """null page never allocated; free/referenced disjoint and
        exhaustive; every refcount equals the page's true reader count
        (tables referencing it); no page twice in one table."""
        free = set(self._free)
        referenced = set(self._ref)
        if len(free) != len(self._free):
            raise PageError("duplicate page on the free list")
        if NULL_PAGE in free or NULL_PAGE in referenced:
            raise PageError("null page leaked into free/referenced sets")
        if free & referenced:
            raise PageError(f"pages both free and referenced: {free & referenced}")
        if free | referenced != set(range(1, self.n_pages)):
            raise PageError("page leak: free+referenced != usable pages")
        counts: Dict[int, int] = {}
        for slot, table in self._tables.items():
            if len(table) != len(set(table)):
                raise PageError(f"slot {slot} holds a page twice")
            for pg in table:
                counts[pg] = counts.get(pg, 0) + 1
        if counts != self._ref:
            drift = {p: (self._ref.get(p), counts.get(p))
                     for p in set(counts) | set(self._ref)
                     if self._ref.get(p) != counts.get(p)}
            raise PageError(f"refcount drift (page: (ref, readers)): {drift}")
        for pg, c in self._ref.items():
            if c <= 0:
                raise PageError(f"non-positive refcount on page {pg}")
