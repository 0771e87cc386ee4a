"""Fixed-capacity slotted KV pool bookkeeping.

The pool is pure host-side state: which slots are free, which request owns
which slot, and each slot's decode depth.  The device-side cache (the
actual KV rows, batch dim == capacity) lives in the engine; keeping the
bookkeeping separate makes the invariants unit-testable without jax.

Sequences of different lengths share ONE jitted decode step: every active
slot decodes each tick at its own `pos` (pad-to-slot), finished/empty slots
are masked on the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class SlotError(RuntimeError):
    pass


class SlotPool:
    """Slot allocator + per-slot decode state for a capacity-S pool."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._free: List[int] = list(range(capacity - 1, -1, -1))  # pop->0..
        self._owner: Dict[int, int] = {}  # slot -> request id
        # per-slot decode depth (next write position); parked slots stay 0
        self.pos = np.zeros(capacity, np.int32)

    # --- alloc/free -------------------------------------------------------
    def alloc(self, rid: int) -> int:
        if not self._free:
            raise SlotError("slot pool exhausted")
        slot = self._free.pop()
        self._owner[slot] = rid
        self.pos[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise SlotError(f"double free / free of unallocated slot {slot}")
        del self._owner[slot]
        self.pos[slot] = 0
        self._free.append(slot)

    # --- queries ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.capacity - self.n_free

    def owner(self, slot: int) -> Optional[int]:
        return self._owner.get(slot)

    def used_slots(self) -> List[int]:
        return sorted(self._owner)

    def occupancy(self) -> float:
        return self.n_used / self.capacity

    def active_mask(self) -> np.ndarray:
        m = np.zeros(self.capacity, bool)
        m[list(self._owner)] = True
        return m

    def check_invariants(self) -> None:
        """free ∪ used == all slots, disjoint; parked slots at depth 0."""
        free = set(self._free)
        used = set(self._owner)
        if free & used:
            raise SlotError(f"slots both free and used: {free & used}")
        if free | used != set(range(self.capacity)):
            raise SlotError("slot leak: free+used != capacity")
        if any(self.pos[s] != 0 for s in free):
            raise SlotError("freed slot kept a nonzero decode depth")
