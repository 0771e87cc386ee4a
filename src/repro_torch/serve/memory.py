"""Unified page-granular KV memory manager: refcounted prefix sharing
(copy-on-write), host-parked eviction, and O(moved-pages) accounting.

Pure host-side policy layer over `serve.pages.PageAllocator`.  The engine
owns the device arrays and the jitted scatter/gather/copy dispatches; this
module decides WHICH physical pages back which logical tokens and hands the
engine explicit *plans*:

- **Prefix sharing**: a chain-hash index over prompt-page contents maps an
  admission whose prompt shares a prefix with a resident sequence onto the
  existing physical pages (refcount bump, zero bytes written).  Full pages
  match by boundary hash; the trailing partial page matches when the whole
  remaining tail is a prefix of a resident page's prompt tokens.
- **Copy-on-write**: the first write into a shared page (the sharer decodes
  past the shared prefix, or the donor decodes into its own partial prompt
  page after someone mapped it) breaks the share — `cow_plan` returns the
  (old_page, new_page) pair the engine fuses into the decode scatter.
- **Park / restore**: preempting a slot moves only its live pages to host
  memory (one O(pages) gather, no row-by-row copy) and frees them; restore
  scatters the payload into freshly allocated pages and the stream resumes
  bit-for-bit — nothing is re-prefilled.  The paper's "elasticity costs
  O(moved state)" applied to serving KV.

Everything here is numpy-only so the invariants (refcounts == reader
counts, index points at live pages, parked payloads cover exactly the live
tokens) are unit-testable and fuzzable without jax — run
``python -m repro_torch.serve.memory --selftest``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import NULL_TRACER, Tracer
from .pages import PageAllocator, PageError

# chain-hash seed for the page-boundary prefix index
_H0 = 0x9E3779B9


def _chain(h: int, toks: Tuple[int, ...]) -> int:
    """Deterministic-within-a-process rolling hash over page contents."""
    return hash((h, toks))


@dataclasses.dataclass
class ParkedSeq:
    """A preempted sequence's KV, parked in host memory.

    `pages` holds one host array per pool leaf (e.g. "k"/"v"), shaped
    (nb, n_pages, page_size, ...) — whole pages, gathered in table order, so
    restore is a single scatter into a fresh table.  `prompt`, when the
    engine supplies it at park time, lets restore re-match the sequence
    against the destination prefix index (restore re-sharing)."""

    rid: int
    pages: Dict[str, np.ndarray]
    live_tokens: int
    next_tok: int
    nbytes: int
    prompt: Optional[np.ndarray] = None


@dataclasses.dataclass
class AdmitPlan:
    """How to place one admitted prompt: `table` is the slot's full block
    table; `write_ids[j]` is table[j] for pages the engine must scatter and
    NULL (0) for pages mapped onto existing physical pages; `shared_tokens`
    counts prompt tokens backed by shared pages (prefill work avoidable by
    the chunked path)."""

    table: List[int]
    write_ids: List[int]
    shared_pages: int
    shared_tokens: int


@dataclasses.dataclass
class RestorePlan:
    """How to scatter a parked sequence back in: `write_ids[j]` is table[j]
    for pages whose host payload must be written and NULL (0) for pages
    re-matched onto resident prefix pages (restore re-sharing), mirroring
    `AdmitPlan`'s write-id routing.  `moved_bytes` counts only the written
    pages' payload — re-shared pages move nothing."""

    seq: ParkedSeq
    table: List[int]
    write_ids: List[int]
    shared_pages: int
    moved_bytes: int


class KVMemoryManager:
    """Refcounted page pool + prefix index + parked-sequence store."""

    def __init__(self, n_pages: int, page_size: int, *,
                 prefix_share: bool = True,
                 tracer: Optional[Tracer] = None):
        self.pages = PageAllocator(n_pages, page_size)
        self.prefix_share = prefix_share
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # full-page prefix index: chain hash of prompt tokens up to a page
        # boundary -> the physical page holding that page of tokens
        self._index: Dict[int, int] = {}
        # partial-tail candidates: boundary hash -> [(page, prompt tokens in
        # that page)] — a new prompt whose whole tail is a prefix of a
        # candidate's tokens shares the candidate page (COW-protected)
        self._partial: Dict[int, List[Tuple[int, Tuple[int, ...]]]] = {}
        self._page_keys: Dict[int, List[Tuple[str, int]]] = {}  # page -> keys
        self._parked: Dict[int, ParkedSeq] = {}
        # accounting (monotonic totals; the engine snapshots deltas per tick)
        self.shared_page_hits = 0
        self.shared_token_hits = 0
        self.cow_breaks = 0
        self.parked_total = 0
        self.restored_total = 0
        self.park_bytes = 0
        self.restore_bytes = 0

    # --- helpers ----------------------------------------------------------
    @property
    def page_size(self) -> int:
        return self.pages.page_size

    def _drop_index_entries(self, pages: Sequence[int]) -> None:
        for pg in pages:
            for kind, key in self._page_keys.pop(pg, ()):
                if kind == "full":
                    if self._index.get(key) == pg:
                        del self._index[key]
                else:
                    cands = self._partial.get(key)
                    if cands is not None:
                        cands[:] = [c for c in cands if c[0] != pg]
                        if not cands:
                            del self._partial[key]

    # --- admission: prefix matching + placement ---------------------------
    def match_prefix(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest indexed prefix of `prompt`: returns (pages, tokens
        covered).  Full pages match by boundary chain-hash; after ALL full
        pages matched, the remaining tail may map onto one resident page
        whose prompt tokens start with the whole tail."""
        if not self.prefix_share:
            return [], 0
        ps = self.page_size
        toks = [int(t) for t in prompt]
        nfull = len(toks) // ps
        h = _H0
        shared: List[int] = []
        for j in range(nfull):
            h2 = _chain(h, tuple(toks[j * ps: (j + 1) * ps]))
            pg = self._index.get(h2)
            if pg is None:
                break
            shared.append(pg)
            h = h2
        covered = len(shared) * ps
        if len(shared) == nfull:
            tail = tuple(toks[nfull * ps:])
            if tail:
                for pg, ptoks in self._partial.get(h, ()):
                    if len(tail) <= len(ptoks) and ptoks[: len(tail)] == tail:
                        shared.append(pg)
                        covered = len(toks)
                        break
        return shared, covered

    def admit_slot(self, slot: int, prompt: np.ndarray, *,
                   partial_tail: bool = True,
                   register: bool = True,
                   grow: bool = True) -> AdmitPlan:
        """Open `slot`'s table for `prompt`: map the longest indexed prefix
        onto existing pages (refcount bump), allocate exclusive pages for
        the rest, and register the prompt's pages in the prefix index.

        partial_tail=False restricts sharing to full pages (the chunked-
        prefill path, which must run at least the tail chunk through the
        model to obtain last-token logits).  register=False skips indexing
        (chunked admissions register page-by-page as chunks land).
        grow=False leaves the unshared remainder unallocated (chunked
        prefill grows the table one chunk at a time)."""
        shared, covered = self.match_prefix(prompt)
        L = len(prompt)
        if shared and not partial_tail:
            # full pages only, and keep >= 1 token of real prefill work (the
            # chunked path needs a final chunk to produce last-token logits)
            keep_full = min(len(shared), (L - 1) // self.page_size)
            shared = shared[:keep_full]
            covered = keep_full * self.page_size
        self.pages.alloc_slot(slot, 0)
        if shared:
            self.pages.share(slot, shared)
            self.shared_page_hits += len(shared)
            self.shared_token_hits += min(covered, L)
            self.tracer.count("serve.prefix_hits")
            self.tracer.count("serve.prefix_hit_pages", len(shared))
        fresh = self.pages.ensure(slot, L) if grow else []
        table = self.pages.table(slot)
        write = set(fresh)
        write_ids = [pg if pg in write else 0 for pg in table]
        if register:
            self.register_prefix(slot, prompt)
        return AdmitPlan(table=table, write_ids=write_ids,
                         shared_pages=len(shared),
                         shared_tokens=min(covered, L))

    def admit_chunked(self, slot: int, prompt: np.ndarray) -> int:
        """Open `slot`'s table for a CHUNKED prefill: map matched full
        prefix pages (never the partial tail — the final chunk must run to
        produce logits) and return the token offset prefill should start
        at; the table then grows chunk by chunk via `pages.ensure`.
        Registration happens incrementally as chunks land
        (`register_prefix(upto=...)`)."""
        plan = self.admit_slot(slot, prompt, partial_tail=False,
                               register=False, grow=False)
        return plan.shared_tokens

    def register_prefix(self, slot: int, prompt: np.ndarray,
                        upto: Optional[int] = None) -> None:
        """Index `slot`'s prompt pages (full pages by boundary hash, the
        partial last page as a tail candidate).  `upto` limits indexing to
        pages whose tokens have actually been written (chunked prefill
        registers incrementally so a sharer can never read an unwritten
        page).  Idempotent: existing keys are kept."""
        if not self.prefix_share:
            return
        ps = self.page_size
        toks = [int(t) for t in prompt]
        table = self.pages.table(slot)
        limit = len(toks) if upto is None else min(upto, len(toks))
        nfull = limit // ps
        h = _H0
        for j in range(nfull):
            h = _chain(h, tuple(toks[j * ps: (j + 1) * ps]))
            if h not in self._index:
                pg = table[j]
                self._index[h] = pg
                self._page_keys.setdefault(pg, []).append(("full", h))
        # the partial last page becomes a tail candidate only once the WHOLE
        # prompt is written (its candidate tokens are the page's final form)
        rest = tuple(toks[nfull * ps:])
        if rest and limit == len(toks):
            pg = table[nfull]
            cands = self._partial.setdefault(h, [])
            if all(c[0] != pg for c in cands):
                cands.append((pg, rest))
                self._page_keys.setdefault(pg, []).append(("partial", h))

    # --- copy-on-write ----------------------------------------------------
    def cow_plan(self, slot: int, pos: int) -> Optional[Tuple[int, int]]:
        """If the page backing write position `pos` is shared, break the
        share: returns (old_page, new_page) for the engine to fuse a page
        copy into its scatter dispatch, or None when the write target is
        exclusive (or a fresh page not yet allocated).  Only the slot's LAST
        page can ever be shared at write time: shared pages all lie in the
        prompt-prefix region, and writes only ever land at/after the live
        length.

        An EXCLUSIVE write target may still be indexed (the other readers
        left, or a COW moved them away): the write makes any index claim
        extending past the write offset stale, so those entries are dropped
        here — a later admission must never map a page whose recorded
        tokens were overwritten by decode output."""
        ps = self.page_size
        if pos % ps == 0:
            return None  # page boundary: the write goes to a fresh page
        j = pos // ps
        table = self.pages.table(slot)
        if j >= len(table):
            return None
        if self.pages.ref(table[j]) < 2:
            self._invalidate_claims(table[j], pos % ps)
            return None
        old, new = self.pages.cow(slot, j)
        self.cow_breaks += 1
        self.tracer.instant("cow_break", track="cow_plan", slot=slot,
                            old=old, new=new)
        self.tracer.count("serve.cow_breaks")
        return old, new

    def _invalidate_claims(self, pg: int, off: int) -> None:
        """Drop index entries of `pg` whose claimed tokens extend to or past
        write offset `off` (full-page claims always do; a partial candidate
        only if its recorded tail is longer than the surviving prefix)."""
        keys = self._page_keys.get(pg)
        if not keys:
            return
        keep: List[Tuple[str, int]] = []
        for kind, key in keys:
            if kind == "full":
                if self._index.get(key) == pg:
                    del self._index[key]
            else:
                cands = self._partial.get(key)
                stale = [c for c in (cands or ())
                         if c[0] == pg and len(c[1]) > off]
                if stale:
                    cands[:] = [c for c in cands if c not in stale]
                    if not cands:
                        del self._partial[key]
                if any(c[0] == pg for c in self._partial.get(key, ())):
                    keep.append((kind, key))  # shorter claim still valid
        if keep:
            self._page_keys[pg] = keep
        else:
            del self._page_keys[pg]

    # --- eviction: park / restore -----------------------------------------
    def park(self, rid: int, slot: int, host_pages: Dict[str, np.ndarray],
             live_tokens: int, next_tok: int,
             prompt: Optional[np.ndarray] = None) -> ParkedSeq:
        """Record `slot`'s gathered pages as parked host state and release
        the device pages (shared pages survive for their other readers).
        The engine gathers `host_pages` (table order) BEFORE calling.
        `prompt` (when given) enables restore re-sharing on the way back."""
        if rid in self._parked:
            raise PageError(f"request {rid} is already parked")
        nbytes = int(sum(a.nbytes for a in host_pages.values()))
        seq = ParkedSeq(rid=rid, pages=host_pages, live_tokens=live_tokens,
                        next_tok=int(next_tok), nbytes=nbytes, prompt=prompt)
        self._parked[rid] = seq
        freed = self.pages.free_slot(slot)
        self._drop_index_entries(freed)
        self.parked_total += 1
        self.park_bytes += nbytes
        self.tracer.count("serve.park_bytes", nbytes)
        return seq

    def has_parked(self, rid: int) -> bool:
        return rid in self._parked

    def take_parked(self, rid: int) -> ParkedSeq:
        """Pop a parked payload for transfer to ANOTHER manager (`adopt`) —
        the disagg prefill->decode handoff.  The bytes were already charged
        as park_bytes here; the adopting side charges restore_bytes when it
        scatters, so each half's kv_moved ledger covers its own transfers."""
        return self._parked.pop(rid)

    def adopt(self, seq: ParkedSeq) -> None:
        """Accept a parked payload gathered by another manager: the next
        `restore(seq.rid, ...)` scatters it into THIS pool."""
        if seq.rid in self._parked:
            raise PageError(f"request {seq.rid} is already parked here")
        self._parked[seq.rid] = seq

    def restore(self, rid: int, slot: int) -> RestorePlan:
        """Allocate pages for a parked sequence and hand the engine the
        payload + write ids to scatter it back through.  The sequence's
        prompt (when parked with one) is RE-MATCHED against this manager's
        prefix index first: full prompt pages already resident are shared
        again (refcount bump, nothing scattered) so a parked or handed-off
        few-shot stream regains its page dedup.  Only FULL prompt pages are
        ever re-shared — the page holding the prompt tail also holds this
        stream's own decode KV, which an indexed donor page does not."""
        seq = self._parked.pop(rid)
        shared: List[int] = []
        if seq.prompt is not None and len(seq.prompt) and self.prefix_share:
            cand, _ = self.match_prefix(seq.prompt)
            nfull = len(seq.prompt) // self.page_size
            shared = cand[:min(len(cand), nfull)]
        self.pages.alloc_slot(slot, 0)
        if shared:
            self.pages.share(slot, shared)
            self.shared_page_hits += len(shared)
            self.shared_token_hits += len(shared) * self.page_size
            self.tracer.count("serve.prefix_hits")
            self.tracer.count("serve.prefix_hit_pages", len(shared))
        fresh = self.pages.ensure(slot, seq.live_tokens)
        table = self.pages.table(slot)
        write = set(fresh)
        write_ids = [pg if pg in write else 0 for pg in table]
        if seq.prompt is not None and len(seq.prompt):
            # the restored pages now also donate: index the prompt so later
            # admissions (and later restores) can map onto them
            self.register_prefix(slot, seq.prompt)
        moved = seq.nbytes * len(fresh) // max(len(table), 1)
        self.restored_total += 1
        self.restore_bytes += moved
        self.tracer.count("serve.restore_bytes", moved)
        return RestorePlan(seq=seq, table=table, write_ids=write_ids,
                           shared_pages=len(shared), moved_bytes=moved)

    @property
    def n_parked(self) -> int:
        return len(self._parked)

    # --- release / defrag --------------------------------------------------
    def release_slot(self, slot: int) -> List[int]:
        """Finish a slot: decref its pages, dropping index entries of pages
        that actually died."""
        freed = self.pages.free_slot(slot)
        self._drop_index_entries(freed)
        return freed

    def trim(self, slot: int, n_tokens: int) -> List[int]:
        freed = self.pages.trim(slot, n_tokens)
        self._drop_index_entries(freed)
        return freed

    def defrag(self) -> Optional[np.ndarray]:
        """Compact the pool; remaps the prefix index through the move map."""
        src = self.pages.defrag()
        if src is None:
            return None
        new_id = {int(old): new for new, old in enumerate(src)}
        self._index = {k: new_id[p] for k, p in self._index.items()}
        self._partial = {k: [(new_id[p], t) for p, t in v]
                         for k, v in self._partial.items()}
        self._page_keys = {new_id[p]: keys
                           for p, keys in self._page_keys.items()}
        return src

    # --- invariants -------------------------------------------------------
    def check(self, live: Optional[Dict[int, int]] = None) -> None:
        """Allocator invariants (+ exact coverage when `live` is given) plus
        index consistency: every indexed page is live and its recorded keys
        round-trip."""
        self.pages.check(live)
        for h, pg in self._index.items():
            if self.pages.ref(pg) <= 0:
                raise PageError(f"prefix index points at dead page {pg}")
            if ("full", h) not in self._page_keys.get(pg, ()):
                raise PageError(f"page {pg} missing reverse key for {h}")
        for h, cands in self._partial.items():
            for pg, _ in cands:
                if self.pages.ref(pg) <= 0:
                    raise PageError(f"partial index points at dead page {pg}")
                if ("partial", h) not in self._page_keys.get(pg, ()):
                    raise PageError(f"page {pg} missing partial key for {h}")
        for pg in self._page_keys:
            if self.pages.ref(pg) <= 0:
                raise PageError(f"reverse key map holds dead page {pg}")

    def stats(self) -> Dict[str, Any]:
        return {
            "physical_pages": self.pages.n_used,
            "logical_pages": self.pages.n_logical,
            "shared_extra": self.pages.n_shared_extra,
            "shared_page_hits": self.shared_page_hits,
            "shared_token_hits": self.shared_token_hits,
            "cow_breaks": self.cow_breaks,
            "parked": self.n_parked,
            "parked_total": self.parked_total,
            "restored_total": self.restored_total,
            "park_bytes": self.park_bytes,
            "restore_bytes": self.restore_bytes,
        }


# ---------------------------------------------------------------------------
# Seeded fuzz selftest (no jax): random admissions drawn from a small prompt
# family (forcing prefix collisions), decode writes with COW breaks, spec-
# style trims, park/restore round trips, frees, and defrags — invariants
# checked after every operation.
# ---------------------------------------------------------------------------


def _selftest(seed: int = 0, steps: int = 2000) -> None:
    rng = np.random.default_rng(seed)
    ps = 4
    capacity = 8
    max_pages = 8  # per-slot cap (cache_len 32)
    mem = KVMemoryManager(capacity * max_pages + 1, ps)
    headers = [rng.integers(0, 97, size=int(n)).astype(np.int64)
               for n in (9, 12, 17)]
    live: Dict[int, Dict[str, Any]] = {}  # slot -> {pos, prompt}
    parked: List[Tuple[int, int]] = []  # (rid, live_tokens)
    next_rid = 0

    def host_payload(slot):
        n = mem.pages.n_pages_of(slot)
        return {"k": np.zeros((1, n, ps, 1, 1), np.float32)}

    # writes dominate (as in a decode loop) so shared partial pages get hit
    ops = ["admit", "admit", "write", "write", "write", "trim", "free",
           "park", "restore", "defrag"]
    for step in range(steps):
        op = rng.choice(ops)
        free_slots = [s for s in range(capacity) if s not in live]
        if op == "admit" and free_slots:
            hdr = headers[int(rng.integers(len(headers)))]
            # empty suffixes are common: identical prompts are what drives
            # partial-tail sharing and therefore copy-on-write breaks
            suffix = rng.integers(0, 97, size=int(rng.integers(0, 3)))
            prompt = np.concatenate([hdr, suffix])[: (max_pages - 2) * ps]
            slot = free_slots[0]
            plan = mem.admit_slot(slot, prompt,
                                  partial_tail=bool(rng.integers(2)))
            assert len(plan.table) == mem.pages.pages_for(len(prompt))
            live[slot] = {"pos": len(prompt), "prompt": prompt,
                          "rid": next_rid}
            next_rid += 1
        elif op == "write" and live:
            slot = int(rng.choice(list(live)))
            st = live[slot]
            span = int(rng.integers(1, 4))
            span = min(span, max_pages * ps - st["pos"])
            if span <= 0:
                continue
            plan = mem.cow_plan(slot, st["pos"])
            if plan is not None:
                old, new = plan
                assert mem.pages.ref(new) == 1
            mem.pages.ensure(slot, st["pos"] + span)
            st["pos"] += span
            # the write target page must now be exclusively owned
            j = (st["pos"] - 1) // ps
            tail_pg = mem.pages.table(slot)[j]
            assert mem.pages.ref(tail_pg) == 1 or st["pos"] % ps == 0
        elif op == "trim" and live:
            slot = int(rng.choice(list(live)))
            st = live[slot]
            back = int(rng.integers(0, 3))
            keep = max(len(st["prompt"]), st["pos"] - back)
            mem.trim(slot, keep)
            st["pos"] = keep
        elif op == "free" and live:
            slot = int(rng.choice(list(live)))
            mem.release_slot(slot)
            del live[slot]
        elif op == "park" and live:
            slot = int(rng.choice(list(live)))
            st = live[slot]
            mem.park(st["rid"], slot, host_payload(slot), st["pos"], 7,
                     prompt=st["prompt"])
            parked.append((st["rid"], st["pos"]))
            del live[slot]
        elif op == "restore" and parked and free_slots:
            rid, n_tok = parked.pop()
            slot = free_slots[0]
            plan = mem.restore(rid, slot)
            assert plan.seq.live_tokens == n_tok
            assert len(plan.table) == mem.pages.pages_for(n_tok)
            # re-shared pages never include the prompt's partial tail and
            # write ids route exactly the unshared pages
            assert plan.shared_pages <= len(plan.seq.prompt) // ps
            assert sum(1 for w in plan.write_ids if w == 0) \
                == plan.shared_pages
            assert plan.moved_bytes <= plan.seq.nbytes
            live[slot] = {"pos": n_tok, "prompt": plan.seq.prompt,
                          "rid": rid}
        elif op == "defrag":
            mem.defrag()
        mem.check({s: st["pos"] for s, st in live.items()})
    # drain
    for slot in list(live):
        mem.release_slot(slot)
    mem.check({})
    assert mem.pages.n_used == 0, "pages leaked after drain"
    s = mem.stats()
    assert s["shared_page_hits"] > 0, "fuzz never exercised sharing"
    assert s["cow_breaks"] > 0, "fuzz never exercised copy-on-write"
    assert s["parked_total"] > 0 and s["restored_total"] > 0
    print(f"memory selftest OK: {steps} ops, "
          f"{s['shared_page_hits']} shared-page hits, "
          f"{s['cow_breaks']} cow breaks, {s['parked_total']} parks "
          f"({s['park_bytes']} bytes), {s['restored_total']} restores")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args()
    if args.selftest:
        for s in range(args.seed, args.seed + 3):
            _selftest(seed=s, steps=args.steps)
    else:
        print(__doc__)
