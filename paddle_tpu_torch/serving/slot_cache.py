"""KV-cache pools for the serving engine: the contiguous slot pool and
its block-paged successor.

Counterpart of ``paddle_tpu/serving/slot_cache.py``. ``SlotKVCache``
(:54-141) holds per-layer ``[max_slots, max_len, kv_heads, head_dim]``
k/v buffers on the engine's device plus the slot lease table: one full
row reserved per slot. ``PagedKVCache`` (:143-989) replaces the row
with a pool of fixed-size pages (``[num_pages, page_size, kv_heads,
head_dim]`` per layer) and a per-slot page table (``[max_slots,
pages_per_slot]``, numpy on the host; the engine sends a copy to the
device once per model call), so a request holds only the pages its
tokens cover and the pool oversubscribes. On top of paging it has:

- copy-on-write prefix sharing: prompts are matched against a
  page-granular radix index keyed by token content (chained full-page
  chunks, plus a partial match into the first divergent page); matched
  pages are refcounted and referenced, not prefilled again; the first
  write into a shared page copies it first (COW). Released requests
  leave their full prompt pages behind as refcount-0 CACHED pages,
  reclaimed LRU-first under allocation pressure;
- int8 KV storage: int8 pools with f32 scales ``[num_pages, page_size,
  kv_heads]`` (absmax over head_dim), dequantized inside the attend;
- reservation-based admission: a request is admitted only when its
  worst-case page span (less its fully shared pages) fits the pool, so
  decode never runs out of pages mid-flight.

Page 0 is the reserved TRASH page: unallocated table entries point at
it, and masked or padded writes land in it. Rows are never cleared on
the device: the per-slot causal mask keeps a stale tail beyond the
current length invisible. The buffers start at zero rather than
uninitialised: the masked decode multiplies stale positions by an exact
zero probability, and uninitialised memory may hold NaN bit patterns,
which would turn ``0 * NaN`` into NaN outputs.

The pools are ``torch.Tensor``s that the engine's programs update in
place; page tables, refcounts and the index stay on the host. A
speculative verify step claims every page its k-wide write window
touches (``ensure_decode_range``) and returns those past the accepted
tokens afterwards (``rollback_speculation``), inside the admission
reservation. The host KV tier (``tier``, demotion and promotion) comes
with the KV-tiering slice and is not here.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["SlotKVCache", "PagedKVCache"]


def _validate_geometry(num_layers: int, max_slots: int, max_len: int,
                       kv_heads: int, head_dim: int) -> None:
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    if max_slots < 1:
        raise ValueError(f"max_slots must be >= 1, got {max_slots}")
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if kv_heads < 1:
        raise ValueError(f"kv_heads must be >= 1, got {kv_heads}")
    if head_dim < 1:
        raise ValueError(f"head_dim must be >= 1, got {head_dim}")


class _SlotTable:
    """Slot lease bookkeeping: incremental free/active sets instead of
    per-call O(max_slots) scans."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self.slots: List[Optional[object]] = [None] * max_slots
        self._free = set(range(max_slots))
        self._active: set = set()

    def free_slots(self) -> List[int]:
        return sorted(self._free)

    def active_slots(self) -> List[int]:
        return sorted(self._active)

    def assign(self, slot: int, req) -> None:
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} is already leased")
        self.slots[slot] = req
        self._free.discard(slot)
        self._active.add(slot)

    def release(self, slot: int) -> None:
        if self.slots[slot] is None:
            raise RuntimeError(f"slot {slot} is already free")
        self.slots[slot] = None
        self._active.discard(slot)
        self._free.add(slot)

    @property
    def occupancy(self) -> float:
        return len(self._active) / self.max_slots

    def kv_bytes(self) -> int:
        """Total device bytes of the KV pools (+scales when paged): the
        one accounting a byte-budget comparison uses."""
        pools = list(self.ks) + list(self.vs) \
            + list(getattr(self, "kss", [])) \
            + list(getattr(self, "vss", []))
        return sum(p.numel() * p.element_size() for p in pools)


class SlotKVCache(_SlotTable):
    """Per-layer [max_slots, max_len, kv_heads, head_dim] k/v buffers
    plus the slot lease table (the contiguous pool). ``pools`` (the
    ``(ks, vs)`` lists of a cache of the same geometry) takes those
    device buffers over instead of allocating new ones: the engine's
    ``recover()`` rebuilds the host state around the pools it has."""

    def __init__(self, num_layers: int, max_slots: int, max_len: int,
                 kv_heads: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device, pools=None):
        _validate_geometry(num_layers, max_slots, max_len, kv_heads,
                           head_dim)
        super().__init__(max_slots)
        self.max_len = max_len
        if pools is not None:
            self.ks, self.vs = list(pools[0]), list(pools[1])
            return
        shape = (max_slots, max_len, kv_heads, head_dim)
        self.ks = [torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(num_layers)]
        self.vs = [torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(num_layers)]


class _PrefixNode:
    """One page of the prefix-sharing radix index: ``chunk`` is the
    token content this page was prefilled with (a full page, except that
    matching may use only a prefix of it), ``page`` the pool page
    holding its k/v. The path from the root IS the key: a node's page is
    only valid given every ancestor matched first."""

    __slots__ = ("chunk", "page", "parent", "children", "lru")

    def __init__(self, chunk: Tuple[int, ...], page: int, parent):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.lru = 0


class PagedKVCache(_SlotTable):
    """Block-paged KV pool with COW prefix sharing and optional int8
    storage (see module docstring). ``num_pages`` INCLUDES the reserved
    trash page 0; None means capacity parity with the contiguous pool
    (``max_slots * max_len / page_size + 1``). ``pools`` (the ``(ks,
    vs, kss, vss)`` lists of a cache of the same geometry) takes those
    device pools over instead of allocating new ones, with fresh host
    state (free list, refcounts, page table, prefix index)."""

    def __init__(self, num_layers: int, max_slots: int, max_len: int,
                 kv_heads: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device, page_size: int = 128,
                 num_pages: Optional[int] = None, quant: bool = False,
                 prefix_sharing: bool = True, pools=None):
        _validate_geometry(num_layers, max_slots, max_len, kv_heads,
                           head_dim)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size}) so prefill buckets tile into pages")
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        if num_pages is None:
            num_pages = max_slots * self.pages_per_slot + 1
        if num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"num_pages ({num_pages}) must cover at least one "
                f"full-length request plus the trash page "
                f"({self.pages_per_slot + 1})")
        super().__init__(max_slots)
        self.num_pages = num_pages
        self.quant = bool(quant)
        self.prefix_sharing = bool(prefix_sharing)
        if pools is not None:
            self.ks, self.vs, self.kss, self.vss = map(list, pools)
        else:
            shape = (num_pages, page_size, kv_heads, head_dim)
            pool_dtype = torch.int8 if self.quant else dtype
            self.ks = [torch.zeros(shape, dtype=pool_dtype, device=device)
                       for _ in range(num_layers)]
            self.vs = [torch.zeros(shape, dtype=pool_dtype, device=device)
                       for _ in range(num_layers)]
            sshape = (num_pages, page_size, kv_heads)
            self.kss = [torch.zeros(sshape, dtype=torch.float32,
                                    device=device)
                        for _ in range(num_layers)] if self.quant else []
            self.vss = [torch.zeros(sshape, dtype=torch.float32,
                                    device=device)
                        for _ in range(num_layers)] if self.quant else []
        # rows of freed slots are zeroed (-> trash page)
        self.page_table = np.zeros((max_slots, self.pages_per_slot),
                                   np.int64)
        self.refcnt = np.zeros((num_pages,), np.int64)
        self.refcnt[0] = 1                     # trash page: pinned
        self._free_pages = deque(range(1, num_pages))
        self._plans: Dict[int, dict] = {}      # rid -> admission plan
        self._committed = 0   # reserved-but-not-yet-allocated pages
        self._cached = 0      # indexed pages at refcount 0 (maintained on
        #                       refcnt 0 <-> 1 transitions)
        self._root = _PrefixNode((), 0, None)
        self._node_of_page: Dict[int, _PrefixNode] = {}
        self._lru_tick = 0
        self.cow_copies = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.pages_reclaimed = 0

    # -- page accounting ----------------------------------------------
    def page_span(self, total_len: int) -> int:
        """Pages a request whose prompt+output totals ``total_len``
        tokens needs: the last WRITE lands at position total_len - 2
        (the final sampled token's k/v is never written)."""
        return (max(0, total_len - 2)) // self.page_size + 1

    def free_page_count(self) -> int:
        return len(self._free_pages)

    def cached_page_count(self) -> int:
        """Index-owned pages no request references: reclaimable."""
        return self._cached

    def active_page_count(self) -> int:
        return int((self.refcnt[1:] > 0).sum())

    def usable_pages(self) -> int:
        return self.free_page_count() + self.cached_page_count()

    @property
    def committed_pages(self) -> int:
        return self._committed

    # -- prefix index ---------------------------------------------------
    def _touch(self, node: _PrefixNode) -> None:
        self._lru_tick += 1
        node.lru = self._lru_tick

    def _match_prefix(self, ids: np.ndarray, limit: Optional[int] = None):
        """Longest shared prefix of ``ids`` in the index. Matching stops
        at ``len(ids) - 1``: the LAST prompt token is always recomputed
        so the prefill has logits to sample from (and at ``limit``
        tokens, if given). Returns (matched_len, [matched nodes]); the
        last node may be a partial match into the first divergent page,
        which the first tail write COWs."""
        matchable = ids[:-1][:limit]
        P = self.page_size
        node = self._root
        nodes: List[_PrefixNode] = []
        m = 0
        while m + P <= len(matchable):
            child = node.children.get(
                tuple(int(t) for t in matchable[m:m + P]))
            if child is None:
                break
            nodes.append(child)
            node = child
            self._touch(node)
            m += P
        # partial match into the first DIVERGENT page: the prompt may
        # run out mid-page, or diverge mid-page from every indexed
        # chunk; the longest common prefix of the page is shareable
        want = [int(t) for t in matchable[m:m + P]]
        if want:
            best, best_child = 0, None
            for chunk, child in node.children.items():
                common = 0
                for a, b in zip(chunk, want):
                    if a != b:
                        break
                    common += 1
                if common > best:
                    best, best_child = common, child
            if best_child is not None:
                self._touch(best_child)
                nodes.append(best_child)
                m += best
        # the hit/lookup counters move in try_reserve, only when the
        # reservation COMMITS: a blocked queue head is claimed again
        # every step and must not inflate the hit rate
        return m, nodes

    def register_prefix(self, slot: int, ids: np.ndarray) -> None:
        """Index every FULL page of ``ids`` (just prefilled into
        ``slot``) so later prompts can reference them. Indexed pages are
        immutable; the owning request writes only at positions >=
        len(ids), past every full page, so it never COWs its own
        registration."""
        if not self.prefix_sharing:
            return
        P = self.page_size
        node = self._root
        row = self.page_table[slot]
        for i in range(int(len(ids)) // P):
            chunk = tuple(int(t) for t in ids[i * P:(i + 1) * P])
            child = node.children.get(chunk)
            if child is None:
                page = int(row[i])
                if page == 0 or page in self._node_of_page:
                    # never re-own a page (or index the trash page):
                    # stop registering deeper instead
                    break
                child = _PrefixNode(chunk, page, node)
                node.children[chunk] = child
                self._node_of_page[page] = child
            node = child
            self._touch(node)

    def _reclaim_one(self) -> bool:
        """Free at least one cached page: the LRU refcount-0 indexed
        subtree is dropped from the index; its pages free now if
        unreferenced, or on release otherwise. The victim itself is
        refcount-0, so one pass always frees at least its page."""
        candidates = [n for n in self._node_of_page.values()
                      if self.refcnt[n.page] == 0]
        if not candidates:
            return False
        victim = min(candidates, key=lambda n: n.lru)
        victim.parent.children.pop(victim.chunk, None)
        stack = [victim]
        while stack:
            nd = stack.pop()
            self._node_of_page.pop(nd.page, None)
            if self.refcnt[nd.page] == 0:
                self._cached -= 1           # cached -> free
                self._free_pages.append(nd.page)
                self.pages_reclaimed += 1
            stack.extend(nd.children.values())
            nd.children = {}
        return True

    # -- allocation / reservation ---------------------------------------
    def _alloc_page(self, plan: Optional[dict]) -> int:
        if not self._free_pages and not self._reclaim_one():
            raise RuntimeError(
                "KV page pool exhausted — admission reservation should "
                f"have prevented this (pages {self.num_pages}, committed "
                f"{self._committed})")
        page = int(self._free_pages.popleft())
        self.refcnt[page] = 1
        if plan is not None:
            plan["allocated"] += 1
            self._committed -= 1
        return page

    def _ref(self, page: int) -> None:
        self.refcnt[page] += 1
        if self.refcnt[page] == 1 and page in self._node_of_page:
            self._cached -= 1               # pinned: not reclaimable

    def _unref(self, page: int) -> None:
        self.refcnt[page] -= 1
        if self.refcnt[page] < 0:
            raise RuntimeError(f"page {page} refcount underflow")
        if self.refcnt[page] == 0:
            if page in self._node_of_page:
                self._cached += 1           # parked in the index
            else:
                self._free_pages.append(page)

    def try_reserve(self, req, ids: np.ndarray, total_len: int,
                    share_limit: Optional[int] = None) -> bool:
        """Admission gate: match the prompt against the prefix index
        (at most ``share_limit`` tokens, if given), pin the matched
        pages, and reserve the worst-case number of NEW pages this
        request can touch (its span less its fully shared pages; a
        partially shared page counts as new, its COW copy needs one).
        False = does not fit now (the matched pages are unpinned
        again)."""
        if req.rid in self._plans:
            raise RuntimeError(
                f"request {req.rid} already holds a reservation")
        budget = self.usable_pages() - self._committed
        # cheap precheck before the radix match: even a FULLY shared
        # prompt needs span - full_prompt_pages new pages
        if self.page_span(total_len) \
                - (max(0, int(len(ids)) - 1)) // self.page_size > budget:
            return False
        if self.prefix_sharing:
            matched, nodes = self._match_prefix(ids, share_limit)
        else:
            matched, nodes = 0, []
        for node in nodes:
            self._ref(node.page)
        need_new = self.page_span(total_len) - matched // self.page_size
        # strict check AFTER pinning: matched cached pages are no longer
        # reclaimable, so they cannot back the new allocations
        if need_new > self.usable_pages() - self._committed:
            for node in nodes:
                self._unref(node.page)
            return False
        self._committed += need_new
        lookup = max(0, int(len(ids)) - 1) if self.prefix_sharing else 0
        self.prefix_lookup_tokens += lookup
        self.prefix_hit_tokens += matched
        self._plans[req.rid] = {
            "state": "reserved", "matched": matched, "nodes": nodes,
            "need_new": need_new, "allocated": 0, "slot": None,
            "total_len": int(total_len),
            # what this plan added to the hit/lookup counters: rolled
            # back if the reservation is cancelled or the prefill aborts,
            # so a requeued request counts exactly once
            "hit_counted": matched, "lookup_counted": lookup,
        }
        return True

    def refresh_reservation(self, req, ids: np.ndarray,
                            share_limit: Optional[int] = None) -> None:
        """Match an unconsumed reservation again right before prefill:
        requests admitted in the SAME wave claim before any of them has
        prefilled, so the head of the wave registers pages the rest can
        only see now. A longer match strictly shrinks the reservation."""
        plan = self._plans.get(req.rid)
        if plan is None or plan["state"] != "reserved" \
                or not self.prefix_sharing:
            return
        matched, nodes = self._match_prefix(ids, share_limit)
        if matched <= plan["matched"]:
            return
        for node in nodes:
            self._ref(node.page)
        for node in plan["nodes"]:
            self._unref(node.page)
        need_new = self.page_span(plan["total_len"]) \
            - matched // self.page_size
        self._committed += need_new - plan["need_new"]
        self.prefix_hit_tokens += matched - plan["matched"]
        plan["hit_counted"] += matched - plan["matched"]
        plan.update(matched=matched, nodes=nodes, need_new=need_new)

    def cancel_reservation(self, req) -> None:
        """Drop an unconsumed reservation (a failed admission batch: the
        request goes back to the queue). No-op once the request holds
        pages in a slot: release() / abort_sequence() handle that."""
        plan = self._plans.get(req.rid)
        if plan is None or plan["state"] != "reserved":
            return
        for node in plan["nodes"]:
            self._unref(node.page)
        self._committed -= plan["need_new"]
        self.prefix_hit_tokens -= plan["hit_counted"]
        self.prefix_lookup_tokens -= plan["lookup_counted"]
        del self._plans[req.rid]

    # -- sequence lifecycle ---------------------------------------------
    def begin_sequence(self, slot: int, req, ids: np.ndarray
                       ) -> Tuple[int, List[Tuple[int, int]]]:
        """Consume the request's reservation into slot state: point the
        page table at the matched shared pages, COW the partially shared
        page (if any), and allocate fresh pages for the prefill tail.
        Returns (matched_len, [(src, dst) page copies the engine must
        run on the device BEFORE the prefill])."""
        plan = self._plans[req.rid]
        if plan["state"] != "reserved":
            raise RuntimeError(
                f"request {req.rid} reservation in state "
                f"{plan['state']!r}")
        P = self.page_size
        n = int(len(ids))
        m = plan["matched"]
        # flip to active FIRST: if an allocation below fails mid-way,
        # abort_sequence()'s row walk unwinds exactly what was placed
        plan["state"] = "active"
        plan["slot"] = slot
        row = self.page_table[slot]
        row[:] = 0
        for j, node in enumerate(plan["nodes"]):
            row[j] = node.page
        copies: List[Tuple[int, int]] = []
        first_new = m // P
        if m % P:
            # mid-page divergence: the first tail write lands inside the
            # shared page, so copy it first (COW)
            src = int(row[first_new])
            dst = self._alloc_page(plan)
            copies.append((src, dst))
            row[first_new] = dst
            self._unref(src)
            self.cow_copies += 1
            first_new += 1
        for j in range(first_new, (n - 1) // P + 1):
            row[j] = self._alloc_page(plan)
        return m, copies

    def ensure_decode_page(self, slot: int, pos: int
                           ) -> Optional[Tuple[int, int]]:
        """Make position ``pos`` writable for this step's decode:
        allocate the page when the write crosses a page boundary, COW it
        if it is shared (defensive: the prefill's COW privatizes every
        page a request decodes into). Returns a (src, dst) device copy
        to run before the step, or None."""
        idx = pos // self.page_size
        row = self.page_table[slot]
        req = self.slots[slot]
        plan = self._plans.get(req.rid) if req is not None else None
        page = int(row[idx])
        if page == 0:
            row[idx] = self._alloc_page(plan)
            return None
        if self.refcnt[page] > 1 or page in self._node_of_page:
            dst = self._alloc_page(plan)
            row[idx] = dst
            self._unref(page)
            self.cow_copies += 1
            return (page, dst)
        return None

    def ensure_decode_range(self, slot: int, pos: int,
                            n: int) -> List[Tuple[int, int]]:
        """Make positions ``pos .. pos + n - 1`` writable for a
        speculative verify step: every page the range touches is
        allocated (or COW'd if shared) as :meth:`ensure_decode_page`
        does for the k=1 position. Returns the (src, dst) device copies
        to run before the step. The engine clamps ``n`` to the tokens
        the request may still emit, so the range stays inside the
        admission reservation."""
        copies: List[Tuple[int, int]] = []
        P = self.page_size
        for idx in range(pos // P, (pos + n - 1) // P + 1):
            c = self.ensure_decode_page(slot, max(pos, idx * P))
            if c is not None:
                copies.append(c)
        return copies

    def rollback_speculation(self, slot: int,
                             next_write_pos: int) -> int:
        """Return the pages a verify step allocated beyond what the
        accepted tokens need: every row page past the page holding
        ``next_write_pos`` goes back to the pool and its reservation
        budget is restored. Those pages can only hold rejected-draft
        k/v: shared and indexed prompt pages all lie at or below the
        next write position (matching stops at prompt_len - 1 <=
        next_write_pos). Returns the number of pages returned."""
        req = self.slots[slot]
        row = self.page_table[slot]
        plan = self._plans.get(req.rid) if req is not None else None
        freed = 0
        for j in range(next_write_pos // self.page_size + 1,
                       self.pages_per_slot):
            page = int(row[j])
            if page:
                row[j] = 0
                self._unref(page)
                freed += 1
        if freed and plan is not None:
            plan["allocated"] -= freed
            self._committed += freed
        return freed

    def release(self, slot: int) -> None:
        """Free the slot lease AND its pages: every referenced page drops
        a refcount (shared pages stay for their other readers, indexed
        pages stay CACHED at refcount 0), the unused tail of the
        reservation returns to the budget, and the table row is zeroed
        (-> trash) so a stale row never reaches the decode gather."""
        req = self.slots[slot]
        super().release(slot)
        row = self.page_table[slot]
        for j in range(self.pages_per_slot):
            if row[j]:
                self._unref(int(row[j]))
        row[:] = 0
        plan = self._plans.pop(req.rid, None)
        if plan is not None:
            self._committed -= plan["need_new"] - plan["allocated"]

    def abort_sequence(self, slot: int, req) -> None:
        """Unwind a failed prefill: the pages the slot row holds (and the
        reservation's remainder) are returned. The slot lease, if held,
        is left alone."""
        plan = self._plans.pop(req.rid, None)
        if plan is None:
            return
        row = self.page_table[slot]
        if plan["state"] == "active":
            for j in range(self.pages_per_slot):
                if row[j]:
                    self._unref(int(row[j]))
            row[:] = 0
        else:                               # still just a reservation
            for node in plan["nodes"]:
                self._unref(node.page)
        self._committed -= plan["need_new"] - plan["allocated"]
        # the requeued request will reserve (and count) again
        self.prefix_hit_tokens -= plan["hit_counted"]
        self.prefix_lookup_tokens -= plan["lookup_counted"]

    # -- introspection --------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "num_pages": self.num_pages - 1,     # usable (sans trash)
            "page_size": self.page_size,
            "pages_free": self.free_page_count(),
            "pages_active": self.active_page_count(),
            "pages_cached": self.cached_page_count(),
            "pages_committed": self._committed,
            "cow_copies": self.cow_copies,
            "pages_reclaimed": self.pages_reclaimed,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "kv_bytes": self.kv_bytes(),
        }
