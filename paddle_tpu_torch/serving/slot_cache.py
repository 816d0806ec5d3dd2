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
reservation.

With a host KV tier (``tier``, ``kv_tier.HostPageTier``) the reclaim
DEMOTES a cold refcount-0 prefix page instead of destroying it: its
payload goes to host RAM (and the persistent store under it, if any) and
its radix node stays, marked as a host node, so a later prompt still
matches it. ``try_reserve`` pins the matched host keys and counts one
fresh device page for each; ``begin_sequence`` allocates those pages and
plans the promotions, which the engine installs (``begin_promotions``,
the H2D copy, ``commit_promotions``) before the extend runs. A fresh
cache rebuilds host nodes for every key the tier holds
(``_rehydrate``), so warm prefixes survive ``recover()`` and restarts.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..resilience.faults import maybe_fail

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
    holding its k/v (``_HOST`` for a page demoted to the host tier). The
    path from the root IS the key: a node's page is only valid given
    every ancestor matched first."""

    __slots__ = ("chunk", "page", "parent", "children", "lru")

    def __init__(self, chunk: Tuple[int, ...], page: int, parent):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.lru = 0


# page id of a radix node whose payload lives in the host tier
# (serving/kv_tier.py) instead of the device pool: it holds no device
# page and is absent from _node_of_page until promoted back
_HOST = -1


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: page-locked when ``t`` is on the card (the
    copy completes before this returns), a clone on the CPU."""
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


class PagedKVCache(_SlotTable):
    """Block-paged KV pool with COW prefix sharing and optional int8
    storage (see module docstring). ``num_pages`` INCLUDES the reserved
    trash page 0; None means capacity parity with the contiguous pool
    (``max_slots * max_len / page_size + 1``). ``pools`` (the ``(ks,
    vs, kss, vss)`` lists of a cache of the same geometry) takes those
    device pools over instead of allocating new ones, with fresh host
    state (free list, refcounts, page table, prefix index). ``tier`` (a
    ``kv_tier.HostPageTier``, which outlives the cache) receives cold
    pages instead of the reclaim destroying them; a fresh cache rebuilds
    host nodes for every key the tier holds."""

    def __init__(self, num_layers: int, max_slots: int, max_len: int,
                 kv_heads: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device, page_size: int = 128,
                 num_pages: Optional[int] = None, quant: bool = False,
                 prefix_sharing: bool = True, pools=None, tier=None):
        _validate_geometry(num_layers, max_slots, max_len, kv_heads,
                           head_dim)
        if tier is not None and not prefix_sharing:
            raise ValueError(
                "the host KV tier keys pages by their radix chunk: it "
                "requires prefix_sharing=True")
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
        # the host/disk tier: _reclaim_one DEMOTES cold refcount-0 index
        # pages into it; a radix hit on a demoted chunk places a freshly
        # allocated device page in the row and records a PROMOTION the
        # engine installs before the extend runs. A demoted node stays in
        # the tree with page == _HOST (and out of _node_of_page), so the
        # device accounting law (free + cached == num_pages - 1) is
        # untouched by tiering
        self.tier = tier
        self.demotions = 0
        self.promotions = 0
        self.prefix_hit_tokens_host = 0
        self.prefix_hit_tokens_disk = 0
        if tier is not None:
            # the tier OUTLIVES caches (recover() rebuilds the host
            # state, warm prefixes survive): rebind the unlink callback,
            # drop the pins the dead cache's plans held, then rebuild
            # host nodes for every still-resident key
            tier.on_evict = self._drop_host_key
            tier.reset_pins()
            self._rehydrate()

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

    # -- host/disk tier -------------------------------------------------
    @staticmethod
    def _node_key(node: _PrefixNode) -> Tuple[int, ...]:
        """The tier key of a radix node: the full token path from the
        root (the path IS the identity of a prefix page)."""
        chunks = []
        while node.parent is not None:
            chunks.append(node.chunk)
            node = node.parent
        out: List[int] = []
        for c in reversed(chunks):
            out.extend(c)
        return tuple(out)

    def _read_page_payload(self, page: int) -> Dict[str, torch.Tensor]:
        """Device -> host copy of one page across every layer pool (the
        demotion payload: k/v blocks plus int8 scales), into page-locked
        buffers on the card; the copy completes before this returns."""
        k = torch.stack([p[page] for p in self.ks])
        v = torch.stack([p[page] for p in self.vs])
        if self.quant:
            ks = torch.stack([p[page] for p in self.kss])
            vs = torch.stack([p[page] for p in self.vss])
        else:
            ks = vs = torch.zeros((0,), dtype=torch.float32)
        return {"k": _to_host(k), "v": _to_host(v), "ks": _to_host(ks),
                "vs": _to_host(vs)}

    def _unlink_subtree(self, top: _PrefixNode) -> None:
        """Drop ``top`` and every descendant from the index: device
        descendants free now if unreferenced (or on release otherwise),
        host descendants leave the tier with their node (a host payload
        is meaningless once its chain is gone)."""
        top.parent.children.pop(top.chunk, None)
        stack = [top]
        while stack:
            nd = stack.pop()
            if nd.page >= 0:
                self._node_of_page.pop(nd.page, None)
                if self.refcnt[nd.page] == 0:
                    self._cached -= 1       # cached -> free
                    self._free_pages.append(nd.page)
                    self.pages_reclaimed += 1
            elif self.tier is not None:
                self.tier.drop(self._node_key(nd))
            stack.extend(nd.children.values())
            nd.children = {}

    def _drop_host_key(self, key) -> None:
        """Tier eviction callback: the tier is shedding ``key`` entirely
        (no disk copy), so unlink the radix subtree it anchors (a host
        node without tier data would promote garbage). No-op when the
        key no longer resolves to a host node."""
        key = tuple(int(t) for t in key)
        P = self.page_size
        node = self._root
        for j in range(0, len(key), P):
            node = node.children.get(key[j:j + P])
            if node is None:
                return
        if node.page < 0:
            self._unlink_subtree(node)

    def _rehydrate(self) -> None:
        """Rebuild host radix nodes from the tier on a FRESH cache (init,
        recover, restart): every resident key whose whole ancestor chain
        is also resident becomes a host node; orphan keys (an ancestor
        chunk was never demoted, or died with the old pool) are dropped
        from the tier: a chain with a gap can never be matched, and a
        resident key with no node is the orphaned-host-buffer leak the
        invariants audit forbids."""
        P = self.page_size
        keys = sorted(self.tier.keys(), key=len)
        resident = set(keys)
        for key in keys:
            if len(key) == 0 or len(key) % P:
                self.tier.drop(key)
                continue
            if any(key[:j] not in resident for j in range(P, len(key), P)):
                self.tier.drop(key)
                resident.discard(key)
                continue
            node = self._root
            for j in range(0, len(key), P):
                chunk = key[j:j + P]
                child = node.children.get(chunk)
                if child is None:
                    child = _PrefixNode(chunk, _HOST, node)
                    node.children[chunk] = child
                node = child

    def _demote(self, victim: _PrefixNode) -> bool:
        """Move one cold refcount-0 indexed page into the host tier: read
        its payload off the device, hand it to the tier keyed by its
        radix path, then free the device page. The node stays in the
        tree as a HOST node, so later prompts still match it (and
        promote it back). The ``serving.kv.demote`` fault point fires
        BEFORE any state mutates: a raise leaves both tiers exactly as
        they were. Returns False when the tier refuses the entry (RAM
        full of unevictable keys, no disk underneath); the caller falls
        back to the destroy path."""
        key = self._node_key(victim)
        payload = self._read_page_payload(victim.page)
        maybe_fail("serving.kv.demote", page=victim.page, tokens=len(key))
        if not self.tier.put(key, payload):
            return False
        page = victim.page
        self._node_of_page.pop(page, None)
        self._cached -= 1                   # cached -> free
        self._free_pages.append(page)
        victim.page = _HOST
        self.demotions += 1
        return True

    def park_in_tier(self) -> int:
        """Copy every device-resident page of the prefix index into the
        tier (deepest first, so a bounded tier that must evict keeps the
        shallow part of each chain), before a fresh cache is built over
        the same pools: it rehydrates them as host nodes, so a request
        whose admission matched them, or promoted them, matches and
        promotes them again. Indexed pages are immutable, so their bits
        are the ones the index served. Each page parked is one blocking
        D2H copy, written through to the store when the tier has one
        (so the store then holds pages no demotion wrote). Returns the
        pages parked."""
        nodes, stack = [], list(self._root.children.values())
        while stack:
            nd = stack.pop()
            nodes.append((self._node_key(nd), nd))
            stack.extend(nd.children.values())
        parked = 0
        for key, nd in sorted(nodes, key=lambda kn: -len(kn[0])):
            if nd.page >= 0 and not self.tier.has(key) \
                    and self.tier.put(key, self._read_page_payload(nd.page)):
                parked += 1
        return parked

    def _match_prefix(self, ids: np.ndarray, limit: Optional[int] = None):
        """Longest shared prefix of ``ids`` in the index. Matching stops
        at ``len(ids) - 1``: the LAST prompt token is always recomputed
        so the prefill has logits to sample from (and at ``limit``
        tokens, if given). Returns (matched_len, [(node, "dev"|"host")],
        deepest full-page node): "host" entries are demoted pages the
        engine must promote back before the extend; a trailing partial
        match (the first divergent page) is COW'd by the first write, so
        it must be on the device (host children are skipped there)."""
        matchable = ids[:-1][:limit]
        P = self.page_size
        node = self._root
        entries: List[Tuple[_PrefixNode, str]] = []
        key: Tuple[int, ...] = ()
        m = 0
        while m + P <= len(matchable):
            chunk = tuple(int(t) for t in matchable[m:m + P])
            child = node.children.get(chunk)
            if child is None:
                break
            key = key + chunk
            if child.page < 0:
                if self.tier is None or not self.tier.has(key):
                    # the tier lost the payload (a torn disk entry): a
                    # host node without data can never be promoted
                    self._unlink_subtree(child)
                    break
                entries.append((child, "host"))
            else:
                entries.append((child, "dev"))
            node = child
            self._touch(node)
            m += P
        # partial match into the first DIVERGENT page: the prompt may
        # run out mid-page, or diverge mid-page from every indexed
        # chunk; the longest common prefix of the page is shareable
        # (COW privatizes it on the first write). Host children are not
        # COW sources (the copy reads the device pool)
        want = [int(t) for t in matchable[m:m + P]]
        if want:
            best, best_child = 0, None
            for chunk, child in node.children.items():
                if child.page < 0:
                    continue
                common = 0
                for a, b in zip(chunk, want):
                    if a != b:
                        break
                    common += 1
                if common > best:
                    best, best_child = common, child
            if best_child is not None:
                self._touch(best_child)
                entries.append((best_child, "dev"))
                m += best
        # the hit/lookup counters move in try_reserve, only when the
        # reservation COMMITS: a blocked queue head is claimed again
        # every step and must not inflate the hit rate
        return m, entries, node

    def probe_prefix(self, ids) -> int:
        """Read-only twin of ``_match_prefix``: how many prompt tokens
        are warm in this pool's index now. No LRU touch, no unlink of a
        dataless host node, no counters (a dataless host node simply
        stops the walk; the next real match repairs it)."""
        if not self.prefix_sharing:
            return 0
        ids = np.asarray(ids)
        if len(ids) < 2:
            return 0
        matchable = ids[:-1]
        P = self.page_size
        node = self._root
        key: Tuple[int, ...] = ()
        m = 0
        while m + P <= len(matchable):
            chunk = tuple(int(t) for t in matchable[m:m + P])
            child = node.children.get(chunk)
            if child is None:
                break
            key = key + chunk
            if child.page < 0 \
                    and (self.tier is None or not self.tier.has(key)):
                break
            node = child
            m += P
        want = [int(t) for t in matchable[m:m + P]]
        if want:
            best = 0
            for chunk, child in node.children.items():
                if child.page < 0:
                    continue
                common = 0
                for a, b in zip(chunk, want):
                    if a != b:
                        break
                    common += 1
                best = max(best, common)
            m += best
        return m

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
            elif child.page < 0:
                # a HOST node for a chunk this slot just prefilled on the
                # device (e.g. the prompt's final full page, which
                # matching skips): adopt the fresh device page, so the
                # index serves it without a promotion, and shed the RAM
                # copy (a disk copy stays warm for restarts)
                page = int(row[i])
                if page == 0 or page in self._node_of_page:
                    break
                child.page = page
                self._node_of_page[page] = child
                if self.tier is not None:
                    self.tier.drop_ram(self._node_key(child))
            node = child
            self._touch(node)

    def _reclaim_one(self) -> bool:
        """Free at least one cached page. With a host tier, the LRU
        refcount-0 indexed page is DEMOTED: its payload moves to host
        RAM (write-through to the disk store when there is one) and the
        node stays matchable; the subtree survives. Without a tier (or
        when the tier refuses the entry), the LRU refcount-0 subtree is
        dropped from the index; its pages free now if unreferenced, or
        on release otherwise. The victim itself is refcount-0, so one
        pass always frees at least its page. Trash page 0 is never in
        the index, so it is never a victim."""
        candidates = [n for n in self._node_of_page.values()
                      if self.refcnt[n.page] == 0]
        if not candidates:
            return False
        victim = min(candidates, key=lambda n: n.lru)
        if self.tier is not None and self._demote(victim):
            return True
        self._unlink_subtree(victim)
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

    def _pin_entries(self, entries) -> List[Tuple[int, ...]]:
        """Reference the matched device pages and pin the matched host
        keys (neither a pinned key nor an ancestor may be evicted while
        a promotion plan depends on the chain); returns the pinned
        keys."""
        host_pins = []
        for node, kind in entries:
            if kind == "dev":
                self._ref(node.page)
            else:
                key = self._node_key(node)
                self.tier.pin(key)
                host_pins.append(key)
        return host_pins

    def _unpin_entries(self, entries, host_pins) -> None:
        for node, kind in entries:
            if kind == "dev":
                self._unref(node.page)
        for key in host_pins:
            self.tier.unpin(key)

    def try_reserve(self, req, ids: np.ndarray, total_len: int,
                    share_limit: Optional[int] = None) -> bool:
        """Admission gate: match the prompt against the prefix index
        (at most ``share_limit`` tokens, if given), pin the matched
        pages and host keys, and reserve the worst-case number of NEW
        pages this request can touch (its span less its fully shared
        pages; a partially shared page counts as new, its COW copy needs
        one; so does each host page, promoted into a fresh device page).
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
            matched, entries, _ = self._match_prefix(ids, share_limit)
        else:
            matched, entries = 0, []
        host_pins = self._pin_entries(entries)
        # host-matched pages cost no recompute (the prefill tail shrinks
        # by their tokens) but each promotion lands in a freshly
        # allocated device page, so they count as new
        need_new = self.page_span(total_len) - matched // self.page_size \
            + len(host_pins)
        # strict check AFTER pinning: matched cached pages are no longer
        # reclaimable, so they cannot back the new allocations
        if need_new > self.usable_pages() - self._committed:
            self._unpin_entries(entries, host_pins)
            return False
        self._committed += need_new
        lookup = max(0, int(len(ids)) - 1) if self.prefix_sharing else 0
        self.prefix_lookup_tokens += lookup
        self.prefix_hit_tokens += matched
        self._plans[req.rid] = {
            "state": "reserved", "matched": matched,
            "entries": list(entries), "need_new": need_new,
            "allocated": 0, "slot": None, "total_len": int(total_len),
            # tier keys this plan pinned: released exactly once, by
            # commit_promotions or the cancel/abort/release unwind
            "host_pins": host_pins, "promote": [],
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
        only see now. Each extra matched page shrinks the reservation by
        one and adds at most one promotion, so a longer match never
        grows it."""
        plan = self._plans.get(req.rid)
        if plan is None or plan["state"] != "reserved" \
                or not self.prefix_sharing:
            return
        matched, entries, _ = self._match_prefix(ids, share_limit)
        if matched <= plan["matched"]:
            return
        host_pins = self._pin_entries(entries)
        self._unpin_entries(plan["entries"], plan["host_pins"])
        need_new = self.page_span(plan["total_len"]) \
            - matched // self.page_size + len(host_pins)
        self._committed += need_new - plan["need_new"]
        self.prefix_hit_tokens += matched - plan["matched"]
        plan["hit_counted"] += matched - plan["matched"]
        plan.update(matched=matched, entries=list(entries),
                    need_new=need_new, host_pins=host_pins)

    def cancel_reservation(self, req) -> None:
        """Drop an unconsumed reservation (a failed admission batch: the
        request goes back to the queue). No-op once the request holds
        pages in a slot: release() / abort_sequence() handle that."""
        plan = self._plans.get(req.rid)
        if plan is None or plan["state"] != "reserved":
            return
        self._unpin_entries(plan["entries"], plan["host_pins"])
        self._committed -= plan["need_new"]
        self.prefix_hit_tokens -= plan["hit_counted"]
        self.prefix_lookup_tokens -= plan["lookup_counted"]
        del self._plans[req.rid]

    # -- sequence lifecycle ---------------------------------------------
    def begin_sequence(self, slot: int, req, ids: np.ndarray
                       ) -> Tuple[int, List[Tuple[int, int]]]:
        """Consume the request's reservation into slot state: point the
        page table at the matched shared pages, allocate a fresh page for
        each matched host page (the promotion ``begin_promotions``
        plans), COW the partially shared page (if any), and allocate
        fresh pages for the prefill tail. Returns (matched_len, [(src,
        dst) page copies the engine must run on the device BEFORE the
        prefill])."""
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
        # device entries FIRST: once a page sits in the row, the abort's
        # row walk unwinds its ref, so a failed host-dst allocation
        # below cannot strand a reserve-time ref
        host_slots: List[Tuple[int, _PrefixNode]] = []
        for j, (node, kind) in enumerate(plan["entries"]):
            if kind == "dev":
                row[j] = node.page
            else:
                host_slots.append((j, node))
        promote: List[Tuple[_PrefixNode, int]] = []
        for j, node in host_slots:
            dst = self._alloc_page(plan)
            row[j] = dst
            promote.append((node, dst))
        plan["promote"] = promote
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

    def begin_promotions(self, req) -> List[tuple]:
        """The payloads of this request's planned promotions: for each
        (node, dst) pair from begin_sequence, the page data the engine
        must install into ``dst`` before the extend. Returns [(node,
        dst, payload, tier_label)]. A node another request promoted first
        (page >= 0 now) is read back from the DEVICE: dst then holds a
        private copy and the pin is simply released at commit. A payload
        the tier lost (a torn disk file) is unrecoverable: the dead
        chain is unlinked and the request must requeue (the raise
        unwinds through abort_sequence, so nothing leaks)."""
        plan = self._plans[req.rid]
        out = []
        for node, dst in plan["promote"]:
            if node.page >= 0:
                out.append((node, dst, self._read_page_payload(node.page),
                            "dev"))
                continue
            key = self._node_key(node)
            label = self.tier.where(key) or "host"
            payload = self.tier.get(key)
            if payload is None:
                self._drop_host_key(key)
                raise RuntimeError(
                    f"host tier lost chunk for request {req.rid} "
                    f"({len(key)} tokens) mid-promotion: chain dropped, "
                    f"request must requeue")
            out.append((node, dst, payload, label))
        return out

    def commit_promotions(self, req, work) -> None:
        """The engine installed every promoted payload on the device:
        flip host nodes to device pages (adopting ``dst`` into the
        index), count the tier-labelled prefix hits, and release the
        promotion pins. Nodes that raced to the device keep ``dst`` as a
        private page (freed by release like any allocated page). RAM
        copies of adopted keys are dropped (the device page is now
        authoritative; a disk copy stays warm for restarts)."""
        plan = self._plans[req.rid]
        for node, dst, _payload, label in work:
            self.promotions += 1
            if label == "host":
                self.prefix_hit_tokens_host += self.page_size
            elif label == "disk":
                self.prefix_hit_tokens_disk += self.page_size
            if node.page < 0:
                node.page = dst
                self._node_of_page[dst] = node
                self.tier.drop_ram(self._node_key(node))
        for key in plan["host_pins"]:
            self.tier.unpin(key)
        plan["host_pins"] = []
        plan["promote"] = []

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
            for key in plan["host_pins"]:    # normally empty after
                self.tier.unpin(key)         # commit_promotions

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
            self._unpin_entries((), plan["host_pins"])
        else:                               # still just a reservation
            self._unpin_entries(plan["entries"], plan["host_pins"])
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
            "pages_host": (self.tier.host_page_count()
                           if self.tier is not None else 0),
            "demotions": self.demotions,
            "promotions": self.promotions,
            "prefix_hit_tokens_host": self.prefix_hit_tokens_host,
            "prefix_hit_tokens_disk": self.prefix_hit_tokens_disk,
        }
