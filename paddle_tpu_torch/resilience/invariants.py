"""The serving engine's no-leak laws: the engine's own state and the
paged KV cache's pages.

Counterpart of ``paddle_tpu/resilience/invariants.py``
``engine_leak_violations`` (:255) and ``page_leak_violations`` (:329),
without the chunked-prefill, disaggregated-mesh and host-tier halves
(their slices bring them). A copy, not an import: the port never
imports the reference package.
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["engine_leak_violations", "page_leak_violations"]


def engine_leak_violations(engine) -> List[str]:
    """A quiesced engine holds nothing: no leased slots, no queued
    requests and, on a speculative engine, no draft-proposer state for
    a request no longer in a slot, in EVERY configured proposer (the
    tuner may have routed a request through either); the draft model's
    pool must not lease a slot to a gone request, and its free list
    and leases must add up to the pool (a leaked lease degrades
    drafting to k=1 silently, invisible to token identity)."""
    out = []
    active = engine.cache.active_slots()
    if active:
        out.append(
            f"leaked slots {active}: "
            f"{[engine.cache.slots[s].rid for s in active]}")
    queued = engine.scheduler.pending()
    if queued:
        out.append(f"leaked queue entries {[r.rid for r in queued]}")
    if engine.speculative:
        live = {engine.cache.slots[s].rid for s in active}
        for kind, prop in sorted(engine._proposers.items()):
            stale = [rid for rid in prop.tracked() if rid not in live]
            if stale:
                out.append(
                    f"leaked {kind} draft-proposer state for rids "
                    f"{stale} (request gone, proposer state still held)")
            if hasattr(prop, "leased_slots"):
                leased = prop.leased_slots()
                if len(set(leased)) != len(leased) \
                        or prop.free_slots() + len(leased) \
                        != prop.max_slots:
                    out.append(
                        f"draft pool accounting hole: {prop.free_slots()} "
                        f"free + leases {leased} != {prop.max_slots} "
                        f"slots")
    return out


def page_leak_violations(engine) -> List[str]:
    """Once an engine quiesces (drained, no active slots), every page
    refcount is back to zero: each page is on the free list or parked
    refcount-0 in the prefix index (cached), the reservation budget is
    fully returned, and no freed slot's page-table row still points at
    a page. A violation means some failure path (an aborted prefill,
    eviction, a deadline, cancel) dropped a refcount on the floor.

    Empty for a contiguous-pool engine."""
    if not getattr(engine, "paged", False):
        return []
    cache = engine.cache
    out = []
    referenced = np.nonzero(cache.refcnt[1:] > 0)[0] + 1
    if len(referenced):
        out.append(
            f"leaked page refcounts: pages {referenced.tolist()} held "
            f"{cache.refcnt[referenced].tolist()} refs after quiesce")
    if cache.committed_pages != 0:
        out.append(
            f"leaked page reservations: committed budget "
            f"{cache.committed_pages} != 0 after quiesce")
    if cache._plans:
        out.append(f"leaked admission plans for rids "
                   f"{sorted(cache._plans)}")
    exact_cached = sum(1 for n in cache._node_of_page.values()
                       if cache.refcnt[n.page] == 0)
    if exact_cached != cache.cached_page_count():
        out.append(
            f"cached-page counter drifted: maintained "
            f"{cache.cached_page_count()} != scanned {exact_cached}")
    accounted = cache.free_page_count() + exact_cached
    if accounted != cache.num_pages - 1:
        out.append(
            f"page accounting hole: free ({cache.free_page_count()}) + "
            f"cached ({exact_cached}) != {cache.num_pages - 1} usable "
            f"pages")
    rows = np.nonzero(cache.page_table.any(axis=1))[0]
    stale = [int(s) for s in rows if cache.slots[s] is None]
    if stale:
        out.append(
            f"freed slots {stale} still hold page-table entries "
            f"{[cache.page_table[s].tolist() for s in stale]}")
    return out
