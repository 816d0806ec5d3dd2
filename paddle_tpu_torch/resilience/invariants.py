"""The serving engine's conservation laws: every request delivered
exactly once, greedy tokens a prefix of the uninjected run's, and no
leaked engine state or page.

Counterpart of ``paddle_tpu/resilience/invariants.py``
``ConservationLedger`` (:74-160), ``token_prefix_violations``
(:219-253), ``engine_leak_violations`` (:255, with its chunked-prefill
and staged-promotion halves but not the disaggregated-mesh half, whose
slice brings it) and ``page_leak_violations`` (:329, with the host-tier
half). A copy, not an import:
the port never imports the reference package.

Checkers return a list of violation strings (empty = the law holds), so
one run reports every broken law at once; ``ConservationLedger.check()``
raises :class:`InvariantViolation` for direct test use.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = ["InvariantViolation", "ConservationLedger",
           "token_prefix_violations", "engine_leak_violations",
           "page_leak_violations"]


class InvariantViolation(AssertionError):
    """A conservation law broke; the message lists every violation."""

    def __init__(self, violations: Sequence[str]):
        self.violations = list(violations)
        super().__init__(
            f"{len(self.violations)} invariant violation(s):\n  - "
            + "\n  - ".join(self.violations))


class ConservationLedger:
    """Double-entry accounting for serving requests.

    Plug into the engine (``ServingEngine(..., auditor=ledger)``): the
    engine calls :meth:`on_submitted` once per accepted ``submit()``
    and :meth:`on_delivered` each time a request surfaces at an
    external boundary (``step`` / ``recover`` / ``drain`` / ``cancel``;
    the step() calls inside drain() are not boundaries).
    :meth:`violations` then audits the books: every submission has
    exactly one delivery, every delivery a submission, and every
    delivered request a terminal state. A front door may also report
    its attempts and typed rejections (:meth:`on_attempt`,
    :meth:`on_rejected`): each attempt then needs exactly one outcome.
    """

    def __init__(self):
        self.submitted: Dict[int, object] = {}        # rid -> Request
        self.delivered: Dict[int, List[str]] = {}     # rid -> [via...]
        self.attempts = 0
        self.rejected: List[Tuple[str, str]] = []   # (tenant, reason)

    # -- hooks (the engine calls these) --------------------------------
    def on_attempt(self) -> None:
        self.attempts += 1

    def on_rejected(self, tenant: str = "", reason: str = "") -> None:
        self.rejected.append((tenant, reason))

    def on_submitted(self, req) -> None:
        if req.rid in self.submitted:
            # recorded as a delivery-side anomaly at audit time
            self.delivered.setdefault(req.rid, []).append("resubmit!")
        self.submitted[req.rid] = req

    def on_delivered(self, req, via: str = "step") -> None:
        self.delivered.setdefault(req.rid, []).append(via)

    # -- audit ---------------------------------------------------------
    def violations(self) -> List[str]:
        out = []
        for rid, req in sorted(self.submitted.items()):
            vias = self.delivered.get(rid, [])
            if not vias:
                out.append(
                    f"request {rid} LOST: submitted, reached "
                    f"finished={req.finished} "
                    f"reason={req.finish_reason!r}, never delivered")
            elif len(vias) > 1:
                out.append(
                    f"request {rid} DELIVERED {len(vias)} times "
                    f"(via {vias})")
            if vias and not req.finished:
                out.append(
                    f"request {rid} delivered via {vias} but not in a "
                    f"terminal state (finished=False)")
            if vias and req.finished and req.finish_reason is None:
                out.append(
                    f"request {rid} finished without a finish_reason")
        for rid, vias in sorted(self.delivered.items()):
            if rid not in self.submitted:
                out.append(
                    f"request {rid} delivered via {vias} but never "
                    f"submitted (phantom)")
        if self.attempts:
            outcomes = len(self.submitted) + len(self.rejected)
            if outcomes != self.attempts:
                out.append(
                    f"front door saw {self.attempts} attempts but "
                    f"recorded {len(self.submitted)} accepts + "
                    f"{len(self.rejected)} rejects = {outcomes} "
                    f"outcomes (a request LOST — vanished at the "
                    f"boundary without an audited accept or reject)")
        return out

    def check(self) -> None:
        v = self.violations()
        if v:
            raise InvariantViolation(v)


def token_prefix_violations(
        pairs: Iterable[Tuple[object, Sequence[int]]]) -> List[str]:
    """Greedy token identity against the uninjected run.

    ``pairs`` yields ``(request, reference_tokens)``, the reference
    being the clean greedy generation of the same prompt, at least as
    long as the request could have produced. A request finished by
    ``length``/``eos`` must match it over its whole output; a cancelled
    or expired one may stop early, but every token it did deliver must
    match (greedy token t depends only on the prefix, so a recovery's
    re-prefill must reproduce it)."""
    out = []
    for req, ref in pairs:
        got = list(req.out_tokens)
        if len(got) > len(ref):
            out.append(
                f"request {req.rid} emitted {len(got)} tokens, "
                f"reference replay has only {len(ref)}")
            continue
        if got != list(ref[:len(got)]):
            out.append(
                f"request {req.rid} tokens diverged from the "
                f"uninjected replay: got {got}, want "
                f"{list(ref[:len(got)])} "
                f"(reason={req.finish_reason!r})")
        if req.finish_reason == "length" \
                and len(got) != req.max_new_tokens:
            out.append(
                f"request {req.rid} finished 'length' with "
                f"{len(got)}/{req.max_new_tokens} tokens")
    return out


def engine_leak_violations(engine) -> List[str]:
    """A quiesced engine holds nothing: no leased slots, no queued
    requests, no undelivered terminal requests, no PREFILLING work (the
    chunk FIFO empty: every chunked admission finished its final chunk
    or was unwound), no request staged mid-promotion and, on a
    speculative engine, no draft-proposer state for
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
    if engine._undelivered:
        out.append(
            f"undelivered terminal requests "
            f"{[r.rid for r in engine._undelivered]}")
    if engine._chunk_fifo:
        out.append(
            f"leaked PREFILLING slots {list(engine._chunk_fifo)} in the "
            f"chunk FIFO (mid-prefill request neither finished nor "
            f"unwound)")
    # tiered-KV half: no request staged mid-promotion (dst pages
    # claimed, host payload not installed): every promotion commits or
    # unwinds through abort_sequence
    promos = getattr(engine, "_staged_promotions", None)
    if promos:
        out.append(
            f"staged KV promotions for rids {sorted(promos)} never "
            f"committed or unwound")
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
    eviction, a deadline, cancel) dropped a refcount on the floor. On a
    tiered cache, also: every promotion pin returned, every RAM-resident
    tier key anchored by a HOST radix node (an unanchored buffer is host
    memory nothing can promote or evict), and every HOST node backed by
    tier data (a dataless node would promote garbage).

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
    tier = getattr(cache, "tier", None)
    if tier is not None:
        pins = {k: c for k, c in tier.pin_counts().items() if c}
        if pins:
            out.append(
                f"leaked tier pins after quiesce: "
                f"{[(len(k), c) for k, c in sorted(pins.items())]} "
                f"(key_len, count)")
        host_keys = set()
        stack = [cache._root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd.page < 0:
                host_keys.add(cache._node_key(nd))
        orphans = [k for k in tier.ram_keys() if k not in host_keys]
        if orphans:
            out.append(
                f"orphaned host-tier buffers: {len(orphans)} RAM entries "
                f"(lens {sorted(len(k) for k in orphans)}) with no HOST "
                f"radix node anchoring them")
        dead = [k for k in host_keys if not tier.has(k)]
        if dead:
            out.append(
                f"dataless HOST radix nodes: {len(dead)} nodes (lens "
                f"{sorted(len(k) for k in dead)}) whose tier entry is "
                f"gone — a match would promote garbage")
    return out
