"""Per-engine serving metrics: tokens/s, TTFT, queue wait, per-token
latency percentiles, slot occupancy, steps, and the draft
proposals' seconds of a speculative engine.

Counterpart of ``paddle_tpu/serving/metrics.py`` ``EngineMetrics``. The
clock is injectable (``time_fn``) so tests can assert exact
accounting with a fake clock. Every hook also publishes to the
``ptpu_serving_*`` families of the observability registry
(``registry``, the process default unless given): request and token
counters, and the TTFT, inter-token, queue-wait, decode-stall, draft
and KV-promotion-wait histograms. Per-request state is dropped when a request
finishes; the percentile pools are rolling windows of the last
``window`` observations.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["EngineMetrics"]


class _ReqStats:
    __slots__ = ("t_submit", "t_first", "t_prefill", "t_last_token",
                 "stalled", "phase")

    def __init__(self, t_submit: float, stalled: bool = False):
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        self.t_prefill: Optional[float] = None
        self.t_last_token: Optional[float] = None
        # submitted while the engine already had work in flight: its
        # first token may have waited behind other requests' prefills
        # (the decode-stall histogram's population)
        self.stalled = stalled
        # the last lifecycle phase seen for this request
        self.phase = "queue"


class EngineMetrics:
    def __init__(self, max_slots: int,
                 time_fn: Callable[[], float] = time.perf_counter,
                 registry=None, window: int = 65536):
        self.max_slots = max_slots
        self.now = time_fn
        self._reqs: Dict[int, _ReqStats] = {}      # in-flight only
        self._n_requests = 0
        self._n_tokens = 0
        self._n_steps = 0
        self._occ_sum = 0
        self._window = window
        self._ttft: deque = deque(maxlen=window)
        self._qwait: deque = deque(maxlen=window)
        self._gaps: deque = deque(maxlen=window)
        self._draft: deque = deque(maxlen=window)
        self._promo: deque = deque(maxlen=window)
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        if registry is None:
            from ..observability import default_registry
            registry = default_registry()
        self._m_requests = registry.counter(
            "ptpu_serving_requests_total", "requests submitted")
        self._m_tokens = registry.counter(
            "ptpu_serving_tokens_total", "tokens emitted")
        self._m_ttft = registry.histogram(
            "ptpu_serving_ttft_seconds",
            "submit-to-first-token latency")
        self._m_gap = registry.histogram(
            "ptpu_serving_inter_token_seconds",
            "gap between consecutive tokens of one request")
        self._m_queue_wait = registry.histogram(
            "ptpu_serving_queue_wait_seconds",
            "submit-to-first-prefill wait (scheduler queueing, "
            "prefill compute excluded)")
        self._m_stall = registry.histogram(
            "ptpu_serving_decode_stall_seconds",
            "submit-to-first-token gap for requests submitted while "
            "other work was in flight (decode blocked behind prefills)")
        self._m_draft = registry.histogram(
            "ptpu_serving_spec_draft_seconds",
            "wall time spent proposing one row's speculative draft "
            "(the spec_draft SLO phase: n-gram lookup or draft-model "
            "forwards, billed separately from verify compute)")
        self._m_promo = registry.histogram(
            "ptpu_kv_promotion_wait_seconds",
            "host/disk -> device KV page promotion wall time per "
            "request (tier fetch + H2D + install, to completion)")

    # -- event hooks (the engine calls these) --------------------------
    def on_submit(self, rid: int, stalled: bool = False) -> None:
        t = self.now()
        self._reqs[rid] = _ReqStats(t, stalled=stalled)
        self._n_requests += 1
        self._m_requests.inc()
        if self._t0 is None:
            self._t0 = t
        self._t_last = t

    def on_first_prefill(self, rid: int) -> None:
        """The request leaves the queue: its prefill starts."""
        r = self._reqs[rid]
        r.phase = "prefill"
        if r.t_prefill is None:
            r.t_prefill = self.now()
            w = r.t_prefill - r.t_submit
            self._qwait.append(w)
            self._m_queue_wait.observe(w)

    def on_token(self, rid: int) -> None:
        t = self.now()
        r = self._reqs[rid]
        r.phase = "decode"
        if r.t_first is None:
            r.t_first = t
            self._ttft.append(t - r.t_submit)
            self._m_ttft.observe(t - r.t_submit)
            if r.stalled:
                self._m_stall.observe(t - r.t_submit)
        else:
            gap = t - r.t_last_token
            self._gaps.append(gap)
            self._m_gap.observe(gap)
        r.t_last_token = t
        self._n_tokens += 1
        self._m_tokens.inc()
        self._t_last = t

    def on_promotion_start(self, rid: int) -> None:
        """The request's prefill is about to install demoted KV pages on
        the device: only its phase moves (``kv_promotion``), so a
        request lost before ``on_promotion`` is attributed there."""
        r = self._reqs.get(rid)
        if r is not None:
            r.phase = "kv_promotion"

    def on_promotion(self, rid: int, wait_s: float) -> None:
        """One request's promotion completed: the wall time its prefill
        spent installing demoted pages on the device."""
        r = self._reqs.get(rid)
        if r is not None:
            r.phase = "prefill"
        self._promo.append(wait_s)
        self._m_promo.observe(wait_s)

    def on_draft(self, wait_s: float) -> None:
        """One row's draft proposal completed (or failed): its wall
        time, the cost side of speculation (``spec_draft_s``)."""
        self._draft.append(wait_s)
        self._m_draft.observe(wait_s)

    def on_step(self, active_slots: int) -> None:
        self._n_steps += 1
        self._occ_sum += active_slots
        self._t_last = self.now()

    def on_finished(self, rid: int) -> None:
        self._reqs.pop(rid, None)

    # -- read surface ---------------------------------------------------
    def snapshot_windows(self) -> Dict[str, object]:
        """Copies of the rolling percentile windows (newest last) and
        their bound (``window``): exact until traffic exceeds it,
        recent-biased after."""
        return {
            "ttft": tuple(self._ttft),
            "queue_wait": tuple(self._qwait),
            "inter_token": tuple(self._gaps),
            "promotion_wait": tuple(self._promo),
            "spec_draft": tuple(self._draft),
            "window": self._window,
        }

    def inflight_phases(self) -> Dict[int, Dict[str, object]]:
        """Per-request last-seen phase and age for every request this
        ledger still holds in flight (``on_finished`` not yet called);
        diffed against ``ServingEngine.inflight_rids()`` it names a
        request some failure path dropped."""
        now = self.now()
        return {rid: {"phase": r.phase,
                      "age_s": now - r.t_submit}
                for rid, r in self._reqs.items()}

    # -- aggregation ---------------------------------------------------
    def summary(self) -> Dict[str, float]:
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)
        pct = lambda xs, q: float(np.percentile(list(xs), q)) \
            if xs else 0.0
        return {
            "requests": self._n_requests,
            "total_tokens": self._n_tokens,
            "wall_s": wall,
            "tokens_per_s": self._n_tokens / wall if wall > 0 else 0.0,
            "ttft_p50_s": pct(self._ttft, 50),
            "ttft_p99_s": pct(self._ttft, 99),
            "queue_wait_p50_s": pct(self._qwait, 50),
            "queue_wait_p99_s": pct(self._qwait, 99),
            "tok_latency_p50_s": pct(self._gaps, 50),
            "tok_latency_p99_s": pct(self._gaps, 99),
            "promotion_wait_p99_s": pct(self._promo, 99),
            "spec_draft_s": float(sum(self._draft)),
            "occupancy_mean": (self._occ_sum / self._n_steps
                               / self.max_slots
                               if self._n_steps else 0.0),
            "steps": self._n_steps,
        }
