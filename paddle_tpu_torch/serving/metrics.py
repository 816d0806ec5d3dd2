"""Per-engine serving metrics: tokens/s, TTFT, queue wait, per-token
latency percentiles, slot occupancy, steps, and the draft
proposals' seconds of a speculative engine.

Counterpart of ``paddle_tpu/serving/metrics.py`` ``EngineMetrics``
without the bridge to the observability registry (that comes with the
observability slice). The clock is injectable (``time_fn``) so tests
can assert exact accounting with a fake clock. Per-request state is
dropped when a request finishes; the percentile pools are rolling
windows of the last ``window`` observations.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["EngineMetrics"]


class _ReqStats:
    __slots__ = ("t_submit", "t_first", "t_prefill", "t_last_token")

    def __init__(self, t_submit: float):
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        self.t_prefill: Optional[float] = None
        self.t_last_token: Optional[float] = None


class EngineMetrics:
    def __init__(self, max_slots: int,
                 time_fn: Callable[[], float] = time.perf_counter,
                 window: int = 65536):
        self.max_slots = max_slots
        self.now = time_fn
        self._reqs: Dict[int, _ReqStats] = {}      # in-flight only
        self._n_requests = 0
        self._n_tokens = 0
        self._n_steps = 0
        self._occ_sum = 0
        self._ttft: deque = deque(maxlen=window)
        self._qwait: deque = deque(maxlen=window)
        self._gaps: deque = deque(maxlen=window)
        self._draft: deque = deque(maxlen=window)
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- event hooks (the engine calls these) --------------------------
    def on_submit(self, rid: int) -> None:
        t = self.now()
        self._reqs[rid] = _ReqStats(t)
        self._n_requests += 1
        if self._t0 is None:
            self._t0 = t
        self._t_last = t

    def on_first_prefill(self, rid: int) -> None:
        """The request leaves the queue: its prefill starts."""
        r = self._reqs[rid]
        if r.t_prefill is None:
            r.t_prefill = self.now()
            self._qwait.append(r.t_prefill - r.t_submit)

    def on_token(self, rid: int) -> None:
        t = self.now()
        r = self._reqs[rid]
        if r.t_first is None:
            r.t_first = t
            self._ttft.append(t - r.t_submit)
        else:
            self._gaps.append(t - r.t_last_token)
        r.t_last_token = t
        self._n_tokens += 1
        self._t_last = t

    def on_draft(self, wait_s: float) -> None:
        """One row's draft proposal completed (or failed): its wall
        time, the cost side of speculation (``spec_draft_s``)."""
        self._draft.append(wait_s)

    def on_step(self, active_slots: int) -> None:
        self._n_steps += 1
        self._occ_sum += active_slots
        self._t_last = self.now()

    def on_finished(self, rid: int) -> None:
        self._reqs.pop(rid, None)

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
            "spec_draft_s": float(sum(self._draft)),
            "occupancy_mean": (self._occ_sum / self._n_steps
                               / self.max_slots
                               if self._n_steps else 0.0),
            "steps": self._n_steps,
        }
