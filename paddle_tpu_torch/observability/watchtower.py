"""Watchtower: the sensing layer over the serving telemetry.

Counterpart of ``paddle_tpu/observability/watchtower.py`` (a copy, not
an import: the port never imports the reference package). It consumes
what the registry, the engine metrics and the flight recorder emit:

- **Multi-window SLO burn rates.** Each :class:`SLOObjective` declares a
  latency threshold and a good-event target over a phase stream: a
  registry *histogram* family (TTFT, queue wait, step time, promotion
  wait) or a per-request *attribution* phase of a telemetry plane
  (``queue``, ``dispatch``, ``prefill``, ``decode``, ``handoff``,
  ``failover``, ``kv_promotion``; the cluster timeline that supplies
  those records comes with the serving fleet). Burn rate = (observed bad
  fraction) / (error budget); an incident requires BOTH the fast window
  (default 30 s) and the slow window (default 5 min) to exceed their
  thresholds. All windows run on the injectable clock (``time_fn``), so
  tests and the chaos band drive them on virtual timelines.

- **Anomaly detectors.** Each stream (step latency, queue depth,
  promotion wait, recompile count) feeds an EWMA detector and a robust
  median/MAD z-score detector; a sample must trip *both* to raise an
  incident. The ``recompiles`` stream reads the engine's
  ``trace_counts`` (XLA compiles in the reference); the eager port has
  no compiles and no ``trace_counts``, so that stream reads ``None`` and
  never trips. Monotonic progress is watched separately: an engine with
  queued or active work whose step counter stops advancing is
  **stalled**, a request the metrics ledger tracks that the engine no
  longer knows is **orphaned**, and a worker whose snapshot age exceeds
  the heartbeat bound is **silent** (with the replica-death detector,
  driven only by tests until the serving fleet exists).

- **Structured incidents.** A trip emits an :class:`Incident` carrying
  the dominant-phase attribution, the offending request ids, a
  flight-recorder excerpt and a trace excerpt, deduped by a stable
  fingerprint (kind + phase + source key) and counted in
  ``ptpu_incidents_total{kind,phase}``; ``healthz()``, ``to_json()`` and
  :func:`render_diagnosis` read them out.

Hot-path contract: ``observe_step()`` is ONE counter increment (no lock,
no clock read, no allocation, no profiler range) and ``poll()`` between
window boundaries is one clock read and a compare. All stream reading
and statistics happen at window boundaries only.
"""
from __future__ import annotations

import hashlib
import math
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["SLOObjective", "DEFAULT_OBJECTIVES", "Incident",
           "EwmaDetector", "RobustZDetector", "Watchtower",
           "render_diagnosis"]

# the closed phase vocabulary incidents attribute to (bounded: these
# are Prometheus label values on ptpu_incidents_total)
PHASES = ("queue", "dispatch", "prefill", "decode", "handoff",
          "failover", "kv_promotion", "compile")

# slo_attribution() record key -> incident phase (chunked prefill
# bills to prefill, failover replay to failover)
_ATTR_PHASE_KEYS = (("queue_s", "queue"),
                    ("dispatch_rpc_s", "dispatch"),
                    ("prefill_s", "prefill"),
                    ("chunked_prefill_s", "prefill"),
                    ("decode_s", "decode"),
                    ("handoff_s", "handoff"),
                    ("kv_promotion_s", "kv_promotion"),
                    ("failover_replay_s", "failover"))


@dataclass(frozen=True)
class SLOObjective:
    """One declared objective: "``objective`` of events finish the
    phase within ``threshold_s``". Exactly one source:

    - ``family``: a registry histogram family name. ``threshold_s``
      snaps UP to the nearest bucket bound (cumulative bucket counts
      are the only resolution a histogram has), so pick thresholds on
      bucket edges for exact accounting.
    - ``phase``: an attribution phase name (``queue`` …
      ``kv_promotion``); events are per-request records from the
      telemetry plane's ``slo_attribution()``.
    """
    name: str
    threshold_s: float
    objective: float = 0.99          # target good fraction
    family: Optional[str] = None     # histogram source
    phase: Optional[str] = None      # attribution source (and/or the
    #                                  phase burn incidents carry)
    fast_window_s: float = 30.0
    slow_window_s: float = 300.0
    fast_burn: float = 14.0          # burn-rate trip thresholds
    slow_burn: float = 6.0
    min_events: int = 5              # fast-window event floor

    def __post_init__(self):
        if self.family is None and self.phase is None:
            raise ValueError(
                f"objective {self.name!r} needs a histogram family "
                f"or an attribution phase")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target fraction must be "
                f"in (0, 1), got {self.objective}")


# sane real-clock defaults for a live front door; the chaos band and
# tests declare their own (virtual-second) objectives
DEFAULT_OBJECTIVES: Tuple[SLOObjective, ...] = (
    SLOObjective("ttft_p99", threshold_s=2.5, objective=0.99,
                 family="ptpu_serving_ttft_seconds", phase="queue"),
    SLOObjective("queue_wait_p95", threshold_s=1.0, objective=0.95,
                 family="ptpu_serving_queue_wait_seconds",
                 phase="queue"),
    SLOObjective("step_p99", threshold_s=1.0, objective=0.99,
                 family="ptpu_serving_step_seconds", phase="decode"),
    SLOObjective("promotion_wait_p95", threshold_s=2.5,
                 objective=0.95,
                 family="ptpu_kv_promotion_wait_seconds",
                 phase="kv_promotion"),
)


class EwmaDetector:
    """Exponentially weighted mean/variance; trips when a sample
    deviates from the smoothed mean by more than ``k`` smoothed
    standard deviations (with a relative floor so near-constant
    streams don't trip on noise). Warmup samples never trip."""

    def __init__(self, alpha: float = 0.3, k: float = 6.0,
                 warmup: int = 8):
        self.alpha = float(alpha)
        self.k = float(k)
        self.warmup = int(warmup)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> bool:
        x = float(x)
        trip = False
        if self.n >= self.warmup and self.mean is not None:
            scale = max(math.sqrt(max(self.var, 0.0)),
                        0.1 * abs(self.mean), 1e-9)
            trip = abs(x - self.mean) > self.k * scale
        if self.mean is None:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            # West's EWMA variance update
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * d * d)
        self.n += 1
        return trip


class RobustZDetector:
    """Median/MAD z-score over a rolling window. MAD is scaled by
    1.4826 (consistency with the normal sigma) and floored at 5% of
    |median| so an exactly-constant stream (virtual clocks produce
    these) doesn't divide by zero and page on the first wobble."""

    def __init__(self, window: int = 64, z: float = 8.0,
                 min_samples: int = 8):
        self.z = float(z)
        self.min_samples = int(min_samples)
        self.samples: deque = deque(maxlen=int(window))

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def update(self, x: float) -> bool:
        x = float(x)
        trip = False
        if len(self.samples) >= self.min_samples:
            xs = list(self.samples)
            med = self._median(xs)
            mad = self._median([abs(v - med) for v in xs])
            scale = max(1.4826 * mad, 0.05 * abs(med), 1e-9)
            trip = abs(x - med) / scale > self.z
        self.samples.append(x)
        return trip


@dataclass
class Incident:
    """One tripped detector, deduped by ``fingerprint``. ``detail``
    carries the detector-specific evidence (burn rates, per-phase
    breakdown, death reasons); ``flight`` and ``trace`` are bounded
    excerpts captured AT trip time."""
    kind: str                 # slo_burn | anomaly | stall |
    #                           request_orphaned | worker_death |
    #                           partition
    phase: str                # dominant-phase attribution (PHASES)
    summary: str
    ts: float
    fingerprint: str
    detail: Dict[str, Any] = field(default_factory=dict)
    request_ids: Tuple[int, ...] = ()
    flight: Tuple[dict, ...] = ()
    trace: Tuple[dict, ...] = ()
    count: int = 1            # dedup hits within the window
    last_ts: float = 0.0

    def to_json(self) -> dict:
        return {"kind": self.kind, "phase": self.phase,
                "summary": self.summary, "ts": self.ts,
                "last_ts": self.last_ts, "count": self.count,
                "fingerprint": self.fingerprint,
                "detail": dict(self.detail),
                "request_ids": list(self.request_ids),
                "flight": [dict(r) for r in self.flight],
                "trace": [dict(r) for r in self.trace]}


def _fingerprint(kind: str, phase: str, key: str) -> str:
    h = hashlib.sha1(f"{kind}|{phase}|{key}".encode()).hexdigest()
    return h[:16]


class _MetricView:
    """Read adapter over one ``MetricRegistry.to_json()`` snapshot."""

    def __init__(self, snap: dict):
        self._m = (snap or {}).get("metrics") or {}

    def counter_total(self, name: str) -> float:
        fam = self._m.get(name)
        if not fam or fam.get("type") != "counter":
            return 0.0
        return float(sum(float(s.get("value", 0.0))
                         for s in fam.get("samples", ())))

    def counter_by_label(self, name: str, label: str
                         ) -> Dict[str, float]:
        fam = self._m.get(name)
        out: Dict[str, float] = {}
        if not fam or fam.get("type") != "counter":
            return out
        for s in fam.get("samples", ()):
            lv = str((s.get("labels") or {}).get(label, ""))
            out[lv] = out.get(lv, 0.0) + float(s.get("value", 0.0))
        return out

    def gauge(self, name: str) -> Optional[float]:
        fam = self._m.get(name)
        if not fam or fam.get("type") != "gauge":
            return None
        samples = fam.get("samples", ())
        if not samples:
            return None
        return float(sum(float(s.get("value", 0.0))
                         for s in samples))

    def hist(self, name: str) -> Optional[dict]:
        """Aggregate histogram across label sets: cumulative buckets
        (le-string keyed), sum, count — or None if absent/empty."""
        fam = self._m.get(name)
        if not fam or fam.get("type") != "histogram":
            return None
        buckets: Dict[str, int] = {}
        total_s, total_n = 0.0, 0
        for s in fam.get("samples", ()):
            for le, c in (s.get("buckets") or {}).items():
                buckets[le] = buckets.get(le, 0) + int(c)
            total_s += float(s.get("sum", 0.0))
            total_n += int(s.get("count", 0))
        if not buckets and not total_n:
            return None
        return {"buckets": buckets, "sum": total_s, "count": total_n}


def _le_key(le: str) -> float:
    return math.inf if le == "+Inf" else float(le)


def _good_count(hist: dict, threshold: float) -> int:
    """Cumulative count at the smallest bucket bound >= threshold
    (the threshold snaps UP to bucket resolution)."""
    best_le, best_cum = None, 0
    for le, cum in hist["buckets"].items():
        b = _le_key(le)
        if b >= threshold and (best_le is None or b < best_le):
            best_le, best_cum = b, int(cum)
    return best_cum if best_le is not None else int(hist["count"])


class _BurnState:
    """Per-objective windowed good/bad accounting: a ring of
    ``(t, events, bad)`` deltas appended once per evaluation, pruned
    past the slow window."""

    def __init__(self, obj: SLOObjective):
        self.obj = obj
        self.ring: deque = deque()
        self.prev_total: Optional[int] = None
        self.prev_bad = 0
        self.seen_rids: "OrderedDict[int, bool]" = OrderedDict()

    def push(self, now: float, d_total: int, d_bad: int) -> None:
        if d_total or d_bad:
            self.ring.append((now, int(d_total), int(d_bad)))
        horizon = now - self.obj.slow_window_s
        while self.ring and self.ring[0][0] < horizon:
            self.ring.popleft()

    def window(self, now: float, w: float) -> Tuple[int, int]:
        t0 = now - w
        total = bad = 0
        for t, d, b in self.ring:
            if t >= t0:
                total += d
                bad += b
        return total, bad

    def burn(self, now: float, w: float) -> float:
        total, bad = self.window(now, w)
        if total <= 0:
            return 0.0
        frac = min(1.0, bad / total)
        return frac / max(1e-9, 1.0 - self.obj.objective)


class Watchtower:
    """The streaming health engine. Construct one per registry you
    want watched; attach sources, then drive it:

    - ``observe_step()`` from the engine hot path (one counter bump);
    - ``poll()`` from any serving loop (front-door pump, chaos loop,
      supervisor poll) — evaluates only when ``eval_interval_s`` has
      elapsed on the injected clock;
    - ``flush()`` to force an evaluation (shutdown, tests).

    The first evaluation only primes counter baselines (a watchtower
    attached to a long-lived registry must not page on history)."""

    def __init__(self, *,
                 registry,
                 objectives: Tuple[SLOObjective, ...] =
                 DEFAULT_OBJECTIVES,
                 telemetry=None,
                 time_fn: Callable[[], float] = time.monotonic,
                 eval_interval_s: float = 5.0,
                 dedup_window_s: float = 300.0,
                 max_incidents: int = 128,
                 stall_after_s: Optional[float] = 60.0,
                 heartbeat_max_age_s: Optional[float] = None,
                 anomaly_streams: bool = True,
                 ewma_alpha: float = 0.3, ewma_k: float = 6.0,
                 z_threshold: float = 8.0, min_samples: int = 8,
                 trace_excerpt: int = 32, flight_excerpt: int = 16):
        self.registry = registry
        self.telemetry = telemetry
        self.now = time_fn
        self.eval_interval_s = float(eval_interval_s)
        self.dedup_window_s = float(dedup_window_s)
        self.max_incidents = int(max_incidents)
        self.stall_after_s = stall_after_s
        self.heartbeat_max_age_s = heartbeat_max_age_s
        self.trace_excerpt = int(trace_excerpt)
        self.flight_excerpt = int(flight_excerpt)
        self.objectives = tuple(objectives)
        self._burn = {o.name: _BurnState(o) for o in self.objectives}
        self._lock = threading.Lock()   # guards evaluation state
        self._steps = 0                 # observe_step() hot counter
        self._next_eval = -math.inf     # first poll() evaluates
        self._primed = False
        self._engine = None
        self._metrics = None
        self._recorder = None
        self._control = None
        # anomaly streams: name -> (phase, ewma, robust)
        self._anomaly_on = bool(anomaly_streams)
        mk = lambda: (EwmaDetector(alpha=ewma_alpha, k=ewma_k,
                                   warmup=min_samples),
                      RobustZDetector(z=z_threshold,
                                      min_samples=min_samples))
        self._streams: Dict[str, Tuple[str, EwmaDetector,
                                       RobustZDetector]] = {
            "step_latency": ("decode", *mk()),
            "queue_depth": ("queue", *mk()),
            "promotion_wait": ("kv_promotion", *mk()),
            "recompiles": ("compile", *mk()),
        }
        # deltas for stream readers / death detection / stall
        self._prev: Dict[str, float] = {}
        self._prev_deaths: Dict[str, float] = {}
        self._stall_since: Optional[float] = None
        self._orphans_prev: set = set()
        self._orphans_reported: set = set()
        self._incidents: "OrderedDict[str, Incident]" = OrderedDict()
        self._m_incidents = registry.counter(
            "ptpu_incidents_total",
            "watchtower incidents raised, by kind and dominant "
            "phase", labels=("kind", "phase"))

    # -- attachment ----------------------------------------------------
    def attach_engine(self, engine) -> "Watchtower":
        """Watch one in-process :class:`ServingEngine`: enables the
        orphaned-request detector and the recompile stream (``None`` on
        the port's eager engine, which has no ``trace_counts``), installs
        the step hook, and captures the engine's flight recorder for
        incident snapshots."""
        self._engine = engine
        self._metrics = getattr(engine, "metrics", None)
        self._recorder = getattr(engine, "recorder", None)
        engine._watchtower = self
        return self

    def attach_recorder(self, recorder) -> "Watchtower":
        self._recorder = recorder
        return self

    def attach_control(self, control) -> "Watchtower":
        """Watch a :class:`serving.control.ControlPlane`: its snapshot
        rides ``to_json()`` (the doctor's control line) and the
        ``controller_flapping`` detector audits every dwell-gated
        controller against its own gate."""
        self._control = control
        return self

    # -- hot path ------------------------------------------------------
    def observe_step(self) -> None:
        """Called from the engine step hot path: ONE counter
        increment, nothing else (micro-asserted)."""
        self._steps += 1

    def poll(self) -> List[Incident]:
        """Cheap gate: one clock read + compare between window
        boundaries; a full evaluation once per ``eval_interval_s``."""
        if self.now() < self._next_eval:
            return []
        return self.flush()

    def flush(self) -> List[Incident]:
        """Force one evaluation now (window boundary, shutdown)."""
        with self._lock:
            now = float(self.now())
            self._next_eval = now + self.eval_interval_s
            return self._evaluate(now)

    # -- evaluation ----------------------------------------------------
    def _evaluate(self, now: float) -> List[Incident]:
        view = _MetricView(self.registry.to_json())
        new: List[Incident] = []
        self._eval_burn(now, view, new)
        self._eval_anomalies(now, view, new)
        self._eval_stall(now, view, new)
        self._eval_orphans(now, new)
        self._eval_deaths(now, view, new)
        self._eval_heartbeats(now, new)
        self._eval_control(now, new)
        self._primed = True
        return new

    # burn-rate engine -------------------------------------------------
    def _eval_burn(self, now: float, view: _MetricView,
                   out: List[Incident]) -> None:
        attr = None
        for obj in self.objectives:
            st = self._burn[obj.name]
            if obj.family is not None:
                h = view.hist(obj.family)
                total = int(h["count"]) if h else 0
                bad = (total - _good_count(h, obj.threshold_s)) \
                    if h else 0
                bad_rids: Tuple[int, ...] = ()
            elif self.telemetry is not None:
                if attr is None:
                    attr = self.telemetry.slo_attribution()
                key = obj.phase + "_s" if obj.phase != "failover" \
                    else "failover_replay_s"
                total, bad, rids = 0, 0, []
                for rec in attr:
                    total += 1
                    v = float(rec.get(key, 0.0))
                    if obj.phase == "prefill":
                        v += float(rec.get("chunked_prefill_s", 0.0))
                    if obj.phase == "dispatch":
                        v = float(rec.get("dispatch_rpc_s", 0.0))
                    if v > obj.threshold_s:
                        bad += 1
                        rids.append(int(rec["request_id"]))
                bad_rids = tuple(rids[-8:])
            else:
                continue
            if st.prev_total is None or total < st.prev_total \
                    or bad < st.prev_bad:
                # first sight, or a reset: re-prime, no deltas
                st.prev_total, st.prev_bad = total, bad
                continue
            d_total = total - st.prev_total
            d_bad = bad - st.prev_bad
            st.prev_total, st.prev_bad = total, bad
            st.push(now, d_total, d_bad)
            if not self._primed:
                continue
            fast = st.burn(now, obj.fast_window_s)
            slow = st.burn(now, obj.slow_window_s)
            ev_fast, _ = st.window(now, obj.fast_window_s)
            if fast >= obj.fast_burn and slow >= obj.slow_burn \
                    and ev_fast >= obj.min_events:
                phase, breakdown = self._dominant_phase(obj)
                share = breakdown.get(phase)
                pct = f"{100.0 * share:.0f}% {phase}" \
                    if share is not None else phase
                self._raise(out, kind="slo_burn", phase=phase,
                            key=obj.name, now=now,
                            summary=(f"{obj.name} burn "
                                     f"{fast:.1f}x/{slow:.1f}x "
                                     f"(fast/slow) over "
                                     f"{obj.threshold_s}s objective "
                                     f"— dominant: {pct}"),
                            detail={"objective": obj.name,
                                    "threshold_s": obj.threshold_s,
                                    "target": obj.objective,
                                    "fast_burn": round(fast, 3),
                                    "slow_burn": round(slow, 3),
                                    "breakdown": breakdown},
                            rids=bad_rids)

    def _dominant_phase(self, obj: SLOObjective
                        ) -> Tuple[str, Dict[str, float]]:
        """Dominant phase + normalized per-phase share from recent
        attribution records; falls back to the objective's declared
        phase when no telemetry plane is attached."""
        if self.telemetry is not None:
            sums: Dict[str, float] = {}
            for rec in self.telemetry.slo_attribution():
                for key, phase in _ATTR_PHASE_KEYS:
                    sums[phase] = sums.get(phase, 0.0) \
                        + float(rec.get(key, 0.0))
            total = sum(sums.values())
            if total > 0:
                breakdown = {p: round(v / total, 4)
                             for p, v in sorted(sums.items())
                             if v > 0}
                dom = max(breakdown, key=lambda p: breakdown[p])
                return dom, breakdown
        return (obj.phase or "decode"), {}

    # anomaly streams --------------------------------------------------
    def _delta(self, key: str, cur: float) -> float:
        prev = self._prev.get(key)
        self._prev[key] = cur
        if prev is None or cur < prev:
            return 0.0
        return cur - prev

    def _read_stream(self, name: str, view: _MetricView
                     ) -> Optional[float]:
        if name == "step_latency":
            h = view.hist("ptpu_serving_step_seconds")
            if h is None:
                return None
            dn = self._delta("step_latency_n", float(h["count"]))
            ds = self._delta("step_latency_s", float(h["sum"]))
            return (ds / dn) if dn > 0 else None
        if name == "queue_depth":
            return view.gauge("ptpu_serving_queue_depth")
        if name == "promotion_wait":
            h = view.hist("ptpu_kv_promotion_wait_seconds")
            if h is None:
                return None
            dn = self._delta("promotion_wait_n", float(h["count"]))
            ds = self._delta("promotion_wait_s", float(h["sum"]))
            return (ds / dn) if dn > 0 else None
        if name == "recompiles":
            eng = self._engine
            if eng is None or not hasattr(eng, "trace_counts"):
                return None
            n = 0
            for v in eng.trace_counts.values():
                n += len(v) and sum(v.values()) \
                    if isinstance(v, dict) else int(v)
            return self._delta("recompiles", float(n))
        return None

    def _eval_anomalies(self, now: float, view: _MetricView,
                        out: List[Incident]) -> None:
        if not self._anomaly_on:
            return
        for name, (phase, ewma, robust) in self._streams.items():
            x = self._read_stream(name, view)
            if x is None:
                continue
            # evaluate both (each must also LEARN the sample)
            t1 = ewma.update(x)
            t2 = robust.update(x)
            if t1 and t2 and self._primed:
                self._raise(out, kind="anomaly", phase=phase,
                            key=name, now=now,
                            summary=(f"{name} anomaly: sample "
                                     f"{x:.4g} vs ewma "
                                     f"{ewma.mean:.4g}"),
                            detail={"stream": name,
                                    "value": float(x),
                                    "ewma_mean": float(ewma.mean),
                                    "ewma_var": float(ewma.var)})

    # monotonic stall --------------------------------------------------
    def _eval_stall(self, now: float, view: _MetricView,
                    out: List[Incident]) -> None:
        if self.stall_after_s is None:
            return
        h = view.hist("ptpu_serving_step_seconds")
        steps = float(h["count"]) if h else float(self._steps)
        depth = view.gauge("ptpu_serving_queue_depth") or 0.0
        active = view.gauge("ptpu_serving_active_slots") or 0.0
        advanced = steps > self._prev.get("stall_steps", -1.0)
        self._prev["stall_steps"] = steps
        if advanced or (depth <= 0 and active <= 0):
            self._stall_since = None
            return
        if self._stall_since is None:
            self._stall_since = now
            return
        age = now - self._stall_since
        if age >= self.stall_after_s and self._primed:
            self._raise(out, kind="stall", phase="decode",
                        key="engine_steps", now=now,
                        summary=(f"engine stalled: {int(depth)} "
                                 f"queued / {int(active)} active "
                                 f"with no step for {age:.0f}s"),
                        detail={"queued": depth, "active": active,
                                "stalled_s": age})

    # orphaned requests ------------------------------------------------
    def _eval_orphans(self, now: float, out: List[Incident]) -> None:
        eng, m = self._engine, self._metrics
        if eng is None or m is None \
                or not hasattr(m, "inflight_phases") \
                or not hasattr(eng, "inflight_rids"):
            return
        inflight = m.inflight_phases()
        known = eng.inflight_rids()
        orphans = {rid for rid in inflight if rid not in known}
        # two consecutive evaluations: a submit racing this poll on
        # another thread must not page
        confirmed = (orphans & self._orphans_prev) \
            - self._orphans_reported
        self._orphans_prev = orphans
        for rid in sorted(confirmed):
            self._orphans_reported.add(rid)
            info = inflight.get(rid) or {}
            phase = str(info.get("phase", "queue"))
            self._raise(out, kind="request_orphaned", phase=phase,
                        key=f"rid={rid}", now=now,
                        summary=(f"request {rid} is tracked by "
                                 f"metrics but unknown to the "
                                 f"engine (dropped mid-"
                                 f"{phase}?)"),
                        detail={"rid": rid, "last_phase": phase,
                                "age_s": float(
                                    info.get("age_s", 0.0))},
                        rids=(rid,))

    # replica deaths ---------------------------------------------------
    def _eval_deaths(self, now: float, view: _MetricView,
                     out: List[Incident]) -> None:
        cur = view.counter_by_label(
            "ptpu_router_replica_deaths_total", "reason")
        prev, self._prev_deaths = self._prev_deaths, cur
        if not self._primed:
            return
        for reason, val in sorted(cur.items()):
            d = val - prev.get(reason, 0.0)
            if d <= 0:
                continue
            # a partition surfaces as the wire dying past the retry
            # budget (the worker process itself may be fine): that is
            # a DISPATCH-phase fault, not a worker death
            if reason == "unreachable":
                kind, phase = "partition", "dispatch"
            else:
                kind, phase = "worker_death", "failover"
            self._raise(out, kind=kind, phase=phase,
                        key=f"reason={reason}", now=now,
                        summary=(f"{int(d)} replica death(s), "
                                 f"reason={reason}"),
                        detail={"reason": reason, "deaths": int(d),
                                "failovers": view.counter_total(
                                    "ptpu_router_failovers_total")})

    # worker heartbeats ------------------------------------------------
    def _eval_heartbeats(self, now: float,
                         out: List[Incident]) -> None:
        if self.heartbeat_max_age_s is None \
                or self.telemetry is None:
            return
        for worker, snap in sorted(
                self.telemetry.worker_snapshots().items()):
            ts = snap.get("ts")
            if ts is None:
                continue
            age = now - float(ts)
            if age > self.heartbeat_max_age_s and self._primed:
                self._raise(out, kind="stall", phase="failover",
                            key=f"heartbeat={worker}", now=now,
                            summary=(f"worker {worker} silent for "
                                     f"{age:.0f}s (heartbeat bound "
                                     f"{self.heartbeat_max_age_s}s)"),
                            detail={"worker": worker,
                                    "age_s": float(age)})

    def _eval_control(self, now: float, out: List[Incident]) -> None:
        """``controller_flapping``: every dwell-gated controller can
        legally transition at most once per dwell (cool-down) period —
        more means the gate is broken (monkeypatched thresholds, a
        buggy controller swap) and the data plane is being thrashed."""
        cp = self._control
        if cp is None or not self._primed:
            return
        try:
            snap = cp.snapshot()
        except Exception:
            return
        checks = (("brownout", "queue", "flips", "dwell"),
                  ("chunk", "prefill", "adaptations", "dwell"),
                  ("autoscale", "failover", "actions", "cooldown"))
        for name, phase, n_key, gate_key in checks:
            st = snap.get(name)
            if not st:
                continue
            step = int(st.get("step", 0))
            gate = max(1, int(st.get(gate_key, 1)))
            n = int(st.get(n_key, 0))
            ceiling = step // gate + 1
            if step > 0 and n > ceiling:
                self._raise(
                    out, kind="controller_flapping", phase=phase,
                    key=f"controller={name}", now=now,
                    summary=(f"{name} controller flapping: {n} "
                             f"transitions in {step} steps exceeds "
                             f"its own gate ({gate}-step dwell "
                             f"allows {ceiling})"),
                    detail={"controller": name, "transitions": n,
                            "steps": step, "gate": gate,
                            "ceiling": ceiling})

    # -- incident plumbing ---------------------------------------------
    def _raise(self, out: List[Incident], *, kind: str, phase: str,
               key: str, now: float, summary: str,
               detail: Dict[str, Any],
               rids: Tuple[int, ...] = ()) -> None:
        fp = _fingerprint(kind, phase, key)
        inc = self._incidents.get(fp)
        if inc is not None \
                and now - inc.last_ts <= self.dedup_window_s:
            inc.count += 1
            inc.last_ts = now
            inc.detail = dict(detail)
            return
        inc = Incident(kind=kind, phase=phase, summary=summary,
                       ts=now, last_ts=now, fingerprint=fp,
                       detail=dict(detail),
                       request_ids=tuple(int(r) for r in rids),
                       flight=self._flight_excerpt(),
                       trace=self._trace_excerpt(rids))
        self._incidents[fp] = inc
        self._incidents.move_to_end(fp)
        while len(self._incidents) > self.max_incidents:
            self._incidents.popitem(last=False)
        self._m_incidents.labels(kind=kind, phase=phase).inc()
        out.append(inc)

    def _flight_excerpt(self) -> Tuple[dict, ...]:
        rec = self._recorder
        if rec is None or not hasattr(rec, "snapshot"):
            return ()
        try:
            return tuple(rec.snapshot()[-self.flight_excerpt:])
        except Exception:
            return ()

    def _trace_excerpt(self, rids: Tuple[int, ...]
                       ) -> Tuple[dict, ...]:
        tel = self.telemetry
        if tel is None:
            return ()
        try:
            if rids:
                spans: List[dict] = []
                for rid in rids[:4]:
                    spans.extend(tel.spans_for(rid))
                return tuple(spans[-self.trace_excerpt:])
            return tuple(tel.aligned_spans()[-self.trace_excerpt:])
        except Exception:
            return ()

    # -- readouts ------------------------------------------------------
    def incidents(self) -> List[Incident]:
        with self._lock:
            return list(self._incidents.values())

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        now = float(self.now())
        with self._lock:
            return {name: {"fast": st.burn(now,
                                           st.obj.fast_window_s),
                           "slow": st.burn(now,
                                           st.obj.slow_window_s)}
                    for name, st in self._burn.items()}

    def healthz(self) -> dict:
        incs = self.incidents()
        return {"ok": not incs, "incidents": len(incs),
                "steps": self._steps, "burn": self.burn_rates(),
                "ts": float(self.now())}

    def to_json(self) -> dict:
        """The ``/incidents`` payload (and the ``ptpu_doctor`` dump
        format): health summary, declared objectives, incidents —
        plus a ``speculation`` block when the attached engine decodes
        speculatively (accepted tokens/step, active proposer, tuner
        state), so one doctor dump answers "is speculation paying?"."""
        snap = {"health": self.healthz(),
                "objectives": [
                    {"name": o.name, "threshold_s": o.threshold_s,
                     "objective": o.objective, "family": o.family,
                     "phase": o.phase,
                     "windows_s": [o.fast_window_s,
                                   o.slow_window_s],
                     "burn_thresholds": [o.fast_burn, o.slow_burn]}
                    for o in self.objectives],
                "incidents": [i.to_json()
                              for i in self.incidents()]}
        eng = getattr(self, "_engine", None)
        if eng is not None and getattr(eng, "speculative", False):
            try:
                snap["speculation"] = eng.spec_stats()
            except Exception:
                pass
        if self._control is not None:
            try:
                snap["control"] = self._control.snapshot()
            except Exception:
                pass
        return snap

    def diagnose(self) -> str:
        return render_diagnosis(self.to_json())


_VERDICT = {"queue": "admission-bound", "dispatch": "rpc-bound",
            "prefill": "prefill-bound", "decode": "decode-bound",
            "handoff": "handoff-bound", "failover": "failover-bound",
            "kv_promotion": "promotion-bound",
            "compile": "recompile-bound"}


def render_diagnosis(snap: dict) -> str:
    """Human diagnosis from a watchtower JSON snapshot, the renderer
    behind ``Watchtower.diagnose()``. Example line::

        p99 TTFT burn: 78% queue-wait, decode healthy — admission-bound
    """
    health = snap.get("health") or {}
    incs = snap.get("incidents") or []
    lines: List[str] = []
    if not incs:
        lines.append("watchtower: healthy — no incidents")
    else:
        lines.append(f"watchtower: {len(incs)} incident(s)")
    for b_name, b in sorted((health.get("burn") or {}).items()):
        fast, slow = b.get("fast", 0.0), b.get("slow", 0.0)
        if fast or slow:
            lines.append(f"  burn[{b_name}]: fast {fast:.2f}x, "
                         f"slow {slow:.2f}x of error budget")
    spec = snap.get("speculation")
    if spec:
        line = (f"  speculation: {spec.get('proposer', 'ngram')} "
                f"accepted {spec.get('accepted_per_step', 0.0):.1f} "
                f"tok/step")
        tuner = spec.get("tuner")
        if tuner:
            st = (tuner.get("classes") or {}).get("greedy") or {}
            line += (f", tuner at k={st.get('k')}" if st.get("on")
                     else ", tuner off (k=1)")
        lines.append(line)
    ctl = snap.get("control")
    if ctl:
        parts = []
        b = ctl.get("brownout")
        if b:
            tiers = b.get("sheds_by_tier") or {}
            shed_s = ",".join(f"t{t}:{n}"
                              for t, n in sorted(tiers.items())) \
                or "none"
            parts.append(f"brownout L{b.get('level', 0)} "
                         f"sheds {shed_s}")
        c = ctl.get("chunk")
        if c:
            parts.append(f"chunk x{c.get('mult', 1)}")
        a = ctl.get("autoscale")
        if a:
            la = a.get("last_action")
            last = f"{la[0]}@{la[1]}" if la else "none"
            parts.append(f"replicas {a.get('replicas', 0)} "
                         f"last-scale {last}")
        if parts:
            lines.append("  control: " + "; ".join(parts))
    for inc in incs:
        phase = inc.get("phase", "?")
        verdict = _VERDICT.get(phase, f"{phase}-bound")
        breakdown = (inc.get("detail") or {}).get("breakdown") or {}
        if breakdown:
            parts = sorted(breakdown.items(),
                           key=lambda kv: -kv[1])
            top = ", ".join(f"{100 * v:.0f}% {p}-wait"
                            for p, v in parts[:2])
            healthy = [p for p in ("decode", "prefill", "queue")
                       if p not in dict(parts[:2])]
            tail = f", {healthy[0]} healthy" if healthy else ""
            lines.append(f"  {inc.get('kind')}: {top}{tail} "
                         f"— {verdict}")
        else:
            lines.append(f"  {inc.get('kind')}[{phase}]: "
                         f"{inc.get('summary', '')} — {verdict}")
        if inc.get("request_ids"):
            rids = ", ".join(str(r)
                             for r in inc["request_ids"][:8])
            lines.append(f"    offending rids: {rids}")
        if inc.get("count", 1) > 1:
            lines.append(f"    (deduped x{inc['count']} since "
                         f"t={inc.get('ts', 0):.0f})")
    return "\n".join(lines)
