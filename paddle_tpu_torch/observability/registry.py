"""Metrics registry: ``Counter`` / ``Gauge`` / ``Histogram`` families
with label sets, a process-global default registry, and two exporters:
Prometheus text exposition (``to_prometheus``) and a JSON tree
(``to_json``).

Counterpart of ``paddle_tpu/observability/registry.py``, the whole
module (a copy, not an import: the port never imports the reference
package); the same operations give the same exposition text.

- **Thread-safe**: one registry ``RLock`` guards family creation, and
  each child instrument carries its own lock for value updates.
- **Injectable clock** (``time_fn``): snapshots carry a timestamp that
  tests drive on a virtual timeline.
- **Cardinality guard**: ``max_label_sets`` (per family) turns an
  unbounded-label bug (a request id used as a label) into an immediate
  ``MetricError`` instead of a slow leak.
- **Full metric names** are explicit (``ptpu_<layer>_<name>_<unit>``):
  no hidden prefixing.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["MetricError", "Counter", "Gauge", "Histogram",
           "MetricRegistry", "default_registry"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# prometheus client default buckets: sub-ms host events up to
# multi-second step/queue waits
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class MetricError(ValueError):
    """Registration conflict, bad name/label, or cardinality overflow."""


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if math.isnan(f):
        return "NaN"       # valid exposition-format sample value
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Child:
    """One (label values) cell of a family; owns its own lock."""

    def __init__(self, family: "_Family", labels: Tuple[str, ...]):
        self._family = family
        self._labels = labels
        self._lock = threading.Lock()


class _CounterChild(_Child):
    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise MetricError(
                f"counter {self._family.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0.0


class _GaugeChild(_Child):
    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0.0


class _HistogramChild(_Child):
    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._bucket_counts = [0] * len(family.buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            # per-bucket storage (first bucket that fits); exporters
            # cumulate on the way out, as the exposition format needs.
            # NaN compares False against every bound, which would
            # desync _count from the bucket sums — park it in +Inf.
            if math.isnan(v):
                self._bucket_counts[-1] += 1
                return
            for i, ub in enumerate(self._family.buckets):
                if v <= ub:
                    self._bucket_counts[i] += 1
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) by linear
        interpolation inside the owning bucket (Prometheus
        ``histogram_quantile`` semantics; exact tails live in
        EngineMetrics which keeps raw samples)."""
        with self._lock:
            counts = list(self._bucket_counts)
            total = self._count
        if not total:
            return 0.0
        target = (q / 100.0) * total
        cum = 0
        lo = 0.0
        ubs = self._family.buckets
        for i, ub in enumerate(ubs):
            prev = cum
            cum += counts[i]
            if cum >= target:
                if ub == math.inf:
                    return lo          # open tail: best effort
                frac = ((target - prev) / counts[i]) if counts[i] else 0.0
                return lo + (ub - lo) * frac
            lo = ub if ub != math.inf else lo
        return lo

    def quantile(self, q: float) -> float:
        """Estimate the q-th quantile (0..1) — the Prometheus
        ``histogram_quantile`` convention. Linear interpolation
        between bucket bounds: the owning bucket ``(lo, ub]`` is
        found by cumulative count, then the estimate is ``lo + (ub -
        lo) * frac`` where ``frac`` is the target's fractional
        position among the bucket's own observations (uniform-within-
        bucket assumption). The open +Inf tail returns its lower
        bound; an empty histogram returns 0.0."""
        if not 0.0 <= q <= 1.0:
            raise MetricError(f"quantile takes q in [0, 1], got {q}")
        return self.percentile(q * 100.0)

    def _reset(self):
        with self._lock:
            self._bucket_counts = [0] * len(self._family.buckets)
            self._sum = 0.0
            self._count = 0


class _Family:
    """A named metric with a fixed label schema; children per label
    set. Families with no labels proxy the instrument API straight to
    their single anonymous child."""

    kind = ""
    _child_cls = _Child

    def __init__(self, registry: "MetricRegistry", name: str,
                 description: str, label_names: Tuple[str, ...],
                 max_label_sets: int):
        self._registry = registry
        self.name = name
        self.description = description
        self.label_names = label_names
        self.max_label_sets = max_label_sets
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not label_names:
            self._children[()] = self._child_cls(self, ())

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.label_names):
            raise MetricError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_label_sets:
                    raise MetricError(
                        f"{self.name}: label cardinality guard — "
                        f"{len(self._children)} label sets already "
                        f"registered (max_label_sets="
                        f"{self.max_label_sets}); a high-cardinality "
                        f"value (request id? timestamp?) is being used "
                        f"as a label")
                child = self._child_cls(self, key)
                self._children[key] = child
            return child

    def _default_child(self) -> _Child:
        if self.label_names:
            raise MetricError(
                f"{self.name} declares labels {self.label_names}; "
                f"use .labels(...)")
        return self._children[()]

    def _sorted_children(self) -> List[_Child]:
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    def reset(self) -> None:
        """Zero every child (label sets are kept — a reset must not
        un-register schemas tests or dashboards rely on)."""
        with self._lock:
            for c in self._children.values():
                c._reset()


class Counter(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n: float = 1.0) -> None:
        self._default_child().inc(n)

    @property
    def value(self) -> float:
        return self._default_child().value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float) -> None:
        self._default_child().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default_child().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default_child().dec(n)

    @property
    def value(self) -> float:
        return self._default_child().value


def _normalize_buckets(buckets: Optional[Sequence[float]]):
    bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
    if bs and bs[-1] != math.inf:
        bs = bs + (math.inf,)
    return bs


class Histogram(_Family):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, registry, name, description, label_names,
                 max_label_sets, buckets: Optional[Sequence[float]] = None):
        bs = _normalize_buckets(buckets)
        if not bs:
            raise MetricError(f"{name}: empty bucket list")
        self.buckets = bs
        super().__init__(registry, name, description, label_names,
                         max_label_sets)

    def observe(self, v: float) -> None:
        self._default_child().observe(v)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def percentile(self, q: float) -> float:
        return self._default_child().percentile(q)

    def quantile(self, q: float) -> float:
        """q in 0..1 (see :meth:`_HistogramChild.quantile`)."""
        return self._default_child().quantile(q)


class MetricRegistry:
    """Create-or-get metric families; export the whole set atomically.

    ``time_fn`` stamps snapshots (injectable for virtual-clock tests);
    ``max_label_sets`` is the per-family cardinality ceiling.
    """

    def __init__(self, time_fn=time.time, max_label_sets: int = 64):
        self.now = time_fn
        self.max_label_sets = int(max_label_sets)
        self._families: Dict[str, _Family] = {}
        self._lock = threading.RLock()

    # -- family factories ----------------------------------------------
    def _get_or_create(self, cls, name, description, labels, **kw):
        if not _NAME_RE.match(name or ""):
            raise MetricError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.label_names != labels:
                    raise MetricError(
                        f"metric {name} already registered as "
                        f"{fam.kind}{fam.label_names}, requested "
                        f"{cls.kind}{labels}")
                want = kw.get("buckets")
                if want is not None and \
                        _normalize_buckets(want) != fam.buckets:
                    # buckets are part of the schema too: silently
                    # returning the other schema would misplace every
                    # observation
                    raise MetricError(
                        f"histogram {name} already registered with "
                        f"buckets {fam.buckets}, requested "
                        f"{_normalize_buckets(want)}")
                return fam
            fam = cls(self, name, description, labels,
                      self.max_label_sets, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, description: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, description, labels)

    def gauge(self, name: str, description: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, description, labels)

    def histogram(self, name: str, description: str = "",
                  labels: Iterable[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, description, labels,
                                   buckets=buckets)

    # -- introspection -------------------------------------------------
    def families(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Zero every value; families and label sets survive (handles
        held by instrumented modules keep working)."""
        with self._lock:
            fams = list(self._families.values())
        for f in fams:
            f.reset()

    # -- exporters -----------------------------------------------------
    def to_json(self) -> dict:
        out = {"ts": float(self.now()), "metrics": {}}
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]
        for fam in fams:
            rows = []
            for c in fam._sorted_children():
                row = {"labels": dict(zip(fam.label_names, c._labels))}
                if fam.kind == "histogram":
                    with c._lock:
                        counts = list(c._bucket_counts)
                        s, n = c._sum, c._count
                    cum, buckets = 0, {}
                    for ub, bc in zip(fam.buckets, counts):
                        cum += bc
                        buckets[_fmt(ub)] = cum
                    row["buckets"] = buckets   # cumulative, le-keyed
                    row["sum"] = s
                    row["count"] = n
                else:
                    row["value"] = c.value
                rows.append(row)
            out["metrics"][fam.name] = {
                "type": fam.kind, "help": fam.description,
                "label_names": list(fam.label_names), "samples": rows}
        return out

    def to_json_str(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_json(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]

        def lbl(names, values, extra=()):
            pairs = [f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values)] + list(extra)
            return "{" + ",".join(pairs) + "}" if pairs else ""

        for fam in fams:
            if fam.description:
                h = fam.description.replace("\\", r"\\") \
                    .replace("\n", r"\n")
                lines.append(f"# HELP {fam.name} {h}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if fam.kind == "histogram" and not fam._sorted_children():
                # a labeled histogram family nobody has observed yet
                # still exposes its _count/_sum (and the +Inf bucket
                # the pair implies): dashboards and the watchtower
                # read "registered but zero traffic" instead of
                # "family missing", and rate() starts from 0 rather
                # than a gap
                lines.append(f'{fam.name}_bucket{{le="+Inf"}} 0')
                lines.append(f"{fam.name}_sum 0")
                lines.append(f"{fam.name}_count 0")
            for c in fam._sorted_children():
                ls = lbl(fam.label_names, c._labels)
                if fam.kind == "histogram":
                    with c._lock:
                        counts = list(c._bucket_counts)
                        s, n = c._sum, c._count
                    cum = 0
                    for ub, bc in zip(fam.buckets, counts):
                        cum += bc
                        bl = lbl(fam.label_names, c._labels,
                                 [f'le="{_fmt(ub)}"'])
                        lines.append(
                            f"{fam.name}_bucket{bl} {cum}")
                    lines.append(f"{fam.name}_sum{ls} {_fmt(s)}")
                    lines.append(f"{fam.name}_count{ls} {n}")
                else:
                    lines.append(f"{fam.name}{ls} {_fmt(c.value)}")
        return "\n".join(lines) + "\n"


_default = MetricRegistry()


def default_registry() -> MetricRegistry:
    """The process-global registry every built-in layer publishes to."""
    return _default
