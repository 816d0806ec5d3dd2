"""Deliberate fault injection: named fault points, armed on demand.

Counterpart of ``paddle_tpu/resilience/faults.py``, the whole module (a
copy, not an import: the port never imports the reference package).
Every recovery path of the serving engine is exercised by INJECTING the
failure it claims to survive, on the CPU, in the tests. Instrumented
code calls ``maybe_fail("<point>")`` where real systems die; with no
fault armed the call costs one cached bool and one environment probe,
and when one is armed it raises :class:`InjectedFault` (or a
caller-chosen exception type).

Points wired in the port:

===========================  ===========================================
``serving.step.decode``      before the decode forward (pages COW'd)
``serving.decode.verify``    mid-verify-step (speculative decoding)
``serving.spec.draft``       one row's draft proposal (contained)
``serving.spec.resample``    sampled acceptance, before the residual draw
``serving.step.prefill``     inside the (re-)prefill driver
``serving.prefill.paged``    paged prefill, AFTER pages are claimed
``serving.prefill.chunk``    between chunks of a chunked prefill
``serving.kv.demote``        tier demotion, BEFORE either tier mutates
``serving.kv.promote``       tier promotion, pages staged, not installed
``control.shed/chunk/affinity/scale``  the control Actuator, per kind
===========================  ===========================================

Arming is programmatic::

    from paddle_tpu_torch.resilience import faults
    faults.inject("serving.step.decode", times=1, after=3)
    with faults.injected("serving.step.prefill", times=2,
                         exc=ConnectionError):
        ...

or through ``PTPU_FAULTS`` (read lazily, at the next evaluation)::

    PTPU_FAULTS="serving.step.decode:1@3,serving.prefill.chunk:1"
    PTPU_FAULTS="serving.step.prefill:p0.25~seed7"  # seeded Bernoulli

Grammar: ``point:TIMES[@SKIP]`` fails TIMES times after skipping SKIP
hits; ``point:pRATE~seedSEED`` fails each hit with probability RATE from
a deterministic per-point RNG. The same arm and the same hit sequence
fire the same faults.

While any rule is armed, every evaluation is counted per point
(``hits()``) and every raise (``fired()``), and each raise bumps the
``ptpu_fault_injections_total{point}`` counter of the default registry,
so a test can assert both that a recovery path works and that the point
it rides is still wired.

Standard library only.
"""
from __future__ import annotations

import contextlib
import os
import random
import threading
from typing import Dict, Optional

__all__ = ["InjectedFault", "maybe_fail", "inject", "clear", "injected",
           "hits", "fired", "reset_counts", "parse_spec",
           "KNOWN_POINTS"]

# The fault points the port's code calls (the module docstring's
# table).
KNOWN_POINTS = (
    # decode step: COW copies run, the forward not yet launched
    "serving.step.decode",
    # speculative verify step: drafts built, pages claimed/COW'd, the
    # k-wide forward not yet run (also on gated steps)
    "serving.decode.verify",
    "serving.step.prefill",
    # mid-prefill on the PAGED cache: pages claimed, table row live,
    # nothing run yet; the abort path must return every page
    "serving.prefill.paged",
    # chunked prefill, between chunks: slot leased, pages claimed, part
    # of the prompt written; the unwind frees the pages AND the lease
    # and requeues the request (the replay re-chunks identically)
    "serving.prefill.chunk",
    # KV host tier: demotion fires BEFORE either tier mutates (the
    # reclaim's caller unwinds); promotion fires with the request
    # staged and its dst pages claimed, nothing installed yet
    "serving.kv.demote",
    "serving.kv.promote",
    # one row's draft proposal: contained to that row's step (k=1)
    "serving.spec.draft",
    # sampled acceptance: first rejection, residual about to be drawn;
    # tokens accepted this step stay, the retried step continues
    "serving.spec.resample",
    # the control plane's Actuator, per actuation kind: a fired fault
    # suppresses that one actuation (fail-static)
    "control.shed",
    "control.chunk",
    "control.affinity",
    "control.scale",
)


class InjectedFault(RuntimeError):
    """The default exception a firing fault point raises."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit

    def __reduce__(self):
        # default exception pickling would replay __init__ with the
        # formatted message
        return type(self), (self.point, self.hit)


class _Rule:
    __slots__ = ("times", "after", "rate", "rng", "exc", "from_env")

    def __init__(self, times=None, after=0, rate=None, seed=None,
                 exc=None, from_env=False):
        if times is None and rate is None:
            times = 1
        self.times = times
        self.after = int(after)
        self.rate = rate
        self.rng = random.Random(seed) if rate is not None else None
        self.exc = exc
        self.from_env = from_env

    def should_fire(self) -> bool:
        if self.rate is not None:
            return self.rng.random() < self.rate
        if self.after > 0:
            self.after -= 1
            return False
        if self.times <= 0:
            return False
        self.times -= 1
        return True

    def make_exc(self, point: str, hit: int) -> BaseException:
        if self.exc is None:
            return InjectedFault(point, hit)
        if isinstance(self.exc, BaseException):
            return self.exc
        try:        # class or factory; fall back to a bare call
            return self.exc(f"injected fault at {point!r} (hit #{hit})")
        except TypeError:
            return self.exc()


_lock = threading.RLock()
_rules: Dict[str, _Rule] = {}
_hits: Dict[str, int] = {}
_fired: Dict[str, int] = {}
_env_cache: Optional[str] = None
# THE disarmed-hot-path flag: True exactly when _rules is empty.
# Every mutation of _rules (inject/clear/injected/_load_env) calls
# _recompute_disarmed(); maybe_fail's fast path reads this one
# cached bool plus one env probe and touches nothing else — no lock,
# no string compare against _env_cache, no dict truthiness walk.
_disarmed = True


def _recompute_disarmed() -> None:
    global _disarmed
    _disarmed = not _rules


def parse_spec(spec: str) -> Dict[str, _Rule]:
    """Parse a ``PTPU_FAULTS`` string into rules (exposed for tests)."""
    out: Dict[str, _Rule] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError(
                f"bad PTPU_FAULTS entry {entry!r}: expected "
                f"'point:TIMES[@SKIP]' or 'point:pRATE[~seedN]'")
        point, _, arm = entry.rpartition(":")
        if arm.startswith("p"):
            rate_s, _, seed_s = arm[1:].partition("~seed")
            out[point] = _Rule(rate=float(rate_s),
                               seed=int(seed_s) if seed_s else 0,
                               from_env=True)
        else:
            times_s, _, after_s = arm.partition("@")
            out[point] = _Rule(times=int(times_s),
                               after=int(after_s) if after_s else 0,
                               from_env=True)
    return out


def _load_env(env: str) -> None:
    global _env_cache
    with _lock:
        _env_cache = env
        for point in [p for p, r in _rules.items() if r.from_env]:
            del _rules[point]
        try:
            _rules.update(parse_spec(env))
        except ValueError:
            # a malformed env spec must not take the process down from
            # inside an instrumented hot path; it just arms nothing
            pass
        _recompute_disarmed()


def maybe_fail(point: str, **ctx) -> None:
    """Evaluate the fault point; raise if a fault is armed and due.

    ``ctx`` kwargs are for call-site readability only (they document
    what the point guards); the raised exception carries the point name
    and per-point hit number.

    Disarmed cost is a single cached emptiness check (the
    ``_disarmed`` bool, maintained by every rule mutation) plus one
    env probe — no lock, no ``_env_cache`` string compare, no dict
    walk, no counting — because this sits in per-row
    and per-step serving paths (the disarmed path never touches
    ``_lock``). The env probe cannot
    be cached away: ``PTPU_FAULTS`` set mid-process (monkeypatch,
    child processes) must arm lazily on the very next evaluation. Hit
    counts therefore accumulate only while at least one rule is armed
    (i.e. during chaos sessions, which is when tests assert wiring
    via ``hits()``/``fired()``).
    """
    if _disarmed and not os.environ.get("PTPU_FAULTS"):
        return
    env = os.environ.get("PTPU_FAULTS", "")
    if env != _env_cache:
        _load_env(env)
    if not _rules:
        return
    with _lock:
        _hits[point] = _hits.get(point, 0) + 1
        rule = _rules.get(point)
        if rule is None or not rule.should_fire():
            return
        _fired[point] = _fired.get(point, 0) + 1
        exc = rule.make_exc(point, _fired[point])
    try:        # observability is optional here (early import paths)
        from ..observability import default_registry
        default_registry().counter(
            "ptpu_fault_injections_total",
            "deliberately injected faults (resilience.faults)",
            labels=("point",)).labels(point=point).inc()
    except Exception:
        pass
    raise exc


def inject(point: str, times: Optional[int] = None, after: int = 0,
           rate: Optional[float] = None, seed: Optional[int] = None,
           exc=None) -> None:
    """Arm a fault at ``point``: fail ``times`` times after skipping
    ``after`` hits, or (``rate``) each hit with seeded probability.
    ``exc`` overrides the raised exception (instance, class, or
    factory)."""
    with _lock:
        _rules[point] = _Rule(times=times, after=after, rate=rate,
                              seed=seed, exc=exc)
        _recompute_disarmed()


def clear(point: Optional[str] = None) -> None:
    """Disarm one point, or every point (``None``)."""
    with _lock:
        if point is None:
            _rules.clear()
        else:
            _rules.pop(point, None)
        _recompute_disarmed()


@contextlib.contextmanager
def injected(point: str, times: Optional[int] = None, after: int = 0,
             rate: Optional[float] = None, seed: Optional[int] = None,
             exc=None):
    """Scoped ``inject``: restores the point's previous rule on exit."""
    with _lock:
        prev = _rules.get(point)
    inject(point, times=times, after=after, rate=rate, seed=seed,
           exc=exc)
    try:
        yield
    finally:
        with _lock:
            if prev is None:
                _rules.pop(point, None)
            else:
                _rules[point] = prev
            _recompute_disarmed()


def hits(point: Optional[str] = None):
    """Evaluation count per point (dict), or for one point (int).
    Counted only while at least one rule is armed (the disarmed hot
    path skips all bookkeeping)."""
    with _lock:
        if point is not None:
            return _hits.get(point, 0)
        return dict(_hits)


def fired(point: Optional[str] = None):
    """Raise count per point (dict), or for one point (int)."""
    with _lock:
        if point is not None:
            return _fired.get(point, 0)
        return dict(_fired)


def reset_counts() -> None:
    with _lock:
        _hits.clear()
        _fired.clear()
