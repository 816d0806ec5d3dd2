"""The serving control plane's chunk-budget controller and the shared
actuator it acts through.

Counterpart of ``paddle_tpu/serving/control.py`` ``Actuator`` (:61-153)
and ``ChunkBudgetController`` (:261-356), copies (the port never imports
the reference package); the brownout controller, prefix affinity, the
autoscaler and ``ControlPlane`` come with later slices. The contract
the reference's controllers share:

* **No RNG, no clock.** Every decision is a pure function of the
  metric stream observed so far, so the same stream gives the same
  action sequence.
* **Hysteresis dead band.** A controller raises at one threshold and
  lowers at a strictly easier one; constructors reject equal ones.
* **Dwell gate.** After a transition a controller holds its setting
  for ``dwell`` steps before reconsidering.
* **Rate-limited actuation with a fault point.** Every actuation passes
  through the shared :class:`Actuator`, which enforces a per-window
  budget and threads a ``control.*`` fault point. A fault (or a spent
  budget) suppresses THAT actuation and nothing else: the engine keeps
  its last applied setting.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..observability import default_registry
from ..resilience.faults import InjectedFault, maybe_fail

__all__ = ["Actuator", "ChunkBudgetController"]


def _ewma(prev: Optional[float], x: float, alpha: float) -> float:
    return x if prev is None else prev + alpha * (x - prev)


class Actuator:
    """Shared rate limiter + fault seam for every control actuation.

    Deterministic: the window is counted in controller steps (one per
    engine step), not wall time.  ``allow`` answers
    whether ONE actuation of ``kind`` may proceed right now; a denial
    is always safe because every caller fails static (keep the last
    setting) or open (admit the request).
    """

    KINDS = ("shed", "chunk", "affinity", "scale")
    DEFAULT_BUDGETS = {"shed": 64, "chunk": 4, "affinity": 256, "scale": 1}

    def __init__(self, *, window: int = 32,
                 budgets: Optional[Dict[str, int]] = None,
                 registry=None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.budgets = dict(self.DEFAULT_BUDGETS)
        if budgets:
            for k, v in budgets.items():
                if k not in self.DEFAULT_BUDGETS:
                    raise ValueError(f"unknown actuation kind {k!r}")
                if int(v) < 0:
                    raise ValueError(f"budget for {k!r} must be >= 0")
                self.budgets[k] = int(v)
        self._step = 0
        self._win_id = 0
        self._win_counts = {k: 0 for k in self.KINDS}
        self.applied = {k: 0 for k in self.KINDS}
        self.suppressed = {k: 0 for k in self.KINDS}
        self.faulted = {k: 0 for k in self.KINDS}
        self.last: Dict[str, int] = {}
        reg = registry if registry is not None else default_registry()
        self._m_applied = reg.counter(
            "ptpu_control_actuations_total",
            "control-plane actuations applied", labels=("kind",))
        self._m_suppressed = reg.counter(
            "ptpu_control_suppressed_total",
            "control-plane actuations suppressed (budget or fault)",
            labels=("kind",))

    def on_step(self) -> None:
        self._step += 1
        wid = self._step // self.window
        if wid != self._win_id:
            self._win_id = wid
            for k in self._win_counts:
                self._win_counts[k] = 0

    def allow(self, kind: str, **ctx) -> bool:
        if kind not in self._win_counts:
            raise ValueError(f"unknown actuation kind {kind!r}")
        if self._win_counts[kind] >= self.budgets[kind]:
            self.suppressed[kind] += 1
            self._m_suppressed.labels(kind=kind).inc()
            return False
        try:
            # literal point names: each call site names its point
            if kind == "shed":
                maybe_fail("control.shed", **ctx)
            elif kind == "chunk":
                maybe_fail("control.chunk", **ctx)
            elif kind == "affinity":
                maybe_fail("control.affinity", **ctx)
            else:
                maybe_fail("control.scale", **ctx)
        except InjectedFault:
            # Contained: a faulted actuator drops this one actuation;
            # the data plane keeps its last applied setting.
            self.faulted[kind] += 1
            self.suppressed[kind] += 1
            self._m_suppressed.labels(kind=kind).inc()
            return False
        self._win_counts[kind] += 1
        self.applied[kind] += 1
        self.last[kind] = self._step
        self._m_applied.labels(kind=kind).inc()
        return True

    def snapshot(self) -> dict:
        return {"step": self._step,
                "applied": dict(self.applied),
                "suppressed": dict(self.suppressed),
                "faulted": dict(self.faulted),
                "last": dict(self.last)}


class ChunkBudgetController:
    """Adaptive per-step prefill token budget.

    The controller never changes the chunk SIZE (``prefill_chunk``,
    one set of kernel and matmul shapes); it changes how many chunks
    the engine may run per step, as ``mults[i] * chunk`` tokens.  Deep admission queues push
    the budget up (drain prefill backlog, protect TTFT); a heavy
    active-decode population pulls it down (each extra chunk stalls
    every running decode).
    """

    def __init__(self, *, raise_depth: float = 6.0,
                 lower_depth: float = 2.0, stall_brake: float = 8.0,
                 alpha: float = 0.5, dwell: int = 8,
                 mults: Sequence[int] = (1, 2, 4),
                 actuator: Optional[Actuator] = None,
                 registry=None):
        if lower_depth >= raise_depth:
            raise ValueError(
                f"lower_depth must be < raise_depth for a dead band "
                f"(got lower {lower_depth} >= raise {raise_depth})")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if dwell < 1:
            raise ValueError(f"dwell must be >= 1, got {dwell}")
        mults = tuple(int(m) for m in mults)
        if not mults or any(m < 1 for m in mults) \
                or list(mults) != sorted(set(mults)):
            # mult 0 would admit nothing and starve the engine into
            # EngineIdle; duplicates/disorder would break hysteresis.
            raise ValueError(
                f"mults must be distinct ascending positive ints, "
                f"got {mults}")
        self.raise_depth, self.lower_depth = float(raise_depth), float(lower_depth)
        self.stall_brake = float(stall_brake)
        self.alpha = float(alpha)
        self.dwell = int(dwell)
        self.mults = mults
        self.actuator = actuator
        self.adaptations = 0  # == flips, in SpecTuner terms
        self._idx = 0
        self._step = 0
        self._since = 0
        self._ewma_depth: Optional[float] = None
        self._ewma_stall: Optional[float] = None
        reg = registry if registry is not None else default_registry()
        self._m_budget = reg.gauge(
            "ptpu_control_chunk_budget",
            "adaptive prefill token budget for the current step")
        self._m_adapt = reg.counter(
            "ptpu_control_chunk_adaptations_total",
            "chunk-budget level transitions applied")

    @property
    def mult(self) -> int:
        return self.mults[self._idx]

    @property
    def flips(self) -> int:
        return self.adaptations

    def step_budget(self, chunk: int, depth: float,
                    stall: float = 0.0) -> int:
        """Token budget for this engine step.  ``depth`` is queued +
        chunk-pending work; ``stall`` is the active-decode population
        (the requests each extra chunk would stall)."""
        self._step += 1
        self._ewma_depth = _ewma(self._ewma_depth, float(depth), self.alpha)
        self._ewma_stall = _ewma(self._ewma_stall, float(stall), self.alpha)
        if self._step - self._since >= self.dwell:
            want = None
            if self._ewma_stall >= self.stall_brake and self._idx > 0:
                want = self._idx - 1
            elif self._ewma_depth >= self.raise_depth \
                    and self._idx < len(self.mults) - 1:
                want = self._idx + 1
            elif self._ewma_depth <= self.lower_depth and self._idx > 0:
                want = self._idx - 1
            if want is not None and (
                    self.actuator is None or self.actuator.allow(
                        "chunk", mult=self.mults[want])):
                self._idx = want
                self._since = self._step
                self.adaptations += 1
                self._m_adapt.inc()
        budget = self.mults[self._idx] * int(chunk)
        self._m_budget.set(float(budget))
        return budget

    def snapshot(self) -> dict:
        return {"step": self._step, "mult": self.mult,
                "adaptations": self.adaptations, "dwell": self.dwell,
                "ewma_depth": self._ewma_depth,
                "ewma_stall": self._ewma_stall}
