"""Accept-rate autotuning for speculative decoding.

A verbatim port of ``paddle_tpu/serving/spec_tune.py``: pure host code,
no RNG and no clock, so a tuned engine replays a trace the same way.

Speculation pays only when drafts are accepted: a k-wide verify step
costs about k times the work of a k=1 decode step over the same
weights, so at accepted length a the gain is about a a step, and the
draft model adds its own forwards. Which proposer wins (n-gram lookup
or a draft model) and which window k pays depends on the traffic. The
tuner feeds per-request-class EWMAs of the accepted length back into a
per-step (k, proposer) decision.

Hysteresis is the point: the tuner routes each row between the k-wide
verify and the k=1 decode (its k caps the draft length inside the
verify, a row drafting d tokens runs at write length d + 1), and an
accepted length measured while speculation is off is stale, so
dwell-gated thresholds and a fixed probe cadence (every
``probe_every`` steps while off, one k=2 probe step, round-robin over
proposers) keep its decisions piecewise constant and replayable.
``ServingEngine.spec_stats()["tuner"]`` reports its state.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["SpecTuner"]

# request classes tuned independently: greedy acceptance is exact
# token match (brittle, often long runs), sampled acceptance is
# probabilistic min(1, p/q) (smoother, usually shorter runs) — one
# EWMA would average two different regimes into tuning neither
CLASSES = ("greedy", "sampled")


class SpecTuner:
    """Per-request-class (k, proposer) controller over accepted-length
    EWMAs. ``decide(klass)`` is read per row per step; ``observe``
    feeds verified accepted lengths back; ``on_step`` advances the
    clock and applies the dwell-gated transitions.

    Knobs (all deterministic):

    - ``k_max``: ceiling for the tuned k (the engine's compiled
      ``spec_k``; the tuner never exceeds the program window).
    - ``alpha``: EWMA smoothing for accepted length.
    - ``enable_at`` / ``disable_at``: accepted-length thresholds for
      turning speculation on / off, split apart so the controller has
      a dead band instead of a flap line.
    - ``dwell``: minimum steps between state flips for one class.
    - ``probe_every``: while off, run one k=2 probe step at this
      cadence (round-robin over proposers) so the EWMA can recover
      when traffic turns draftable again.
    - ``switch_margin``: a rival proposer must beat the incumbent's
      EWMA by this much before the tuner switches kinds.
    """

    def __init__(self, k_max: int,
                 proposers: Sequence[str] = ("ngram",),
                 alpha: float = 0.25,
                 enable_at: float = 1.35,
                 disable_at: float = 1.15,
                 dwell: int = 8,
                 probe_every: int = 32,
                 switch_margin: float = 0.25):
        if k_max < 2:
            raise ValueError(f"k_max must be >= 2, got {k_max}")
        if not proposers:
            raise ValueError("at least one proposer kind required")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if disable_at > enable_at:
            raise ValueError(
                f"disable_at={disable_at} must not exceed "
                f"enable_at={enable_at} (the dead band)")
        self.k_max = int(k_max)
        self.proposers = tuple(proposers)
        self.alpha = float(alpha)
        self.enable_at = float(enable_at)
        self.disable_at = float(disable_at)
        self.dwell = int(dwell)
        self.probe_every = int(probe_every)
        self.switch_margin = float(switch_margin)
        self._step = 0
        # (klass, kind) -> EWMA accepted length (None until seen)
        self._ewma: Dict[Tuple[str, str], Optional[float]] = {
            (c, p): None for c in CLASSES for p in self.proposers}
        # optimistic start: speculate from step 0 with the first
        # proposer at full k — the EWMA then earns (or loses) it
        self._st = {c: {"on": True, "k": self.k_max,
                        "kind": self.proposers[0], "since": 0,
                        "probe_i": 0}
                    for c in CLASSES}
        self.flips = 0                      # state transitions (tests)

    # -- per-row read --------------------------------------------------
    def decide(self, klass: str) -> Tuple[int, Optional[str]]:
        """(k, proposer kind) for a row of this class THIS step; kind
        None means don't draft (the row runs wlen=1 — and when every
        row says so, the engine's spec_gate routes the whole step onto
        the cheap k=1 decode program)."""
        st = self._st[klass]
        if st["on"]:
            return st["k"], st["kind"]
        if self.probe_every > 0 \
                and self._step % self.probe_every == 0:
            kind = self.proposers[st["probe_i"] % len(self.proposers)]
            return 2, kind
        return 1, None

    # -- feedback ------------------------------------------------------
    def observe(self, klass: str, kind: str, accepted: int) -> None:
        """Feed one verified row's accepted length (1 = only the base
        token, i.e. every draft rejected)."""
        key = (klass, kind)
        prev = self._ewma.get(key)
        x = float(accepted)
        self._ewma[key] = x if prev is None \
            else prev + self.alpha * (x - prev)

    def on_step(self) -> None:
        """Advance the step clock and apply dwell-gated transitions."""
        # rotate the probe cursor when a probe step just ran, so the
        # next probe exercises the other proposer
        for c in CLASSES:
            st = self._st[c]
            if not st["on"] and self.probe_every > 0 \
                    and self._step % self.probe_every == 0:
                st["probe_i"] += 1
        self._step += 1
        for c in CLASSES:
            self._evaluate(c)

    def _evaluate(self, klass: str) -> None:
        st = self._st[klass]
        if self._step - st["since"] < self.dwell:
            return
        seen = [(kind, self._ewma[(klass, kind)])
                for kind in self.proposers
                if self._ewma[(klass, kind)] is not None]
        if not seen:
            return
        best_kind, best = max(seen, key=lambda kv: kv[1])
        if st["on"]:
            cur = self._ewma.get((klass, st["kind"]))
            if cur is not None and cur < self.disable_at \
                    and best < self.enable_at:
                st.update(on=False, since=self._step)
                self.flips += 1
                return
            if best_kind != st["kind"] and cur is not None \
                    and best > cur + self.switch_margin:
                st.update(kind=best_kind, since=self._step)
                self.flips += 1
            k = min(self.k_max, max(2, int(math.ceil(
                self._ewma[(klass, st["kind"])] or 2)) + 1))
            st["k"] = k
        elif best > self.enable_at:
            k = min(self.k_max, max(2, int(math.ceil(best)) + 1))
            st.update(on=True, kind=best_kind, k=k,
                      since=self._step)
            self.flips += 1

    # -- readout -------------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic state dump (``spec_stats()["tuner"]``)."""
        return {
            "step": self._step,
            "flips": self.flips,
            "classes": {
                c: {"on": self._st[c]["on"],
                    "k": self._st[c]["k"] if self._st[c]["on"] else 1,
                    "kind": self._st[c]["kind"]
                    if self._st[c]["on"] else None,
                    "ewma": {p: self._ewma[(c, p)]
                             for p in self.proposers}}
                for c in CLASSES},
        }
