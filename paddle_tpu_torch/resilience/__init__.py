"""paddle_tpu_torch.resilience — fault points, the laws the serving
engine's failure paths are held to, and the seeded chaos soak
(counterpart of ``paddle_tpu/resilience``: ``faults``, ``invariants``
and ``chaos``'s serving episode; the reference's retry policy,
resilient train loop and the training, front-door and cluster episodes
come with later slices of the port).

Recovery itself is ``ServingEngine.recover()``: after a failed step it
rebuilds the KV state from host-side request state and writes every
in-flight request's KV again. ``chaos.run_serving_episode(seed)`` drives
the engine through a seeded fault schedule and audits every law."""
from . import faults  # noqa: F401
from .faults import InjectedFault, maybe_fail  # noqa: F401
from .invariants import (ConservationLedger, InvariantViolation,
                         engine_leak_violations, page_leak_violations,
                         token_prefix_violations)
from . import chaos  # noqa: F401

__all__ = ["faults", "chaos", "InjectedFault", "maybe_fail",
           "ConservationLedger", "InvariantViolation",
           "engine_leak_violations", "page_leak_violations",
           "token_prefix_violations"]
