"""paddle_tpu_torch.resilience — fault points and the laws the serving
engine's failure paths are held to (counterpart of
``paddle_tpu/resilience``: ``faults`` and ``invariants``; the reference's
chaos soak, retry policy and resilient train loop come with later
slices of the port).

Recovery itself is ``ServingEngine.recover()``: after a failed step it
rebuilds the KV state from host-side request state and re-prefills
every in-flight request."""
from . import faults  # noqa: F401
from .faults import InjectedFault, maybe_fail  # noqa: F401
from .invariants import (ConservationLedger, InvariantViolation,
                         engine_leak_violations, page_leak_violations,
                         token_prefix_violations)

__all__ = ["faults", "InjectedFault", "maybe_fail", "ConservationLedger",
           "InvariantViolation", "engine_leak_violations",
           "page_leak_violations", "token_prefix_violations"]
