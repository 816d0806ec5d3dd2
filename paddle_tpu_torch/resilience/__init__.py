"""paddle_tpu_torch.resilience — the audits the serving engine's failure
paths are held to (counterpart of ``paddle_tpu/resilience``; the fault
points and ``recover()`` come with the resilience slice)."""
from .invariants import engine_leak_violations, page_leak_violations

__all__ = ["engine_leak_violations", "page_leak_violations"]
