"""Training-step driver of the port (counterpart of ``paddle_tpu/jit``'s
``TrainStep``)."""
from .functional import TrainStep

__all__ = ["TrainStep"]
