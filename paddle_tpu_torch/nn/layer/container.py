"""``Sequential`` (counterpart of ``paddle_tpu/nn/layer/container.py``
:13): ``torch.nn.Sequential`` names its sublayers "0", "1", ... in order,
as the reference's does, and its slices keep them."""
from torch.nn import Sequential

__all__ = ["Sequential"]
