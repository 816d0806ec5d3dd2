"""``ReLU`` (counterpart of ``paddle_tpu/nn/layer/activation.py`` :27)."""
from __future__ import annotations

from torch import nn

from ..functional.common import relu

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)
