"""``Linear`` (counterpart of ``paddle_tpu/nn/layer/common.py`` :18):
Paddle's ``[in_features, out_features]`` weight from ``XavierNormal``
and a zero bias, f32 from the layer's generator; ``functional.linear``
computes ``x @ W + b``. ``torch.nn.Linear`` keeps ``[out, in]``, so it
is not used, and weights cross from the reference without a
transpose."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from ..functional.common import linear
from ._init import default_generator, xavier_normal
from .norm import _attr

__all__ = ["Linear"]


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(dev, generator)
        self._in_features = in_features
        self._out_features = out_features
        _attr(weight_attr, "weight_attr")
        self.weight = nn.Parameter(xavier_normal(
            (in_features, out_features), dev, gen))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=torch.float32, device=dev)) \
            if _attr(bias_attr, "bias_attr") else None

    def forward(self, input):
        return linear(input, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, " \
               f"out_features={self._out_features}"
