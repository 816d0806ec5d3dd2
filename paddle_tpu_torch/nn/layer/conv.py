"""``Conv2D``.

Counterpart of ``paddle_tpu/nn/layer/conv.py`` ``Conv2D`` (:72, over
``_ConvNd`` :18): weight ``[out, in/groups, kH, kW]`` from
``KaimingUniform(fan_in)`` (:43), bias (unless ``bias_attr=False``)
uniform in ±1/sqrt(fan_in), both f32 from the layer's generator;
``functional.conv2d`` applies it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from ..functional.conv import conv2d
from ._init import default_generator, kaiming_uniform, uniform
from .norm import _attr

__all__ = ["Conv2D"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class Conv2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"Conv2D padding_mode={padding_mode!r}"
                                      f": only 'zeros' is ported")
        dev = resolve_device(device)
        gen = default_generator(dev, generator)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        _attr(weight_attr, "weight_attr")
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = nn.Parameter(kaiming_uniform(
            (out_channels, in_channels // groups, *self._kernel_size),
            fan_in, dev, gen))
        if _attr(bias_attr, "bias_attr"):
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = nn.Parameter(uniform((out_channels,), -bound, bound,
                                             dev, gen))
        else:
            self.bias = None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")
