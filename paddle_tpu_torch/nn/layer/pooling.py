"""``MaxPool2D`` and ``AdaptiveAvgPool2D`` (counterpart of
``paddle_tpu/nn/layer/pooling.py`` :42, :104)."""
from __future__ import annotations

from torch import nn

from ..functional.pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["AdaptiveAvgPool2D", "MaxPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask: bool = False, ceil_mode: bool = False,
                 data_format: str = "NCHW", name=None):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride,
                        padding=padding, return_mask=return_mask,
                        ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return max_pool2d(x, **self._kw)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format: str = "NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self._output_size, self._data_format)
