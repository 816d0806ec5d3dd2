"""Norm layers: ``RMSNorm``, ``LayerNorm`` and the BatchNorms.

Counterpart of ``paddle_tpu/nn/layer/norm.py``: ``RMSNorm`` (weight
``[hidden]`` initialised to ones, applied by ``functional.rms_norm``),
``LayerNorm`` (:87-113: weight ones and bias zeros in the model dtype,
epsilon 1e-5, applied by ``functional.layer_norm``) and ``_BatchNormBase``, ``BatchNorm``, ``BatchNorm1D``/``2D``/``3D``
(:15-72): weight ones and bias zeros (f32; ``weight_attr=False`` /
``bias_attr=False`` drop them), the running statistics in the
reference's buffer names ``_mean`` (zeros) and ``_variance`` (ones),
momentum 0.9 in Paddle's convention. ``forward(x, relu=False)``:
``relu=True`` fuses the relu that follows into the BN kernels (the
ResNet blocks use it; the result is the reference's ``relu(bn(x))``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import resolve_device
from ..functional.norm import batch_norm, layer_norm, rms_norm

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            self.normalized_shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            self.normalized_shape, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)


def _attr(attr, what: str) -> bool:
    """Whether the parameter exists: ``None`` yes, ``False`` no; a
    ``ParamAttr`` (initializer, learning rate, ...) is not ported."""
    if attr is None:
        return True
    if attr is False:
        return False
    raise NotImplementedError(f"{what}={attr!r}: only None or False is "
                              f"ported")


class _BatchNormBase(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        f32 = dict(dtype=torch.float32, device=dev)
        self.weight = nn.Parameter(torch.ones(num_features, **f32)) \
            if _attr(weight_attr, "weight_attr") else None
        self.bias = nn.Parameter(torch.zeros(num_features, **f32)) \
            if _attr(bias_attr, "bias_attr") else None
        self.register_buffer("_mean", torch.zeros(num_features, **f32))
        self.register_buffer("_variance", torch.ones(num_features, **f32))

    def forward(self, input, relu: bool = False):
        return batch_norm(input, self._mean, self._variance, self.weight,
                          self.bias, self.training, self._momentum,
                          self._epsilon, self._data_format,
                          self._use_global_stats, relu=relu)

    def extra_repr(self):
        return f"num_features={self._num_features}, " \
               f"momentum={self._momentum}, epsilon={self._epsilon}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCL", use_global_stats=None, name=None,
                 *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL"
                         else data_format, use_global_stats, device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCDHW", use_global_stats=None,
                 name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)
