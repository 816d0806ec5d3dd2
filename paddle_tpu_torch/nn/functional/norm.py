"""Normalisation functionals: RMS and layer normalisation, BatchNorm.

Counterpart of ``paddle_tpu/nn/functional/norm.py``.

``layer_norm`` (:135-164) keeps the reference's order too: mean and
variance in f32, the normalized value rounded to the input dtype, then
the weight multiply and bias add in the input dtype. ``ops/layer_norm.py``
(the trainer's) and ``torch.nn.functional.layer_norm`` apply the affine
in f32 and round once, which differs at bf16, so neither is used here.

``rms_norm`` (:174-189) keeps the reference's order of operations: mean
square in f32, ``rsqrt``, cast back to the input dtype, then the weight
multiply. ``torch.nn.RMSNorm`` rounds at other places, so it is not
used.

``batch_norm`` (:40-133) over ``[N, C, spatial...]`` (the ``NC*``
formats): the training branch takes the batch statistics through the
BN kernels (``ops/batch_norm.py:bn_train``: kernel 1 for the sums,
kernel 2 for the apply, kernels 3 and 4 in the backward) and updates
the running statistics in Paddle's convention
(``_update_running_stats`` :19-37): ``running = momentum * running +
(1 - momentum) * batch``, momentum 0.9 by default, the variance
unbiased by ``n / max(n - 1, 1)``; the opposite of torch's
``momentum=0.1``, so ``torch.nn.functional.batch_norm`` is not used.
The eval branch and ``use_global_stats`` fold the running statistics,
weight and bias into one f32 scale and shift per channel (:104-132) and
run kernel 2 (its backward, when a gradient is needed, kernels 3 and 4).
The reference computes in f32 and returns f32 under AMP (``batch_norm``
and ``bn_stats`` are on its black list), and its next op rounds to the
low dtype; the port reads the low dtype, computes in f32 and writes the
input's dtype once, the same values. ``relu=True`` fuses the relu that
follows in the ResNet blocks into kernel 2 (and its mask into 3 and 4).
"""
from __future__ import annotations

import torch

from ...ops import batch_norm as _bn

__all__ = ["batch_norm", "layer_norm", "rms_norm"]


def rms_norm(x, weight=None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1):
    axis = begin_norm_axis if begin_norm_axis >= 0 \
        else x.dim() + begin_norm_axis
    dims = tuple(range(axis, x.dim()))
    xf = x.float()
    ms = xf.square().mean(dim=dims, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    n = len(normalized_shape) if isinstance(normalized_shape,
                                            (list, tuple)) else 1
    dims = tuple(range(x.dim() - n, x.dim()))
    xf = x.float()
    centred = xf - xf.mean(dim=dims, keepdim=True)
    var = centred.square().mean(dim=dims, keepdim=True)
    out = (centred * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@torch.no_grad()
def _update_running_stats(running_mean, running_var, mean, var,
                          momentum: float, n: int) -> None:
    """Paddle's EMA in f32, in the reference's order of operations."""
    unbiased = var * (n / max(n - 1, 1))
    running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
    running_var.copy_(momentum * running_var + (1 - momentum) * unbiased)


class _BNApply(torch.autograd.Function):
    """``y = x * scale[c] + shift[c]`` (relu) with fixed statistics:
    kernel 2 forward; kernel 3 (Σdy for dshift, Σdy·x for dscale) and
    kernel 4 (``dx = scale * dy``) backward."""

    @staticmethod
    def forward(ctx, x3, scale, shift, relu):
        ctx.save_for_backward(x3, scale, shift)
        ctx.relu = relu
        return _bn.bn_apply(x3, scale, shift, relu)

    @staticmethod
    def backward(ctx, dy3):
        x3, scale, shift = ctx.saved_tensors
        relu_from = (scale, shift) if ctx.relu else None
        dshift, dscale = _bn.bn_gsum(dy3, x3, relu_from)
        zero = torch.zeros_like(scale)
        dx = _bn.bn_dx(dy3, x3, scale, zero, zero, relu_from)
        return dx, dscale, dshift, None


def _view3(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None, name=None, *, relu: bool = False):
    """BatchNorm over the channel axis 1 of ``x`` (``NCL``, ``NCHW``,
    ``NCDHW``); the running statistics are updated in place when the
    batch statistics are used. ``relu`` applies ``max(y, 0)`` in the
    same pass."""
    if not data_format.startswith("NC"):
        raise NotImplementedError(
            f"batch_norm data_format={data_format!r}: the port's BN kernels "
            f"take the channel axis 1 (NCL/NCHW/NCDHW); channel-last "
            f"layouts are a later slice")
    if x.dim() < 2:
        raise ValueError(f"batch_norm takes [N, C, ...]; got "
                         f"{tuple(x.shape)}")
    if training and not use_global_stats:
        y, mean, var = _bn.bn_train(x, weight, bias, epsilon, relu)
        _update_running_stats(running_mean, running_var, mean, var,
                              momentum, x.numel() // x.shape[1])
        return y
    _, scale, shift = _bn.bn_fold(running_mean, running_var, weight, bias,
                                  epsilon)
    x3 = _view3(x.contiguous())
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)
            or (bias is not None and bias.requires_grad)):
        return _BNApply.apply(x3, scale, shift, relu).view(x.shape)
    return _bn.bn_apply(x3, scale, shift, relu).view(x.shape)
