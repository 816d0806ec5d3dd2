"""2-D convolution.

Counterpart of ``paddle_tpu/nn/functional/conv.py`` ``conv2d`` (:78,
``_conv`` :42 over ``lax.conv_general_dilated``, XLA and not Pallas, so
the port hands it to ``torch.nn.functional.conv2d``, cuDNN on the card).
Weight ``[O, I/groups, kH, kW]``; padding is normalised as the
reference's ``_padding`` (:29) does: an int, ``[pH, pW]``, ``[top,
bottom, left, right]``, pairs, or ``"SAME"``/``"VALID"`` with XLA's
rule (SAME puts the odd pixel at the end). Asymmetric padding is padded
explicitly, symmetric padding goes to the convolution. Under
``auto_cast`` the inputs are cast as the reference's ``apply_op`` casts
them (O2: the f32 image down to the low dtype). Channel-last layouts
raise: the port keeps NCHW, the BN kernels' layout.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import autocast_inputs

__all__ = ["conv2d"]


def _tuple(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(i) for i in v)
    return tuple(int(v) for _ in range(n))


def _padding(padding, n: int):
    """The reference's ``_padding``: a string (upper-cased) or ``n``
    (low, high) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def same_pads(sizes, kernel, stride, dilation) -> List[Tuple[int, int]]:
    """XLA's SAME padding: output ceil(in / stride), the odd pixel at the
    high end."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        k_eff = d * (k - 1) + 1
        total = max((math.ceil(size / s) - 1) * s + k_eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCHW", name=None):
    if data_format != "NCHW":
        raise NotImplementedError(
            f"conv2d data_format={data_format!r}: the port keeps NCHW (the "
            f"BN kernels' layout); channel-last is a later slice")
    x, weight, bias = autocast_inputs("conv2d", x, weight, bias)
    strides = _tuple(stride, 2)
    dil = _tuple(dilation, 2)
    pad = _padding(padding, 2)
    if isinstance(pad, str):
        if pad == "VALID":
            pad = [(0, 0), (0, 0)]
        elif pad == "SAME":
            pad = same_pads(x.shape[2:], weight.shape[2:], strides, dil)
        else:
            raise ValueError(f"padding {padding!r}: expected 'SAME', "
                             f"'VALID', ints or pairs")
    if all(lo == hi for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        (top, bottom), (left, right) = pad
        x = TF.pad(x, (left, right, top, bottom))
        sym = (0, 0)
    return TF.conv2d(x, weight, bias, strides, sym, dil, groups)
