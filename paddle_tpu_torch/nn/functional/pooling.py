"""2-D max pooling and adaptive average pooling.

Counterpart of ``paddle_tpu/nn/functional/pooling.py`` ``max_pool2d``
(:76, ``_pool`` over ``lax.reduce_window`` with a ``-inf`` init) and
``adaptive_avg_pool2d`` (:151, ``_adaptive``): XLA in the reference,
``torch.nn.functional`` here. Padding follows the reference's
``_pad_cfg`` (:25): symmetric pads, and ``ceil_mode`` adds the missing
window's pixels at the high end, padded with ``-inf``. Adaptive
pooling's regions are the reference's (``floor(i * in / out)`` to
``ceil((i + 1) * in / out)``), which are torch's. Both read and write
the input's dtype (bf16 under AMP O2, with f32 accumulation in the
average).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import autocast_inputs
from .conv import _tuple, same_pads

__all__ = ["adaptive_avg_pool2d", "max_pool2d"]


def _pool_pads(padding, in_sizes, k, s, ceil_mode: bool):
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_pads(in_sizes, k, s, (1, 1))
        return [(0, 0), (0, 0)]
    p = _tuple(padding, 2)
    pads = [(pi, pi) for pi in p]
    if ceil_mode:
        out = []
        for i in range(2):
            size = in_sizes[i] + 2 * p[i]
            rem = (size - k[i]) % s[i]
            out.append((p[i], p[i] + ((s[i] - rem) % s[i] if rem else 0)))
        pads = out
    return pads


def max_pool2d(x, kernel_size, stride=None, padding=0,
               return_mask: bool = False, ceil_mode: bool = False,
               data_format: str = "NCHW", name=None):
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported: no path of the port needs it")
    if data_format != "NCHW":
        raise NotImplementedError(f"max_pool2d data_format={data_format!r}:"
                                  f" the port keeps NCHW")
    (x,) = autocast_inputs("max_pool2d", x)
    k = _tuple(kernel_size, 2)
    s = _tuple(stride if stride is not None else kernel_size, 2)
    pads = _pool_pads(padding, x.shape[2:], k, s, ceil_mode)
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        return TF.max_pool2d(x, k, s, tuple(lo for lo, _ in pads))
    (top, bottom), (left, right) = pads
    x = TF.pad(x, (left, right, top, bottom), value=float("-inf"))
    return TF.max_pool2d(x, k, s, 0)


def adaptive_avg_pool2d(x, output_size, data_format: str = "NCHW",
                        name=None):
    if data_format != "NCHW":
        raise NotImplementedError(f"adaptive_avg_pool2d data_format="
                                  f"{data_format!r}: the port keeps NCHW")
    (x,) = autocast_inputs("adaptive_avg_pool2d", x)
    return TF.adaptive_avg_pool2d(x, _tuple(output_size, 2))
