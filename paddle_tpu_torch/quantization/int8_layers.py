"""Weight-only int8 serving layers: int8 weights with per-output-channel
scales, activations quantized per call, an int8 product.

Counterpart of ``paddle_tpu/quantization/int8_layers.py`` (``Int8Linear``
:40, ``weight_only_int8`` :156), which is XLA in the reference: the
activation quantize (a static scale from calibration, or a dynamic
per-row one), an int8 ``dot_general`` with int32 accumulation, and the
f32 dequant ``y * x_scale * w_scale``. Here the dynamic quantize is
kernel row 8 (``ops/quant_matmul.quantize_rows``, the same formula), the
product ``torch._int_mm`` through ``int8_dot_dequant`` (the same
epilogue order). ``Int8Conv2D`` comes with the vision slice of the port:
``weight_only_int8`` raises on a convolution the reference would swap.

Layout: ``wq`` is the reference's ``[in, out]``, held as the transposed
view of an ``[out, in]``-contiguous buffer: the column-major B that
``torch._int_mm`` takes at full rate.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as TF

from ..ops.quant_matmul import int8_dot_dequant, quantize_rows
from ._swap import swap_layers

__all__ = ["Int8Linear", "weight_only_int8"]

# torch._int_mm on CUDA takes only more than 16 rows of A; a decode step
# has 1-16, so the codes are padded with zero rows to this many and the
# product sliced back (the int32 sums of the real rows do not change)
_INT_MM_MIN_ROWS = 17


def _quantize_weight(w, axis: int):
    """Symmetric per-channel int8 in ``w``'s dtype, as the reference's
    numpy ops compute it: ``(q int8, scale f32)`` with ``w ~= q * scale``
    and ``axis`` (the output channels) kept in the scale."""
    red = [i for i in range(w.dim()) if i != axis]
    amax = w.abs().amax(dim=red, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax) \
        / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


class Int8Linear(nn.Module):
    """W8A8 linear from ``source`` (an ``nn.Linear``): per-output-channel
    weight scales, and the activation scale static (``act_absmax`` from
    calibration: ``max / 127``) or, with ``act_absmax=None``, dynamic per
    row. Inference only: the output carries no gradient."""

    def __init__(self, source: nn.Linear, act_absmax=None):
        super().__init__()
        q, s = _quantize_weight(source.weight.detach(), axis=0)  # [out, in]
        act_scale = None
        if act_absmax is not None:
            if isinstance(act_absmax, torch.Tensor):
                act_absmax = act_absmax.detach().cpu().numpy()
            act_scale = float(np.asarray(act_absmax).max() / 127.0)
        self._set(q.t(), s.reshape(-1), source.bias, act_scale)

    @classmethod
    def from_codes(cls, wq, w_scale, bias=None) -> "Int8Linear":
        """The layer holding int8 codes ``wq`` (``[in, out]``) and scales
        ``w_scale`` (``[out]``) as they are, with a dynamic activation
        scale."""
        if wq.dtype != torch.int8 or wq.dim() != 2 \
                or tuple(w_scale.shape) != (wq.shape[1],):
            raise ValueError(
                f"int8 codes {wq.dtype}{tuple(wq.shape)} and scales "
                f"{tuple(w_scale.shape)} are not an [in, out] int8 weight "
                f"with [out] scales")
        layer = cls.__new__(cls)
        nn.Module.__init__(layer)
        layer._set(wq.t().contiguous().t(), w_scale, bias, None)
        return layer

    def _set(self, wq, w_scale, bias, act_scale) -> None:
        self.in_features, self.out_features = wq.shape
        self.register_buffer("wq", wq)              # [in, out], column-major
        self.register_buffer("w_scale", w_scale.float())
        self.register_parameter("bias", bias)
        self.act_scale = act_scale

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, act_scale={self.act_scale}, "
                f"bias={self.bias is not None}")

    @torch.no_grad()
    def forward(self, x):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features).contiguous()
        if self.act_scale is None:
            xq, xs = quantize_rows(x2)              # kernel row 8
        else:
            xs = torch.full((1, 1), self.act_scale, dtype=torch.float32,
                            device=x.device)
            xq = torch.clamp(torch.round(x2.float() / xs), -127,
                             127).to(torch.int8)
        M = xq.shape[0]
        pad = max(0, _INT_MM_MIN_ROWS - M)
        if pad:
            xq = TF.pad(xq, (0, 0, 0, pad))
            if xs.shape[0] == M:
                xs = TF.pad(xs, (0, 0, 0, pad), value=1.0)
        y = int8_dot_dequant(xq, xs, self.wq, self.w_scale)[:M]
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype).reshape(*lead, self.out_features)


def _swapped_conv(model: nn.Module, min_features: int):
    """The first ``nn.Conv2d`` the reference's ``weight_only_int8`` would
    swap for an ``Int8Conv2D``, or None."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d) \
                and mod.weight.shape[1] >= min_features // 4:
            return name
    return None


def weight_only_int8(model: nn.Module, min_features: int = 256,
                     inplace: bool = True) -> nn.Module:
    """Swap every ``nn.Linear`` whose weight is at least ``min_features``
    on both sides for an ``Int8Linear`` with dynamic activation scales
    (no calibration): int8 weights with per-channel scales, half the
    bytes of bf16. A convolution the reference would swap raises
    ``NotImplementedError`` before anything is swapped."""
    conv = _swapped_conv(model, min_features)
    if conv is not None:
        raise NotImplementedError(
            f"weight_only_int8: {conv!r} is an nn.Conv2d the reference "
            f"swaps for Int8Conv2D, which comes with the vision slice of "
            f"the port")

    def factory(child):
        if isinstance(child, nn.Linear) \
                and min(child.weight.shape) >= min_features:
            return Int8Linear(child, None)
        return None

    return swap_layers(model, factory, inplace=inplace)
