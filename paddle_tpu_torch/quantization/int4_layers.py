"""Weight-only int4 serving layers: per-group scales, two weights a byte.

Counterpart of ``paddle_tpu/quantization/int4_layers.py``. The weights
live as packed uint8 nibble pairs (``ops/int4_matmul.pack_rows_int4``,
halves layout) with f32 scales per (group of input rows, output column),
and the unpack and the scales run inside the matmul kernel
(``csrc/int4_matmul.cu``, kernel row 7): no dequantized weight is
written. The reference's verdict that int4 decode does not pay
(``README.md``, "int4 measured and rejected") was measured on a TPU
v5e; the port's numbers on the H100 are in ``PERF.md``.

Layout: the port's ``nn.Linear.weight`` is ``[out, in]``, the
reference's ``[in, out]``. ``Int4Linear`` quantizes the ``[in, out]``
transpose, so its buffers ``wq`` (uint8 ``[in/2, out]``) and
``w_scale`` (f32 ``[in/group, out]``) are named and laid out as the
reference's, and ``models/convert.py`` copies them untransposed.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.int4_matmul import int4_matmul, pack_rows_int4, quantize_int4_rows
from ._swap import swap_layers

__all__ = ["Int4Linear", "pack_rows_int4", "quantize_int4_rows",
           "weight_only_int4"]


class Int4Linear(nn.Module):
    """Weight-only int4 linear built from ``source`` (an ``nn.Linear``).
    When ``group`` does not divide ``in_features / 2`` (the halves
    layout gives whole groups to each nibble half), it falls back to
    ``gcd(in_features / 2, group)``, as the reference does: Llama-1B's
    ``down_proj`` (in 5504) takes 64 for 128. Inference only: the output
    carries no gradient."""

    def __init__(self, source: nn.Linear, group: int = 128):
        super().__init__()
        w = source.weight.detach().t()              # [in, out]
        if (w.shape[0] // 2) % group:
            group = math.gcd(w.shape[0] // 2, group)
        q, scale = quantize_int4_rows(w, group)
        self._set(pack_rows_int4(q), scale, group, source.bias)

    @classmethod
    def from_codes(cls, wq, w_scale, bias=None) -> "Int4Linear":
        """The layer holding packed codes ``wq`` (uint8 ``[in/2, out]``)
        and scales ``w_scale`` (``[in/group, out]``) as they are; the
        group is read off the shapes."""
        K, N = 2 * wq.shape[0], wq.shape[1]
        G = w_scale.shape[0]
        if wq.dtype != torch.uint8 or w_scale.dim() != 2 or G < 1 \
                or K % G or w_scale.shape[1] != N or (K // 2) % (K // G):
            raise ValueError(
                f"int4 codes {wq.dtype}{tuple(wq.shape)} and scales "
                f"{tuple(w_scale.shape)} are not a packed [K/2, N] uint8 "
                f"weight with [K/group, N] scales, group | K/2")
        layer = cls.__new__(cls)
        nn.Module.__init__(layer)
        layer._set(wq, w_scale, K // G, bias)
        return layer

    def _set(self, wq, w_scale, group: int, bias) -> None:
        self.group = int(group)
        self.in_features = 2 * wq.shape[0]
        self.out_features = wq.shape[1]
        self.register_buffer("wq", wq)
        self.register_buffer("w_scale", w_scale.float())
        self.register_parameter("bias", bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, group={self.group}, "
                f"bias={self.bias is not None}")

    @torch.no_grad()
    def forward(self, x):
        lead = x.shape[:-1]
        y = int4_matmul(x.reshape(-1, self.in_features).contiguous(),
                        self.wq, self.w_scale, self.group)
        y = y.reshape(*lead, self.out_features)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.to(x.dtype)


def weight_only_int4(model: nn.Module, group: int = 128,
                     min_features: int = 256,
                     inplace: bool = True) -> nn.Module:
    """Swap every ``nn.Linear`` whose weight is at least ``min_features``
    on both sides and whose ``in_features`` ``group`` divides for an
    ``Int4Linear`` (``weight_only_int8``'s traversal, half its weight
    bytes)."""
    def factory(child):
        if isinstance(child, nn.Linear) \
                and min(child.weight.shape) >= min_features \
                and child.in_features % group == 0:
            return Int4Linear(child, group)
        return None

    return swap_layers(model, factory, inplace=inplace)
