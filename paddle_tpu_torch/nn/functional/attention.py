"""Scaled dot-product attention on ``[batch, seq, heads, head_dim]``.

Counterpart of ``paddle_tpu/nn/functional/attention.py``
``scaled_dot_product_attention`` (:54). The plain branch is a port of
``_sdpa_xla`` (:26-51): f32 scores and softmax, a ``-inf`` mask, the
causal triangle aligned bottom-right when ``Sq < Skv``. The dispatch
mirrors ``_pallas_eligible`` (:88-100): no mask, no dropout, a square
call (q, k, v of one shape) on a CUDA tensor, and a dtype and head_dim
the kernels take (``ops.flash_attention.kernel_takes``, the terms of
``_pallas_eligible``) -> the flash-attention kernel, which copies views
its TMA maps cannot read; every other call -> this plain branch,
decided from shapes before any launch, as the reference sends what its
kernel does not take to ``_sdpa_xla``. The kernels take bf16, f16 and
f32 at every head_dim up to 256 whose row is a whole number of 16
bytes, so they compute every call the reference's Pallas kernel does
(its head_dim set {64, 128, 256}, f32 included); head_dim above 256, or
a row not a whole number of 16 bytes, computes here. The reference's
``S % 128 == 0``
condition is dropped: the CUDA kernel masks its ragged last tile. q
and k (f32 after RoPE's f32 tables) are cast to ``v``'s dtype before
the launch, since the kernel takes one dtype.
``torch.nn.functional.scaled_dot_product_attention`` is never called.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.flash_attention import flash_attention_fwd, kernel_takes

__all__ = ["scaled_dot_product_attention"]


def _sdpa(q, k, v, mask, causal: bool, dropout_p: float,
          generator: Optional[torch.Generator], scale=None):
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", qh.float(), kh.float()) * s
    if causal:
        sq, skv = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(sq, skv, dtype=torch.bool,
                        device=q.device).tril(diagonal=skv - sq)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    out = torch.einsum("bhst,bhtd->bhsd", probs,
                       vh.to(probs.dtype))
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 generator: Optional[torch.Generator] = None):
    """paddle layout [batch_size, seq_len, num_heads, head_dim]."""
    drop = dropout_p if training else 0.0
    if attn_mask is None and drop == 0.0 and query.is_cuda \
            and query.shape == key.shape == value.shape:
        dt = value.dtype
        q, k = query.to(dt), key.to(dt)
        if kernel_takes(q, k, value):
            return flash_attention_fwd(q, k, value, causal=is_causal)
    return _sdpa(query, key, value, attn_mask, is_causal, drop, generator)
