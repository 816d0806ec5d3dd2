"""Fixed-buffer KV-cache attention for serving decode (contiguous layout).

Counterpart of ``paddle_tpu/models/_decode_cache.py`` ``check_cache_pos``
and ``cache_attend`` (:73-161): write the new k/v block into the fixed
``[B, Tmax, KV, D]`` buffers at the write position and attend over the
causally masked full buffer. The position ``p`` is a scalar (the whole
batch at one position: ``generate()``) or a per-row ``[B]`` tensor
(every row at its own position: the serving slot pool). ``wlen``
(``[B]``) gates which incoming tokens write (the speculative-verify
contract, see the reference module's docstring).

Unlike the reference, whose arrays are immutable, the buffers are
updated IN PLACE and returned: copying a whole ``[slots, Tmax]`` pool
per layer per step would move more bytes than the decode itself.

One branch is added. Prefill — a scalar ``p == 0``, no ``wlen``,
``t > 1``, as many kv heads as query heads, and a cache dtype and
head_dim the kernels take (``ops.flash_attention.kernel_takes_head_dim``)
— attends only over the ``t`` new positions (every buffer position
``>= t`` is masked there), which is exactly square causal
self-attention: it runs through
``ops/flash_attention.flash_attention_fwd`` (the Hopper kernel on a
CUDA tensor, its plain version on the CPU). Every other call, a head_dim
above 256 among them, takes the masked einsum below, the reference's
own path (its cache uses no flash kernel at all); the route is decided
from shapes, on either device, before any launch. Admission prefill
(``t == Tmax == bucket``) and ``generate()``'s prefill (``t < Tmax``)
both take the same branch, so the two stay consistent. The kernel takes
one dtype, so on the card q (f32 after RoPE's f32 tables) is cast to
the cache dtype first; the plain path keeps the reference's f32 q.

``paged_cache_attend`` and ``quantize_kv_page`` come with the paged-KV
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.flash_attention import (NEG_INF, flash_attention_fwd,
                                   kernel_takes_head_dim)

__all__ = ["cache_attend", "check_cache_pos"]


def check_cache_pos(pos, t: int, Tmax: int) -> bool:
    """Validate a static-cache write position against the buffer and
    classify it: returns per_row (True when ``pos`` is a [B] vector).

    Positions the host holds (an int, a numpy array, a CPU tensor) are
    checked here: a write past the buffer fails with a diagnosis. A
    CUDA tensor is not read back (that would stall the device once per
    layer); the serving engine validates its positions on the host at
    submit."""
    per_row = getattr(pos, "ndim", 0) >= 1
    if isinstance(pos, torch.Tensor) and pos.is_cuda:
        return per_row
    concrete = int(pos) if not per_row else int(np.asarray(pos).max())
    if concrete + t > Tmax:
        raise ValueError(
            f"static cache overflow: pos {concrete} + {t} new "
            f"tokens exceeds cache length {Tmax}")
    return per_row


def _flash_prefill(qr, kr, kc, p, wlen, per_row: bool) -> bool:
    return (not per_row and wlen is None and qr.shape[1] > 1
            and kr.shape[2] == qr.shape[2]
            and not isinstance(p, torch.Tensor) and int(p) == 0
            and kernel_takes_head_dim(qr.shape[-1], kc.dtype))


def cache_attend(qr, kr, v, kc, vc, p, per_row: bool, wlen=None):
    """Masked fixed-buffer cache attention.

    qr: [B, t, H, D] position-encoded queries; kr/v: [B, t, KV, D] new
    keys (position-encoded) / values; kc/vc: [B, Tmax, KV, D] cache
    buffers, written in place; p: write position, an int, or a [B]
    tensor when ``per_row``. ``wlen`` ([B], per_row only): only the
    first ``wlen[b]`` incoming tokens of row ``b`` write their k/v;
    None = every token writes. GQA folds the query-group dim into the
    einsum against kv-head caches.

    Returns (out [B, t, H*D] in the cache dtype, kc, vc).
    """
    b, t, h, D = qr.shape
    kv = kr.shape[2]
    rep = h // kv
    Tmax = kc.shape[1]
    dev = kc.device
    if _flash_prefill(qr, kr, kc, p, wlen, per_row):
        kc[:, :t] = kr
        vc[:, :t] = v
        q = qr.to(kc.dtype) if kc.is_cuda else qr
        out = flash_attention_fwd(q, kc[:, :t], vc[:, :t], causal=True)
        return out.to(vc.dtype).reshape(b, t, h * D), kc, vc
    if wlen is not None and not per_row:
        # scalar position + wlen: the chunked-prefill flavour, taken
        # through the per-row masked-scatter path
        p = torch.full((b,), int(p), dtype=torch.long, device=dev)
        per_row = True
    steps = torch.arange(t, device=dev)
    if per_row:
        p = torch.as_tensor(p, device=dev).long()
        idx = p[:, None] + steps[None, :]                     # [B, t]
        bidx = torch.arange(b, device=dev)[:, None].expand(b, t)
        if wlen is None:
            kc[bidx, idx] = kr.to(kc.dtype)
            vc[bidx, idx] = v.to(vc.dtype)
        else:
            # token j of row b lands at p[b]+j only when j < wlen[b] and
            # in range; the rest is dropped (the reference's mode="drop")
            wl = torch.as_tensor(wlen, device=dev).long()
            ok = (steps[None, :] < wl[:, None]) & (idx < Tmax)
            kc[bidx[ok], idx[ok]] = kr[ok].to(kc.dtype)
            vc[bidx[ok], idx[ok]] = v[ok].to(vc.dtype)
        mask = torch.arange(Tmax, device=dev)[None, None, :] \
            <= idx[:, :, None]                                # [B, t, Tmax]
        maskx = mask[:, None, None]                     # [B,1,1,t,Tmax]
    else:
        p = int(p)
        kc[:, p:p + t] = kr.to(kc.dtype)
        vc[:, p:p + t] = v.to(vc.dtype)
        mask = torch.arange(Tmax, device=dev)[None, :] \
            <= (p + steps)[:, None]                           # [t, Tmax]
        maskx = mask[None, None, None]                  # [1,1,1,t,Tmax]
    qg = qr.reshape(b, t, kv, rep, D)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          kc.float()) / (D ** 0.5)
    scores = scores.masked_fill(~maskx, NEG_INF)
    # cast back to the CACHE dtype (the model dtype), not qr's: RoPE's
    # f32 tables promote a bf16 q to f32
    probs = torch.softmax(scores, dim=-1).to(vc.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, vc)
    return out.reshape(b, t, h * D), kc, vc
