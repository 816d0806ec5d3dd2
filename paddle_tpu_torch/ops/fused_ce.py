"""Fused vocab-chunked softmax cross-entropy.

Counterpart of ``paddle_tpu/ops/fused_ce.py`` ``fused_softmax_cross_entropy``
(:93, the ``jax.custom_vjp`` of ``_forward`` :65 and ``_ce_bwd`` :113).
The head matmul runs over vocab chunks with an online logsumexp, so the
full logits exist one chunk at a time; the backward recomputes each
chunk's logits from the saved ``(max, sumexp)`` and accumulates ``dx``
and the head gradient per chunk. ``vocab_major`` keeps a tied
embedding's ``[V, D]`` layout (head gradient in the same layout, no
transpose). Not a Pallas kernel in the reference: its matmuls are
plain ``torch`` matmuls here, with f32 results as the reference's
``preferred_element_type=f32``.

``int8=True`` is the reference's ``ce_int8`` branch (``_quantized_x``
:42, ``_head_logits_int8`` :53, the int8 dgrad :135-142): the logits
(forward and the backward's recompute) and ``dx`` run as int8 products
through the quantize kernels of ``ops/quant_matmul.py`` and
``torch._int_mm``; the head gradient stays exact. x is quantized once
per pass, outside the chunk loop (per-row scales), each head chunk per
use: per vocab entry for the logits, per model column for ``dx``.
"""
from __future__ import annotations

import torch

from .quant_matmul import int8_dot_dequant, quantize_cols, quantize_rows

__all__ = ["fused_softmax_cross_entropy"]


def _mm_f32(a, b):
    """``a @ b`` (2-D) with an f32 result, accumulated in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(head, n_chunks: int, vocab_major: bool):
    """Head chunks as ``[Vc, D]`` (vocab-major) or ``[D, Vc]`` views."""
    return head.chunk(n_chunks, dim=0 if vocab_major else 1)


def _logits(x2, hc, vocab_major: bool, xq=None):
    """f32 logits of one head chunk; int8 when ``xq`` holds x's codes
    and row scales: the chunk quantized per vocab entry."""
    if xq is None:
        return _mm_f32(x2, hc.t() if vocab_major else hc)
    if vocab_major:                   # hc [Vc, D]: a row per vocab entry
        hq, hs = quantize_rows(hc)
        return int8_dot_dequant(*xq, hq.t(), hs.reshape(1, -1))
    hq, hs = quantize_cols(hc.contiguous())        # hc [D, Vc]
    return int8_dot_dequant(*xq, hq, hs)


def _dx_int8(dlg, hc, vocab_major: bool):
    """``dlg [N, Vc] @ hc`` (as ``[Vc, D]``) in int8: per-row scales on
    dlg, per model column on the chunk; f32 ``[N, D]``."""
    gq, gs = quantize_rows(dlg)
    if vocab_major:                   # hc [Vc, D]: scales along Vc
        hq, hs = quantize_cols(hc)
        return int8_dot_dequant(gq, gs, hq, hs)
    hq, hs = quantize_rows(hc.contiguous())        # hc [D, Vc]
    return int8_dot_dequant(gq, gs, hq.t(), hs.reshape(1, -1))


def _forward(x2, head, labels, n_chunks, vocab_major, int8):
    N = x2.shape[0]
    xq = quantize_rows(x2) if int8 else None
    m = torch.full((N,), float("-inf"), dtype=torch.float32,
                   device=x2.device)
    s = torch.zeros(N, dtype=torch.float32, device=x2.device)
    lterm = torch.zeros_like(s)
    off = 0
    for hc in _chunks(head, n_chunks, vocab_major):
        lg = _logits(x2, hc, vocab_major, xq)
        Vc = lg.shape[1]
        m2 = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m2) + torch.exp(lg - m2[:, None]).sum(-1)
        m = m2
        idx = labels - off
        inb = (idx >= 0) & (idx < Vc)
        pick = lg.gather(1, idx.clamp(0, Vc - 1)[:, None])[:, 0]
        lterm = lterm + torch.where(inb, pick, torch.zeros_like(pick))
        off += Vc
    lse = m + torch.log(s)
    return (lse - lterm).mean(), m, s


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head, labels, n_chunks, int8, vocab_major):
        x2 = x.reshape(-1, x.shape[-1])
        lab = labels.reshape(-1)
        hb = head.to(x.dtype)
        loss, m, s = _forward(x2, hb, lab, n_chunks, vocab_major, int8)
        ctx.save_for_backward(x2, hb, lab, m, s)
        ctx.n_chunks, ctx.vocab_major, ctx.int8 = n_chunks, vocab_major, int8
        ctx.x_shape, ctx.head_dtype = x.shape, head.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, hb, lab, m, s = ctx.saved_tensors
        vm = ctx.vocab_major
        n_tokens = float(x2.shape[0])
        coef = g.float() / n_tokens
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dh = []
        rows = torch.arange(x2.shape[0], device=x2.device)
        xq = quantize_rows(x2) if ctx.int8 else None
        off = 0
        for hc in _chunks(hb, ctx.n_chunks, vm):
            # the recompute must match the forward's arithmetic exactly:
            # (m, s) were computed on these logits
            lg = _logits(x2, hc, vm, xq)
            Vc = lg.shape[1]
            p = lg.sub_(m[:, None]).exp_().div_(s[:, None])   # in place
            idx = lab - off
            inb = (idx >= 0) & (idx < Vc)
            p[rows[inb], idx[inb]] -= 1.0
            dlg = p.mul_(coef).to(x2.dtype)
            dx += _dx_int8(dlg, hc, vm) if ctx.int8 \
                else _mm_f32(dlg, hc if vm else hc.t())
            dh.append(_mm_f32(dlg.t(), x2) if vm else _mm_f32(x2.t(), dlg))
            off += Vc
        dh = torch.cat(dh, dim=0 if vm else 1).to(ctx.head_dtype)
        return (dx.to(x2.dtype).reshape(ctx.x_shape), dh, None, None, None,
                None)


def fused_softmax_cross_entropy(x, head, labels, n_chunks: int = 8,
                                int8: bool = False,
                                vocab_major: bool = False):
    """Mean token NLL of ``softmax(x @ head)`` against integer
    ``labels``; differentiable in ``x`` and ``head``.

    x: ``[..., D]``; head: ``[D, V]``, or ``[V, D]`` with
    ``vocab_major=True`` (the tied embedding); labels: ``[...]`` int.
    V must divide by ``n_chunks``. Equals
    ``-mean(log_softmax(x @ head)[labels])`` with f32 logits; ``int8``
    takes the logits and ``dx`` through int8 products (see above)."""
    V = head.shape[0] if vocab_major else head.shape[1]
    if V % n_chunks:
        raise ValueError(f"vocab {V} does not divide by n_chunks "
                         f"{n_chunks}")
    return _FusedCE.apply(x, head, labels, n_chunks, bool(int8), vocab_major)
