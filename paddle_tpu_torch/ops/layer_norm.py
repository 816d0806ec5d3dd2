"""LayerNorm over the last dim with f32 statistics, and its backward from
the saved row statistics.

Counterpart of ``paddle_tpu/models/gpt.py:_layer_norm`` (:1530): f32
mean and biased variance, ``rsqrt(var + 1e-5)``, ``(xhat * g + b)``
rounded to x's dtype. Plain PyTorch, no kernel: the reference leaves it
to XLA. The GPT trainer's blocks and the LN-fused int8 linear
(``ops/quant_matmul.py:int8_ln_linear_all8``) share ``ln_bwd``.
"""
from __future__ import annotations

import torch

__all__ = ["LN_EPS", "layer_norm", "ln_apply", "ln_bwd", "ln_fwd"]

LN_EPS = 1e-5


def ln_apply(x, mean, rstd, g, b):
    """LayerNorm's output in f32 from the row statistics, in the
    reference's op order ``((x - mean) * rstd) * g + b``."""
    return (x.float() - mean) * rstd * g.float() + b.float()


def ln_fwd(x, g, b, eps: float = LN_EPS):
    """LayerNorm's output (in x's dtype) and its per-row f32 mean and
    rstd (shaped like x with a last dim of 1)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return ((xf - mean) * rstd * g + b).to(x.dtype), mean, rstd


def ln_bwd(x, g, mean, rstd, dy):
    """LayerNorm's ``(dx, dg, db)`` from x and the saved row statistics;
    dx in x's dtype, dg and db in g's."""
    xhat = (x.float() - mean) * rstd
    dyf = dy.float()
    lead = tuple(range(x.dim() - 1))
    dg = (dyf * xhat).sum(lead)
    db = dyf.sum(lead)
    dxhat = dyf * g.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dg.to(g.dtype), db.to(g.dtype)


class _LayerNorm(torch.autograd.Function):
    """``ln_fwd`` with an explicit backward that saves only x and the
    per-row mean and rstd: autograd of the plain formula would keep
    three f32 copies of x per call."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        y, mean, rstd = ln_fwd(x, g, b, eps)
        ctx.save_for_backward(x, g, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*ln_bwd(*ctx.saved_tensors, dy), None)


def layer_norm(x, g, b, eps: float = LN_EPS):
    """LayerNorm over the last dim with f32 statistics (``gpt.py:1530``)."""
    return _LayerNorm.apply(x, g, b, eps)
