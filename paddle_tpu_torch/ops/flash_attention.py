"""Flash attention, forward and backward: the Hopper kernels, their
plain PyTorch versions, and the wrappers that pick between them by the
tensors' device.

Counterpart of ``paddle_tpu/ops/pallas_ops.py``: ``flash_attention_fwd``
(:372, a ``jax.custom_vjp`` over ``_fa_forward`` :146 and
``_fa_backward`` :268) and ``flash_attention_qkv_fused`` (:709, over
``_fa_forward_qkvpacked`` :636 and ``_fa_backward_hsplit`` :570).
Layout is the reference's public one, ``[batch, seq, heads, head_dim]``;
the CUDA kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) read and write it by stride, so the
reference's ``_pack``/``_unpack`` copies do not exist here, and the
packed ``[B, S, 3*H*D]`` projection is three strided views of one
tensor (no relayout, and the backward writes dq, dk, dv straight into
one gradient buffer where the reference concatenates).

The custom VJP is a ``torch.autograd.Function``: its forward saves
``out`` and ``lse``, its backward runs the backward kernels, whose
first pass takes ``delta = rowsum(out * dO)`` in f32 (the reference
computes it in XLA; the plain version, ``_delta``, in torch). Both run
the plain versions on CPU tensors. Calls that
need no gradient (``torch.no_grad``/``inference_mode``, inputs without
``requires_grad``) skip the Function.

The kernels take bf16 and f16 at any head_dim that is a multiple of 8
up to 256 (run at the next instantiated tile width, 32/64/96/128/192/
256, with zero-filled columns past the true head_dim; wgmma kernels
with TMA rings), and f32 at any
multiple of 4 up to 256 (every product of both passes on wgmma as
3xTF32, three TF32 products a product, ~2^-21 of each product). q, k,
v, out and dO whose strides or base the kernels' TMA maps cannot take
(a non-unit stride in head_dim, other strides or the base not 16-byte
aligned) are copied to dense tensors first; in-place dq/dk/dv must
already be aligned. A CUDA input of another dtype, or with head_dim
above 256 or a row not a whole number of 16 bytes, raises; nothing
falls back. ``kernel_takes`` says so from dtypes and head_dim, the
reference's ``_pallas_eligible`` terms, so that the callers
(``nn.functional.scaled_dot_product_attention``, the cache's prefill)
route such a call to their plain branch before any launch.
``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches``
count kernel launches (one backward launch runs the delta pass, the
dk/dv pass and then the dq pass); ``flash_attention_bwd.f32_launches``
counts the float32 ones among them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_qkv_fused", "flash_qkv_packed_bwd",
           "flash_qkv_packed_fwd", "kernel_takes", "kernel_takes_head_dim",
           "NEG_INF"]

NEG_INF = -1e30                      # the reference kernel's mask value
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# head_dim: at most 256, and a row a whole number of 16-byte vectors
_KERNEL_MAX_HEAD_DIM = 256
_KERNEL_ROW_ALIGN = 16


def _scores(q, k, causal: bool, scale: float):
    """f32 scaled scores ``[B, H, Sq, Sk]`` with the -1e30 causal mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_attention_fwd_plain(q, k, v, causal: bool = False,
                              scale: Optional[float] = None):
    """The kernel's function in plain PyTorch: f32 scores, the -1e30
    causal mask, unnormalised probabilities rounded to ``v``'s dtype for
    the PV product (f32 accumulation), then division by the row sum.
    Returns (out [B, S, H, D] in ``q``'s dtype, lse [B, H, S] f32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).transpose(1, 2).to(q.dtype)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def _delta(out, dout):
    """rowsum(out * dO) per (batch, head, row): ``[B, H, S]`` f32."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = False,
                              scale: Optional[float] = None):
    """The backward kernels' function in plain PyTorch, with the
    reference's roundings (``_fa_bwd_dkdv_kernel``/``_fa_bwd_dq_kernel``):
    P = exp(S - lse) from the saved lse, P rounded to dO's dtype for dV,
    dS = P * (dP - delta) * scale rounded to q's dtype for dK and dQ, f32
    accumulation. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - _delta(out, dout)[..., None]) * scale)
    ds = ds.to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_strides_ok(t) -> bool:
    vec = _KERNEL_ROW_ALIGN // t.element_size()
    return t.stride(-1) == 1 and not any(s % vec for s in t.stride()[:3]) \
        and t.data_ptr() % _KERNEL_ROW_ALIGN == 0


def _aligned(t):
    """``t`` as it is when the kernels take its strides and base, else a
    dense copy (``clone``: ``contiguous`` returns a dense view with a
    misaligned base as it is)."""
    if _kernel_strides_ok(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def kernel_takes_head_dim(D: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernels take ``head_dim`` ``D`` in ``dtype``:
    bf16, f16 or f32, ``D <= 256`` and a row of ``D`` elements a whole
    number of 16-byte vectors (a multiple of 8 in bf16/f16, of 4 in
    f32)."""
    if dtype not in _KERNEL_DTYPES:
        return False
    size = torch.empty((), dtype=dtype).element_size()
    return 0 < D <= _KERNEL_MAX_HEAD_DIM and D * size % _KERNEL_ROW_ALIGN == 0


def _refusal(tensors: dict) -> Optional[str]:
    """Why the kernels do not take these tensors' dtypes and head_dim,
    or None: the one contract behind ``kernel_takes`` and
    ``_check_cuda``."""
    first = next(iter(tensors.values()))
    dt, D = first.dtype, first.shape[-1]
    if dt not in _KERNEL_DTYPES or any(t.dtype != dt
                                       for t in tensors.values()):
        return ("takes bfloat16/float16/float32 tensors of one dtype; got "
                + ", ".join(f"{n} {t.dtype}" for n, t in tensors.items()))
    if not kernel_takes_head_dim(D, dt):
        return (f"takes head_dim <= {_KERNEL_MAX_HEAD_DIM} with rows of a "
                f"whole number of {_KERNEL_ROW_ALIGN} bytes (a multiple of "
                f"{_KERNEL_ROW_ALIGN // first.element_size()} in {dt}); got "
                f"head_dim {D}")
    return None


def kernel_takes(q, k, v) -> bool:
    """Whether the CUDA kernels take ``q``, ``k``, ``v``: one dtype they
    are built for and a head_dim ``kernel_takes_head_dim`` accepts,
    whatever the strides (the wrappers copy what their TMA maps cannot
    read). It reads dtypes and shapes only and launches nothing: the
    port's counterpart of the reference's ``_pallas_eligible``, by which
    a caller picks its route before any launch (``flash_attention_fwd``
    itself still raises on what the kernels do not take)."""
    return _refusal({"q": q, "k": k, "v": v}) is None


def _check_cuda(what: str, **tensors) -> None:
    why = _refusal(tensors)
    if why is not None:
        raise ValueError(f"{what} kernel {why}")
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{what}: all tensors must be on one CUDA "
                             f"device")
        if not _kernel_strides_ok(t):
            raise ValueError(
                f"{what} kernel needs {name} with unit stride in "
                f"head_dim, other strides a multiple of 16 bytes and a "
                f"16-byte aligned base; got strides {t.stride()}")


def _bind(lib, name: str, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.ptt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_P] * 5 + [_I] * 4 + [_LL] * 12 + [ctypes.c_float, _I, _I, _P]
_BWD_ARGS = [_P] * 10 + [_I] * 4 + [_P, ctypes.c_float, _I, _I, _P]


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ptt_cuda_error_string(err).decode()})")


def _flash_cuda(q, k, v, causal: bool, scale: float):
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    _check_cuda("flash_attention_fwd", q=q, k=k, v=v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_fwd")
    fn = _bind(lib, "ptt_flash_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, S, H, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(scale), int(bool(causal)),
                 _KERNEL_DTYPES[q.dtype], stream)
    _raise_on(err, lib, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, out, lse, dout, causal, scale, dq, dk, dv):
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    _check_cuda("flash_attention_bwd", q=q, k=k, v=v, dout=dout, out=out,
                dq=dq, dk=dk, dv=dv)
    B, S, H, D = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, S] = {(B, H, S)}; "
                         f"got {lse.dtype}{tuple(lse.shape)}")
    lse = lse.contiguous()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, dout, dq, dk, dv, out)
          for s in t.stride()[:3]))
    lib = _build.load("flash_attention_bwd")
    fn = _bind(lib, "ptt_flash_attention_bwd", _BWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, D,
                 ctypes.cast(strides, ctypes.c_void_p), float(scale),
                 int(bool(causal)), _KERNEL_DTYPES[q.dtype], stream)
    _raise_on(err, lib, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.f32_launches += q.dtype == torch.float32


def _devices(*tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        return kinds.pop()
    raise ValueError(f"flash attention takes tensors all on the CPU or all "
                     f"on CUDA; got {[str(t.device) for t in tensors]}")


def _forward(q, k, v, causal, scale):
    if _devices(q, k, v) == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    return _flash_cuda(q, k, v, causal, scale)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        scale: Optional[float] = None, dq=None, dk=None,
                        dv=None):
    """Gradients (dq, dk, dv) of ``flash_attention_fwd`` from its saved
    ``out`` and ``lse`` and the output gradient ``dout``, all ``[B, S,
    H, D]`` (lse ``[B, H, S]`` f32). ``dq``/``dk``/``dv``, when given,
    are written in place (any kernel-compatible strides, e.g. views of
    one packed gradient). CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dense = torch.contiguous_format
    dq = torch.empty_like(q, memory_format=dense) if dq is None else dq
    dk = torch.empty_like(k, memory_format=dense) if dk is None else dk
    dv = torch.empty_like(v, memory_format=dense) if dv is None else dv
    if _devices(q, k, v, out, lse, dout, dq, dk, dv) == "cpu":
        for dst, src in zip((dq, dk, dv), flash_attention_bwd_plain(
                q, k, v, out, lse, dout, causal, scale)):
            dst.copy_(src)
    else:
        _flash_bwd_cuda(q, k, v, out, lse, dout, causal, scale, dq, dk, dv)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.f32_launches = 0


class _Flash(torch.autograd.Function):
    """The reference's ``_flash_bshd`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """Fused attention on ``[batch, seq, heads, head_dim]`` tensors
    (square: q, k, v share one shape), differentiable. Returns ``out``
    in ``q``'s dtype, or ``(out, lse)`` with ``lse`` ``[batch, heads,
    seq]`` f32 when ``return_lse``. CPU tensors take the plain versions,
    CUDA tensors the kernels."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention_fwd takes q, k, v of one [B, S, H, D] "
            f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.shape[1] < 1:
        raise ValueError("flash_attention_fwd needs seq >= 1")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _needs_grad(q, k, v):
        out, lse = _Flash.apply(q, k, v, causal, scale)
    else:
        out, lse = _forward(q, k, v, causal, scale)
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def _unpack(qkv, H: int):
    B, S, HD3 = qkv.shape
    return qkv.view(B, S, 3, H, HD3 // (3 * H)).unbind(2)


def flash_qkv_packed_fwd(qkv, num_heads: int, causal: bool, scale: float):
    """The packed forward without autograd: ``(out [B, S, H, D], lse [B,
    H, S])`` off the three strided views of ``qkv [B, S, 3*H*D]``."""
    return _forward(*_unpack(qkv, num_heads), causal, scale)


def flash_qkv_packed_bwd(qkv, out, lse, dout, num_heads: int, causal: bool,
                         scale: float):
    """The packed backward: ``dqkv [B, S, 3*H*D]``, dq, dk and dv written
    into its three views by one backward call."""
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    flash_attention_bwd(*_unpack(qkv, num_heads), out, lse,
                        dout.reshape(out.shape), causal, scale,
                        *_unpack(dqkv, num_heads))
    return dqkv


class _FlashQKVPacked(torch.autograd.Function):
    """The reference's ``_flash_qkvpacked`` custom VJP: q, k, v are
    strided views of the projection output, and the backward writes
    dq, dk, dv into the three views of one ``[B, S, 3*H*D]`` buffer."""

    @staticmethod
    def forward(ctx, qkv, H, causal, scale):
        out, lse = flash_qkv_packed_fwd(qkv, H, causal, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.H, ctx.causal, ctx.scale = H, causal, scale
        return out.reshape(*qkv.shape[:2], -1)

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return flash_qkv_packed_bwd(qkv, out, lse, dout, ctx.H, ctx.causal,
                                    ctx.scale), None, None, None


def flash_attention_qkv_fused(qkv, num_heads: int, causal: bool = False,
                              scale: Optional[float] = None):
    """Fused attention straight off the qkv projection output ``[batch,
    seq, 3*heads*head_dim]`` (q | k | v column blocks); returns
    ``[batch, seq, heads*head_dim]``. Differentiable; no relayout or
    copy on either pass. The reference's ``head_dim % 128`` and
    ``seq % 128`` gates are TPU lane rules and do not apply: a CUDA call
    launches or raises."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(
            f"qkv must be [B, S, 3*num_heads*head_dim]; got "
            f"{tuple(qkv.shape)} with num_heads={num_heads}")
    if not qkv.is_contiguous():
        raise ValueError("flash_attention_qkv_fused takes a contiguous "
                         "qkv (its q, k, v are views of it)")
    head_dim = qkv.shape[-1] // (3 * num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    if _needs_grad(qkv):
        return _FlashQKVPacked.apply(qkv, num_heads, causal, scale)
    out, _ = _forward(*_unpack(qkv, num_heads), causal, scale)
    return out.reshape(*qkv.shape[:2], -1)
