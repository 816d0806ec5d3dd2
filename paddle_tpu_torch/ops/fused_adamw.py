"""Fused AdamW: the Hopper kernel, its plain PyTorch version, and the
wrapper that picks between them by the tensors' device.

Counterpart of ``paddle_tpu/ops/fused_adamw.py`` ``fused_adamw_update``
(:251, the Pallas kernel ``_kernel`` :42). One in-place pass over a
leaf's ``p, g, m, v``: f32 math, the global clip scale, bias
corrections, an lr multiplier, decoupled weight decay and, with
``stoch_round``, exact stochastic rounding of the new ``p`` to bf16
(non-finite values kept). Every leaf takes it on CUDA: the reference's
``fused_adamw_eligible`` (8, 128) tiling rule is a TPU layout rule.

Random bits: the TPU kernel's ``prng_random_bits`` becomes Philox4x32-10
keyed by ``(seed + leaf_id * 1000003) mod 2**32`` (the reference's
seed fold, ``fused_adamw.py:64``) with the counter ``(e // 4, 0, 0)``
for flat element ``e``, which takes word ``e % 4``. The plain version
below computes the same generator with int64 tensor ops masked to 32
bits, and the same f32 operations in the same order as the kernel
(which rounds each one explicitly), so on the card kernel and plain
agree bit for bit.

``fused_adamw_update.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_adamw_update", "fused_adamw_update_plain",
           "philox_words", "stochastic_round_bf16"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the uint32 values in int64 tensor ``b``, without int64 overflow
    (``b`` is split into 16-bit halves)."""
    p_lo = a * (b & 0xFFFF)                  # < 2**48
    p_hi = a * (b >> 16)                     # < 2**48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox_words(n: int, key: int, device) -> torch.Tensor:
    """The ``n`` 32-bit words (in int64) that the kernel draws for flat
    elements ``0..n-1`` under ``key``: Philox4x32-10 with key
    ``(key, 0)`` and counter ``(e // 4, 0, 0)``, word ``e % 4``."""
    grp = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = grp & _MASK, grp >> 32
    c2 = c3 = torch.zeros_like(grp)
    k0, k1 = key & _MASK, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:n]


def stochastic_round_bf16(x: torch.Tensor, words: torch.Tensor
                          ) -> torch.Tensor:
    """Exact SR of f32 ``x`` to bf16 with the low 16 bits of ``words``
    (int64, one per element) as noise: add them to the f32 bits and keep
    the top 16; non-finite values are kept as they are."""
    u = x.reshape(-1).view(torch.int32).to(torch.int64) & _MASK
    y = torch.where(torch.isfinite(x.reshape(-1)), u + (words & 0xFFFF), u)
    top = y >> 16
    top = top - ((top >> 15) << 16)          # to the int16 bit pattern
    return top.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def _key(seed: int, leaf_id: int) -> int:
    return (int(seed) + int(leaf_id) * 1000003) & _MASK


def fused_adamw_update_plain(p, g, m, v, scalars, *, lr: float, wd: float,
                             b1: float, b2: float, eps: float = 1e-8,
                             stoch_round: bool = False, leaf_id: int = 0,
                             seed: int = 0):
    """The kernel's function in plain PyTorch, in place: the same f32
    operations in the kernel's order. ``scalars``: f32 tensor of 4 on
    ``p``'s device (clip scale, 1/(1-b1^t), 1/(1-b2^t), lr multiplier).
    Returns ``(p, m, v)``."""
    scale, inv_bc1, inv_bc2, lr_mult = scalars.float().unbind()
    lr_t = lr_mult * lr
    decay = 1 - lr_t * wd
    gs = g.float() * scale
    m2 = m.float() * b1 + gs * (1 - b1)
    v2 = v.float() * b2 + gs * (1 - b2) * gs
    num = m2 * inv_bc1 * lr_t
    den = torch.sqrt(v2 * inv_bc2) + eps
    p2 = p.float() * decay - num / den
    if stoch_round:
        words = philox_words(p2.numel(), _key(seed, leaf_id), p2.device)
        p.copy_(stochastic_round_bf16(p2, words))
    else:
        p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)
    return p, m, v


def _check_cuda(p, g, m, v, scalars, stoch_round):
    ok = (p.dtype in _DTYPES and g.dtype in _DTYPES and m.dtype in _DTYPES
          and v.dtype == m.dtype and g.shape == p.shape
          and m.shape == p.shape and v.shape == p.shape)
    if not ok:
        raise ValueError(
            f"fused_adamw kernel takes float32/bfloat16 p, g and m, v of "
            f"one dtype, all of one shape; got p {p.dtype}{tuple(p.shape)}"
            f", g {g.dtype}{tuple(g.shape)}, m {m.dtype}{tuple(m.shape)}, "
            f"v {v.dtype}{tuple(v.shape)}")
    if stoch_round and p.dtype != torch.bfloat16:
        raise ValueError("stochastic rounding writes a bfloat16 p; got "
                         f"{p.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if not t.is_contiguous() or t.device != p.device:
            raise ValueError(f"fused_adamw kernel needs {name} contiguous "
                             f"on {p.device}")
    if scalars.dtype != torch.float32 or scalars.numel() != 4 \
            or scalars.device != p.device or not scalars.is_contiguous():
        raise ValueError("scalars must be 4 contiguous float32 values on "
                         "p's device")


def _bind(lib):
    fn = lib.ptt_fused_adamw
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, i, i, i,
                       f, f, f, f, f, f, f, ctypes.c_uint, i, vp]
        fn.restype = i
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _adamw_cuda(p, g, m, v, scalars, lr, wd, b1, b2, eps, stoch_round,
                leaf_id, seed):
    _check_cuda(p, g, m, v, scalars, stoch_round)
    lib = _build.load("fused_adamw")
    fn = _bind(lib)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 scalars.data_ptr(), p.numel(), _DTYPES[p.dtype],
                 _DTYPES[g.dtype], _DTYPES[m.dtype], lr, wd, b1, 1 - b1,
                 b2, 1 - b2, eps, _key(seed, leaf_id), int(stoch_round),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"fused_adamw kernel launch failed: CUDA error {err} "
            f"({lib.ptt_cuda_error_string(err).decode()})")
    fused_adamw_update.launches += 1
    return p, m, v


def fused_adamw_update(p, g, m, v, scalars, *, lr: float, wd: float,
                       b1: float, b2: float, eps: float = 1e-8,
                       stoch_round: bool = False, leaf_id: int = 0,
                       seed: int = 0):
    """One-pass AdamW on one leaf, in place; returns ``(p, m, v)``.

    ``scalars``: f32 tensor ``[clip scale, 1/(1-b1^t), 1/(1-b2^t), lr
    multiplier]`` on ``p``'s device (no host sync). ``seed`` (the step)
    and ``leaf_id`` pick the SR stream. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    args = dict(lr=lr, wd=wd, b1=b1, b2=b2, eps=eps,
                stoch_round=stoch_round, leaf_id=leaf_id, seed=seed)
    devices = {t.device.type for t in (p, g, m, v, scalars)}
    if devices == {"cpu"}:
        return fused_adamw_update_plain(p, g, m, v, scalars, **args)
    if devices == {"cuda"}:
        return _adamw_cuda(p, g, m, v, scalars, **args)
    raise ValueError(f"fused_adamw_update takes tensors all on the CPU or "
                     f"all on CUDA; got {sorted(devices)}")


fused_adamw_update.launches = 0
