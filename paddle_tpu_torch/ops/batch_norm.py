"""Training BatchNorm over ``[N, C, spatial...]``: the four Hopper
kernels, their plain PyTorch versions, the wrappers that pick between
them by the tensors' device, and ``bn_train`` with the reference's
custom VJP.

Counterpart of ``paddle_tpu/ops/bn_pallas.py``: ``_stats_call`` (:117),
``_apply_call`` (:136), ``_gsum_call`` (:149), ``_dx_call`` (:162) and
``bn_train`` (:186-253, a ``jax.custom_vjp`` here a
``torch.autograd.Function``). The kernels (``csrc/batch_norm.cu``) view
the activation as ``[N, C, S]`` with S the product of the spatial dims
and take every such shape (any C, S = 1) in bf16, f16 and f32 with f32
sums: the reference's ``C % 8`` and tile checks (``bn_train_eligible``
:171) are TPU constraints. They read bf16 and sum in f32 registers; only
the plain versions upcast the activation.

- ``bn_stats(x3)`` -> (Σx, Σx²) per channel, f32 (kernel 1);
- ``bn_apply(x3, scale, shift, relu)`` -> ``x·scale[c] + shift[c]``,
  optional relu, in x's dtype (kernel 2);
- ``bn_gsum(dy3, x3, relu_from)`` -> (Σdy, Σdy·x), dy masked on y > 0
  when ``relu_from = (scale, shift)`` of the forward (kernel 3);
- ``bn_dx(dy3, x3, A, B, D, relu_from)`` -> ``A[c]·dy + B[c]·x + D[c]``
  in x's dtype, dy masked likewise (kernel 4).

The relu mask is recomputed from x and the forward's scale and shift
with the apply pass's own operations, so it is the mask of the y the
forward stored, and the backward never reads y. The ``[C]``-sized math
between the passes (mean, ``var = max(s2/n - mean², 0)``, rstd, scale,
shift; A, B, D, dgamma, dbeta) is plain torch, as it is XLA in the
reference. The sums run in another order than the reference's, so the
two agree to f32 rounding, not bit for bit; the kernels give the same
bits on every run (per-chunk partials added in order, no atomics).

CPU tensors take the plain versions; CUDA tensors launch the kernels
or raise (a dtype other than bf16/f16/f32, more than 2^31 - 1
elements, mixed devices); nothing falls back. Each wrapper counts its
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["bn_apply", "bn_apply_plain", "bn_dx", "bn_dx_plain", "bn_fold",
           "bn_gsum", "bn_gsum_plain", "bn_stats", "bn_stats_plain",
           "bn_train", "stat_chunks"]

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# ~8 resident blocks on each of the H100's 132 SMs for the sum passes
_TARGET_BLOCKS = 132 * 8
_MIN_PER_THREAD = 32 * 256       # values a chunk holds at least


def stat_chunks(N: int, C: int, S: int) -> int:
    """Chunks each channel's ``N * S`` values are summed in by the sum
    kernels (1 and 3): enough blocks to fill the card, each thread of a
    block with at least 32 values. Depends only on the shape, so the
    order of the sums, and their bits, do not change between runs."""
    want = -(-_TARGET_BLOCKS // C)
    most = -(-(N * S) // _MIN_PER_THREAD)
    return max(1, min(want, most, 65535))


def _c(t):
    """``[C]`` -> ``[1, C, 1]`` for broadcasting over ``[N, C, S]``."""
    return t.view(1, -1, 1)


def bn_stats_plain(x3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1 in plain PyTorch: f32 Σx and Σx² over N and S."""
    xf = x3.float()
    return xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))


def bn_apply_plain(x3, scale, shift, relu: bool = False):
    """Kernel 2 in plain PyTorch: ``x·scale + shift`` in f32 (two
    roundings, as the kernel), relu, then x's dtype."""
    y = x3.float() * _c(scale) + _c(shift)
    if relu:
        y = y.masked_fill(y < 0, 0.0)
    return y.to(x3.dtype)


def _masked(dy3, x3, relu_from):
    if relu_from is None:
        return dy3.float()
    keep = bn_apply_plain(x3, *relu_from, relu=True) > 0
    return dy3.float().masked_fill(~keep, 0.0)


def bn_gsum_plain(dy3, x3, relu_from=None):
    """Kernel 3 in plain PyTorch: f32 Σdy and Σdy·x, dy masked on the
    forward's y > 0 when ``relu_from`` is its (scale, shift)."""
    d = _masked(dy3, x3, relu_from)
    return d.sum(dim=(0, 2)), (d * x3.float()).sum(dim=(0, 2))


def bn_dx_plain(dy3, x3, A, B, D, relu_from=None):
    """Kernel 4 in plain PyTorch: ``A·dy + B·x + D`` in f32 (the
    kernel's order and roundings), in x's dtype."""
    d = _masked(dy3, x3, relu_from)
    return (d * _c(A) + x3.float() * _c(B) + _c(D)).to(x3.dtype)


# ---- the CUDA route ----

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = {
    "ptt_bn_stats": [_P] * 4 + [_I, _I, _LL, _I, _I, _P],
    "ptt_bn_apply": [_P] * 4 + [_I, _I, _LL, _I, _I, _P],
    "ptt_bn_gsum": [_P] * 7 + [_I, _I, _LL, _I, _I, _I, _P],
    "ptt_bn_dx": [_P] * 8 + [_I, _I, _LL, _I, _I, _P],
}


def _fn(name: str):
    lib = _build.load("batch_norm")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
        lib.ptt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _call(name: str, x3, *args) -> None:
    lib, fn = _fn(name)
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.ptt_cuda_error_string(err).decode()})")


def _device(what: str, *tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"} \
            or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} takes tensors all on the CPU or all on "
                         f"one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    return kinds.pop()


def _check_cuda(what: str, x3, *same) -> Tuple[int, int, int, int]:
    if x3.dim() != 3:
        raise ValueError(f"{what} takes [N, C, S]; got {tuple(x3.shape)}")
    if x3.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} kernel takes bfloat16/float16/float32; "
                         f"got {x3.dtype}")
    for t in same:
        if t.shape != x3.shape or t.dtype != x3.dtype:
            raise ValueError(f"{what}: {t.dtype}{tuple(t.shape)} does not "
                             f"match x {x3.dtype}{tuple(x3.shape)}")
    N, C, S = x3.shape
    if N * C * S >= 2 ** 31 or min(N, C, S) < 1:
        raise ValueError(f"{what} kernel takes 1 <= N*C*S < 2^31 values; "
                         f"got {tuple(x3.shape)}")
    return N, C, S, _KERNEL_DTYPES[x3.dtype]


def _vec(t, C: int):
    """A contiguous f32 ``[C]`` operand."""
    t = t.to(torch.float32).contiguous()
    if t.shape != (C,):
        raise ValueError(f"per-channel operand must be [{C}]; got "
                         f"{tuple(t.shape)}")
    return t


def bn_stats(x3):
    """(Σx, Σx²) per channel of ``x3 [N, C, S]``, f32 (kernel 1)."""
    if _device("bn_stats", x3) == "cpu":
        return bn_stats_plain(x3)
    x3 = x3.contiguous()
    N, C, S, code = _check_cuda("bn_stats", x3)
    P = stat_chunks(N, C, S)
    part = torch.empty(2, C, P, dtype=torch.float32, device=x3.device)
    s1 = torch.empty(C, dtype=torch.float32, device=x3.device)
    s2 = torch.empty_like(s1)
    _call("ptt_bn_stats", x3, x3.data_ptr(), part.data_ptr(), s1.data_ptr(),
          s2.data_ptr(), N, C, S, P, code)
    bn_stats.launches += 1
    return s1, s2


bn_stats.launches = 0


def bn_apply(x3, scale, shift, relu: bool = False):
    """``x3·scale[c] + shift[c]`` (relu) in ``x3``'s dtype (kernel 2)."""
    if _device("bn_apply", x3, scale, shift) == "cpu":
        return bn_apply_plain(x3, scale, shift, relu)
    x3 = x3.contiguous()
    N, C, S, code = _check_cuda("bn_apply", x3)
    scale, shift = _vec(scale, C), _vec(shift, C)
    y = torch.empty_like(x3)
    _call("ptt_bn_apply", x3, x3.data_ptr(), scale.data_ptr(),
          shift.data_ptr(), y.data_ptr(), N, C, S, int(bool(relu)), code)
    bn_apply.launches += 1
    return y


bn_apply.launches = 0


def _relu_operands(relu_from, C: int, like):
    if relu_from is None:
        z = torch.zeros(C, dtype=torch.float32, device=like.device)
        return z, z, 0
    return _vec(relu_from[0], C), _vec(relu_from[1], C), 1


def bn_gsum(dy3, x3, relu_from=None):
    """(Σdy, Σdy·x) per channel, f32 (kernel 3); dy masked on the
    forward's y > 0 when ``relu_from`` is its (scale, shift)."""
    extra = tuple(relu_from) if relu_from is not None else ()
    if _device("bn_gsum", dy3, x3, *extra) == "cpu":
        return bn_gsum_plain(dy3, x3, relu_from)
    dy3, x3 = dy3.contiguous(), x3.contiguous()
    N, C, S, code = _check_cuda("bn_gsum", x3, dy3)
    sc, sh, relu = _relu_operands(relu_from, C, x3)
    P = stat_chunks(N, C, S)
    part = torch.empty(2, C, P, dtype=torch.float32, device=x3.device)
    sdy = torch.empty(C, dtype=torch.float32, device=x3.device)
    sdyx = torch.empty_like(sdy)
    _call("ptt_bn_gsum", x3, dy3.data_ptr(), x3.data_ptr(), sc.data_ptr(),
          sh.data_ptr(), part.data_ptr(), sdy.data_ptr(), sdyx.data_ptr(),
          N, C, S, P, relu, code)
    bn_gsum.launches += 1
    return sdy, sdyx


bn_gsum.launches = 0


def bn_dx(dy3, x3, A, B, D, relu_from=None):
    """``A[c]·dy + B[c]·x + D[c]`` in ``x3``'s dtype (kernel 4); dy
    masked as in ``bn_gsum``."""
    extra = tuple(relu_from) if relu_from is not None else ()
    if _device("bn_dx", dy3, x3, A, B, D, *extra) == "cpu":
        return bn_dx_plain(dy3, x3, A, B, D, relu_from)
    dy3, x3 = dy3.contiguous(), x3.contiguous()
    N, C, S, code = _check_cuda("bn_dx", x3, dy3)
    A, B, D = (_vec(t, C) for t in (A, B, D))
    sc, sh, relu = _relu_operands(relu_from, C, x3)
    dx = torch.empty_like(x3)
    _call("ptt_bn_dx", x3, dy3.data_ptr(), x3.data_ptr(), A.data_ptr(),
          B.data_ptr(), D.data_ptr(), sc.data_ptr(), sh.data_ptr(),
          dx.data_ptr(), N, C, S, relu, code)
    bn_dx.launches += 1
    return dx


bn_dx.launches = 0


def _view3(x):
    N, C = x.shape[0], x.shape[1]
    return x.reshape(N, C, x.numel() // max(N * C, 1))


def bn_fold(mean, var, gamma, beta, eps: float):
    """rstd and the per-channel f32 scale and shift of statistics
    ``mean``, ``var`` (:205-213, and the eval fold of
    ``nn/functional/norm.py`` :104-132)."""
    rstd = torch.rsqrt(var.float() + eps)
    scale = rstd if gamma is None else gamma.float() * rstd
    mean = mean.float()
    shift = -mean * scale if beta is None else beta.float() - mean * scale
    return rstd, scale, shift


class _BNTrain(torch.autograd.Function):
    """The reference's ``bn_train`` custom VJP (``_bn_fwd``/``_bn_bwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu):
        x3 = _view3(x)
        N, _, S = x3.shape
        s1, s2 = bn_stats(x3)
        mean = s1 / (N * S)
        var = torch.clamp_min(s2 / (N * S) - mean * mean, 0.0)
        rstd, scale, shift = bn_fold(mean, var, gamma, beta, eps)
        y = bn_apply(x3, scale, shift, relu).view(x.shape)
        ctx.save_for_backward(x, gamma, beta, mean, rstd, scale, shift)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, rstd, scale, shift = ctx.saved_tensors
        x3 = _view3(x)
        N, C, S = x3.shape
        dy3 = dy.reshape(x3.shape)
        relu_from = (scale, shift) if ctx.relu else None
        sdy, sdyx = bn_gsum(dy3, x3, relu_from)
        n = N * S
        g = torch.ones_like(rstd) if gamma is None else gamma.float()
        dgamma = rstd * (sdyx - mean * sdy)
        m1 = sdy / n
        m2 = dgamma / n
        A = g * rstd
        B = -g * rstd * rstd * m2
        D = -A * m1 - B * mean
        dx = bn_dx(dy3, x3, A, B, D, relu_from).view(x.shape)
        dg = None if gamma is None else dgamma.to(gamma.dtype)
        db = None if beta is None else sdy.to(beta.dtype)
        return dx, dg, db, None, None


def bn_train(x, gamma: Optional[torch.Tensor] = None,
             beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
             relu: bool = False):
    """Training BatchNorm over ``[N, C, spatial...]``: returns ``(y,
    batch_mean, batch_var)``, the statistics f32 and not differentiated
    through (the reference's contract); ``relu`` fuses ``max(y, 0)`` into
    the apply pass and masks the backward on ``y > 0``. Differentiable
    in x, gamma and beta."""
    if x.dim() < 2:
        raise ValueError(f"bn_train takes [N, C, spatial...]; got "
                         f"{tuple(x.shape)}")
    return _BNTrain.apply(x.contiguous(), gamma, beta, float(eps),
                          bool(relu))
