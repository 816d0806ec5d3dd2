"""Dynamic int8 matmuls for training: the quantize kernels (Hopper), their
plain PyTorch versions, the wrappers that pick between them by the
tensor's device, and the all-int8 linear layers built on them.

Counterpart of ``paddle_tpu/ops/quant_matmul.py``:

- the seeds (``site_seed`` :37, the wgrad ``base = seed * 1000003``
  then ``+ 7919`` / ``+ 104729`` of ``_bwd_all8`` :522), with the
  reference's ``jnp.int32`` wrap-around kept exactly (Python ints do not
  wrap; ``wrap_int32`` does it);
- the RTN quantize: ``quantize_rowwise`` (:47, plain), ``_apply_act``
  (:71, f32 tanh-gelu), ``quantize_rowwise_fast`` (:140), and the two
  kernels behind it, ``quantize_rows`` (``_rowq_call`` :114, kernel row
  8: per-row scales, optionally of gelu(x)) and ``quantize_cols``
  (``_colq_call`` :129, row 9: per-column scales);
- the SR column quantize ``sr_quantize_colwise`` (:479, the kernel of
  ``_sr_colq_pallas`` :447, row 12): per-column scales, codes
  ``floor(x / scale + u)``. The TPU's ``prng_random_bits`` becomes
  Philox4x32-10 keyed by ``(seed mod 2**32, 1)`` with the flat
  row-major element index as the counter (``ops/fused_adamw.py:
  philox_words``), so the noise depends on (seed, element) only;
- the matmul core ``int8_dot_dequant`` (:327): an XLA ``dot_general``
  in the reference, here ``torch._int_mm`` (int8 x int8 -> int32, exact:
  6144 * 127**2 < 2**31) and the f32 epilogue ``y * a_scale *
  b_scale``. cuBLASLt's int8 GEMM runs at full rate only with A
  row-major and B column-major (a row-major B ran several times slower
  on an H100), so the column kernels write their codes column-major: the
  forward's B (w's codes), and the wgrad's A (``q.t()`` of the
  activation's codes) and B (g's codes) then need no copy; the dgrad's
  B is the transpose of the row-major codes of w;
- ``int8_linear_all8`` (:491) and ``int8_gelu_linear_all8`` (:536) as
  ``torch.autograd.Function``s: the forward runs RTN int8 (per-row x,
  per-column w); dgrad a per-row int8 of ``g`` and of ``w`` along axis
  1; wgrad an SR per-column int8 of the saved activation (gelu fused
  for ffn2) and of ``g``. The seed is a Python int and takes no
  gradient. ``int8_linear_all8_bwd`` and ``int8_gelu_linear_all8_bwd``
  are their backward passes, for callers that save their own
  residuals (the GPT trainer's remat).

All scale arithmetic is f32 in the reference's op order: ``scale =
where(amax == 0, 1, amax) * f32(1/127)``, the product XLA compiles the
reference's ``/ 127`` into (its jitted step and its Pallas kernels in
interpret mode alike), and codes ``clip(round_half_even(x / scale),
-127, 127)`` with ``x / scale`` a true division (tensor by tensor:
PyTorch on CUDA turns a division by a Python scalar into a product with
its reciprocal).
CPU tensors take the plain versions; a CUDA tensor launches the kernel
(``csrc/quantize.cu``) or raises. ``quantize_rows.launches``,
``quantize_cols.launches`` and ``sr_quantize_colwise.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .fused_adamw import INV127, philox_words, uniform01

__all__ = ["int8_dot_dequant", "int8_gelu_linear_all8",
           "int8_gelu_linear_all8_bwd", "int8_linear_all8",
           "int8_linear_all8_bwd", "int8_matmul", "layer_seed",
           "quantize_cols", "quantize_cols_plain", "quantize_rows",
           "quantize_rows_plain", "quantize_rowwise",
           "quantize_rowwise_fast", "site_seed", "sr_quantize_colwise",
           "sr_quantize_colwise_plain", "step_seed", "wgrad_seeds",
           "wrap_int32"]

_MASK = 0xFFFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "gelu": 1}
_GELU_C = 0.7978845608028654          # sqrt(2 / pi)


# -- seeds ------------------------------------------------------------------
def wrap_int32(v: int) -> int:
    """``v`` wrapped to int32 as the reference's ``jnp.int32`` arithmetic
    wraps it."""
    v = int(v) & _MASK
    return v - (1 << 32) if v >= (1 << 31) else v


def step_seed(step: int) -> int:
    """The trainer's per-step SR seed, ``(step + 1) * 40503`` with
    ``step`` the optimizer step before the update (``gpt.py:1378``)."""
    return wrap_int32((int(step) + 1) * 40503)


def layer_seed(seed: Optional[int], li: int) -> int:
    """Layer ``li``'s seed: layers sit 16 apart (``gpt.py:996``)."""
    return wrap_int32((1 if seed is None else seed) + 16 * li)


def site_seed(seed: Optional[int], site: int) -> int:
    """The (layer, site) stream of one int8 matmul: ``seed * 8 + site``
    (``quant_matmul.py:37``; site 1 qkv, 2 ffn1, 3 ffn2)."""
    return wrap_int32((1 if seed is None else seed) * 8 + site)


def wgrad_seeds(seed: int) -> Tuple[int, int]:
    """The SR seeds of a site's wgrad operands: the activation's and
    ``g``'s (``base = seed * 1000003``, ``+ 7919``, ``+ 104729``)."""
    base = wrap_int32(seed * 1000003)
    return wrap_int32(base + 7919), wrap_int32(base + 104729)


# -- plain versions -----------------------------------------------------------
def _apply_act(x, act):
    """The producer-fused activation in f32, in the reference's op order:
    ``0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x)))``."""
    if act is None:
        return x
    if act == "gelu":
        return 0.5 * x * (1.0 + torch.tanh(
            _GELU_C * (x + 0.044715 * x * x * x)))
    raise ValueError(f"unsupported fused act {act!r}")


def _scale(amax):
    """``where(amax == 0, 1, amax) / 127`` as the reference computes it:
    XLA compiles the division by the constant into a product with
    f32(1/127) (in the jitted step and in the Pallas kernels run in
    interpret mode alike), one ulp off the division on ~5% of values."""
    one = torch.ones_like(amax)
    return torch.where(amax == 0.0, one, amax) * torch.full_like(
        amax, INV127)


def quantize_rowwise(x, axis: int):
    """Symmetric int8 round-to-nearest along ``axis``: ``(q, scale)`` with
    ``x ~= q * scale`` and ``scale`` shaped like ``x`` with ``axis`` of
    size 1 (f32)."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=axis, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows_plain(x2, act=None):
    """Kernel row 8 in plain PyTorch: ``(q [M, K] int8, scale [M, 1]
    f32)`` of ``act(x2)`` computed in f32."""
    return quantize_rowwise(_apply_act(x2.float(), act), 1)


def _column_major(q):
    """``q`` with the same values stored column-major, as the column
    kernels write it (the layout ``torch._int_mm`` takes at full rate)."""
    return q.t().contiguous().t()


def quantize_cols_plain(x2):
    """Kernel row 9 in plain PyTorch: ``(q [K, N] int8, column-major,
    scale [1, N] f32)``."""
    q, scale = quantize_rowwise(x2, 0)
    return _column_major(q), scale


def sr_quantize_colwise_plain(x2, seed: int, act=None):
    """Kernel row 12 in plain PyTorch: ``(q [M, C] int8, column-major,
    scale [1, C] f32)``, codes ``clip(floor(act(x) / scale + u), -127,
    127)`` with ``u`` from Philox key ``(seed mod 2**32, 1)``, counter
    the flat row-major element index."""
    xf = _apply_act(x2.float(), act)
    scale = _scale(xf.abs().amax(dim=0, keepdim=True))
    u = uniform01(philox_words(xf.numel(), int(seed) & _MASK, xf.device,
                              key_hi=1)).view(xf.shape)
    q = torch.clamp(torch.floor(xf / scale + u), -127, 127)
    return _column_major(q.to(torch.int8)), scale


# -- kernels ------------------------------------------------------------------
def _check_cuda(what: str, x2) -> None:
    if x2.dtype not in _DTYPES or x2.dim() != 2:
        raise ValueError(f"{what} kernel takes a 2-D float32/bfloat16 "
                         f"tensor; got {x2.dtype}{tuple(x2.shape)}")
    vec = 16 // x2.element_size()
    if not x2.is_contiguous() or x2.shape[1] % vec or x2.data_ptr() % 16:
        raise ValueError(
            f"{what} kernel needs a contiguous x with its last dim a "
            f"multiple of {vec} and a 16-byte aligned base; got shape "
            f"{tuple(x2.shape)}, strides {x2.stride()}")


def _lib():
    lib = _build.load("quantize")
    if lib.ptt_quantize_rows.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ptt_quantize_rows.argtypes = [vp, vp, vp, ll, i, i, i, vp]
        lib.ptt_quantize_rows.restype = i
        lib.ptt_quantize_cols.argtypes = [vp, vp, vp, vp, ll, i, i, i, i,
                                          ctypes.c_uint, vp]
        lib.ptt_quantize_cols.restype = i
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ptt_cuda_error_string(err).decode()})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows_cuda(x2, act):
    _check_cuda("quantize_rows", x2)
    M, K = x2.shape
    if K > 49152:
        raise ValueError(f"quantize_rows kernel stages a row of K <= "
                         f"49152 floats in shared memory; got K={K}")
    q = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.ptt_quantize_rows(x2.data_ptr(), q.data_ptr(),
                                    scale.data_ptr(), M, K,
                                    _DTYPES[x2.dtype], _ACTS[act],
                                    _stream(x2))
    _raise_on(err, lib, "quantize_rows")
    return q, scale


def _cols_cuda(x2, act, seed):
    what = "quantize_cols" if seed is None else "sr_quantize_colwise"
    _check_cuda(what, x2)
    R, C = x2.shape
    if R % 16:
        raise ValueError(f"{what} kernel writes the codes column-major in "
                         f"16-row pieces: rows % 16 == 0; got {R}")
    qt = torch.empty((C, R), dtype=torch.int8, device=x2.device)
    scale = torch.empty((1, C), dtype=torch.float32, device=x2.device)
    amax = torch.empty(C, dtype=torch.float32, device=x2.device)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.ptt_quantize_cols(
            x2.data_ptr(), qt.data_ptr(), scale.data_ptr(), amax.data_ptr(),
            R, C, _DTYPES[x2.dtype], _ACTS[act], int(seed is not None),
            0 if seed is None else int(seed) & _MASK, _stream(x2))
    _raise_on(err, lib, what)
    return qt.t(), scale


def _device(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize kernels take CPU or CUDA tensors; got "
                         f"{x.device}")
    return x.device.type


def quantize_rows(x2, act=None):
    """Per-row symmetric int8 RTN of ``act(x2)`` for ``x2 [M, K]``:
    ``(q [M, K] int8, scale [M, 1] f32)``. ``act``: None or "gelu"."""
    if act not in _ACTS:
        raise ValueError(f"unsupported fused act {act!r}")
    if _device(x2) == "cpu":
        return quantize_rows_plain(x2, act)
    out = _rows_cuda(x2, act)
    quantize_rows.launches += 1
    return out


quantize_rows.launches = 0


def quantize_cols(x2):
    """Per-column symmetric int8 RTN of ``x2 [K, N]``: ``(q [K, N] int8,
    stored column-major, scale [1, N] f32)``."""
    if _device(x2) == "cpu":
        return quantize_cols_plain(x2)
    out = _cols_cuda(x2, None, None)
    quantize_cols.launches += 1
    return out


quantize_cols.launches = 0


def sr_quantize_colwise(x2, seed: int, act=None):
    """Unbiased per-column int8 quantize of ``act(x2)`` for ``x2 [M,
    C]`` with stochastic rounding drawn from ``seed`` (an int, taken mod
    2**32): ``(q [M, C] int8, stored column-major, scale [1, C] f32)``."""
    if act not in _ACTS:
        raise ValueError(f"unsupported fused act {act!r}")
    if _device(x2) == "cpu":
        return sr_quantize_colwise_plain(x2, seed, act)
    out = _cols_cuda(x2, act, int(seed))
    sr_quantize_colwise.launches += 1
    return out


sr_quantize_colwise.launches = 0


def quantize_rowwise_fast(x, axis: int, act=None):
    """``quantize_rowwise`` through the kernels: ``axis`` the last dim
    (any leading dims; optional ``act``) or 0 of a 2-D tensor."""
    axis = axis % x.dim()
    if axis == x.dim() - 1:
        lead, K = x.shape[:-1], x.shape[-1]
        q, s = quantize_rows(x.reshape(-1, K), act)
        return q.reshape(x.shape), s.reshape(*lead, 1)
    if axis == 0 and x.dim() == 2 and act is None:
        return quantize_cols(x)
    raise ValueError(f"quantize_rowwise_fast: axis {axis} of a "
                     f"{x.dim()}-D tensor (act {act!r}) has no kernel")


# -- the int8 matmul core -----------------------------------------------------
def int8_dot_dequant(aq, a_scale, bq, b_scale, out_dtype=None):
    """``aq [M, K] @ bq [K, N]`` in int8 with int32 accumulation, then
    ``y * a_scale * b_scale`` in f32 (scales broadcast against ``[M,
    N]``), cast to ``out_dtype`` when given. Either operand may be a
    transposed view; on CUDA a column-major ``bq`` runs at full rate."""
    y = torch._int_mm(aq, bq)
    out = y.float() * a_scale * b_scale
    return out if out_dtype is None else out.to(out_dtype)


def int8_matmul(x, w, act=None):
    """``act(x) [..., K] @ w [K, N]`` through RTN int8 (per-row x,
    per-column w), output in ``x.dtype``: the forward of the all-int8
    linears (``_int8_matmul`` :342, ``_int8_matmul_gelu`` :547)."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, K), act)
    wq, ws = quantize_cols(w)
    y = int8_dot_dequant(xq, xs, wq, ws, out_dtype=x.dtype)
    return y.reshape(*lead, w.shape[1])


def _dgrad(g2, w):
    """``g [M, N] @ w [K, N].T`` in int8: per-row scales on ``g`` and on
    ``w`` along its axis 1; f32 ``[M, K]``."""
    gq, gs = quantize_rows(g2)
    wq, ws = quantize_rows(w)
    return int8_dot_dequant(gq, gs, wq.t(), ws.reshape(1, -1))


def _wgrad(a2, g2, seed: int, act=None):
    """``act(a) [M, K].T @ g [M, N]`` in int8 with SR per-column scales
    along the token axis; f32 ``[K, N]``."""
    a_seed, g_seed = wgrad_seeds(seed)
    aq, a_s = sr_quantize_colwise(a2, a_seed, act)
    gq, g_s = sr_quantize_colwise(g2, g_seed)
    return int8_dot_dequant(aq.t(), a_s.reshape(-1, 1), gq, g_s)


def int8_linear_all8_bwd(x, w, seed: int, g):
    """The backward of ``int8_linear_all8`` from its residuals ``(x, w,
    seed)``: ``(dx in x.dtype, dw in w.dtype)``."""
    K, N = w.shape
    g2 = g.reshape(-1, N)
    dx = _dgrad(g2, w).to(x.dtype).reshape(x.shape)
    dw = _wgrad(x.reshape(-1, K), g2, seed)
    return dx, dw.to(w.dtype)


def int8_gelu_linear_all8_bwd(x, w, seed: int, g):
    """The backward of ``int8_gelu_linear_all8`` (``x`` the pre-gelu
    activation): dgrad in int8 chained through gelu' in f32, wgrad an SR
    int8 of gelu(x) fused in the column quantize."""
    K, N = w.shape
    g2 = g.reshape(-1, N)
    da = _dgrad(g2, w).reshape(x.shape)
    dx = torch.ops.aten.gelu_backward(da, x.float(), approximate="tanh")
    dw = _wgrad(x.reshape(-1, K), g2, seed, act="gelu")
    return dx.to(x.dtype), dw.to(w.dtype)


class _Int8LinearAll8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, seed, act):
        ctx.save_for_backward(x, w)
        ctx.seed, ctx.act = seed, act
        return int8_matmul(x, w, act)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        bwd = int8_gelu_linear_all8_bwd if ctx.act == "gelu" \
            else int8_linear_all8_bwd
        dx, dw = bwd(x, w, ctx.seed, g)
        return dx, dw, None, None


def int8_linear_all8(x, w, seed: int):
    """``x [..., K] @ w [K, N]`` with int8 products in the forward, the
    dgrad and the wgrad (SR along the token axis, streams from the int
    ``seed``); differentiable in ``x`` and ``w``."""
    return _Int8LinearAll8.apply(x, w, int(seed), None)


def int8_gelu_linear_all8(x, w, seed: int):
    """``int8_linear_all8(gelu(x), w, seed)`` with the tanh-gelu computed
    inside the quantize kernels: ``x`` is the pre-activation."""
    return _Int8LinearAll8.apply(x, w, int(seed), "gelu")
