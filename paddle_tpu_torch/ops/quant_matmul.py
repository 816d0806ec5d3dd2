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
  8: per-row scales, optionally of gelu(x); on the card the row stays in
  registers, a warp a row or a block a row by shape, up to K = 16384,
  and longer rows are staged in shared memory) and ``quantize_cols``
  (``_colq_call`` :129, row 9: per-column scales; on the card one launch
  that reads x once, row 12's thread-block cluster with an RTN cast, up
  to ``cols_one_read_max_rows`` rows, and the two-pass pair past that);
- the SR column quantize ``sr_quantize_colwise`` (:479, the kernel of
  ``_sr_colq_pallas`` :447, row 12): per-column scales, codes
  ``floor(x / scale + u)``. The TPU's ``prng_random_bits`` becomes
  Philox4x32-10 keyed by ``(seed mod 2**32, 1)`` with the flat
  row-major element index as the counter (``ops/fused_adamw.py:
  philox_words``), so the noise depends on (seed, element) only. On
  the card it is one launch that reads x once (a thread-block cluster a
  32-column strip, all rows in its blocks' shared memory) up to
  ``sr_cols_one_read_max_rows`` rows; a taller x takes the two-pass
  pair (an amax pass, then the cast), picked from the shape before the
  launch;
- the LayerNorm-fused quantizes: ``ln_quantize_rowwise`` (:239, the
  kernel of ``_rowq_ln_call`` :215, row 10: LayerNorm and row 8's RTN
  in one read of the pre-LN x, also returning the rows' mean and
  rstd) and ``sr_quantize_colwise_ln`` (:313, the kernel of
  ``_sr_colq_ln_pallas`` :296, row 11: row 12's SR column quantize of
  ``((x - mean) * rstd) * g + b`` from those statistics, drawing row
  12's Philox words, so the fused and the unfused wgrad quantize of
  one activation take the same noise; on the card row 12's cluster
  kernel with the LayerNorm taken from the staged x for the maxima and
  again in the cast, up to ``sr_cols_one_read_max_rows(dtype, ln=True)``
  rows, the pair past them). Row 10's kernel keeps the row in
  registers (a warp a row up to K = 2048, a block a row up to 16384;
  longer rows, and K % 16 != 0, staged in shared memory) and sums it
  in a fixed order that K alone sets (``row10_route``,
  ``_kernel_row_sums``: each thread's four partial sums, the warp
  butterfly, the warps in order), never M, so a row has the same bits
  in any batch; its plain version sums in that order too, so the two
  agree bit for bit;
- the matmul core ``int8_dot_dequant`` (:327): an XLA ``dot_general``
  in the reference, here ``torch._int_mm`` (int8 x int8 -> int32, exact:
  6144 * 127**2 < 2**31) and the f32 epilogue ``y * a_scale *
  b_scale``. cuBLASLt's int8 GEMM runs at full rate only with A
  row-major and B column-major (a row-major B ran several times slower
  on an H100), so the column kernels write their codes column-major: the
  forward's B (w's codes), and the wgrad's A (``q.t()`` of the
  activation's codes) and B (g's codes) then need no copy; the dgrad's
  B is the transpose of the row-major codes of w;
- ``int8_linear_all8`` (:491), ``int8_gelu_linear_all8`` (:536) and
  ``int8_ln_linear_all8`` (:608) as ``torch.autograd.Function``s: the
  forward runs RTN int8 (per-row x, or LayerNorm(x) through row 10,
  per-column w); dgrad a per-row int8 of ``g`` and of ``w`` along axis
  1 (then LayerNorm's backward from the saved statistics); wgrad an SR
  per-column int8 of the saved activation (gelu fused for ffn2;
  LayerNorm fused through row 11 with ``fuse_bwd_colq``, else
  LayerNorm's output made once and row 12) and of ``g``. The seed is a
  Python int and takes no gradient. The ``*_bwd`` functions are their
  backward passes, for callers that save their own residuals (the GPT
  trainer's int8 block);
- the lower tiers ``int8_linear`` (:351, int8 forward, exact backward)
  and ``int8_linear_dgrad8`` (:376, int8 forward and dgrad, exact
  wgrad), on rows 8 and 9.

All scale arithmetic is f32 in the reference's op order: ``scale =
where(amax == 0, 1, amax) * f32(1/127)``, the product XLA compiles the
reference's ``/ 127`` into (its jitted step and its Pallas kernels in
interpret mode alike), and codes ``clip(round_half_even(x / scale),
-127, 127)`` with ``x / scale`` a true division (tensor by tensor:
PyTorch on CUDA turns a division by a Python scalar into a product with
its reciprocal).
CPU tensors take the plain versions; a CUDA tensor launches the kernel
(``csrc/quantize.cu``) or raises. ``quantize_rows.launches``,
``quantize_cols.launches``, ``sr_quantize_colwise.launches``,
``ln_quantize_rowwise.launches`` and ``sr_quantize_colwise_ln.launches``
count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.nn import functional as TF

from . import _build
from .fused_adamw import INV127, philox_words, uniform01
from .layer_norm import LN_EPS, ln_apply, ln_bwd

__all__ = ["cols_one_read_max_rows", "int8_dgrad", "int8_dot_dequant",
           "int8_gelu_linear_all8", "int8_gelu_linear_all8_bwd", "int8_linear",
           "int8_linear_all8", "int8_linear_all8_bwd", "int8_linear_dgrad8",
           "int8_ln_linear_all8", "int8_ln_linear_all8_bwd", "int8_ln_matmul",
           "int8_matmul", "layer_seed", "ln_quantize_rowwise",
           "ln_quantize_rowwise_plain", "quantize_cols", "quantize_cols_plain",
           "quantize_rows", "quantize_rows_plain", "quantize_rowwise",
           "quantize_rowwise_fast", "row10_route", "site_seed",
           "sr_cols_one_read_max_rows", "sr_quantize_colwise",
           "sr_quantize_colwise_ln", "sr_quantize_colwise_ln_plain",
           "sr_quantize_colwise_plain", "step_seed", "wgrad_seeds",
           "wrap_int32"]

_MASK = 0xFFFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "gelu": 1}
_ACT_LN = 2                           # the column kernels' LayerNorm prologue
_THREADS = 256                        # threads of a row-kernel block
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


# row 10's register routes (csrc/quantize.cu launch_rows_ln): a warp a
# row up to K = 2048, a block a row up to 16384, units of 16 values
_UNIT, _WARP_MAX_K, _REG_MAX_K = 16, 2048, 16384


def row10_route(K: int):
    """Row 10's kernel route for rows of ``K`` values, by K alone: ``(G,
    NU)`` (G threads a row, NU units of 16 values a thread: a warp a row
    up to K = 2048, else a block a row, G and NU as row 8's block route)
    while the row fits the registers (K <= 16384, K % 16 == 0), else
    None (the staged kernel)."""
    if K % _UNIT or K > _REG_MAX_K:
        return None
    units = K // _UNIT
    G = 32 if K <= _WARP_MAX_K else _THREADS
    nu = 1 if units <= G else 2 if units <= 2 * G else 4
    if K > _WARP_MAX_K:
        G = (-(-units // nu) + 31) // 32 * 32
    return G, nu


def _threads_then_warps(acc):
    """The sum over a row's G threads of ``acc [M, G]`` in the kernels'
    order: within each warp lane l adds lane l + 16, then l + 8, 4, 2, 1
    (the butterfly as lane 0 sees it); then the warps' sums in order."""
    M, G = acc.shape
    lanes = acc.view(M, G // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    warps = lanes[..., 0]
    total = warps[:, 0]
    for w in range(1, warps.shape[1]):
        total = total + warps[:, w]
    return total[:, None]


def _kernel_row_sums(v, vec: int):
    """Row sums of ``v [M, K]`` (f32) in row 10's kernel order, ``[M,
    1]``; the order follows K alone (``row10_route``), never M. Register
    routes: thread t of G keeps four partial sums p[k] of the values 4 i
    + k of its units (unit u * G + t holds columns (u * G + t) * 16 ..
    + 15), adding unit by unit, i by i, from 0; then (p0 + p1) + (p2 +
    p3); then the warp butterfly and the warps in order. The staged
    route: thread t of 256 adds elements ``t * vec + j``, then ``(t +
    256) * vec + j``, ..., one by one from 0 (``vec`` = 16 bytes of x);
    then the butterfly and the 8 warps in order. Values past K add
    zeros."""
    M, K = v.shape
    route = row10_route(K)
    if route is None:
        v = TF.pad(v, (0, (-K) % (_THREADS * vec))).view(M, -1, _THREADS,
                                                         vec)
        acc = torch.zeros((M, _THREADS), dtype=torch.float32,
                          device=v.device)
        for it in range(v.shape[1]):
            for j in range(vec):
                acc = acc + v[:, it, :, j]
        return _threads_then_warps(acc)
    G, nu = route
    v = TF.pad(v, (0, nu * G * _UNIT - K)).view(M, nu, G, 4, 4)
    p = torch.zeros((M, G, 4), dtype=torch.float32, device=v.device)
    for u in range(nu):
        for i in range(4):
            p = p + v[:, u, :, i, :]
    return _threads_then_warps((p[..., 0] + p[..., 1])
                               + (p[..., 2] + p[..., 3]))


def ln_quantize_rowwise_plain(x2, g, b):
    """Kernel row 10 in plain PyTorch: LayerNorm of ``x2 [M, K]`` (f32
    statistics, eps 1e-5) and the per-row RTN of its f32 output: ``(q
    [M, K] int8, scale, mean, rstd [M, 1] f32)``. Sums in the kernel's
    order (``_kernel_row_sums``: set by K, so a row has the same bits in
    any batch); ``rstd = 1 / sqrt(var + eps)`` (correctly rounded)."""
    xf = x2.float()
    vec = 16 // x2.element_size()
    k = torch.full((xf.shape[0], 1), float(xf.shape[1]), device=xf.device)
    mean = _kernel_row_sums(xf, vec) / k
    xc = xf - mean
    var = _kernel_row_sums(xc * xc, vec) / k
    rstd = torch.ones_like(var) / torch.sqrt(var + LN_EPS)
    q, scale = quantize_rowwise(ln_apply(xf, mean, rstd, g, b), 1)
    return q, scale, mean, rstd


def sr_quantize_colwise_ln_plain(x2, mean, rstd, g, b, seed: int):
    """Kernel row 11 in plain PyTorch: row 12's SR column quantize of
    ``((x2 - mean) * rstd) * g + b`` in f32 (``mean``, ``rstd`` [M, 1]
    f32, ``g``, ``b`` [C]): ``(q [M, C] int8, column-major, scale [1, C]
    f32)``, the noise of row 12 at the same seed."""
    return sr_quantize_colwise_plain(ln_apply(x2, mean, rstd, g, b), seed)


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
                                          ctypes.c_uint, vp, vp, vp, vp, vp]
        lib.ptt_quantize_cols.restype = i
        lib.ptt_quantize_rows_ln.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll,
                                             i, i, i, vp]
        lib.ptt_quantize_rows_ln.restype = i
        lib.ptt_quantize_cols_one_read.argtypes = [vp, vp, vp, ll, i, i, i,
                                                   i, ctypes.c_uint, vp, vp,
                                                   vp, vp, vp]
        lib.ptt_quantize_cols_one_read.restype = i
        lib.ptt_cols_one_read_max_rows.argtypes = [i, i, i]
        lib.ptt_cols_one_read_max_rows.restype = i
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


# a block's shared memory on Hopper after the opt-in (232,448 bytes),
# less the block reductions' static scratch: row 10, and row 8 past the
# K = 16384 it keeps in registers, stage a row of K floats there (the
# int8 CE head's dlg rows have K = vocab, 50304)
_ROW_MAX_K = (232448 - 64) // 4


def _row_smem_check(what: str, K: int) -> None:
    if K > _ROW_MAX_K:
        raise ValueError(f"{what} kernel stages a row of K <= {_ROW_MAX_K} "
                         f"floats in shared memory; got K={K}")


def _rows_cuda(x2, act):
    _check_cuda("quantize_rows", x2)
    M, K = x2.shape
    _row_smem_check("quantize_rows", K)
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


def _f32_vector(what: str, name: str, t, n: int, device):
    """A LayerNorm parameter or statistic as the kernels take it: f32,
    contiguous, ``n`` values from a 16-byte aligned address, on
    ``device`` (a tensor elsewhere raises)."""
    if t.device != device or t.numel() != n:
        raise ValueError(f"{what} kernel: {name} must hold {n} values on "
                         f"{device}; got {tuple(t.shape)} on {t.device}")
    t = t.reshape(n).float().contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _rows_ln_cuda(x2, g, b, staged: bool = False):
    """Row 10 on the route K picks (``row10_route``), or with ``staged``
    the staged kernel at any K (its own summation order: for timing the
    former route beside the new)."""
    what = "ln_quantize_rowwise"
    _check_cuda(what, x2)
    M, K = x2.shape
    _row_smem_check(what, K)
    g, b = (_f32_vector(what, n, t, K, x2.device)
            for n, t in (("g", g), ("b", b)))
    q = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    scale, mean, rstd = (torch.empty((M, 1), dtype=torch.float32,
                                     device=x2.device) for _ in range(3))
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.ptt_quantize_rows_ln(
            x2.data_ptr(), g.data_ptr(), b.data_ptr(), q.data_ptr(),
            scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(), M, K,
            _DTYPES[x2.dtype], int(staged), _stream(x2))
    _raise_on(err, lib, what)
    return q, scale, mean, rstd


def sr_cols_one_read_max_rows(dtype, act=None, ln: bool = False) -> int:
    """The most rows ``sr_quantize_colwise`` (``act``), or with ``ln``
    ``sr_quantize_colwise_ln``, takes in one read of x on the card for
    ``dtype`` (``csrc/quantize.cu``: a cluster of at most 16 blocks, each
    at most half an SM's shared memory, holds a 32-column strip of all
    rows: x, and act(x) in f32 with gelu, or the rows' mean and rstd with
    LayerNorm); more rows take the two-pass pair."""
    return _lib().ptt_cols_one_read_max_rows(
        _DTYPES[dtype], _ACT_LN if ln else _ACTS[act], 1)


def cols_one_read_max_rows(dtype) -> int:
    """The most rows ``quantize_cols`` takes in one read of x on the card
    for ``dtype`` (row 12's cluster, its blocks' rows a multiple of 16);
    more rows take the two-pass pair."""
    return _lib().ptt_cols_one_read_max_rows(_DTYPES[dtype], 0, 0)


def _cols_name(seed, ln) -> str:
    return "quantize_cols" if seed is None else \
        "sr_quantize_colwise_ln" if ln else "sr_quantize_colwise"


def _cols_cuda(x2, act, seed, ln=()):
    """Rows 9 and 12, or row 11 when ``ln`` holds (mean, rstd, g, b).
    Each takes the one-read cluster kernel when R fits it (by shape,
    before any launch), else the two-pass pair."""
    what = _cols_name(seed, ln)
    _check_cuda(what, x2)
    R, C = x2.shape
    if R % 16:
        raise ValueError(f"{what} kernel writes the codes column-major in "
                         f"16-row pieces: rows % 16 == 0; got {R}")
    limit = (cols_one_read_max_rows(x2.dtype) if seed is None
             else sr_cols_one_read_max_rows(x2.dtype, act, bool(ln)))
    if R <= limit:
        return _cols_one_read(x2, act, seed, ln)
    return _cols_two_pass(x2, act, seed, ln)


def _ln_ptrs(what: str, x2, ln):
    """Row 11's (mean, rstd, g, b) as the kernels take them, and their
    addresses (None without LayerNorm)."""
    if not ln:
        return (), [None] * 4
    R, C = x2.shape
    ln = [_f32_vector(what, name, t, n, x2.device) for name, t, n in
          zip(("mean", "rstd", "g", "b"), ln, (R, R, C, C))]
    return ln, [t.data_ptr() for t in ln]


def _cols_two_pass(x2, act, seed, ln=()):
    """The two-pass pair (an amax pass, then the cast) on a checked
    ``x2``: rows 9, 11 and 12 past the one-read limit (and, called
    directly, at any R, for timing the two routes on one input)."""
    what = _cols_name(seed, ln)
    R, C = x2.shape
    ln, ln_ptrs = _ln_ptrs(what, x2, ln)
    qt = torch.empty((C, R), dtype=torch.int8, device=x2.device)
    scale = torch.empty((1, C), dtype=torch.float32, device=x2.device)
    amax = torch.empty(C, dtype=torch.float32, device=x2.device)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.ptt_quantize_cols(
            x2.data_ptr(), qt.data_ptr(), scale.data_ptr(), amax.data_ptr(),
            R, C, _DTYPES[x2.dtype], _ACT_LN if ln else _ACTS[act],
            int(seed is not None), 0 if seed is None else int(seed) & _MASK,
            *ln_ptrs, _stream(x2))
    _raise_on(err, lib, what)
    return qt.t(), scale


def _cols_one_read(x2, act, seed, ln=()):
    """The one-read cluster kernel on a checked ``x2``: row 12 (SR from
    ``seed``), row 11 when ``ln`` holds (mean, rstd, g, b), or row 9
    (RTN) when ``seed`` is None."""
    what = _cols_name(seed, ln)
    R, C = x2.shape
    ln, ln_ptrs = _ln_ptrs(what, x2, ln)
    qt = torch.empty((C, R), dtype=torch.int8, device=x2.device)
    scale = torch.empty((1, C), dtype=torch.float32, device=x2.device)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.ptt_quantize_cols_one_read(
            x2.data_ptr(), qt.data_ptr(), scale.data_ptr(), R, C,
            _DTYPES[x2.dtype], _ACT_LN if ln else _ACTS[act],
            int(seed is not None), 0 if seed is None else int(seed) & _MASK,
            *ln_ptrs, _stream(x2))
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


def ln_quantize_rowwise(x2, g, b):
    """LayerNorm (f32 statistics, eps 1e-5, gain ``g`` and bias ``b``
    [K]) and the per-row symmetric int8 RTN of its f32 output, for ``x2
    [M, K]`` in one read: ``(q [M, K] int8, scale [M, 1], mean [M, 1],
    rstd [M, 1])``, all f32 but q."""
    if _device(x2) == "cpu":
        return ln_quantize_rowwise_plain(x2, g, b)
    out = _rows_ln_cuda(x2, g, b)
    ln_quantize_rowwise.launches += 1
    return out


ln_quantize_rowwise.launches = 0


def sr_quantize_colwise_ln(x2, mean, rstd, g, b, seed: int):
    """``sr_quantize_colwise`` of LayerNorm(``x2``) from its row
    statistics (``mean``, ``rstd`` [M, 1] f32, as ``ln_quantize_rowwise``
    returns them) and ``g``, ``b`` [C], without the LN output in memory:
    ``(q [M, C] int8, stored column-major, scale [1, C] f32)``."""
    if _device(x2) == "cpu":
        return sr_quantize_colwise_ln_plain(x2, mean, rstd, g, b, seed)
    out = _cols_cuda(x2, None, int(seed), (mean, rstd, g, b))
    sr_quantize_colwise_ln.launches += 1
    return out


sr_quantize_colwise_ln.launches = 0


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


def int8_dgrad(g2, w):
    """``g [M, N] @ w [K, N].T`` in int8: per-row scales on ``g`` and on
    ``w`` along its axis 1; f32 ``[M, K]``."""
    gq, gs = quantize_rows(g2)
    wq, ws = quantize_rows(w)
    return int8_dot_dequant(gq, gs, wq.t(), ws.reshape(1, -1))


def _sr_wgrad(aq, a_scale, g2, g_seed: int):
    """``a.T @ g`` from the SR codes of ``a [M, K]`` (column-major, scales
    ``[1, K]``) and an SR quantize of ``g [M, N]``; f32 ``[K, N]``."""
    gq, g_s = sr_quantize_colwise(g2, g_seed)
    return int8_dot_dequant(aq.t(), a_scale.reshape(-1, 1), gq, g_s)


def _wgrad(a2, g2, seed: int, act=None):
    """``act(a) [M, K].T @ g [M, N]`` in int8 with SR per-column scales
    along the token axis; f32 ``[K, N]``."""
    a_seed, g_seed = wgrad_seeds(seed)
    aq, a_s = sr_quantize_colwise(a2, a_seed, act)
    return _sr_wgrad(aq, a_s, g2, g_seed)


def int8_linear_all8_bwd(x, w, seed: int, g):
    """The backward of ``int8_linear_all8`` from its residuals ``(x, w,
    seed)``: ``(dx in x.dtype, dw in w.dtype)``."""
    K, N = w.shape
    g2 = g.reshape(-1, N)
    dx = int8_dgrad(g2, w).to(x.dtype).reshape(x.shape)
    dw = _wgrad(x.reshape(-1, K), g2, seed)
    return dx, dw.to(w.dtype)


def int8_gelu_linear_all8_bwd(x, w, seed: int, g):
    """The backward of ``int8_gelu_linear_all8`` (``x`` the pre-gelu
    activation): dgrad in int8 chained through gelu' in f32, wgrad an SR
    int8 of gelu(x) fused in the column quantize."""
    K, N = w.shape
    g2 = g.reshape(-1, N)
    da = int8_dgrad(g2, w).reshape(x.shape)
    dx = torch.ops.aten.gelu_backward(da, x.float(), approximate="tanh")
    dw = _wgrad(x.reshape(-1, K), g2, seed, act="gelu")
    return dx.to(x.dtype), dw.to(w.dtype)


def int8_ln_matmul(x, g_ln, b_ln, w):
    """The forward of ``int8_ln_linear_all8``: LayerNorm(x) ``[..., K] @ w
    [K, N]`` through row 10 and RTN int8, output in ``x.dtype``, and the
    row statistics ``(mean, rstd)`` ``[M, 1]`` f32 (``_int8_matmul_ln``
    :600)."""
    lead, K = x.shape[:-1], x.shape[-1]
    q, s, mean, rstd = ln_quantize_rowwise(x.reshape(-1, K), g_ln, b_ln)
    wq, ws = quantize_cols(w)
    y = int8_dot_dequant(q, s, wq, ws, out_dtype=x.dtype)
    return y.reshape(*lead, w.shape[1]), mean, rstd


def int8_ln_linear_all8_bwd(x, g_ln, b_ln, w, seed: int, mean, rstd, g,
                            fuse_bwd_colq: bool):
    """The backward of ``int8_ln_linear_all8`` (``_bwd_ln_all8`` :644)
    from its residuals and the forward's row statistics: ``(dx, dg_ln,
    db_ln, dw)``. The dgrad is int8 per-row, cast to x's dtype and taken
    through LayerNorm's backward; the wgrad quantizes LayerNorm(x) by
    SR, fused from the statistics (row 11) with ``fuse_bwd_colq``, else
    made once in x's dtype and quantized by row 12."""
    K, N = w.shape
    x2, g2 = x.reshape(-1, K), g.reshape(-1, N)
    stats = x.shape[:-1] + (1,)
    dh = int8_dgrad(g2, w).to(x.dtype).reshape(x.shape)
    dx, dg_ln, db_ln = ln_bwd(x, g_ln, mean.reshape(stats),
                              rstd.reshape(stats), dh)
    a_seed, g_seed = wgrad_seeds(seed)
    if fuse_bwd_colq:
        hq, hs = sr_quantize_colwise_ln(x2, mean, rstd, g_ln, b_ln, a_seed)
    else:
        h = ln_apply(x2, mean, rstd, g_ln, b_ln).to(x.dtype)
        hq, hs = sr_quantize_colwise(h, a_seed)
    dw = _sr_wgrad(hq, hs, g2, g_seed)
    return dx, dg_ln, db_ln, dw.to(w.dtype)


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


class _Int8LnLinearAll8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g_ln, b_ln, w, seed, fuse_bwd_colq):
        y, mean, rstd = int8_ln_matmul(x, g_ln, b_ln, w)
        ctx.save_for_backward(x, g_ln, b_ln, w, mean, rstd)
        ctx.seed, ctx.fuse_bwd_colq = seed, fuse_bwd_colq
        return y

    @staticmethod
    def backward(ctx, g):
        x, g_ln, b_ln, w, mean, rstd = ctx.saved_tensors
        grads = int8_ln_linear_all8_bwd(x, g_ln, b_ln, w, ctx.seed, mean,
                                        rstd, g, ctx.fuse_bwd_colq)
        return (*grads, None, None)


def int8_ln_linear_all8(x, g_ln, b_ln, w, seed: int,
                        fuse_bwd_colq: bool = False):
    """``int8_linear_all8(layer_norm(x, g_ln, b_ln), w, seed)`` with the
    LayerNorm inside the quantize kernels: ``x`` is the pre-LN input and
    no LN output is written in the forward. Differentiable in ``x``,
    ``g_ln``, ``b_ln`` and ``w``; ``fuse_bwd_colq`` picks the wgrad's
    quantize (see ``int8_ln_linear_all8_bwd``; the reference's default,
    its environment's ``PTPU_FUSE_BWD_COLQ`` unset, is False)."""
    return _Int8LnLinearAll8.apply(x, g_ln, b_ln, w, int(seed),
                                   bool(fuse_bwd_colq))


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dgrad8):
        ctx.save_for_backward(x, w)
        ctx.dgrad8 = dgrad8
        return int8_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        K, N = w.shape
        g2 = g.reshape(-1, N)
        dx = int8_dgrad(g2, w) if ctx.dgrad8 else g2 @ w.t()
        dw = x.reshape(-1, K).t() @ g2
        return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype), None


def int8_linear(x, w):
    """``x [..., K] @ w [K, N]`` through RTN int8 in the forward; the
    backward is exact in the input dtype (``int8_linear`` :351)."""
    return _Int8Linear.apply(x, w, False)


def int8_linear_dgrad8(x, w):
    """``int8_linear`` with the activation gradient in int8 as well
    (per-row scales on the cotangent and on ``w`` along N); the weight
    gradient stays exact (``int8_linear_dgrad8`` :376)."""
    return _Int8Linear.apply(x, w, True)
