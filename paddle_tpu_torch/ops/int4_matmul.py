"""Weight-only int4 matmul: the Hopper kernel, its plain PyTorch version,
the wrapper that picks between them by the tensor's device, and the
quantizers that make its operands.

Counterpart of ``paddle_tpu/ops/int4_matmul.py``:

- ``quantize_int4_rows`` (:29) and ``pack_rows_int4`` (:43), here in
  torch so that they run on the model's device. They give the
  reference's numpy results bit for bit: f32 ``amax / 7`` (a true
  division), round half to even, clip to +-7, scale 1 for an all-zero
  group; the codes stored as ``u = q + 8`` in a nibble, row ``k`` in
  the high nibble and row ``k + K/2`` in the low one ("halves layout").
- ``int4_matmul`` (:118, kernel ``_kernel`` :54, kernel row 7):
  ``x [M, K] @ dequant(packed [K/2, N], scales [K/group, N])`` with
  per-group dots and the group scale applied to each group's f32
  partial (never folded into a 16-bit weight), output in x's dtype.
  The high nibbles multiply ``x[:, :K/2]``, the low ones
  ``x[:, K/2:]``; group ``g`` of the high half takes scale row ``g``,
  of the low half row ``K/(2 group) + g``, which is the natural row
  order of ``quantize_int4_rows``'s scales.

On the chip the reference computes in bf16 (``cdtype``: x rounded to
bf16, codes exact in bf16, f32 accumulation); in interpret mode on the
CPU in f32. ``int4_matmul_plain`` computes with x as given, in f32, so
for bf16 x (the model's dtype on the card) it is the chip's function
and on the CPU it is interpret mode's. It takes the reference's group
order: per group the high-half dot, scaled, added to the f32
accumulator, then the low-half one.

CPU tensors take the plain version; a CUDA tensor launches the kernel
(``csrc/int4_matmul.cu``: M <= 16 streams the weight with a K split
whose partials the same launch adds, M > 16 runs wgmma) or raises.
``int4_matmul.launches`` counts kernel launches, one a call.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build

__all__ = ["int4_matmul", "int4_matmul_plain", "int4_plan", "pack_rows_int4",
           "quantize_int4_rows", "unpack_rows_int4"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DECODE_ROWS = 16            # M up to this runs the decode kernel
_SMALL_UNITS = 512           # (64-column tile, group) pairs of a small weight
_TARGET_WARPS = 768          # decode warps in all: ~1.5 a scheduler of 528


def quantize_int4_rows(w, group: int = 128):
    """``w [K, N]`` float -> ``(q [K, N] int8 in [-7, 7], scales [K //
    group, N] f32)``, symmetric per (group of rows, column)."""
    K, N = w.shape
    if K % group:
        raise ValueError(f"K {K} % group {group} != 0")
    wg = w.detach().reshape(K // group, group, N).float()
    amax = wg.abs().amax(dim=1)
    scale = amax / torch.full_like(amax, 7.0)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    # elementwise ops keep a transposed w's strides: hand back row-major
    return q.reshape(K, N).to(torch.int8).contiguous(), scale.contiguous()


def pack_rows_int4(q):
    """``q [K, N]`` int4-valued -> uint8 ``[K/2, N]``: row k in the HIGH
    nibble, row k + K/2 in the LOW nibble (the halves layout)."""
    K = q.shape[0]
    if K % 2:
        raise ValueError("K must be even")
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    return ((u[:K // 2] << 4) | u[K // 2:]).contiguous()


def unpack_rows_int4(packed):
    """The inverse of ``pack_rows_int4``: ``(hi, lo)`` int codes ``[K/2,
    N]`` in [-8, 7], rows ``0..K/2`` and ``K/2..K``."""
    p = packed.to(torch.int32)
    return (p >> 4) - 8, (p & 0xF) - 8


def _check(x, packed, scales, group: int):
    """The reference's ``ValueError``s, in its order."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K]; got {tuple(x.shape)}")
    K = x.shape[1]
    N = packed.shape[1]
    if (K // 2) % group:
        raise ValueError(
            f"group {group} must divide K//2 = {K // 2} "
            f"(pick a group size with group | K/2)")
    if packed.shape[0] != K // 2:
        raise ValueError(
            f"packed rows {packed.shape[0]} != K//2 = {K // 2}")
    if tuple(scales.shape) != (K // group, N):
        raise ValueError(
            f"scales shape {tuple(scales.shape)} != {(K // group, N)}")


def int4_matmul_plain(x, packed, scales, group: int = 128):
    """Kernel row 7 in plain PyTorch: per group, ``x_hi_g @ hi_g`` and
    ``x_lo_g @ lo_g`` in f32 (x as given, codes exact), each times its
    scale row and added to an f32 accumulator in the reference's order;
    the result in x's dtype."""
    _check(x, packed, scales, group)
    M, K = x.shape
    half, N = K // 2, packed.shape[1]
    gh = half // group
    hi, lo = (c.float().view(gh, group, N) for c in unpack_rows_int4(packed))
    xf = x.float()
    # [gh, M, N] partial products of each group, one batched product per half
    p_hi = torch.bmm(xf[:, :half].reshape(M, gh, group).transpose(0, 1), hi)
    p_lo = torch.bmm(xf[:, half:].reshape(M, gh, group).transpose(0, 1), lo)
    s = scales.float()
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(gh):
        acc = acc + p_hi[g] * s[g]
        acc = acc + p_lo[g] * s[gh + g]
    return acc.to(x.dtype)


def int4_plan(K: int, N: int, group: int):
    """``(bn, warps, splits)`` of the decode kernel (M <= 16) for this
    weight: tiles of ``bn`` columns, the K range of a tile cut into
    ``splits`` runs of whole groups, one a warp, ``warps`` of them a
    block; the block adds its warps' partials in order, and the
    ``splits // warps`` blocks of a tile (one cluster) add theirs in
    order in the first one's shared memory.

    A small weight (at most ``_SMALL_UNITS`` pairs of a 64-column tile and
    a group) takes 32-column tiles and blocks of 4 warps, so more SMs
    share it; the splits aim at ``_TARGET_WARPS`` warps in all (at most
    32: a cluster is at most 8 blocks), in one block up to 8, else in
    blocks of 4. Depends on the weight's shape only, never on M, so a
    row's result does not depend on how many rows ride along (the
    choices were timed on an H100 at Llama-1B's shapes)."""
    gh = K // 2 // group
    bn = 32 if -(-N // 64) * gh <= _SMALL_UNITS else 64
    splits = min(gh, 32, -(-_TARGET_WARPS // -(-N // bn)))
    if bn == 32 and splits % 4 == 0:
        return bn, 4, splits
    if splits <= 8:
        return bn, splits, splits
    return bn, 4, min(-(-splits // 4) * 4, gh - gh % 4)


def _lib():
    lib = _build.load("int4_matmul")
    if lib.ptt_int4_matmul.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_int4_matmul.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                        i, i, vp]
        lib.ptt_int4_matmul.restype = i
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _int4_cuda(x, packed, scales, group: int):
    if x.dtype not in _DTYPES:
        raise ValueError(f"int4_matmul kernel takes float32/bfloat16 x; "
                         f"got {x.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise ValueError(f"int4_matmul kernel takes uint8 codes and f32 "
                         f"scales; got {packed.dtype}, {scales.dtype}")
    M, K = x.shape
    N = packed.shape[1]
    vec = 16 // x.element_size()
    if group % 16 or N % 16 or K % vec:
        raise ValueError(
            f"int4_matmul kernel needs group % 16 == 0 (16-deep tensor-core "
            f"steps), N % 16 == 0 and K % {vec} == 0 (16-byte loads); got "
            f"group {group}, K {K}, N {N}")
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"int4_matmul kernel: {name} must be "
                             f"contiguous, 16-byte aligned, on {x.device}")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    plan = int4_plan(K, N, group) if M <= _DECODE_ROWS else (0, 0, 0)
    lib = _lib()
    args = (x.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
            M, K, N, group, *plan, _DTYPES[x.dtype])
    # switch devices only when x is not on the current one
    with contextlib.nullcontext() \
            if x.device.index == torch.cuda.current_device() \
            else torch.cuda.device(x.device):
        err = lib.ptt_int4_matmul(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"int4_matmul kernel launch failed: CUDA error {err} "
            f"({lib.ptt_cuda_error_string(err).decode()})")
    return y


def int4_matmul(x, packed, scales, group: int = 128):
    """``x [M, K] @ dequant(packed [K/2, N] uint8, scales [K // group, N]
    f32)``, output in x's dtype (see the module docstring)."""
    _check(x, packed, scales, group)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, group)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul takes CPU or CUDA tensors; got "
                         f"{x.device}")
    y = _int4_cuda(x, packed, scales, group)
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0

