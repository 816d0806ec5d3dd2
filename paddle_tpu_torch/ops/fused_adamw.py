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

``fused_adamw_update_leaves`` updates a list of leaves (each with its
own ``leaf_id``) in one kernel launch per combination of p, g and m/v
dtypes: the GPT trainer's bf16 recipe is one launch a step. Each leaf
gets exactly the bits ``fused_adamw_update`` gives it alone, which is
that launch with a list of one. ``AdamWLeaves`` is the same launch for
a caller that updates the same leaves every step (the GPT trainer): it
lays out their part of the kernel's leaf table once.

``fused_adamw_update8`` is the int8-moment variant (``fused_adamw.py``
:203, the Pallas kernel ``_kernel8`` :115; ``csrc/fused_adamw8.cu``):
m and sqrt(v) stored as int8 codes with per-row f32 scales, dequantized,
updated as above, then requantized per row with stochastic rounding
(m codes in [-127, 127], sqrt(v) codes in [0, 127]). Its streams share
the key above and differ in the counter's third word: 0 for p (so p's
bits equal ``fused_adamw_update``'s for the same step and leaf), 1 for
m, 2 for sqrt(v). Like row 14 it takes a list of leaves in one launch
per (p, g) dtype pair (``fused_adamw_update8_leaves``; the per-leaf
entry is a list of one), and the GPT trainer keeps an ``AdamW8Leaves``
table. ``moment8_eligible``, ``moment8_init`` and ``moment8_unpack``
are the reference's (:173, :182, :192), so the leaves with int8 moments
and their state are the same in both packages.

``fused_adamw_update_leaves.launches`` (row 14's kernel, whichever
entry called it) and ``fused_adamw_update8.launches`` (row 13's, the
same) count kernel launches.
"""
from __future__ import annotations

import ctypes
import operator

import numpy as np
import torch

from . import _build

__all__ = ["INV127", "AdamW8Leaves", "AdamWLeaves", "fused_adamw_update",
           "fused_adamw_update8", "fused_adamw_update8_leaves",
           "fused_adamw_update8_plain", "fused_adamw_update_leaves",
           "fused_adamw_update_plain", "moment8_eligible",
           "moment8_init", "moment8_unpack", "philox_words",
           "stochastic_round_bf16", "uniform01"]

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


def philox_words(n: int, key: int, device, key_hi: int = 0,
                 stream: int = 0) -> torch.Tensor:
    """The ``n`` 32-bit words (in int64) that the kernels draw for flat
    elements ``0..n-1``: Philox4x32-10 with key ``(key, key_hi)`` and
    counter ``(e // 4 low, e // 4 high, stream, 0)``, word ``e % 4``
    (``csrc/philox.cuh``)."""
    grp = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = grp & _MASK, grp >> 32
    c2 = torch.full_like(grp, stream & _MASK)
    c3 = torch.zeros_like(grp)
    k0, k1 = key & _MASK, key_hi & _MASK
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


# f32(1/127): XLA compiles the reference's per-row and per-column
# `where(amax == 0, 1, amax) / 127` into a product with it
INV127 = float(np.float32(1 / 127))


def uniform01(words: torch.Tensor) -> torch.Tensor:
    """The reference kernels' uniform in [0, 1) from 32-bit words (int64):
    ``bitcast(0x3F800000 | bits >> 9) - 1`` (``csrc/philox.cuh``)."""
    return ((words >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


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


def _check_leaf(p, g, m, v, stoch_round, device):
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
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"fused_adamw kernel needs {name} contiguous "
                             f"on {device}")


def _upload(host: np.ndarray, device) -> torch.Tensor:
    """A kernel's leaf table on ``device``, copied from pinned memory so
    that the copy is asynchronous; the caching host allocator keeps the
    buffer until the copy has run."""
    return torch.from_numpy(host).pin_memory().to(device, non_blocking=True)


def _check_scalars(scalars, device) -> None:
    if scalars.dtype != torch.float32 or scalars.numel() != 4 \
            or scalars.device != device or not scalars.is_contiguous():
        raise ValueError("scalars must be 4 contiguous float32 values on "
                         "p's device")


def _parts(moment) -> tuple:
    """A moment's tensors: the tensor, or an int8 moment's (codes,
    scales)."""
    return tuple(moment) if isinstance(moment, (tuple, list)) else (moment,)


class _LeafTable:
    """What the AdamW kernels' kept leaf tables share (``AdamWLeaves``,
    row 14, and ``AdamW8Leaves``, row 13): a fixed list of leaves
    ``(ps[i], ms[i], vs[i])`` with SR streams ``leaf_ids[i]``, all on the
    CPU or all on CUDA; the addresses the table was laid out at
    (``holds``); and ``update``, which runs the plain version leaf by leaf
    on the CPU and the subclass's launch on CUDA (``_lay_out`` once,
    ``_update_cuda`` a step)."""

    def __init__(self, ps, ms, vs, leaf_ids):
        name = type(self).__name__
        lists = (ps, ms, vs, leaf_ids)
        if len({len(t) for t in lists}) != 1:
            raise ValueError(f"{name} takes lists of one length; got "
                             f"{[len(t) for t in lists]}")
        self._ps, self._ms, self._vs = list(ps), list(ms), list(vs)
        self._ids = [int(i) for i in leaf_ids]
        self._tensors = self._flat(ps, ms, vs)
        self._ptrs = [t.data_ptr() for t in self._tensors]
        devices = {t.device.type for t in self._tensors}
        if len(devices) > 1 or not devices <= {"cpu", "cuda"}:
            raise ValueError(f"{name} takes tensors all on the CPU or all "
                             f"on CUDA; got {sorted(devices)}")
        self._cuda = devices == {"cuda"}
        if self._cuda:
            self._device = ps[0].device
            self._live = [i for i, p in enumerate(ps) if p.numel()]
            self._leaf_ids = np.array([self._ids[i] for i in self._live],
                                      np.int64)
            self._f32_p = any(ps[i].dtype != torch.bfloat16
                              for i in self._live)
            self._lay_out()

    @staticmethod
    def _flat(ps, ms, vs) -> list:
        return [t for p, m, v in zip(ps, ms, vs)
                for t in (p, *_parts(m), *_parts(v))]

    def holds(self, ps, ms, vs) -> bool:
        """Whether this table was built for these very tensors, each
        still at the address the table holds (``p.data = ...`` moves
        it): one walk over the lists."""
        flat = self._flat(ps, ms, vs)
        return len(ps) == len(self._ps) \
            and len(flat) == len(self._tensors) \
            and all(map(operator.is_, flat, self._tensors)) \
            and [t.data_ptr() for t in flat] == self._ptrs

    def update(self, gs, scalars, *, lr: float, wd: float, b1: float,
               b2: float, eps: float = 1e-8, stoch_round: bool = False,
               seed: int = 0) -> None:
        """One AdamW step of every leaf with gradients ``gs`` (in the
        leaves' order). ``scalars``: f32 tensor ``[clip scale,
        1/(1-b1^t), 1/(1-b2^t), lr multiplier]`` on the leaves' device."""
        if len(gs) != len(self._ps):
            raise ValueError(f"{type(self).__name__} holds {len(self._ps)} "
                             f"leaves; got {len(gs)} gradients")
        if not gs:
            return
        args = dict(lr=lr, wd=wd, b1=b1, b2=b2, eps=eps,
                    stoch_round=stoch_round, seed=seed)
        if self._cuda:
            _check_scalars(scalars, self._device)
            if stoch_round and self._f32_p:
                raise ValueError("stochastic rounding writes a bfloat16 p; "
                                 "got a float32 p")
            self._update_cuda(gs, scalars, **args)
            return
        devices = {t.device.type for t in (*gs, scalars)}
        if devices != {"cpu"}:
            raise ValueError(f"fused_adamw takes tensors all on the CPU or "
                             f"all on CUDA; got {sorted(devices | {'cpu'})}")
        for p, g, m, v, leaf_id in zip(self._ps, gs, self._ms, self._vs,
                                       self._ids):
            self._plain(p, g, m, v, scalars, leaf_id=leaf_id, **args)

    def _keys(self, seed: int) -> np.ndarray:
        """The step's Philox key of each leaf laid out."""
        return ((int(seed) & _MASK) + self._leaf_ids * 1000003) & _MASK


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ptt_cuda_error_string(err).decode()})")


def _bind(lib):
    fn = lib.ptt_fused_adamw_leaves
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, i, ctypes.c_longlong, vp, i, i, i,
                       f, f, f, f, f, f, f, i, vp]
        fn.restype = i
        lib.ptt_fused_adamw_chunk.argtypes = []
        lib.ptt_fused_adamw_chunk.restype = ctypes.c_longlong
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return fn


class AdamWLeaves(_LeafTable):
    """Row 14 for a fixed list of leaves ``(ps[i], ms[i], vs[i])`` with
    SR streams ``leaf_ids[i]``: p, m and v are checked, and their part
    of the kernel's leaf table laid out, once. Each ``update(gs,
    scalars, **hp)`` checks the gradients, writes their addresses and
    the step's Philox keys into the table and launches, exactly as
    ``fused_adamw_update_leaves`` (which builds one a call) does. The
    table holds the addresses of p, m and v: keep them (update in place)
    while it is in use; ``holds`` says whether it was built for given
    tensors at their present addresses. On the CPU ``update`` runs the
    plain version leaf by leaf.

    The leaf table (``csrc/fused_adamw.cu``), int64 words: ``begin[0..L]``
    (each leaf's first chunk; ``begin[L]`` is the grid), then 8 words a
    leaf: the p, g, m, v addresses, the element count, the Philox key,
    two zeros; one table and one launch for each combination of p, g and
    m/v dtypes, with the leaves of no elements left out."""

    _plain = staticmethod(fused_adamw_update_plain)

    def _lay_out(self):
        for p, m, v in zip(self._ps, self._ms, self._vs):
            _check_leaf(p, p, m, v, False, self._device)
        live = [(self._ps[i], self._ms[i], self._vs[i]) for i in self._live]
        self._shapes = [p.shape for p, _, _ in live]
        self._sizes = np.array([p.numel() for p, _, _ in live], np.int64)
        self._entries = np.zeros((len(live), 8), dtype=np.int64)
        if live:
            self._entries[:, [0, 2, 3]] = [[t.data_ptr() for t in leaf]
                                           for leaf in live]
        self._entries[:, 4] = self._sizes
        # dtype combination: 4 * p + 2 * g + m/v (g's added per update)
        self._pm = np.array([4 * _DTYPES[p.dtype] + _DTYPES[m.dtype]
                             for p, m, _ in live], np.int64)

    def _update_cuda(self, gs, scalars, lr, wd, b1, b2, eps, stoch_round,
                     seed):
        device = self._device
        live = [gs[i] for i in self._live]
        g_codes = [_DTYPES.get(g.dtype, -1) for g in live]
        if -1 in g_codes or [g.shape for g in live] != self._shapes or \
                not all(g.is_contiguous() and g.device == device
                        for g in live):
            for leaf in zip(self._ps, gs, self._ms, self._vs):
                _check_leaf(*leaf, stoch_round, device)
            raise ValueError("fused_adamw: a leaf's shape changed since "
                             "its AdamWLeaves was built")
        if not live:
            return
        entries = self._entries.copy()
        entries[:, 1] = [g.data_ptr() for g in live]
        entries[:, 5] = self._keys(seed)
        combos = self._pm + 2 * np.array(g_codes, np.int64)
        lib = _build.load("fused_adamw")
        fn = _bind(lib)
        chunk = lib.ptt_fused_adamw_chunk()
        chunks = (self._sizes + chunk - 1) // chunk
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for combo in np.unique(combos):
                rows = np.flatnonzero(combos == combo)
                begin = np.zeros(len(rows) + 1, dtype=np.int64)
                np.cumsum(chunks[rows], out=begin[1:])
                table = _upload(np.concatenate(
                    [begin, entries[rows].reshape(-1)]), device)
                _raise_on(fn(table.data_ptr(), len(rows), int(begin[-1]),
                             scalars.data_ptr(), int(combo) >> 2,
                             (int(combo) >> 1) & 1, int(combo) & 1, lr, wd,
                             b1, 1 - b1, b2, 1 - b2, eps, int(stoch_round),
                             stream), lib, "fused_adamw")
                fused_adamw_update_leaves.launches += 1


def fused_adamw_update_leaves(ps, gs, ms, vs, scalars, leaf_ids, *,
                              lr: float, wd: float, b1: float, b2: float,
                              eps: float = 1e-8, stoch_round: bool = False,
                              seed: int = 0) -> None:
    """One-pass AdamW on a list of leaves, in place: leaf ``i`` is
    ``(ps[i], gs[i], ms[i], vs[i])`` with SR stream ``leaf_ids[i]``, each
    updated exactly as ``fused_adamw_update`` would update it alone.

    ``scalars``: f32 tensor ``[clip scale, 1/(1-b1^t), 1/(1-b2^t), lr
    multiplier]`` on the leaves' device, shared by every leaf. CPU
    tensors take the plain version leaf by leaf; CUDA tensors one kernel
    launch for each combination of p, g and m/v dtypes in the list. A
    caller that updates the same leaves every step keeps an
    ``AdamWLeaves`` instead, which lays out their table once."""
    if len({len(t) for t in (ps, gs, ms, vs, leaf_ids)}) != 1:
        raise ValueError(f"fused_adamw_update_leaves takes lists of one "
                         f"length; got {[len(t) for t in (ps, gs, ms, vs)]}"
                         f" and {len(leaf_ids)} leaf ids")
    AdamWLeaves(ps, ms, vs, leaf_ids).update(
        gs, scalars, lr=lr, wd=wd, b1=b1, b2=b2, eps=eps,
        stoch_round=stoch_round, seed=seed)


fused_adamw_update_leaves.launches = 0


def fused_adamw_update(p, g, m, v, scalars, *, lr: float, wd: float,
                       b1: float, b2: float, eps: float = 1e-8,
                       stoch_round: bool = False, leaf_id: int = 0,
                       seed: int = 0):
    """One-pass AdamW on one leaf, in place; returns ``(p, m, v)``.

    ``scalars``: f32 tensor ``[clip scale, 1/(1-b1^t), 1/(1-b2^t), lr
    multiplier]`` on ``p``'s device (no host sync). ``seed`` (the step)
    and ``leaf_id`` pick the SR stream. CPU tensors take the plain
    version, CUDA tensors the kernel (``fused_adamw_update_leaves`` with
    a list of one)."""
    fused_adamw_update_leaves([p], [g], [m], [v], scalars, [leaf_id], lr=lr,
                              wd=wd, b1=b1, b2=b2, eps=eps,
                              stoch_round=stoch_round, seed=seed)
    return p, m, v


# -- int8 moments ------------------------------------------------------------
def _tile(n: int, candidates):
    for c in candidates:
        if n % c == 0:
            return c
    return None


def _row_block(R: int, C: int):
    """The reference's full-row block (``fused_adamw.py:165``)."""
    for br in (512, 256, 128, 64, 32, 16, 8):
        if R % br == 0 and br * C <= (1 << 18):
            return br
    return None


def moment8_eligible(p) -> bool:
    """The leaves that keep int8 moments, exactly the reference's rule
    (``fused_adamw_eligible`` :84 and a full-row block that fits
    ``_row_block``): at least 2-D and 65536 elements, the last dim a
    multiple of 128 and the rest a multiple of 8. ``p``: a tensor or a
    shape."""
    shape = tuple(p.shape) if hasattr(p, "shape") else tuple(p)
    size = 1
    for d in shape:
        size *= d
    if len(shape) < 2 or size < (1 << 16):
        return False
    C = shape[-1]
    R = size // C
    return C % 128 == 0 and R % 8 == 0 \
        and _tile(C, (2048, 1024, 512, 384, 256, 128)) is not None \
        and _tile(R, (512, 256, 128, 64, 32, 16, 8)) is not None \
        and _row_block(R, C) is not None


def moment8_init(p):
    """Zero int8-moment state for one eligible leaf: ``(m_q, m_scale,
    v_q, v_scale)``, ``[R, C]`` int8 and per-row ``[R, 1]`` f32 (1/127),
    on ``p``'s device."""
    C = p.shape[-1]
    R = p.numel() // C

    def zeros():
        return torch.zeros((R, C), dtype=torch.int8, device=p.device)

    def scale():
        return torch.full((R, 1), 1.0 / 127.0, dtype=torch.float32,
                          device=p.device)
    return zeros(), scale(), zeros(), scale()


def moment8_unpack(mq, msc, vq, vsc, shape):
    """Dequantize int8 moment state to f32 ``(m, v)`` of ``shape``."""
    m = (mq.float() * msc).reshape(shape)
    s = (vq.float() * vsc).reshape(shape)
    return m, (s * s).reshape(shape)


def fused_adamw_update8_plain(p, g, mq, msc, vq, vsc, scalars, *,
                              lr: float, wd: float, b1: float, b2: float,
                              eps: float = 1e-8, stoch_round: bool = False,
                              leaf_id: int = 0, seed: int = 0):
    """The int8-moment kernel's function in plain PyTorch, in place: the
    same f32 operations in the kernel's order. Returns ``(p, m_q,
    m_scale, v_q, v_scale)``."""
    R, C = mq.shape
    scale, inv_bc1, inv_bc2, lr_mult = scalars.float().unbind()
    lr_t = lr_mult * lr
    decay = 1 - lr_t * wd
    gs = g.float().reshape(R, C) * scale
    m = mq.float() * msc
    vsq = vq.float() * vsc
    v = vsq * vsq
    m2 = m * b1 + gs * (1 - b1)
    v2 = v * b2 + gs * (1 - b2) * gs
    num = m2 * inv_bc1 * lr_t
    den = torch.sqrt(v2 * inv_bc2) + eps
    p2 = p.float().reshape(R, C) * decay - num / den
    key = _key(seed, leaf_id)
    if stoch_round:
        p.copy_(stochastic_round_bf16(
            p2, philox_words(p2.numel(), key, p2.device)).reshape(p.shape))
    else:
        p.copy_(p2.reshape(p.shape))
    s2 = torch.sqrt(v2)
    for x, q, sc, lo, stream in ((m2, mq, msc, -127, 1),
                                 (s2, vq, vsc, 0, 2)):
        amax = (x.abs() if lo else x).amax(dim=1, keepdim=True)
        new = torch.where(amax == 0, torch.ones_like(amax), amax) \
            * torch.full_like(amax, INV127)
        u = uniform01(philox_words(x.numel(), key, x.device,
                                   stream=stream)).view(R, C)
        q.copy_(torch.clamp(torch.floor(x / new + u), lo, 127))
        sc.copy_(new)
    return p, mq, msc, vq, vsc


def _check_leaf8(p, mq, msc, vq, vsc, device) -> None:
    """A leaf as row 13's kernel takes it: float32/bfloat16 p ``[..., C]``
    with C % 8 == 0, int8 codes ``[R, C]`` and f32 scales ``[R, 1]``, all
    contiguous on ``device``; p 16-byte aligned, the codes 8-byte aligned
    (a thread step is 8 elements: 16 bytes of bf16 p, 8 of each code
    array)."""
    R, C = mq.shape if mq.dim() == 2 else (0, 0)
    ok = (p.dtype in _DTYPES and mq.dtype == vq.dtype == torch.int8
          and msc.dtype == vsc.dtype == torch.float32
          and mq.dim() == 2 and vq.shape == mq.shape
          and msc.shape == vsc.shape == (R, 1)
          and p.dim() >= 1 and p.numel() == R * C and p.shape[-1] == C)
    if not ok:
        raise ValueError(
            f"fused_adamw8 kernel takes a float32/bfloat16 p [..., C], int8 "
            f"codes [R, C] and f32 scales [R, 1]; got p {p.dtype}"
            f"{tuple(p.shape)}, m_q {mq.dtype}{tuple(mq.shape)}, m_scale "
            f"{msc.dtype}{tuple(msc.shape)}, v_q {vq.dtype}{tuple(vq.shape)}"
            f", v_scale {vsc.dtype}{tuple(vsc.shape)}")
    if C % 8:
        raise ValueError(f"fused_adamw8 kernel steps 8 elements of a row: "
                         f"C % 8 == 0; got C={C}")
    for name, t, align in (("p", p, 16), ("m_q", mq, 8), ("m_scale", msc, 4),
                           ("v_q", vq, 8), ("v_scale", vsc, 4)):
        if not t.is_contiguous() or t.device != device or t.data_ptr() % align:
            raise ValueError(f"fused_adamw8 kernel needs {name} contiguous "
                             f"on {device}, its base {align}-byte aligned")


def _lib8():
    lib = _build.load("fused_adamw8")
    fn = lib.ptt_fused_adamw8_leaves
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, i, ctypes.c_longlong, vp, i, i, f, f, f, f, f, f,
                       f, i, vp]
        fn.restype = i
        lib.ptt_fused_adamw8_block_elements.argtypes = []
        lib.ptt_fused_adamw8_block_elements.restype = ctypes.c_longlong
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _rows_per_block(C: int, block: int) -> int:
    """Rows of width C a block of row 13's kernel takes: its ``block``
    elements (``ptt_fused_adamw8_block_elements``, whole block steps of
    2048) when C is a multiple of 2048 that divides them, else one
    row."""
    return block // C if C % 2048 == 0 and block % C == 0 else 1


class AdamW8Leaves(_LeafTable):
    """Row 13 for a fixed list of leaves ``(ps[i], ms[i], vs[i])`` with SR
    streams ``leaf_ids[i]``, where ``ms[i]`` is ``(m_q, m_scale)`` and
    ``vs[i]`` is ``(v_q, v_scale)`` (``moment8_init``): the leaves are
    checked, and their part of the kernel's leaf table laid out, once.
    Each ``update(gs, scalars, **hp)`` checks the gradients, writes their
    addresses and the step's Philox keys into the table and launches once
    for each (p, g) dtype pair, exactly as ``fused_adamw_update8_leaves``
    (which builds one a call) does. Like ``AdamWLeaves`` it holds
    addresses: ``holds`` says whether it was built for given tensors at
    their present addresses. On the CPU ``update`` runs the plain version
    leaf by leaf.

    The leaf table (``csrc/fused_adamw8.cu``), int64 words:
    ``begin[0..L]`` (each leaf's first block; ``begin[L]`` is the grid),
    then 10 words a leaf: the p, g, m code, m scale, v code and v scale
    addresses, R, C, the rows a block takes (``_rows_per_block``), the
    Philox key; the leaves of no elements left out."""

    @staticmethod
    def _plain(p, g, m, v, scalars, **kw):
        fused_adamw_update8_plain(p, g, *m, *v, scalars, **kw)

    def _lay_out(self):
        for p, m, v in zip(self._ps, self._ms, self._vs):
            _check_leaf8(p, *m, *v, self._device)
        self._shapes = [self._ps[i].shape for i in self._live]
        self._entries = np.zeros((len(self._live), 10), dtype=np.int64)
        block = _lib8().ptt_fused_adamw8_block_elements()
        for row, i in enumerate(self._live):
            R, C = self._ms[i][0].shape
            self._entries[row, [0, 2, 3, 4, 5]] = [
                t.data_ptr()
                for t in (self._ps[i], *self._ms[i], *self._vs[i])]
            self._entries[row, 6:9] = R, C, _rows_per_block(C, block)
        # a block a group of rows: begin[] counts blocks
        self._blocks = -(-self._entries[:, 6] // self._entries[:, 8])
        self._p_codes = np.array(
            [_DTYPES[self._ps[i].dtype] for i in self._live], np.int64)

    def _update_cuda(self, gs, scalars, lr, wd, b1, b2, eps, stoch_round,
                     seed):
        device = self._device
        live = [gs[i] for i in self._live]
        g_codes = [_DTYPES.get(g.dtype, -1) for g in live]
        if -1 in g_codes or [g.shape for g in live] != self._shapes or \
                not all(g.is_contiguous() and g.device == device
                        and g.data_ptr() % 16 == 0 for g in live):
            got = [(g.dtype, tuple(g.shape)) for g in gs]
            raise ValueError(
                f"fused_adamw8 kernel takes float32/bfloat16 gradients of "
                f"their leaves' shapes, contiguous on {device} with 16-byte "
                f"aligned bases; got {got}")
        if not live:
            return
        entries = self._entries.copy()
        entries[:, 1] = [g.data_ptr() for g in live]
        entries[:, 9] = self._keys(seed)
        combos = 2 * self._p_codes + np.array(g_codes, np.int64)
        lib = _lib8()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for combo in np.unique(combos):
                sel = np.flatnonzero(combos == combo)
                begin = np.zeros(len(sel) + 1, dtype=np.int64)
                np.cumsum(self._blocks[sel], out=begin[1:])
                table = _upload(np.concatenate(
                    [begin, entries[sel].reshape(-1)]), device)
                _raise_on(lib.ptt_fused_adamw8_leaves(
                    table.data_ptr(), len(sel), int(begin[-1]),
                    scalars.data_ptr(), int(combo) >> 1, int(combo) & 1, lr,
                    wd, b1, 1 - b1, b2, 1 - b2, eps, int(stoch_round),
                    stream), lib, "fused_adamw8")
                fused_adamw_update8.launches += 1


def fused_adamw_update8_leaves(ps, gs, ms, vs, scalars, leaf_ids, *,
                               lr: float, wd: float, b1: float, b2: float,
                               eps: float = 1e-8, stoch_round: bool = False,
                               seed: int = 0) -> None:
    """One-pass AdamW with int8 moments on a list of leaves, in place:
    leaf ``i`` is ``(ps[i], gs[i], ms[i], vs[i])`` with ``ms[i] = (m_q,
    m_scale)``, ``vs[i] = (v_q, v_scale)`` and SR stream ``leaf_ids[i]``,
    each updated exactly as ``fused_adamw_update8`` would update it
    alone. CPU tensors take the plain version leaf by leaf; CUDA tensors
    one kernel launch for each (p, g) dtype pair in the list. A caller
    that updates the same leaves every step keeps an ``AdamW8Leaves``."""
    if len({len(t) for t in (ps, gs, ms, vs, leaf_ids)}) != 1:
        raise ValueError(f"fused_adamw_update8_leaves takes lists of one "
                         f"length; got {[len(t) for t in (ps, gs, ms, vs)]}"
                         f" and {len(leaf_ids)} leaf ids")
    AdamW8Leaves(ps, ms, vs, leaf_ids).update(
        gs, scalars, lr=lr, wd=wd, b1=b1, b2=b2, eps=eps,
        stoch_round=stoch_round, seed=seed)


def fused_adamw_update8(p, g, mq, msc, vq, vsc, scalars, *, lr: float,
                        wd: float, b1: float, b2: float, eps: float = 1e-8,
                        stoch_round: bool = False, leaf_id: int = 0,
                        seed: int = 0):
    """One-pass AdamW with int8 moment storage on one leaf, in place;
    returns ``(p, m_q, m_scale, v_q, v_scale)``. ``mq``/``vq`` ``[R, C]``
    int8 codes of m and sqrt(v), ``msc``/``vsc`` their ``[R, 1]`` f32
    scales (``moment8_init``); otherwise as ``fused_adamw_update``. CPU
    tensors take the plain version, CUDA tensors the kernel
    (``fused_adamw_update8_leaves`` with a list of one)."""
    fused_adamw_update8_leaves([p], [g], [(mq, msc)], [(vq, vsc)], scalars,
                               [leaf_id], lr=lr, wd=wd, b1=b1, b2=b2,
                               eps=eps, stoch_round=stoch_round, seed=seed)
    return p, mq, msc, vq, vsc


# row 13's launches, whichever entry made them
fused_adamw_update8.launches = 0
