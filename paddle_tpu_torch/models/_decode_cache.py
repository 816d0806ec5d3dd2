"""Fixed-buffer and paged KV-cache attention for serving decode.

Counterpart of ``paddle_tpu/models/_decode_cache.py``. ``check_cache_pos``
and ``cache_attend`` (:73-161) write the new k/v block into the fixed
``[B, Tmax, KV, D]`` buffers at the write position and attend over the
causally masked full buffer. The position ``p`` is a scalar (the whole
batch at one position: ``generate()``) or a per-row ``[B]`` tensor
(every row at its own position: the serving slot pool). ``wlen``
(``[B]``) gates which incoming tokens write (the speculative-verify
contract, see the reference module's docstring); the gated write reads
nothing back to the host (``_write_gated``).

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

``paged_cache_attend`` is the page-table flavour (reference :164-252):
k/v live in a shared pool of fixed-size pages ``[num_pages, page, KV,
D]`` and each row carries a ``[B, pages_per_seq]`` page table. Writes
scatter through the table, in place (flat position ``f`` lands in page
``table[b, f // page]`` at offset ``f % page``; writes past the table,
the extend's bucket padding, and the verify's writes past ``wlen`` land
in the reserved trash page 0; a ``PageTable`` computes those indices
once for all layers); reads
gather the row's pages into a ``[B, pages_per_seq * page, KV, D]`` view
and run ``_masked_attend``, the very code of ``cache_attend``'s einsum
branch, so the non-quantized paged decode gives the contiguous pool's
bits. Optional int8 storage keeps int8 pools with f32 scales per (page
slot, position, kv-head) and dequantizes inside the attend.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.flash_attention import (NEG_INF, flash_attention_fwd,
                                   kernel_takes_head_dim)
from ..ops.fused_adamw import INV127

__all__ = ["PageTable", "cache_attend", "check_cache_pos",
           "paged_cache_attend", "per_position", "quantize_kv_page"]


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


def per_position(fn, x, on: bool = True):
    """``fn`` over each position's ``[B, 1, ...]`` slice of ``x``, made
    contiguous as the k=1 decode hands it over, the results concatenated
    along dim 1 (``fn(x)`` when not ``on``). The speculative verify runs
    its norms, linears and LM head this way: a GEMM library may pick
    another kernel for the verify's M = B * t rows than for the decode's
    M = B, and sum in another order (on the H100, Llama-1B's down_proj
    at M = 64 against 16), so a [B, t] verify would not give the k=1
    decode's bits at each position. Elementwise ops and the cache
    attention keep their bits across t and run on the whole block."""
    if not on or x.shape[1] == 1:
        return fn(x)
    return torch.cat([fn(x[:, j:j + 1].contiguous())
                      for j in range(x.shape[1])], dim=1)


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
            _write_gated(kc, vc, kr, v, p, idx, bidx, wlen)
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
    return _masked_attend(qr, kc, vc, maskx), kc, vc


def _write_gated(kc, vc, kr, v, p, idx, bidx, wlen) -> None:
    """The verify's gated write without a host sync: token ``j`` of row
    ``b`` lands at ``p[b] + j`` only when ``j < wlen[b]`` and the
    position is in the buffer; every other position keeps what it
    holds, as the reference's ``mode="drop"`` scatter leaves it. Lane
    ``j`` writes position ``w = min(p[b] + j, Tmax - 1)`` with token
    ``w - p[b]`` when that token is below ``wlen[b]``, else with the
    buffer's own value, so lanes clamped onto one position all write
    the same value and the scatter's order cannot matter. (Indexing
    with a boolean mask would read the mask back to the host, once a
    layer.)"""
    Tmax = kc.shape[1]
    wl = torch.as_tensor(wlen, device=kc.device).long()
    widx = idx.clamp(max=Tmax - 1)
    src = (widx - p[:, None]).clamp(min=0)                    # [B, t]
    ok = (src < wl[:, None])[..., None, None]
    for buf, x in ((kc, kr), (vc, v)):
        took = x.gather(1, src[..., None, None].expand(-1, -1,
                                                       *x.shape[2:]))
        buf[bidx, widx] = torch.where(ok, took.to(buf.dtype),
                                      buf[bidx, widx])


def _masked_attend(qr, kc, vc, maskx):
    """The masked einsum attention both cache flavours share: qr [B, t,
    H, D] against kc/vc [B, Tmax, KV, D] under ``maskx`` (broadcast to
    [B, KV, rep, t, Tmax]); scores in f32, probs cast to ``vc``'s dtype
    before the value einsum. Returns [B, t, H*D] in ``vc``'s dtype."""
    b, t, h, D = qr.shape
    kv = kc.shape[2]
    qg = qr.reshape(b, t, kv, h // kv, D)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          kc.float()) / (D ** 0.5)
    scores = scores.masked_fill(~maskx, NEG_INF)
    # cast back to the CACHE dtype (the model dtype), not qr's: RoPE's
    # f32 tables promote a bf16 q to f32
    probs = torch.softmax(scores, dim=-1).to(vc.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, vc)
    return out.reshape(b, t, h * D)


def quantize_kv_page(x):
    """Symmetric int8 quantization of a k/v block ``[..., KV, D]``: per
    (position, kv-head) absmax over head_dim. Returns (int8 values, f32
    scales ``[..., KV]``). The scale is ``amax * f32(1/127)``, the
    product XLA compiles the reference's ``amax / 127.0`` into; the floor
    keeps all-zero rows (never-written page tails) from dividing by
    zero."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax * torch.full_like(amax, INV127), 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant(pool_rows, scale_rows):
    return pool_rows.float() * scale_rows[..., None]


class PageTable:
    """A ``[B, pages_per_seq]`` page table on the device and the indices
    every layer's attend derives from it for one write position ``p``
    and block length ``t``: the flat write slot of each new token and
    the causal mask. The engine builds one per model call; the first
    layer computes the indices and the others reuse them, so their host
    cost is paid once a call, not once a layer."""

    def __init__(self, table: torch.Tensor):
        self.table = table.long()
        self.flat = self.table.reshape(-1)
        self.shape = self.table.shape
        self._memo = None

    def indices(self, p, t: int, page: int, wlen=None):
        """(flat write slots [B*t], mask [B, 1, 1, t, Tmax]) for tokens
        at ``p .. p + t - 1`` (``p`` an int or a [B] tensor). A write past
        the table (the extend's bucket padding) goes to trash page 0 at
        offset 0, never to a real page at a clamped offset; so does the
        write of token ``j >= wlen[b]`` of row ``b`` when ``wlen`` (the
        verify's [B] write lengths) is given."""
        memo = self._memo
        if memo is not None and memo[1] == t and memo[3] is wlen and (
                memo[0] is p or (
                    isinstance(p, int) and isinstance(memo[0], int)
                    and memo[0] == p)):
            return memo[2]
        b, npg = self.shape
        Tmax = npg * page
        dev = self.table.device
        steps = torch.arange(t, device=dev)
        if isinstance(p, torch.Tensor) and p.dim() >= 1:
            qpos = p.to(dev).long()[:, None] + steps[None, :]     # [B, t]
        else:
            qpos = (steps + int(p))[None, :].expand(b, t)
        pidx = torch.clamp(qpos // page, max=npg - 1)
        slot = torch.gather(self.table, 1, pidx) * page + qpos % page
        ok = qpos < Tmax
        if wlen is not None:
            wl = torch.as_tensor(wlen, device=dev).long()
            ok = ok & (steps[None, :] < wl[:, None])
        slot = torch.where(ok, slot, torch.zeros_like(slot))
        mask = torch.arange(Tmax, device=dev)[None, None, :] \
            <= qpos[:, :, None]                                 # [B, t, Tmax]
        out = (slot.reshape(-1), mask[:, None, None])
        self._memo = (p, t, out, wlen)
        return out


def paged_cache_attend(qr, kr, v, kp, vp, ks, vs, table, p, out_dtype,
                       wlen=None):
    """Masked paged-pool cache attention (see module docstring).

    qr: [B, t, H, D] position-encoded queries; kr/v: [B, t, KV, D] new
    keys/values; kp/vp: [num_pages, page, KV, D] pools, written in place
    (int8 when the scales ks/vs [num_pages, page, KV] f32 are given, else
    the model dtype); table: a [B, pages_per_seq] integer page table on
    the pools' device, or a ``PageTable`` shared by the layers of one
    model call (rows of inactive lanes point at trash page 0); p: write
    position, an int or a [B] tensor. ``wlen`` ([B], the speculative
    verify's write lengths): only the first ``wlen[b]`` incoming tokens
    of row ``b`` write; the rest land in trash page 0, as in the
    reference; None = every token writes.

    Returns (out [B, t, H*D] in ``out_dtype``, kp, vp, ks, vs).
    """
    b, t, h, D = qr.shape
    page = kp.shape[1]
    if not isinstance(table, PageTable):
        table = PageTable(table)
    Tmax = table.shape[1] * page
    slot, maskx = table.indices(p, t, page, wlen)

    def write(pool, x):
        pool.view(-1, *pool.shape[2:]).index_copy_(
            0, slot, x.reshape(b * t, *x.shape[2:]).to(pool.dtype))

    # the row's pages as one contiguous view: with npg * page == Tmax of
    # the contiguous pool, the same values at the same positions
    def gather(pool):
        return pool.index_select(0, table.flat).view(b, Tmax,
                                                     *pool.shape[2:])
    if ks is not None:
        kq, ksc = quantize_kv_page(kr)
        vq, vsc = quantize_kv_page(v)
        for pool, x in ((kp, kq), (vp, vq), (ks, ksc), (vs, vsc)):
            write(pool, x)
        kc = _dequant(gather(kp), gather(ks))
        vc = _dequant(gather(vp), gather(vs)).to(out_dtype)
    else:
        write(kp, kr)
        write(vp, v)
        # the non-shared token-identity contract: cache_attend's own
        # probs dtype and value einsum
        kc, vc = gather(kp), gather(vp)
    out = _masked_attend(qr, kc, vc, maskx)
    return out.to(out_dtype), kp, vp, ks, vs
