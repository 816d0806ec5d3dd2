"""Llama model family (RMSNorm + RoPE + SwiGLU decoder) in PyTorch.

Counterpart of ``paddle_tpu/models/llama.py``: the same config, module
tree and parameter names (so ``models/convert.py`` maps the reference's
``state_dict()`` one to one), the same RoPE (half-split rotation, f32
tables) and the same attention flavours:

- uncached (``cache=None``): causal ``scaled_dot_product_attention``,
  which routes square causal attention to the flash-attention kernel on
  the card;
- dynamic cache (a 2-tuple ``(k, v)``, ``(None, None)`` to start):
  concat-grown keys/values, the numerics reference of ``generate()``;
- static cache (``(k_cache, v_cache, pos)`` or ``(..., pos, wlen)``):
  fixed ``[B, Tmax, KV, D]`` buffers written in place at a scalar or
  per-row position through ``_decode_cache.cache_attend`` — the
  serving engine's contiguous path;
- paged cache (``(k_pool, v_pool, k_scale, v_scale, page_table,
  pos)``, or ``(..., pos, wlen)``, the speculative verify's form):
  ``[num_pages, page, KV, D]`` pools written in place through a
  ``[B, pages_per_seq]`` page table by
  ``_decode_cache.paged_cache_attend`` (scales None: model-dtype pages;
  set: int8 pages with f32 scales) — the serving engine's paged path.

``positionwise=True`` (the serving engine's speculative verify) runs
the norms and linears of a ``[B, t]`` block one position at a time
(``_decode_cache.per_position``), so each position gets the bits of a
``[B, 1]`` decode step.

Not in this slice: ``use_tp`` (multi-GPU slice), which raises
``NotImplementedError``.

Numerics: ``Linear`` weights are ``[out, in]`` (PyTorch's layout; the
reference's are ``[in, out]``). As in the reference, RoPE's f32 tables
promote a 16-bit q/k to f32. Unlike the reference, whose uncached
bf16 forward then runs in f32 from the first attention on (an f32
attention output promotes ``o_proj`` and the residual), the port casts
each attention output back to the model dtype, so every path keeps the
model dtype between layers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as TF
from .._device import resolve_device, resolve_dtype
from ..nn.functional import scaled_dot_product_attention
from ..nn.layer.norm import RMSNorm
from ._decode_cache import (cache_attend, check_cache_pos,
                            paged_cache_attend, per_position)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "llama_tiny_config"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # GQA; None = MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self):
        return self.num_key_value_heads or self.num_attention_heads


def llama_tiny_config(**kw) -> LlamaConfig:
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("max_position_embeddings", 64)
    return LlamaConfig(**kw)


def _rope_cache(head_dim: int, max_len: int, theta: float):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv)                      # [T, D/2]
    return np.cos(freqs), np.sin(freqs)


def _apply_rope(x, cos, sin):
    """x [B, T, H, D]; rotate the half-split pairs (x1, x2).

    cos/sin are [T, D/2] (shared positions) or [B, T, D/2] (per-row
    positions — the serving slot-pool decode)."""
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2]
    x2 = x[..., d2:]
    if cos.dim() == 3:
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    else:
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class _Linear(nn.Linear):
    """Left as allocated: ``LlamaForCausalLM.reset_parameters`` draws
    the weights (the default init would only be overwritten)."""

    def reset_parameters(self) -> None:
        pass


class _Embedding(nn.Embedding):
    """Left as allocated, as ``_Linear``."""

    def reset_parameters(self) -> None:
        pass


def _linear(n_in, n_out, device, dtype):
    return _Linear(n_in, n_out, bias=False, device=device, dtype=dtype)


def _no_tp(use_tp: bool) -> None:
    if use_tp:
        raise NotImplementedError(
            "tensor-parallel Llama (use_tp) comes with the multi-GPU "
            "slice of the port")


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_tp: bool, rope_cache,
                 device=None, dtype=None):
        """``rope_cache``: the model's shared (cos, sin) f32 tables,
        [max_position_embeddings, head_dim / 2] on ``device``."""
        super().__init__()
        _no_tp(use_tp)
        self.cfg = cfg
        H, KV, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        self.q_proj = _linear(cfg.hidden_size, H * D, device, dtype)
        self.k_proj = _linear(cfg.hidden_size, KV * D, device, dtype)
        self.v_proj = _linear(cfg.hidden_size, KV * D, device, dtype)
        self.o_proj = _linear(H * D, cfg.hidden_size, device, dtype)
        self.register_buffer("_cos", rope_cache[0], persistent=False)
        self.register_buffer("_sin", rope_cache[1], persistent=False)

    def forward(self, x, attn_mask=None, cache=None,
                positionwise: bool = False):
        """cache: optional (k_cache, v_cache) [B, T_past, KV, D]; when
        given, ``x`` holds only the NEW tokens and the return is
        (out, (k_cache', v_cache')) — see the module docstring for the
        static-cache tuples and ``positionwise``."""
        cfg = self.cfg
        b, t, _ = x.shape
        static_cache = cache is not None and len(cache) in (3, 4, 6, 7)
        past = cache[0].shape[1] if cache is not None \
            and not static_cache and cache[0] is not None else 0
        if past + t > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {past + t} exceeds "
                f"max_position_embeddings={cfg.max_position_embeddings}")
        D = cfg.head_dim
        pw = positionwise and static_cache
        q = per_position(self.q_proj, x, pw).reshape(b, t, -1, D)
        k = per_position(self.k_proj, x, pw).reshape(b, t, -1, D)
        v = per_position(self.v_proj, x, pw).reshape(b, t, -1, D)
        h_local, kv_local = q.shape[2], k.shape[2]
        if static_cache:
            if attn_mask is not None:
                raise NotImplementedError(
                    "attn_mask with KV cache is not supported; pad-free "
                    "batches only in cached decoding")
            out, new_cache = self._forward_static_cache(x, q, k, v, cache)
            return per_position(self.o_proj, out, pw), new_cache
        cos, sin = self._cos[past:past + t], self._sin[past:past + t]
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        if cache is not None:
            if cache[0] is not None:   # (None, None) = empty prefill cache
                k = torch.cat([cache[0], k], dim=1)
                v = torch.cat([cache[1], v], dim=1)
            new_cache = (k, v)
        if kv_local != h_local:        # GQA: repeat kv heads
            rep = h_local // kv_local
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if cache is not None:
            if attn_mask is not None:
                raise NotImplementedError(
                    "attn_mask with KV cache is not supported; pad-free "
                    "batches only in cached decoding")
            # new queries attend all cached positions plus the causal
            # prefix of the new block (bottom-right triangle)
            attn = scaled_dot_product_attention(
                q, k, v, is_causal=True, training=self.training)
            return self.o_proj(attn.reshape(b, t, -1).to(x.dtype)), \
                new_cache
        if attn_mask is not None:
            # a decoder never attends forward, mask or not
            tri = torch.ones(t, t, dtype=torch.bool,
                             device=x.device).tril()
            causal = attn_mask.bool() & tri[None, None]
            attn = scaled_dot_product_attention(
                q, k, v, attn_mask=causal, training=self.training)
        else:
            attn = scaled_dot_product_attention(
                q, k, v, is_causal=True, training=self.training)
        return self.o_proj(attn.reshape(b, t, -1).to(x.dtype))

    def _forward_static_cache(self, x, q, k, v, cache):
        """Fixed-size cache attention: write the new k/v block at
        ``pos`` and attend over the masked full buffer. ``pos`` is an
        int (whole batch at one position — generate()) or a [b] vector
        of per-row positions (the continuous-batching slot pool). The
        4-tuple (k, v, pos, wlen) is the speculative-verify form; the
        6- and 7-tuples are the paged flavour (``_forward_paged``).
        Returns the attention output before ``o_proj`` and the new
        cache."""
        if len(cache) in (6, 7):
            return self._forward_paged(x, q, k, v, cache)
        t = q.shape[1]
        wlen = None
        if len(cache) == 4:
            k_cache, v_cache, pos, wlen = cache
        else:
            k_cache, v_cache, pos = cache
        # verify flavour: writes past the buffer are dropped, so only
        # the START position must be in range
        per_row = check_cache_pos(
            pos, 1 if wlen is not None else t, k_cache.shape[1])
        dev = x.device
        cos_full, sin_full = self._cos, self._sin
        p = torch.as_tensor(pos, device=dev).long() if per_row else pos
        if wlen is not None:
            # p + t may run past the rope table for rows near their cap:
            # gather per POSITION with a clip touching only the masked tail
            pb = p[:, None] if per_row else p
            idx = (pb + torch.arange(t, device=dev)[None]).clamp(
                0, cos_full.shape[0] - 1)
            cos, sin = cos_full[idx], sin_full[idx]         # [b, t, D/2]
        elif per_row:
            idx = p[:, None] + torch.arange(t, device=dev)[None]
            cos, sin = cos_full[idx], sin_full[idx]         # [b, t, D/2]
        else:
            cos, sin = cos_full[p:p + t], sin_full[p:p + t]
        qr, kr = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        out, kc2, vc2 = cache_attend(qr, kr, v, k_cache, v_cache, p,
                                     per_row, wlen=wlen)
        return out.to(x.dtype), (kc2, vc2, pos + t)

    def _forward_paged(self, x, q, k, v, cache):
        """Paged-pool cache attention (reference
        ``_forward_static_cache``'s 6- and 7-tuple flavours): cache =
        (k_pool, v_pool, k_scale, v_scale, page_table, pos[, wlen]) with
        [num_pages, page, KV, D] pools, None scales for model-dtype
        pages, and a [b, pages_per_seq] table (or a ``PageTable``, which
        the layers of one call share). ``pos`` is a [b] vector
        (the engine's decode and verify) or an int (the shared-prefix
        extend); ``wlen`` ([b], the verify) gates which tokens write."""
        kp, vp, ksc, vsc, table, pos = cache[:6]
        wlen = cache[6] if len(cache) == 7 else None
        t = q.shape[1]
        # only the START position must be in range: the extend's bucket
        # padding may overshoot the table and is sent to the trash page
        per_row = check_cache_pos(pos, 1, table.shape[1] * kp.shape[1])
        dev = x.device
        steps = torch.arange(t, device=dev)
        if per_row:
            p = torch.as_tensor(pos, device=dev).long()
            # the verify's p + t may run past the rope table for rows
            # near their cap: the clip touches only the gated tail
            idx = (p[:, None] + steps[None]).clamp(
                max=self._cos.shape[0] - 1)                 # [b, t]
        else:
            # gather RoPE per POSITION with a clip: the extend's padding
            # may run past the table, and a clamped slice start would
            # rotate the real tail at the wrong positions
            p = int(pos)
            idx = (steps + p).clamp(max=self._cos.shape[0] - 1)
        cos, sin = self._cos[idx], self._sin[idx]
        qr, kr = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        out, kp2, vp2, ks2, vs2 = paged_cache_attend(
            qr, kr, v, kp, vp, ksc, vsc, table, p, x.dtype, wlen=wlen)
        return out, (kp2, vp2, ks2, vs2, table, pos + t)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_tp: bool = False,
                 device=None, dtype=None):
        super().__init__()
        _no_tp(use_tp)
        self.gate_proj = _linear(cfg.hidden_size, cfg.intermediate_size,
                                 device, dtype)
        self.up_proj = _linear(cfg.hidden_size, cfg.intermediate_size,
                               device, dtype)
        self.down_proj = _linear(cfg.intermediate_size, cfg.hidden_size,
                                 device, dtype)

    def forward(self, x):
        return self.down_proj(TF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_tp: bool, rope_cache,
                 device=None, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(cfg, use_tp, rope_cache,
                                        device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.mlp = LlamaMLP(cfg, use_tp, device=device, dtype=dtype)

    def forward(self, x, attn_mask=None, cache=None,
                positionwise: bool = False):
        if cache is not None:
            a, new_cache = self.self_attn(
                per_position(self.input_layernorm, x, positionwise),
                attn_mask, cache, positionwise)
            x = x + a
            return x + per_position(
                lambda y: self.mlp(self.post_attention_layernorm(y)), x,
                positionwise), new_cache
        x = x + self.self_attn(self.input_layernorm(x), attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_tp: bool = False,
                 device=None, dtype=None):
        super().__init__()
        _no_tp(use_tp)
        self.config = cfg
        self.embed_tokens = _Embedding(cfg.vocab_size, cfg.hidden_size,
                                       device=device, dtype=dtype)
        rope_cache = tuple(
            torch.as_tensor(a, device=device) for a in _rope_cache(
                cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta))
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, use_tp, rope_cache, device=device,
                               dtype=dtype)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            device=device, dtype=dtype)

    def forward(self, input_ids, attn_mask=None, caches=None,
                positionwise: bool = False):
        x = self.embed_tokens(input_ids)
        if caches is not None:
            new_caches = []
            for layer, c in zip(self.layers, caches):
                x, nc = layer(x, attn_mask, c, positionwise)
                new_caches.append(nc)
            return per_position(self.norm, x, positionwise), new_caches
        for layer in self.layers:
            x = layer(x, attn_mask)
        return self.norm(x)


def _top_p_sample(probs, top_p: float, generator=None):
    """Nucleus sampling (reference ``ops/extras.py`` ``top_p_sampling``):
    keep the smallest prefix of descending probs whose mass reaches
    ``top_p``, renormalise, draw with the Gumbel-max trick."""
    sorted_p, order = probs.sort(dim=-1, descending=True)
    csum = sorted_p.cumsum(dim=-1)
    keep = csum - sorted_p < top_p
    keep[..., 0] = True
    filt = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    filt = filt / filt.sum(dim=-1, keepdim=True)
    u = torch.rand(filt.shape, generator=generator, device=filt.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    choice = (torch.log(filt + 1e-30) + g).argmax(dim=-1, keepdim=True)
    return order.gather(-1, choice)


class LlamaForCausalLM(nn.Module):
    """``device=None`` means the CUDA device (raises without one);
    ``dtype`` is a name (``"bfloat16"``, ``"float32"``) or a
    ``torch.dtype``, f32 by default. Weights are drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 when
    None) with the reference's initialisers: Xavier-normal linears and
    embedding, RMSNorm weights at one."""

    def __init__(self, cfg: LlamaConfig, use_tp: bool = False,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_tp(use_tp)
        dev = resolve_device(device)
        dt = resolve_dtype(dtype)
        self.config = cfg
        self.llama = LlamaModel(cfg, device=dev, dtype=dt)
        if not cfg.tie_word_embeddings:
            self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, dev, dt)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                w = mod.weight
                std = math.sqrt(2.0 / (w.shape[0] + w.shape[1]))
                w.normal_(0.0, std, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def forward(self, input_ids, attn_mask=None):
        return self._head(self.llama(input_ids, attn_mask))

    def _head(self, h):
        if self.config.tie_word_embeddings:
            return TF.linear(h, self.llama.embed_tokens.weight)
        return self.lm_head(h)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_p: float = 1.0,
                 use_cache="static",
                 generator: Optional[torch.Generator] = None):
        """Greedy / nucleus decoding; returns [B, T0 + max_new_tokens]
        token ids.

        use_cache:
          - True / "static" (default): the serving path — one prefill
            over fixed-size KV buffers, then one-token decode steps
            written at the current position;
          - "dynamic": concat-grown KV cache (numerics reference);
          - False: no cache, full-context recompute per token.
        """
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids,
            device=self.device).long()

        def pick(last):
            if temperature <= 0:
                return last.argmax(dim=-1, keepdim=True)
            probs = torch.softmax(last.float() / temperature, dim=-1)
            return _top_p_sample(probs, top_p, generator)

        if max_new_tokens <= 0:
            return ids
        if not use_cache:
            for _ in range(max_new_tokens):
                nxt = pick(self(ids)[:, -1])
                ids = torch.cat([ids, nxt], dim=1)
            return ids
        L = len(self.llama.layers)
        if use_cache == "dynamic":
            caches = [(None, None)] * L
            pos = None
        else:
            caches, pos = self._static_caches(ids, max_new_tokens), 0
        out = [ids]
        nxt = ids
        for _ in range(max_new_tokens):
            if pos is not None:
                caches = [(c[0], c[1], pos) for c in caches]
                pos += nxt.shape[1]
            h, caches = self.llama(nxt, caches=caches)
            nxt = pick(self._head(h[:, -1:])[:, -1])
            out.append(nxt)
        return torch.cat(out, dim=1)

    def _static_caches(self, ids, max_new_tokens: int):
        cfg = self.config
        B, T0 = ids.shape
        want = T0 + max_new_tokens
        if want > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {want} exceeds "
                f"max_position_embeddings={cfg.max_position_embeddings}")
        # round the buffer up, as the reference does for its programs
        max_len = min(cfg.max_position_embeddings, ((want + 63) // 64) * 64)
        D = cfg.head_dim
        # k_proj may be an nn.Linear or a weight-only quantized layer
        # (quantization/): both have out_features
        kv = self.llama.layers[0].self_attn.k_proj.out_features // D
        w = self.llama.embed_tokens.weight
        return [(torch.zeros(B, max_len, kv, D, dtype=w.dtype,
                             device=w.device),
                 torch.zeros(B, max_len, kv, D, dtype=w.dtype,
                             device=w.device))
                for _ in self.llama.layers]
