"""GPT in PyTorch: the serving model and the pretraining step on one
device.

Counterpart of ``paddle_tpu/models/gpt.py``: ``GPTConfig`` (:82), the
serving model ``GPTBlock`` / ``GPTModel`` / ``GPTForCausalLM``
(:106-294, at the end of this module: the uncached forward and the
contiguous, paged and verify cache flavours the serving engine drives,
see ``GPTBlock``; learned positions from the cache's write position;
LayerNorm in the reference's rounding order, ``nn.LayerNorm``), and
``GPTTrainer``, the one-device form of
``GPTSpmdTrainer`` (:345) at ``layer_unroll="full"`` with no mesh. The
step is the reference's: token + position embedding, pre-LN blocks
(LayerNorm with f32 statistics from ``ops/layer_norm.py``, the fused
qkv projection, causal flash
attention straight off the packed ``[B, T, 3*H*D]`` projection, the
output projection, a tanh-gelu FFN), a final LayerNorm, the fused
vocab-chunked cross-entropy against the tied embedding, then AdamW:
a global-norm clip in f32, bias corrections, an optional lr schedule,
and the fused AdamW kernel on every leaf, one launch for all of them
(bf16 masters take exact stochastic rounding).

Parameters keep the reference's pytree: a dict with ``wte [V, D]``,
``wpe [T, D]``, ``ln_f_g``/``ln_f_b`` and ``blocks`` of per-layer dicts
``layer_000``..; matmul weights are ``[in, out]``. The AdamW
``leaf_id`` is a leaf's index in the reference's flatten order (sorted
keys at every level, ``gpt.py:1314-1319``), so both draw the same SR
streams per (step, leaf).

The int8 switches of the reference trainer are ported:

- ``quant8="wgrad"`` (``bench.py:build_flagship``): the qkv (site 1),
  ffn1 (site 2) and ffn2 (site 3) products take int8 in the forward, the
  dgrad and the wgrad (``ops/quant_matmul.py``, ``_mm`` :775); ``wproj``
  and the CE head stay bf16 matmuls. Seeds: ``(step + 1) * 40503`` per
  step (``step`` before the update, :1378), ``+ 16 * layer`` per layer
  (:996), ``* 8 + site`` per site, int32-wrapped as the reference's
  ``jnp.int32`` arithmetic. By default the ffn2 site takes gelu inside
  its quantize kernels (``fuse_gelu_quant``; ``False`` runs gelu in the
  compute dtype and ``int8_linear_all8``, :859-866).
  ``fuse_ln_quant`` (``True``, ``"qkv"``, ``"ffn1"``; :586-610) fuses
  LayerNorm into the qkv and/or ffn1 sites' quantize
  (``int8_ln_linear_all8``: kernel row 10 in the forward, and with
  ``fuse_bwd_colq`` row 11 in the wgrad).
- ``quant8=True`` (``int8_linear``: int8 forward, exact backward) and
  ``quant8="dgrad"`` (``int8_linear_dgrad8``: int8 dgrad as well) on
  the three sites of the autograd block.
- ``ce_int8``: the CE head's logits and ``dx`` as int8 products
  (``ops/fused_ce.py``), on any tier.
- The drift guard (``int8_guard_period``, ``int8_guard_threshold``,
  :1412-1490): before every ``period``-th step a probe measures the
  relative error of layer 0's int8 qkv dgrad (and wgrad in "wgrad"
  mode) on the batch; above the threshold ``quant8`` falls one tier
  ("wgrad" -> "dgrad" -> exact, True -> exact) for that step and the
  rest, logged in ``guard_events()``.
- ``moment8=True``: the leaves ``moment8_eligible`` picks keep m and
  sqrt(v) as int8 codes with per-row scales (``(q, scale)`` pairs in
  ``opt_state``, :641) and take the int8-moment AdamW kernel, all of
  them in one launch; the others keep ``moment_dtype`` moments and the
  AdamW kernel, in one launch too (:1322).
- ``remat="save_main"`` (:1021) with ``quant8="wgrad"``: per layer the
  backward keeps the block input, ``qkv_out``, the flash out and lse,
  and ``ffn1_out`` (and a fused site's row statistics), and recomputes
  LayerNorm 1, the ``wproj`` product with its residual add and
  LayerNorm 2 (where not fused). It never runs the flash forward, the
  qkv or ffn1 products or their quantize kernels again.

The int8 block is one ``torch.autograd.Function`` with an explicit
backward (``_Int8Block``), so the remat recompute is exactly the cheap
ops above: with remat off it saves those results instead.

On a CPU device every kernel runs its plain version. Arguments this
slice does not port (the other remat policies, ``save_main`` off
``quant8="wgrad"`` and so the guard under it, MoE, pipelines) raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as TF

from .._device import resolve_device, resolve_dtype
from ..nn.functional import scaled_dot_product_attention
from ..nn.layer.norm import LayerNorm
from ..ops.flash_attention import (flash_attention_qkv_fused,
                                   flash_qkv_packed_bwd, flash_qkv_packed_fwd)
from ..ops.fused_adamw import (AdamW8Leaves, AdamWLeaves,
                               moment8_eligible, moment8_init)
from ..ops.fused_ce import fused_softmax_cross_entropy
from ..ops.layer_norm import layer_norm, ln_bwd, ln_fwd
from ..ops.quant_matmul import (int8_dgrad, int8_dot_dequant,
                                int8_gelu_linear_all8_bwd, int8_linear,
                                int8_linear_all8_bwd, int8_linear_dgrad8,
                                int8_ln_linear_all8_bwd, int8_ln_matmul,
                                int8_matmul, layer_seed, site_seed,
                                sr_quantize_colwise, step_seed)
from ._decode_cache import (cache_attend, check_cache_pos,
                            paged_cache_attend, per_position)
from .llama import _Embedding, _Linear

__all__ = ["GPTBlock", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTTrainer", "block_shapes", "flatten_params", "layer_norm",
           "top_shapes"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_mult: int = 4
    dropout: float = 0.0
    tie_embeddings: bool = True
    dtype: Any = "bfloat16"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self):
        return self.hidden_size * self.ffn_mult


def block_shapes(cfg: GPTConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of one layer's leaves (the reference's ``_init_params``)."""
    D, F = cfg.hidden_size, cfg.ffn_size
    return {"ln1_g": (D,), "ln1_b": (D,), "ln2_g": (D,), "ln2_b": (D,),
            "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wproj": (D, D),
            "bproj": (D,), "win": (D, F), "bin": (F,), "wout": (F, D),
            "bout": (D,)}


def top_shapes(cfg: GPTConfig) -> Dict[str, Tuple[int, ...]]:
    D, V = cfg.hidden_size, cfg.vocab_size
    shapes = {"wte": (V, D), "wpe": (cfg.max_seq_len, D), "ln_f_g": (D,),
              "ln_f_b": (D,)}
    if not cfg.tie_embeddings:
        shapes["head"] = (D, V)
    return shapes


def flatten_params(params) -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` in the reference's ``jax.tree.flatten`` order:
    keys sorted at every level."""
    out = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{k}.", node[k])
        else:
            out.append((prefix[:-1], node))
    walk("", params)
    return out


# leaves of one block in the order _Int8Block takes them
_BLOCK_KEYS = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_g",
               "ln2_b", "win", "bin", "wout", "bout")


def _sum_lead(t):
    """A bias gradient: ``t`` summed over every dim but the last."""
    return t.sum(tuple(range(t.dim() - 1)))


@dataclasses.dataclass(frozen=True)
class _BlockOpts:
    """What one ``_Int8Block`` fuses and keeps: LayerNorm into the qkv
    (site 1) and ffn1 (site 2) quantizes (``fuse_ln_quant``), row 11 in
    their wgrad (``fuse_bwd_colq``), gelu into the ffn2 quantize
    (``fuse_gelu_quant``), and the ``save_main`` policy."""
    fuse_qkv: bool
    fuse_ffn1: bool
    fuse_bwd_colq: bool
    fuse_gelu: bool
    save_main: bool


class _Int8Block(torch.autograd.Function):
    """One pre-LN block of the ``quant8="wgrad"`` recipe (``_block``
    :819) with an explicit backward.

    Forward: LN1, qkv = int8(h1 @ wqkv) + bqkv, packed flash attention
    (out, lse), xm = x + attn @ wproj + bproj, LN2, a = int8(h2 @ win) +
    bin (``ffn1_out``), y = xm + int8(gelu(a) @ wout) + bout. A site with
    LayerNorm fused (``int8_ln_linear_all8``) runs LN and its quantize
    as kernel row 10 and keeps the rows' mean and rstd ([M, 1] f32, 24 KB
    at GPT-1.3B) in place of h; the ffn2 site takes gelu inside its
    quantizes (``int8_gelu_linear_all8``), or with ``fuse_gelu=False``
    gelu(a) in x's dtype and ``int8_linear_all8`` (:859-866).

    Saved: the block input, qkv, out, lse, a and the fused sites' row
    statistics; with ``save_main`` that is all (the reference's policy,
    :1021), without it also xm, an unfused site's LN output and
    statistics, and gelu(a) when it is not fused. The backward
    recomputes what was not saved (the wproj product with its residual
    add, an unfused site's LN, gelu(a)), then runs each site's int8
    backward, the flash backward and the LayerNorm backwards. ``seed``
    is the layer's int seed."""

    @staticmethod
    def forward(ctx, x, seed, num_heads, opts, *leaves):
        w = dict(zip(_BLOCK_KEYS, leaves))
        keep = {}
        if opts.fuse_qkv:
            qkv, keep["mean1"], keep["rstd1"] = int8_ln_matmul(
                x, w["ln1_g"], w["ln1_b"], w["wqkv"])
        else:
            h1, mean1, rstd1 = ln_fwd(x, w["ln1_g"], w["ln1_b"])
            qkv = int8_matmul(h1, w["wqkv"])
            if not opts.save_main:
                keep.update(h1=h1, mean1=mean1, rstd1=rstd1)
        qkv = qkv + w["bqkv"]
        scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * num_heads))
        out, lse = flash_qkv_packed_fwd(qkv, num_heads, True, scale)
        xm = x + out.reshape(x.shape[:-1] + (-1,)) @ w["wproj"] \
            + w["bproj"]
        if not opts.save_main:
            keep["xm"] = xm
        if opts.fuse_ffn1:
            a, keep["mean2"], keep["rstd2"] = int8_ln_matmul(
                xm, w["ln2_g"], w["ln2_b"], w["win"])
        else:
            h2, mean2, rstd2 = ln_fwd(xm, w["ln2_g"], w["ln2_b"])
            a = int8_matmul(h2, w["win"])
            if not opts.save_main:
                keep.update(h2=h2, mean2=mean2, rstd2=rstd2)
        a = a + w["bin"]
        if opts.fuse_gelu:
            o = int8_matmul(a, w["wout"], "gelu")
        else:
            act = TF.gelu(a, approximate="tanh")
            o = int8_matmul(act, w["wout"])
            if not opts.save_main:
                keep["act"] = act
        y = xm + o + w["bout"]
        keep.update(x=x, qkv=qkv, out=out, lse=lse, a=a)
        ctx.names = tuple(keep)
        ctx.save_for_backward(*keep.values(), *leaves)
        ctx.seed, ctx.num_heads, ctx.scale = seed, num_heads, scale
        ctx.opts = opts
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        t = dict(zip(ctx.names, saved))
        w = dict(zip(_BLOCK_KEYS, saved[len(ctx.names):]))
        opts = ctx.opts
        x, qkv, a = t["x"], t["qkv"], t["a"]
        attn = t["out"].reshape(x.shape[:-1] + (-1,))
        if opts.save_main:           # recompute what the policy drops
            t["xm"] = x + attn @ w["wproj"] + w["bproj"]
            for k, xin, fused in (("1", x, opts.fuse_qkv),
                                  ("2", t["xm"], opts.fuse_ffn1)):
                if not fused:
                    t["h" + k], t["mean" + k], t["rstd" + k] = ln_fwd(
                        xin, w[f"ln{k}_g"], w[f"ln{k}_b"])
            if not opts.fuse_gelu:
                t["act"] = TF.gelu(a, approximate="tanh")
        xm = t["xm"]
        s1, s2, s3 = (site_seed(ctx.seed, k) for k in (1, 2, 3))
        g = {"bout": _sum_lead(dy)}
        if opts.fuse_gelu:
            da, g["wout"] = int8_gelu_linear_all8_bwd(a, w["wout"], s3, dy)
        else:
            dact, g["wout"] = int8_linear_all8_bwd(t["act"], w["wout"], s3,
                                                   dy)
            da = torch.ops.aten.gelu_backward(dact, a, approximate="tanh")
        g["bin"] = _sum_lead(da)

        def ln_site(k, xin, wname, seed, dout):
            """(dx, dg, db, dw) of LN{k} and the int8 product after it."""
            gk, bk = w[f"ln{k}_g"], w[f"ln{k}_b"]
            if "h" + k not in t:             # LayerNorm fused (row 10)
                return int8_ln_linear_all8_bwd(
                    xin, gk, bk, w[wname], seed, t["mean" + k],
                    t["rstd" + k], dout, opts.fuse_bwd_colq)
            dh, dw = int8_linear_all8_bwd(t["h" + k], w[wname], seed, dout)
            return (*ln_bwd(xin, gk, t["mean" + k], t["rstd" + k], dh), dw)
        dxm, g["ln2_g"], g["ln2_b"], g["win"] = ln_site("2", xm, "win", s2,
                                                        da)
        dxm = dy + dxm
        g["bproj"] = _sum_lead(dxm)
        D = dxm.shape[-1]
        g["wproj"] = attn.reshape(-1, attn.shape[-1]).t() \
            @ dxm.reshape(-1, D)
        dqkv = flash_qkv_packed_bwd(qkv, t["out"], t["lse"],
                                    dxm @ w["wproj"].t(), ctx.num_heads,
                                    True, ctx.scale)
        g["bqkv"] = _sum_lead(dqkv)
        dx, g["ln1_g"], g["ln1_b"], g["wqkv"] = ln_site("1", x, "wqkv", s1,
                                                        dqkv)
        return (dxm + dx, None, None, None, *(g[k] for k in _BLOCK_KEYS))


def _not_ported(what: str, slice_: str):
    raise NotImplementedError(
        f"GPTTrainer: {what} is not in this slice of the port ({slice_})")


_REMAT_SLICE = "the remat slice, ROADMAP Queue 1"
_QUANT8 = (False, True, "dgrad", "wgrad")


def _kept_update(kept, table, leaves, scalars, hp):
    """One AdamW step of ``leaves`` ((p, g, m, v, leaf_id) each) through
    the leaf table ``kept`` (an ``AdamWLeaves`` or ``AdamW8Leaves``,
    ``table``): one launch a dtype group. The table of p, m and v is laid
    out again only when the params or the moments were replaced. Returns
    the table to keep."""
    if not leaves:
        return kept
    ps, gs, ms, vs, ids = map(list, zip(*leaves))
    if kept is None or not kept.holds(ps, ms, vs):
        kept = table(ps, ms, vs, ids)
    kept.update(gs, scalars, **hp)
    return kept


class GPTTrainer:
    """Functional GPT pretraining step on one device: the port of
    ``paddle_tpu.models.gpt.GPTSpmdTrainer`` with a single-device mesh,
    ``layer_unroll="full"``, the packed flash-attention path and the
    fused AdamW kernel.

    ``master_dtype=bfloat16`` stores the masters at compute precision
    and updates them with stochastic rounding (the flagship recipe);
    float32 masters are cast to ``cfg.dtype`` inside the step and take
    f32 gradients and exact updates. ``quant8`` (the int8 tiers),
    ``fuse_gelu_quant``, ``fuse_ln_quant``, ``fuse_bwd_colq``,
    ``ce_int8``, ``moment8``, ``remat="save_main"`` and the drift guard
    (``int8_guard_period``, ``int8_guard_threshold``) are the
    reference's switches (see the module docstring). ``params`` (a dict
    in the reference's layout, e.g. from ``models.convert``) replaces
    the random initialisation."""

    def __init__(self, cfg: GPTConfig, microbatches: Optional[int] = 1,
                 learning_rate: float = 3e-4, weight_decay: float = 0.1,
                 beta1: float = 0.9, beta2: float = 0.95,
                 grad_clip: float = 1.0, seed: int = 0,
                 remat: Any = False, moment_dtype: Any = "float32",
                 master_dtype: Any = "float32", quant8: Any = False,
                 pipeline_schedule: str = "gpipe", moe_experts: int = 0,
                 fused_optimizer: bool = True, moment8: bool = False,
                 layer_unroll: Any = "full", ce_chunks: int = 16,
                 ce_int8: bool = False, fuse_gelu_quant: Any = None,
                 fuse_ln_quant: Any = None, fuse_bwd_colq: Any = None,
                 lr_schedule: Optional[Callable[[float], Any]] = None,
                 int8_guard_period: int = 0,
                 int8_guard_threshold: float = 0.10, device=None,
                 params: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None):
        if not isinstance(quant8, str):
            quant8 = bool(quant8)
        if quant8 not in _QUANT8:
            raise ValueError(f"quant8 must be False, True, 'dgrad' or "
                             f"'wgrad'; got {quant8!r}")
        if remat and remat != "save_main":
            _not_ported(f"remat={remat!r}", _REMAT_SLICE + "; "
                        "remat='save_main' is ported")
        if remat and quant8 != "wgrad":
            _not_ported("remat='save_main' off quant8='wgrad'",
                        _REMAT_SLICE)
        if remat and int8_guard_period:
            _not_ported("the int8 drift guard under remat='save_main' (its "
                        "ladder falls to quant8='dgrad')", _REMAT_SLICE)
        # the reference's checks (gpt.py:555-610), in its order
        if fuse_gelu_quant and quant8 != "wgrad":
            raise ValueError(
                "fuse_gelu_quant rides the all-int8 recipe: it needs "
                "quant8='wgrad'")
        if fuse_gelu_quant is None:
            fuse_gelu_quant = quant8 == "wgrad"
        if fuse_ln_quant and quant8 != "wgrad":
            raise ValueError(
                "fuse_ln_quant rides the all-int8 recipe: it needs "
                "quant8='wgrad' (the fused op quantizes both the fwd row "
                "and the wgrad SR column streams)")
        if fuse_ln_quant is None:
            fuse_ln_quant = False
        if fuse_ln_quant not in (True, False, "qkv", "ffn1"):
            raise ValueError(f"fuse_ln_quant must be True/False/'qkv'/"
                             f"'ffn1', got {fuse_ln_quant!r}")
        if moe_experts:
            _not_ported("moe_experts", "the multi-GPU training slice")
        if pipeline_schedule != "gpipe" or microbatches not in (None, 1):
            _not_ported("pipeline schedules and microbatches",
                        "the multi-GPU training slice")
        if not fused_optimizer:
            _not_ported("the unfused optimizer", "no slice brings it: the "
                        "port runs the fused AdamW kernel on every leaf")
        if layer_unroll != "full":
            _not_ported(f"layer_unroll={layer_unroll!r}", "no slice brings "
                        "it: the port keeps per-layer parameters only")
        if cfg.dropout:
            _not_ported("dropout", "no slice brings it: the reference "
                        "trainer has none")
        self.cfg = cfg
        self.quant8, self.remat, self.moment8 = quant8, remat, bool(moment8)
        self.ce_int8 = bool(ce_int8)
        self.fuse_gelu_quant = bool(fuse_gelu_quant)
        self.fuse_ln_quant = fuse_ln_quant
        # None: the reference's default, its PTPU_FUSE_BWD_COLQ unset
        self.fuse_bwd_colq = bool(fuse_bwd_colq)
        self.int8_guard_period = int(int8_guard_period)
        self.int8_guard_threshold = float(int8_guard_threshold)
        self._guard_events: List[Dict[str, Any]] = []
        self._host_step = 0
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(cfg.dtype)
        self.master_dtype = resolve_dtype(master_dtype)
        self.moment_dtype = resolve_dtype(moment_dtype)
        self._stoch_round = self.master_dtype == torch.bfloat16
        self.lr, self.wd = float(learning_rate), float(weight_decay)
        self.betas = (float(beta1), float(beta2))
        self.grad_clip = float(grad_clip)
        self.ce_chunks = int(ce_chunks)
        self.lr_schedule = lr_schedule
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(seed)
            params = self._init_params(generator)
        self.params = params
        self.opt_state = {"step": 0, "m": [], "v": []}
        for p in self._leaves:
            if self.moment8 and moment8_eligible(p):
                mq, msc, vq, vsc = moment8_init(p)
                m, v = (mq, msc), (vq, vsc)
            else:
                m, v = (torch.zeros_like(p, dtype=self.moment_dtype)
                        for _ in range(2))
            self.opt_state["m"].append(m)
            self.opt_state["v"].append(v)

    @property
    def params(self) -> Dict[str, Any]:
        """The parameter tree; the step updates its leaves in place."""
        return self._params

    @params.setter
    def params(self, params: Dict[str, Any]) -> None:
        """Replace the parameters, as the reference's step reassigns its
        ``params`` (a restore does the same): the new tree must have the
        old one's paths and each leaf its shape, dtype and device. The
        optimizer state stays with the leaf positions, as in the
        reference; the AdamW leaf tables are laid out again."""
        leaves = flatten_params(params)
        if hasattr(self, "_params"):
            def layout(items):
                return [(path, tuple(t.shape), t.dtype, t.device)
                        for path, t in items]
            old, new = layout(flatten_params(self._params)), layout(leaves)
            if new != old:
                diff = next(((a, b) for a, b in zip(old, new) if a != b),
                            (len(old), len(new)))
                raise ValueError(f"GPTTrainer.params takes a tree of the "
                                 f"trainer's leaves; first difference "
                                 f"(was, got): {diff}")
        self._params = params
        self._leaves = [p for _, p in leaves]
        for p in self._leaves:
            p.requires_grad_(True)
        self._row13 = None     # AdamW8Leaves of the leaves with int8 moments
        self._row14 = None     # AdamWLeaves of the others

    # -- init --------------------------------------------------------------
    def _init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        cfg = self.cfg
        std = 0.02
        resid_std = std / math.sqrt(2 * cfg.num_layers)
        dev, mdt = self.device, self.master_dtype

        def normal(shape, scale):
            return (torch.randn(shape, generator=gen, device=dev) * scale
                    ).to(mdt)

        def const(shape, value):
            return torch.full(shape, value, dtype=mdt, device=dev)

        scales = {"wqkv": std, "win": std, "wproj": resid_std,
                  "wout": resid_std}
        params = {k: (normal(s, std) if k in ("wte", "wpe", "head")
                      else const(s, 1.0 if k.endswith("_g") else 0.0))
                  for k, s in top_shapes(cfg).items()}
        params["blocks"] = {
            f"layer_{li:03d}": {
                k: normal(s, scales[k]) if k in scales
                else const(s, 1.0 if k.endswith("_g") else 0.0)
                for k, s in block_shapes(cfg).items()}
            for li in range(cfg.num_layers)}
        return params

    # -- model -------------------------------------------------------------
    def _embed(self, wte, wpe, input_ids):
        T = input_ids.shape[1]
        return TF.embedding(input_ids, wte.to(self.dtype)) + \
            wpe.to(self.dtype)[:T][None]

    def _mm(self, a, w):
        """One block product on the autograd path (``_mm`` :775) at the
        quant8 tiers below "wgrad": int8 forward with an exact backward
        (True), int8 dgrad as well ("dgrad"), or a plain matmul."""
        if self.quant8 == "dgrad":
            return int8_linear_dgrad8(a, w)
        if self.quant8:
            return int8_linear(a, w)
        return a @ w

    def _attn_sublayer(self, x, bp):
        """ln1 + qkv + attention + proj + residual on ``[B, T, D]``,
        attention straight off the packed projection (the reference's
        hsplit path)."""
        dt = x.dtype
        h = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
        qkv = self._mm(h, bp["wqkv"].to(dt)) + bp["bqkv"].to(dt)
        attn = flash_attention_qkv_fused(qkv, self.cfg.num_heads,
                                         causal=True)
        return x + attn @ bp["wproj"].to(dt) + bp["bproj"].to(dt)

    def _block_opts(self) -> _BlockOpts:
        f = self.fuse_ln_quant
        return _BlockOpts(fuse_qkv=f in (True, "qkv"),
                          fuse_ffn1=f in (True, "ffn1"),
                          fuse_bwd_colq=self.fuse_bwd_colq,
                          fuse_gelu=self.fuse_gelu_quant,
                          save_main=self.remat == "save_main")

    def _block(self, x, bp, seed=None):
        """One block; ``seed`` is the layer's SR seed in int8 mode."""
        dt = x.dtype
        if self.quant8 == "wgrad":
            leaves = [bp[k] if k.startswith("ln") else bp[k].to(dt)
                      for k in _BLOCK_KEYS]
            return _Int8Block.apply(x, seed, self.cfg.num_heads,
                                    self._block_opts(), *leaves)
        x = self._attn_sublayer(x, bp)
        h = layer_norm(x, bp["ln2_g"], bp["ln2_b"])
        a = TF.gelu(self._mm(h, bp["win"].to(dt)) + bp["bin"].to(dt),
                    approximate="tanh")
        return x + self._mm(a, bp["wout"].to(dt)) + bp["bout"].to(dt)

    def _forward_loss(self, params, input_ids, labels, seed=None):
        """The step's loss; ``seed`` is the step's SR seed in int8 mode
        (the reference's default 1 when None)."""
        cfg = self.cfg
        x = self._embed(params["wte"], params["wpe"], input_ids)
        for li, key in enumerate(sorted(params["blocks"])):
            x = self._block(x, params["blocks"][key], layer_seed(seed, li))
        x = layer_norm(x, params["ln_f_g"], params["ln_f_b"])
        vm = bool(cfg.tie_embeddings)
        head = params["wte"] if vm else params["head"]
        return fused_softmax_cross_entropy(
            x, head.to(self.dtype), labels, n_chunks=self.ce_chunks,
            int8=self.ce_int8, vocab_major=vm)

    # -- optimizer ---------------------------------------------------------
    def _adamw(self, grads: List[torch.Tensor]) -> None:
        b1, b2 = self.betas
        step = self.opt_state["step"] + 1
        gnorm = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads]).square().sum().sqrt()
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-6), max=1.0)
        t = np.float32(step)
        one = np.float32(1.0)
        inv_bc1 = one / (one - np.float32(b1) ** t)
        inv_bc2 = one / (one - np.float32(b2) ** t)
        lr_mult = 1.0 if self.lr_schedule is None \
            else self.lr_schedule(float(step))
        scalars = torch.stack([
            scale.float(),
            *(torch.as_tensor(float(c), dtype=torch.float32,
                              device=self.device)
              for c in (inv_bc1, inv_bc2)),
            torch.as_tensor(lr_mult, dtype=torch.float32,
                            device=self.device).reshape(())])
        hp = dict(lr=self.lr, wd=self.wd, b1=b1, b2=b2, eps=1e-8,
                  stoch_round=self._stoch_round, seed=step)
        # (p, g, m, v, leaf_id) of the leaves with int8 moments (moment8:
        # m and v are (codes, scales) pairs) and of the others
        eight, rest = [], []
        for i, (p, g, m, v) in enumerate(zip(
                self._leaves, grads, self.opt_state["m"],
                self.opt_state["v"])):
            (eight if isinstance(m, tuple) else rest).append((p, g, m, v, i))
        with torch.no_grad():
            self._row13 = _kept_update(self._row13, AdamW8Leaves, eight,
                                       scalars, hp)
            self._row14 = _kept_update(self._row14, AdamWLeaves, rest,
                                       scalars, hp)
        self.opt_state["step"] = step

    # -- public step -------------------------------------------------------
    def loss_and_grads(self, input_ids, labels):
        """The step's loss and the gradient of every leaf (flatten
        order), without the optimizer update."""
        ids, lab = (torch.as_tensor(t).to(self.device, torch.long)
                    for t in (input_ids, labels))
        for p in self._leaves:
            p.grad = None
        seed = step_seed(self.opt_state["step"]) \
            if self.quant8 == "wgrad" else None
        loss = self._forward_loss(self.params, ids, lab, seed)
        loss.backward()
        grads = [p.grad for p in self._leaves]
        for p in self._leaves:
            p.grad = None
        return loss.detach(), grads

    # -- the int8 drift guard --------------------------------------------
    def _probe(self, input_ids) -> float:
        """The drift probe (``_build_guard`` :1412): the relative error of
        the int8 dgrad of layer 0's qkv product, with the current
        weights, the batch's LN1 output and a Gaussian cotangent; in
        "wgrad" mode the larger of that and the SR int8 wgrad's (seeds
        ``step`` and ``step + 1``). The cotangent comes from a
        ``torch.Generator`` seeded by the optimizer step, so it is not
        the reference's ``jax.random`` draw: the two agree in
        distribution only."""
        step = int(self.opt_state["step"])
        ids = torch.as_tensor(input_ids).to(self.device, torch.long)
        with torch.no_grad():
            x = self._embed(self.params["wte"], self.params["wpe"], ids)
            bp = self.params["blocks"]["layer_000"]
            h = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
            w = bp["wqkv"].to(h.dtype)
            D, N = w.shape
            gen = torch.Generator(self.device).manual_seed(step)
            g2 = torch.randn((h.numel() // D, N), generator=gen,
                             device=self.device).to(h.dtype)
            h2 = h.reshape(-1, D)

            def rel(approx, exact):
                return (approx - exact).norm() / (exact.norm() + 1e-30)
            err = rel(int8_dgrad(g2, w), (g2 @ w.t()).float())
            if self.quant8 == "wgrad":
                hq, hs = sr_quantize_colwise(h2, step)
                gq, gs = sr_quantize_colwise(g2, step + 1)
                dw = int8_dot_dequant(hq.t(), hs.reshape(-1, 1), gq, gs)
                err = torch.maximum(err, rel(dw, (h2.t() @ g2).float()))
        return float(err)

    def _run_guard(self, input_ids) -> float:
        """Measure the drift; above the threshold fall one int8 tier
        (``_run_guard`` :1466: "wgrad" -> "dgrad" -> exact, True ->
        exact) and log it. Returns the measured relative error."""
        r = self._probe(input_ids)
        if r > self.int8_guard_threshold:
            nxt = {"wgrad": "dgrad", "dgrad": False}.get(self.quant8, False)
            self._guard_events.append(
                {"step": int(self.opt_state["step"]), "rel_err": r,
                 "from": self.quant8, "to": nxt})
            self.quant8 = nxt
        return r

    def guard_events(self) -> List[Dict[str, Any]]:
        """The drift guard's fallbacks: ``[{step, rel_err, from, to}]``."""
        return list(self._guard_events)

    def train_step(self, input_ids, labels) -> torch.Tensor:
        """One AdamW step on a ``[B, T]`` batch; returns the loss (a
        0-dim tensor on the device, before the update). With
        ``int8_guard_period`` the drift guard runs first every that many
        calls, and may lower ``quant8`` for this step and the rest."""
        if self.quant8 and self.int8_guard_period and \
                self._host_step % self.int8_guard_period == 0:
            self._run_guard(input_ids)
        loss, grads = self.loss_and_grads(input_ids, labels)
        self._adamw(grads)
        self._host_step += 1
        return loss

    def n_params(self) -> int:
        return sum(p.numel() for p in self._leaves)



# ---------------------------------------------------------------------------
# the serving model (reference gpt.py:106-294)
# ---------------------------------------------------------------------------

def _gelu(x):
    return TF.gelu(x, approximate="tanh")


class GPTBlock(nn.Module):
    """A pre-LN block (reference :106-213): ``ln1``, the fused ``qkv``
    projection read as ``[b, t, 3, H, D]``, attention, ``proj``, ``ln2``,
    ``fc1``, tanh-gelu, ``fc2``. ``cache`` selects the attention:

    - None: causal ``scaled_dot_product_attention`` (row 1 on the card
      where ``kernel_takes``, its plain branch otherwise);
    - ``(k, v, pos)`` / ``(k, v, pos, wlen)``: the contiguous buffers
      through ``_decode_cache.cache_attend`` (the verify and chunk
      flavours with ``wlen``; a scalar ``pos == 0`` prefill takes row 1);
    - ``(kp, vp, ks, vs, table, pos)`` / ``(..., pos, wlen)``: the paged
      pools through ``_decode_cache.paged_cache_attend``.

    Cached and uncached calls share one tail (:208-213). ``positionwise``
    (cached calls only) runs the norms and linears one position at a
    time (``_decode_cache.per_position``)."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        D, F = cfg.hidden_size, cfg.ffn_size
        self.ln1 = LayerNorm(D, device=device, dtype=dtype)
        self.ln2 = LayerNorm(D, device=device, dtype=dtype)
        self.qkv = _Linear(D, 3 * D, device=device, dtype=dtype)
        self.proj = _Linear(D, D, device=device, dtype=dtype)
        self.fc1 = _Linear(D, F, device=device, dtype=dtype)
        self.fc2 = _Linear(F, D, device=device, dtype=dtype)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, cache=None, positionwise: bool = False):
        b, t, _ = x.shape
        D = self.cfg.head_dim
        pw = positionwise and cache is not None
        qkv = per_position(lambda y: self.qkv(self.ln1(y)), x, pw)
        qkv = qkv.reshape(b, t, 3, -1, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        new_cache = None
        if cache is None:
            attn = scaled_dot_product_attention(
                q, k, v, is_causal=True, training=self.training)
            attn = attn.reshape(b, t, -1)
        elif len(cache) in (6, 7):
            kp, vp, ksc, vsc, table, pos = cache[:6]
            wlen = cache[6] if len(cache) == 7 else None
            # the extend's bucket padding may run past the table and is
            # sent to the trash page: only the start position is checked
            per_row = check_cache_pos(pos, 1, table.shape[1] * kp.shape[1])
            p = torch.as_tensor(pos, device=x.device).long() if per_row \
                else int(pos)
            attn, kp2, vp2, ks2, vs2 = paged_cache_attend(
                q, k, v, kp, vp, ksc, vsc, table, p, x.dtype, wlen=wlen)
            new_cache = (kp2, vp2, ks2, vs2, table, pos + t)
        else:
            kc, vc, pos = cache[:3]
            wlen = cache[3] if len(cache) == 4 else None
            # the verify's writes past the buffer are dropped
            per_row = check_cache_pos(pos, 1 if wlen is not None else t,
                                      kc.shape[1])
            p = torch.as_tensor(pos, device=x.device).long() if per_row \
                else pos
            attn, kc2, vc2 = cache_attend(q, k, v, kc, vc, p, per_row,
                                          wlen=wlen)
            new_cache = (kc2, vc2, pos + t)
        x = x + self.drop(per_position(self.proj, attn.to(x.dtype), pw))
        x = x + self.drop(per_position(
            lambda y: self.fc2(_gelu(self.fc1(self.ln2(y)))), x, pw))
        return x if new_cache is None else (x, new_cache)


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.wte = _Embedding(cfg.vocab_size, cfg.hidden_size,
                              device=device, dtype=dtype)
        self.wpe = _Embedding(cfg.max_seq_len, cfg.hidden_size,
                              device=device, dtype=dtype)
        self.blocks = nn.ModuleList([GPTBlock(cfg, device, dtype)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, device=device, dtype=dtype)

    def _cache_positions(self, base, t: int):
        """Learned positions of a cached call (reference :236-255): the
        write position ``base`` (an int, or a ``[b]`` tensor) plus
        ``0..t-1``, clipped to the table. The clip touches only tokens
        whose writes are masked or sent to the trash page (a verify row
        near its cap, the extend's bucket padding), where the
        reference's gather fills NaN."""
        dev = self.wpe.weight.device
        steps = torch.arange(t, device=dev)
        if getattr(base, "ndim", 0) >= 1:
            pos = torch.as_tensor(base, device=dev).long()[:, None] \
                + steps[None]
        else:
            pos = (steps + int(base))[None]
        return pos.clamp(max=self.cfg.max_seq_len - 1)

    def forward(self, input_ids, caches=None, positionwise: bool = False):
        b, t = input_ids.shape
        if caches is None:
            if t > self.cfg.max_seq_len:
                raise ValueError(f"sequence length {t} exceeds "
                                 f"max_seq_len={self.cfg.max_seq_len}")
            pos = torch.arange(t, device=input_ids.device)[None]
            x = self.wte(input_ids) + self.wpe(pos)
            for blk in self.blocks:
                x = blk(x)
            return self.ln_f(x)
        # pos is the last element of the (k, v, pos) and paged 6-tuples,
        # the second to last of the verify flavours (which append wlen)
        verify = len(caches[0]) in (4, 7)
        base = caches[0][-2] if verify else caches[0][-1]
        x = self.wte(input_ids) + self.wpe(self._cache_positions(base, t))
        new_caches = []
        for blk, c in zip(self.blocks, caches):
            x, nc = blk(x, c, positionwise)
            new_caches.append(nc)
        return per_position(self.ln_f, x, positionwise), new_caches


class GPTForCausalLM(nn.Module):
    """The GPT serving model (reference :258-294), ``nn.Module``s with the
    reference's names (``gpt.wte``, ``gpt.wpe``, ``gpt.blocks.{i}.{ln1,
    qkv,proj,ln2,fc1,fc2}``, ``gpt.ln_f``, ``lm_head`` when untied).
    ``device=None`` means the CUDA device (raises without one);
    ``dtype`` is a name or a ``torch.dtype``, f32 by default
    (``cfg.dtype`` is the trainer's). Weights are drawn from
    ``generator`` (seed 0 when None) with the reference's initialisers:
    Xavier-normal linears and embeddings, zero biases, LayerNorm weights
    at one and biases at zero. The tied head is ``h @ wte.weight.T``."""

    def __init__(self, cfg: GPTConfig, use_tp: bool = False, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_tp:
            raise NotImplementedError(
                "tensor-parallel GPT serving (use_tp) comes with the "
                "multi-GPU slice of the port")
        dev = resolve_device(device)
        dt = resolve_dtype(dtype)
        self.config = cfg
        self.gpt = GPTModel(cfg, device=dev, dtype=dt)
        if not cfg.tie_embeddings:
            self.lm_head = _Linear(cfg.hidden_size, cfg.vocab_size,
                                   bias=False, device=dev, dtype=dt)
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
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids, caches=None, positionwise: bool = False):
        if caches is not None:
            h, new_caches = self.gpt(input_ids, caches, positionwise)
            return self._head(h), new_caches
        return self._head(self.gpt(input_ids))

    def _head(self, h):
        if self.config.tie_embeddings:
            return TF.linear(h, self.gpt.wte.weight)
        return self.lm_head(h)
