"""GPT pretraining step on one device.

Counterpart of ``paddle_tpu/models/gpt.py``: ``GPTConfig`` (:82),
``_layer_norm`` (:1530) and ``GPTTrainer``, the one-device form of
``GPTSpmdTrainer`` (:345) at ``layer_unroll="full"`` with no mesh. The
step is the reference's: token + position embedding, pre-LN blocks
(LayerNorm with f32 statistics, the fused qkv projection, causal flash
attention straight off the packed ``[B, T, 3*H*D]`` projection, the
output projection, a tanh-gelu FFN), a final LayerNorm, the fused
vocab-chunked cross-entropy against the tied embedding, then AdamW:
a global-norm clip in f32, bias corrections, an optional lr schedule,
and the fused AdamW kernel on every leaf (bf16 masters take exact
stochastic rounding).

Parameters keep the reference's pytree: a dict with ``wte [V, D]``,
``wpe [T, D]``, ``ln_f_g``/``ln_f_b`` and ``blocks`` of per-layer dicts
``layer_000``..; matmul weights are ``[in, out]``. The AdamW
``leaf_id`` is a leaf's index in the reference's flatten order (sorted
keys at every level, ``gpt.py:1314-1319``), so both draw the same SR
streams per (step, leaf).

The flagship recipe of ``bench.py:build_flagship`` is ported as well:

- ``quant8="wgrad"``: the qkv (site 1), ffn1 (site 2) and ffn2 (site
  3, ``int8_gelu_linear_all8`` on the pre-gelu ``ffn1_out``: the gelu
  runs inside the quantize kernels, ``fuse_gelu_quant``) products take
  int8 in the forward, the dgrad and the wgrad (``ops/quant_matmul.py``,
  ``_mm`` :775); ``wproj`` and the CE head stay bf16 matmuls. Seeds:
  ``(step + 1) * 40503`` per step (``step`` before the update,
  :1378), ``+ 16 * layer`` per layer (:996), ``* 8 + site`` per site,
  int32-wrapped as the reference's ``jnp.int32`` arithmetic.
- ``moment8=True``: the leaves ``moment8_eligible`` picks keep m and
  sqrt(v) as int8 codes with per-row scales (``(q, scale)`` pairs in
  ``opt_state``, :641) and take the int8-moment AdamW kernel; the
  others keep ``moment_dtype`` moments and the AdamW kernel (:1322).
- ``remat="save_main"`` (:1021): per layer the backward keeps the block
  input, ``qkv_out``, the flash out and lse, and ``ffn1_out``, and
  recomputes LayerNorm 1, the ``wproj`` product with its residual add
  and LayerNorm 2. It never runs the flash forward, the qkv or ffn1
  products or their quantize kernels again.

The int8 block is one ``torch.autograd.Function`` with an explicit
backward (``_Int8Block``), so the remat recompute is exactly the three
cheap ops above: with remat off it saves those three results instead.

On a CPU device every kernel runs its plain version. Arguments this
slice does not port raise ``NotImplementedError`` naming the slice that
brings them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as TF

from .._device import resolve_device, resolve_dtype
from ..ops.flash_attention import (flash_attention_qkv_fused,
                                   flash_qkv_packed_bwd, flash_qkv_packed_fwd)
from ..ops.fused_adamw import (fused_adamw_update, fused_adamw_update8,
                               moment8_eligible, moment8_init)
from ..ops.fused_ce import fused_softmax_cross_entropy
from ..ops.quant_matmul import (int8_gelu_linear_all8_bwd,
                                int8_linear_all8_bwd, int8_matmul,
                                layer_seed, site_seed, step_seed)

__all__ = ["GPTConfig", "GPTTrainer", "block_shapes", "flatten_params",
           "layer_norm", "top_shapes"]


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


class _LayerNorm(torch.autograd.Function):
    """The reference's ``_layer_norm`` (f32 statistics, ``(xhat * g +
    b)`` rounded to x's dtype) with an explicit backward that saves
    only x and the per-row mean and rstd: autograd of the plain
    formula would keep three f32 copies of x per call."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        y, mean, rstd = _ln_fwd(x, g, b, eps)
        ctx.save_for_backward(x, g, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*_ln_bwd(*ctx.saved_tensors, dy), None)


def _ln_fwd(x, g, b, eps: float = 1e-5):
    """LayerNorm's output and its per-row f32 mean and rstd."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return ((xf - mean) * rstd * g + b).to(x.dtype), mean, rstd


def _ln_bwd(x, g, mean, rstd, dy):
    """LayerNorm's ``(dx, dg, db)`` from x and the saved row statistics."""
    xhat = (x.float() - mean) * rstd
    dyf = dy.float()
    lead = tuple(range(x.dim() - 1))
    dg = (dyf * xhat).sum(lead)
    db = dyf.sum(lead)
    dxhat = dyf * g.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dg.to(g.dtype), db.to(g.dtype)


def layer_norm(x, g, b, eps: float = 1e-5):
    """LayerNorm over the last dim with f32 statistics (``gpt.py:1530``)."""
    return _LayerNorm.apply(x, g, b, eps)


# leaves of one block in the order _Int8Block takes them
_BLOCK_KEYS = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_g",
               "ln2_b", "win", "bin", "wout", "bout")


def _sum_lead(t):
    """A bias gradient: ``t`` summed over every dim but the last."""
    return t.sum(tuple(range(t.dim() - 1)))


class _Int8Block(torch.autograd.Function):
    """One pre-LN block of the ``quant8="wgrad"`` recipe (``_block``
    :819 with ``fuse_gelu_quant``) with an explicit backward.

    Forward: LN1, qkv = int8(h1 @ wqkv) + bqkv, packed flash attention
    (out, lse), xm = x + attn @ wproj + bproj, LN2, a = int8(h2 @ win) +
    bin (``ffn1_out``), y = xm + int8(gelu(a) @ wout) + bout. It saves
    the block input, qkv, out, lse and a; with ``save_main`` that is all
    (the reference's policy, :1021), without it also h1, xm, h2 and the
    two LayerNorms' row statistics. The backward recomputes what was not
    saved (LN1, the wproj product with its residual add, LN2), then runs
    the int8 backward of each site, the flash backward and the
    LayerNorm backwards. ``seed`` is the layer's int seed."""

    @staticmethod
    def forward(ctx, x, seed, num_heads, save_main, *leaves):
        w = dict(zip(_BLOCK_KEYS, leaves))
        h1, mean1, rstd1 = _ln_fwd(x, w["ln1_g"], w["ln1_b"])
        qkv = int8_matmul(h1, w["wqkv"]) + w["bqkv"]
        scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * num_heads))
        out, lse = flash_qkv_packed_fwd(qkv, num_heads, True, scale)
        xm = x + out.reshape(x.shape[:-1] + (-1,)) @ w["wproj"] \
            + w["bproj"]
        h2, mean2, rstd2 = _ln_fwd(xm, w["ln2_g"], w["ln2_b"])
        a = int8_matmul(h2, w["win"]) + w["bin"]
        y = xm + int8_matmul(a, w["wout"], "gelu") + w["bout"]
        kept = () if save_main else (h1, mean1, rstd1, xm, h2, mean2, rstd2)
        ctx.save_for_backward(x, qkv, out, lse, a, *kept, *leaves)
        ctx.seed, ctx.num_heads, ctx.scale = seed, num_heads, scale
        ctx.save_main = save_main
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        x, qkv, out, lse, a = saved[:5]
        w = dict(zip(_BLOCK_KEYS, saved[-len(_BLOCK_KEYS):]))
        attn = out.reshape(x.shape[:-1] + (-1,))
        if ctx.save_main:
            h1, mean1, rstd1 = _ln_fwd(x, w["ln1_g"], w["ln1_b"])
            xm = x + attn @ w["wproj"] + w["bproj"]
            h2, mean2, rstd2 = _ln_fwd(xm, w["ln2_g"], w["ln2_b"])
        else:
            h1, mean1, rstd1, xm, h2, mean2, rstd2 = saved[5:12]
        s1, s2, s3 = (site_seed(ctx.seed, k) for k in (1, 2, 3))
        g = {"bout": _sum_lead(dy)}
        da, g["wout"] = int8_gelu_linear_all8_bwd(a, w["wout"], s3, dy)
        g["bin"] = _sum_lead(da)
        dh2, g["win"] = int8_linear_all8_bwd(h2, w["win"], s2, da)
        dxm, g["ln2_g"], g["ln2_b"] = _ln_bwd(xm, w["ln2_g"], mean2, rstd2,
                                              dh2)
        dxm = dy + dxm
        g["bproj"] = _sum_lead(dxm)
        D = dxm.shape[-1]
        g["wproj"] = attn.reshape(-1, attn.shape[-1]).t() \
            @ dxm.reshape(-1, D)
        dqkv = flash_qkv_packed_bwd(qkv, out, lse, dxm @ w["wproj"].t(),
                                    ctx.num_heads, True, ctx.scale)
        g["bqkv"] = _sum_lead(dqkv)
        dh1, g["wqkv"] = int8_linear_all8_bwd(h1, w["wqkv"], s1, dqkv)
        dx, g["ln1_g"], g["ln1_b"] = _ln_bwd(x, w["ln1_g"], mean1, rstd1,
                                             dh1)
        return (dxm + dx, None, None, None, *(g[k] for k in _BLOCK_KEYS))


def _not_ported(what: str, slice_: str):
    raise NotImplementedError(
        f"GPTTrainer: {what} is not in this slice of the port ({slice_})")


class GPTTrainer:
    """Functional GPT pretraining step on one device: the port of
    ``paddle_tpu.models.gpt.GPTSpmdTrainer`` with a single-device mesh,
    ``layer_unroll="full"``, the packed flash-attention path and the
    fused AdamW kernel.

    ``master_dtype=bfloat16`` stores the masters at compute precision
    and updates them with stochastic rounding (the flagship recipe);
    float32 masters are cast to ``cfg.dtype`` inside the step and take
    f32 gradients and exact updates. ``quant8="wgrad"``, ``moment8``
    and ``remat="save_main"`` are the flagship's int8 matmuls, int8
    moments and selective remat (see the module docstring). ``params``
    (a dict in the reference's layout, e.g. from ``models.convert``)
    replaces the random initialisation."""

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
                 int8_guard_period: int = 0, device=None,
                 params: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None):
        if quant8 and quant8 != "wgrad":
            _not_ported(f"quant8={quant8!r}", "a later trainer slice; "
                        "quant8='wgrad' is ported")
        if remat and remat != "save_main":
            _not_ported(f"remat={remat!r}", "a later trainer slice; "
                        "remat='save_main' is ported")
        if remat and quant8 != "wgrad":
            _not_ported("remat='save_main' without quant8='wgrad'",
                        "a later trainer slice")
        if int8_guard_period:
            _not_ported("int8_guard_period", "a later trainer slice")
        if fuse_gelu_quant and quant8 != "wgrad":
            raise ValueError(
                "fuse_gelu_quant rides the all-int8 recipe: it needs "
                "quant8='wgrad'")
        if quant8 == "wgrad" and fuse_gelu_quant is False:
            _not_ported("quant8='wgrad' with fuse_gelu_quant=False",
                        "a later trainer slice; the ffn2 site fuses gelu")
        if ce_int8 or fuse_ln_quant or fuse_bwd_colq:
            _not_ported("ce_int8, fuse_ln_quant and fuse_bwd_colq",
                        "a later trainer slice (kernel rows 10 and 11)")
        if moe_experts:
            _not_ported("moe_experts", "MoE slice")
        if pipeline_schedule != "gpipe" or microbatches not in (None, 1):
            _not_ported("pipeline schedules and microbatches",
                        "multi-GPU training slice")
        if not fused_optimizer:
            _not_ported("the unfused optimizer", "this slice runs the "
                        "fused AdamW kernel on every leaf")
        if layer_unroll != "full":
            _not_ported(f"layer_unroll={layer_unroll!r}",
                        "the port keeps per-layer parameters only")
        if cfg.dropout:
            _not_ported("dropout", "the reference trainer has none")
        self.cfg = cfg
        self.quant8, self.remat, self.moment8 = quant8, remat, bool(moment8)
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
        self._leaves = [p for _, p in flatten_params(params)]
        for p in self._leaves:
            p.requires_grad_(True)
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

    def _attn_sublayer(self, x, bp):
        """ln1 + qkv + attention + proj + residual on ``[B, T, D]``,
        attention straight off the packed projection (the reference's
        hsplit path)."""
        dt = x.dtype
        h = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
        qkv = h @ bp["wqkv"].to(dt) + bp["bqkv"].to(dt)
        attn = flash_attention_qkv_fused(qkv, self.cfg.num_heads,
                                         causal=True)
        return x + attn @ bp["wproj"].to(dt) + bp["bproj"].to(dt)

    def _block(self, x, bp, seed=None):
        """One block; ``seed`` is the layer's SR seed in int8 mode."""
        dt = x.dtype
        if self.quant8 == "wgrad":
            leaves = [bp[k] if k.startswith("ln") else bp[k].to(dt)
                      for k in _BLOCK_KEYS]
            return _Int8Block.apply(x, seed, self.cfg.num_heads,
                                    self.remat == "save_main", *leaves)
        x = self._attn_sublayer(x, bp)
        h = layer_norm(x, bp["ln2_g"], bp["ln2_b"])
        a = TF.gelu(h @ bp["win"].to(dt) + bp["bin"].to(dt),
                    approximate="tanh")
        return x + a @ bp["wout"].to(dt) + bp["bout"].to(dt)

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
            vocab_major=vm)

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
        with torch.no_grad():
            for i, (p, g, m, v) in enumerate(zip(
                    self._leaves, grads, self.opt_state["m"],
                    self.opt_state["v"])):
                if isinstance(m, tuple):      # int8 moments (moment8)
                    fused_adamw_update8(p, g, *m, *v, scalars, leaf_id=i,
                                        **hp)
                else:
                    fused_adamw_update(p, g, m, v, scalars, leaf_id=i, **hp)
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

    def train_step(self, input_ids, labels) -> torch.Tensor:
        """One AdamW step on a ``[B, T]`` batch; returns the loss (a
        0-dim tensor on the device, before the update)."""
        loss, grads = self.loss_and_grads(input_ids, labels)
        self._adamw(grads)
        return loss

    def n_params(self) -> int:
        return sum(p.numel() for p in self._leaves)

