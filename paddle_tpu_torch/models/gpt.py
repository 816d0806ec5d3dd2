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
from ..ops.flash_attention import flash_attention_qkv_fused
from ..ops.fused_adamw import fused_adamw_update
from ..ops.fused_ce import fused_softmax_cross_entropy

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
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, g, mean, rstd)
        return ((xf - mean) * rstd * g + b).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, g, mean, rstd = ctx.saved_tensors
        xhat = (x.float() - mean) * rstd
        dyf = dy.float()
        lead = tuple(range(x.dim() - 1))
        dg = (dyf * xhat).sum(lead)
        db = dyf.sum(lead)
        dxhat = dyf * g.float()
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), dg.to(g.dtype), db.to(g.dtype), None


def layer_norm(x, g, b, eps: float = 1e-5):
    """LayerNorm over the last dim with f32 statistics (``gpt.py:1530``)."""
    return _LayerNorm.apply(x, g, b, eps)


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
    f32 gradients and exact updates. ``params`` (a dict in the
    reference's layout, e.g. from ``models.convert``) replaces the
    random initialisation."""

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
        if quant8:
            _not_ported(f"quant8={quant8!r}", "next trainer slice")
        if moment8:
            _not_ported("moment8", "next trainer slice")
        if remat is not False:
            _not_ported(f"remat={remat!r}", "next trainer slice")
        if int8_guard_period:
            _not_ported("int8_guard_period", "next trainer slice")
        if moe_experts:
            _not_ported("moe_experts", "MoE slice")
        if pipeline_schedule != "gpipe" or microbatches not in (None, 1):
            _not_ported("pipeline schedules and microbatches",
                        "multi-GPU training slice")
        if ce_int8 or fuse_gelu_quant or fuse_ln_quant or fuse_bwd_colq:
            _not_ported("ce_int8 and the fuse_* int8 options",
                        "next trainer slice")
        if not fused_optimizer:
            _not_ported("the unfused optimizer", "this slice runs the "
                        "fused AdamW kernel on every leaf")
        if layer_unroll != "full":
            _not_ported(f"layer_unroll={layer_unroll!r}",
                        "the port keeps per-layer parameters only")
        if cfg.dropout:
            _not_ported("dropout", "the reference trainer has none")
        self.cfg = cfg
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
        self.opt_state = {
            "step": 0,
            "m": [torch.zeros_like(p, dtype=self.moment_dtype)
                  for p in self._leaves],
            "v": [torch.zeros_like(p, dtype=self.moment_dtype)
                  for p in self._leaves]}

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

    def _block(self, x, bp):
        dt = x.dtype
        x = self._attn_sublayer(x, bp)
        h = layer_norm(x, bp["ln2_g"], bp["ln2_b"])
        a = TF.gelu(h @ bp["win"].to(dt) + bp["bin"].to(dt),
                    approximate="tanh")
        return x + a @ bp["wout"].to(dt) + bp["bout"].to(dt)

    def _forward_loss(self, params, input_ids, labels):
        cfg = self.cfg
        x = self._embed(params["wte"], params["wpe"], input_ids)
        for key in sorted(params["blocks"]):
            x = self._block(x, params["blocks"][key])
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
        with torch.no_grad():
            for i, (p, g, m, v) in enumerate(zip(
                    self._leaves, grads, self.opt_state["m"],
                    self.opt_state["v"])):
                fused_adamw_update(
                    p, g, m, v, scalars, lr=self.lr, wd=self.wd, b1=b1,
                    b2=b2, eps=1e-8, stoch_round=self._stoch_round,
                    leaf_id=i, seed=step)
        self.opt_state["step"] = step

    # -- public step -------------------------------------------------------
    def loss_and_grads(self, input_ids, labels):
        """The step's loss and the gradient of every leaf (flatten
        order), without the optimizer update."""
        ids, lab = (torch.as_tensor(t).to(self.device, torch.long)
                    for t in (input_ids, labels))
        for p in self._leaves:
            p.grad = None
        loss = self._forward_loss(self.params, ids, lab)
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

