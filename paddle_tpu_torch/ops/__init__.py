"""Kernels of the port, each beside its plain PyTorch version.

Counterpart of ``paddle_tpu/ops`` for the kernels ported so far:
``flash_attention`` (``pallas_ops.py`` ``_fa_forward``, ``_fa_backward``,
``_fa_forward_qkvpacked``, ``_fa_backward_hsplit``), ``fused_adamw``
(``fused_adamw.py`` ``fused_adamw_update`` and ``fused_adamw_update8``,
whose kernels each take a list of leaves in one launch)
and ``quant_matmul`` (``quant_matmul.py`` ``_rowq_call``, ``_colq_call``,
``_rowq_ln_call``, ``_sr_colq_ln_pallas``, ``_sr_colq_pallas`` and the
int8 linears over ``torch._int_mm``) and ``int4_matmul``
(``int4_matmul.py`` ``int4_matmul``, the weight-only int4 matmul, with
its torch quantizers; imported from its module, whose name it shares)
and ``batch_norm`` (``bn_pallas.py`` ``_stats_call``, ``_apply_call``,
``_gsum_call``, ``_dx_call`` and ``bn_train``); ``fused_ce`` is the
reference's
chunked cross-entropy (plain or int8 matmuls) and ``layer_norm`` the
trainer's LayerNorm (plain PyTorch).
``_build`` compiles ``csrc/*.cu`` with ``nvcc`` on first use.
"""
from .flash_attention import (flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_fwd_plain,
                              flash_attention_qkv_fused)
from .batch_norm import bn_train
from .fused_adamw import (AdamW8Leaves, AdamWLeaves, fused_adamw_update,
                          fused_adamw_update8, fused_adamw_update8_leaves,
                          fused_adamw_update8_plain,
                          fused_adamw_update_leaves, fused_adamw_update_plain)
from .fused_ce import fused_softmax_cross_entropy
from .layer_norm import layer_norm
from .quant_matmul import (int8_gelu_linear_all8, int8_linear,
                           int8_linear_all8, int8_linear_dgrad8,
                           int8_ln_linear_all8, ln_quantize_rowwise,
                           quantize_cols, quantize_rows, sr_quantize_colwise,
                           sr_quantize_colwise_ln)

__all__ = ["AdamW8Leaves", "AdamWLeaves", "bn_train", "flash_attention_bwd",
           "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_qkv_fused", "fused_adamw_update",
           "fused_adamw_update8", "fused_adamw_update8_leaves",
           "fused_adamw_update8_plain",
           "fused_adamw_update_leaves", "fused_adamw_update_plain",
           "fused_softmax_cross_entropy",
           "int8_gelu_linear_all8", "int8_linear", "int8_linear_all8",
           "int8_linear_dgrad8", "int8_ln_linear_all8", "layer_norm",
           "ln_quantize_rowwise", "quantize_cols", "quantize_rows",
           "sr_quantize_colwise", "sr_quantize_colwise_ln"]
