"""``auto_cast`` and ``decorate``: the reference's O1/O2 mixed precision.

Counterpart of ``paddle_tpu/amp/auto_cast.py``. The reference casts
inside ``apply_op`` (``maybe_autocast_inputs`` :51-76): under O2 every
f32 input of every op goes down to the low dtype, except the ops of
``BLACK_LIST`` (:29-34), whose bf16/f16 inputs go up to f32; under O1
only ``WHITE_LIST`` ops (:21-26) go down. ``torch.autocast`` casts by
other rules, so it is not used: the port's layers call
``autocast_inputs(op_name, ...)`` at the places where the reference's
``apply_op`` casts, reading the same thread-local state.
``decorate(level="O2")`` casts every parameter to the low dtype except
those of layers whose class name contains a ``_FP32_KEEP_LAYERS`` name
(:110-129): BatchNorm's weight, bias (and its buffers, which are not
parameters) stay f32. Parameters are cast in place (``p.data``), so an
optimizer built before ``decorate`` keeps its references.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

from .._device import resolve_dtype

__all__ = ["BLACK_LIST", "WHITE_LIST", "auto_cast", "autocast_inputs",
           "decorate"]

# ops whose inputs go down to the low dtype under O1 (the reference's
# FP16_WHITE_LIST: matmul-class and conv-class)
WHITE_LIST: Set[str] = {
    "matmul", "bmm", "mm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "sdpa", "flash_attention", "flash_attn_unpadded",
}

# ops forced to float32 under O1 and O2 (numerically sensitive)
BLACK_LIST: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "kl_div",
    "binary_cross_entropy", "bce_with_logits", "mse_loss", "l1_loss",
    "mean", "sum", "p_norm", "cumsum", "logsumexp", "erf", "erfinv",
    "layer_norm", "bn_stats", "batch_norm", "group_norm", "rms_norm",
    "softmax_with_cross_entropy", "sigmoid_focal_loss",
}

_LOW = (torch.float16, torch.bfloat16)
_state = threading.local()


class _AmpState:
    __slots__ = ("enable", "dtype", "level")

    def __init__(self, enable: bool, dtype: torch.dtype, level: str):
        self.enable = enable
        self.dtype = dtype
        self.level = level


def amp_state() -> Optional[_AmpState]:
    return getattr(_state, "amp", None)


def autocast_inputs(op_name: str, *tensors):
    """The inputs of op ``op_name`` as the reference's ``apply_op`` casts
    them under the current ``auto_cast`` (a tuple; ``None`` entries pass
    through): black-listed ops take bf16/f16 up to f32; under O2 every
    other op, under O1 a white-listed one, takes f32 down to the low
    dtype; outside ``auto_cast`` nothing changes."""
    st = amp_state()
    if st is None or not st.enable or st.level not in ("O1", "O2"):
        return tensors
    if op_name in BLACK_LIST:
        return tuple(t.float() if t is not None and t.dtype in _LOW else t
                     for t in tensors)
    if op_name == "cast":
        return tensors
    if st.level == "O2" or op_name in WHITE_LIST:
        return tuple(t.to(st.dtype)
                     if t is not None and t.dtype == torch.float32 else t
                     for t in tensors)
    return tensors


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype="bfloat16", use_promote: bool = True):
    """``paddle.amp.auto_cast``: within the block the port's layers cast
    their inputs by ``level`` (O0, O1 or O2) and ``dtype``."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0/O1/O2, got {level}")
    added_w, added_b = set(), set()
    if custom_white_list:
        added_w = set(custom_white_list) - WHITE_LIST
        WHITE_LIST.update(added_w)
    if custom_black_list:
        added_b = set(custom_black_list) - BLACK_LIST
        BLACK_LIST.update(added_b)
    prev = amp_state()
    _state.amp = _AmpState(enable and level != "O0", resolve_dtype(dtype),
                           level)
    try:
        yield
    finally:
        _state.amp = prev
        WHITE_LIST.difference_update(added_w)
        BLACK_LIST.difference_update(added_b)


_FP32_KEEP_LAYERS = ("BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
                     "RMSNorm")


def decorate(models, optimizers=None, level: str = "O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad: bool = False):
    """O2: cast the models' f32 parameters to ``dtype`` in place, except
    those of norm layers (no master weights: the optimizer updates the
    low-precision parameters, as the reference's Momentum does). O1
    leaves the models as they are. Returns ``models`` or ``(models,
    optimizers)``, as the reference."""
    if level == "O1":
        return (models, optimizers) if optimizers is not None else models
    low = resolve_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    with torch.no_grad():
        for model in model_list:
            for layer in model.modules():
                if any(k in type(layer).__name__ for k in _FP32_KEEP_LAYERS):
                    continue
                for p in layer.parameters(recurse=False):
                    if p.dtype == torch.float32:
                        p.data = p.data.to(low)
    if optimizers is not None:
        return models, optimizers
    return models
