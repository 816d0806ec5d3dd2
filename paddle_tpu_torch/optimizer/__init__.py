"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``):
``Momentum`` for the ResNet path; the GPT trainer's AdamW lives in
``models/gpt.py`` over ``ops/fused_adamw.py``."""
from .optimizer import Momentum, Optimizer

__all__ = ["Momentum", "Optimizer"]
