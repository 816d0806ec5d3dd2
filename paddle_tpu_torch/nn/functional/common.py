"""``linear`` and ``relu``.

Counterpart of ``paddle_tpu/nn/functional/common.py`` ``linear`` (:19:
``x @ W + b`` with Paddle's ``[in, out]`` weight, two ops as the
reference writes them) and ``activation.py`` ``relu`` (:22), each with
the reference's ``auto_cast`` input casts.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import autocast_inputs

__all__ = ["linear", "relu"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias``; ``weight`` is ``[in, out]``."""
    x, weight, bias = autocast_inputs("linear", x, weight, bias)
    out = x @ weight
    return out if bias is None else out + bias


def relu(x, name=None):
    (x,) = autocast_inputs("relu", x)
    return torch.relu(x)
