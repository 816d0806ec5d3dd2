"""Initial weights of the port's layers, drawn from an explicit
``torch.Generator`` (counterpart of the initializers the reference's
layers name, ``paddle_tpu/nn/initializer.py``): the same distributions,
not the same numbers (JAX's keys and torch's generators differ; the
tests copy weights across with ``models/convert.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..._device import resolve_device

__all__ = ["default_generator", "kaiming_uniform", "uniform",
           "xavier_normal"]


def default_generator(device, generator: Optional[torch.Generator]
                      ) -> torch.Generator:
    """``generator``, or a fresh one on ``device`` seeded with 0."""
    if generator is not None:
        return generator
    return torch.Generator(device=resolve_device(device)).manual_seed(0)


def uniform(shape, low: float, high: float, device, generator):
    """f32 uniform in [low, high) (``I.Uniform``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(low, high, generator=generator)


def kaiming_uniform(shape, fan_in: int, device, generator):
    """``I.KaimingUniform(fan_in)`` with the relu gain: uniform in
    ±sqrt(2) * sqrt(3 / fan_in)."""
    limit = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
    return uniform(shape, -limit, limit, device, generator)


def xavier_normal(shape, device, generator):
    """``I.XavierNormal`` of a ``[fan_in, fan_out]`` weight."""
    std = math.sqrt(2.0 / (shape[0] + shape[1]))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=generator)
