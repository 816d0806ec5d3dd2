"""``Optimizer`` (minimal) and ``Momentum``.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (:25-199) as the
reference's ``TrainStep`` drives it (``jit/functional.py`` :117-140):
the learning rate an f32 scalar, one update per parameter with a
gradient, the state one velocity per parameter. Momentum keeps the
reference's dtype flow exactly (``_momentum_update`` :172-181, measured
on its jitted step): the velocity is ``zeros_like(p)`` (bf16 for the
weights ``amp.decorate`` cast, f32 for BatchNorm's), the gradient is
cast to ``p.dtype``, ``mu`` (a Python float) meets the velocity in the
velocity's dtype (so 0.9 is 0.8984375 in bf16) and ``mu * vel`` is
rounded there; the new velocity is ``mu * vel + g`` rounded once more,
while the parameter takes the unrounded f32 sum: ``p - lr * (mu * vel +
g)`` in f32, rounded to ``p.dtype``. There are no master weights: with
lr 0.01 many bf16 updates round away, as in the reference. Plain torch:
the reference has no kernel here. Weight decay, gradient clipping and
LR schedulers are not ported (a later slice).
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch

__all__ = ["Momentum", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate: float = 0.001,
                 parameters: Iterable[torch.nn.Parameter] = None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if weight_decay or grad_clip is not None:
            raise NotImplementedError(
                "weight_decay and grad_clip are not ported to this "
                "optimizer yet (a later slice)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("an LR scheduler is not ported yet; "
                                      "pass a float")
        self._parameter_list = list(parameters)
        self._learning_rate = float(learning_rate)
        self._accumulators: Dict[torch.nn.Parameter,
                                 Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    def _acc(self, p, name: str) -> torch.Tensor:
        slot = self._accumulators.setdefault(p, {})
        if name not in slot:
            slot[name] = torch.zeros_like(p, memory_format=torch.
                                          contiguous_format)
        return slot[name]

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient."""
        self._step_count += 1
        for p in self._parameter_list:
            if p.grad is not None and p.requires_grad:
                self._update_param(p, p.grad)

    def _update_param(self, p, g) -> None:
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None


class Momentum(Optimizer):
    def __init__(self, learning_rate: float = 0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = float(momentum)
        self._use_nesterov = use_nesterov

    def _update_param(self, p, g) -> None:
        vel = self._acc(p, "velocity")
        g = g.to(p.dtype)
        # mu as the reference's weak-typed scalar: in the velocity's dtype
        mu = torch.tensor(self._momentum, dtype=vel.dtype).item()
        mv = vel * mu                                  # rounded to vel
        vel_new = mv.float() + g.float()               # f32, unrounded
        vel.copy_(vel_new)                             # rounded to vel
        if self._use_nesterov:
            upd = g.float() + (vel * mu).float()
        else:
            upd = vel_new
        p.copy_(p.float() - self._learning_rate * upd)
