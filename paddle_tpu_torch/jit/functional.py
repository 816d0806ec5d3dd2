"""``TrainStep``: forward, backward and optimizer update in one call.

Counterpart of ``paddle_tpu/jit/functional.py`` ``TrainStep`` (:73-231),
which traces the three into one jitted XLA program. PyTorch runs them
eagerly here: ``TrainStep(model, opt, loss_fn)(x, labels)`` runs the
model (BatchNorm's running statistics update in place, as the
reference's new buffers are written back), the loss, ``backward()`` and the optimizer's update of every
parameter with a gradient, and returns the loss. It is not a CUDA graph
in this slice (launch overhead is a later slice's, with the graphs).
Under ``amp.auto_cast`` the layers read the AMP state during the
forward, as the reference's ops do while it traces.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable,
                 num_labels: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.num_labels = num_labels      # trailing batch entries -> loss

    def __call__(self, *batch):
        inputs, labels = self._split(batch)
        out = self.model(*inputs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        loss = self.loss_fn(*outs, *labels)
        comps = loss if isinstance(loss, (tuple, list)) else [loss]
        total = comps[0]
        for extra in comps[1:]:
            total = total + extra
        self.optimizer.clear_grad()
        total.backward()
        self.optimizer.step()
        return total.detach()

    def _split(self, batch) -> Tuple[tuple, tuple]:
        n = min(self.num_labels, max(len(batch) - 1, 0))
        if n == 0:
            return tuple(batch), ()
        return tuple(batch[:-n]), tuple(batch[-n:])
