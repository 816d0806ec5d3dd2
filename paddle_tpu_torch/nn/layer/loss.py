"""``CrossEntropyLoss`` (counterpart of ``paddle_tpu/nn/layer/loss.py``
:13), over ``functional.cross_entropy``."""
from __future__ import annotations

from torch import nn

from ..functional.loss import cross_entropy

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 axis: int = -1, use_softmax: bool = True,
                 label_smoothing: float = 0.0, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label,
                        axis=axis, use_softmax=use_softmax,
                        label_smoothing=label_smoothing)

    def forward(self, input, label):
        return cross_entropy(input, label, **self._kw)
