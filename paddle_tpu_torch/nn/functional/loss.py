"""Cross entropy with hard labels.

Counterpart of ``paddle_tpu/nn/functional/loss.py`` ``cross_entropy``
(:27): ``log_softmax`` in f32 (the reference casts the logits to f32,
and ``cross_entropy`` is on the AMP black list), the picked log
probability of each hard label, ``ignore_index`` rows masked, and the
mean over the rows that are not ignored (at least 1), the sum, or no
reduction. Soft labels, label smoothing, class weights and
``use_softmax=False`` raise ``NotImplementedError``: no path of the
port needs them yet; they belong to the slice that ports a model
trained with them.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import autocast_inputs

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    if soft_label or label_smoothing > 0.0 or weight is not None \
            or not use_softmax or label.is_floating_point():
        raise NotImplementedError(
            "cross_entropy with soft labels, label smoothing, class weights "
            "or use_softmax=False is not ported yet (a later slice, with the "
            "model trained with it); hard integer labels only")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean/sum/none; got "
                         f"{reduction!r}")
    (logits,) = autocast_inputs("cross_entropy", input)
    axis = axis % logits.dim()
    lp = torch.log_softmax(logits.float(), dim=axis)
    idx = label.squeeze(axis) if label.dim() == logits.dim() else label
    idx = idx.long()
    mask = idx != ignore_index
    safe = torch.where(mask, idx, torch.zeros_like(idx))
    picked = lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(mask, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(mask.float().sum(), 1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
