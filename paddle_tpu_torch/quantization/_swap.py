"""Shared module-swap traversal for the weight-only quantizers.

Counterpart of ``paddle_tpu/quantization/_swap.py`` over ``nn.Module``
children.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

from torch import nn

__all__ = ["swap_layers"]


def swap_layers(model: nn.Module,
                factory: Callable[[nn.Module], Optional[nn.Module]],
                inplace: bool = True) -> nn.Module:
    """Replace submodules bottom-up: ``factory(child)`` returns the
    replacement or None to recurse into the child instead. One traversal
    shared by ``weight_only_int8`` and ``weight_only_int4``, so their
    contract cannot diverge: ``inplace=False`` swaps in a deep copy and
    leaves ``model`` as it was."""
    if not inplace:
        model = copy.deepcopy(model)
    for name, child in list(model._modules.items()):
        if child is None:
            continue
        repl = factory(child)
        if repl is not None:
            model._modules[name] = repl
        else:
            swap_layers(child, factory, inplace=True)
    return model
