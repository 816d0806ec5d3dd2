"""Load the reference's weights into the port: Llama and GPT models and
the GPT trainer.

``llama_from_jax_state`` takes the reference model's ``state_dict()``
as numpy arrays (``{name: np.asarray(t)}``; the caller converts, so
this module never imports the reference) and returns a
``LlamaForCausalLM`` of the port holding the same weights, so both
compute the same function. The module trees and names match one to
one; the only layout change is the linear weights: the reference's
``Linear`` stores ``[in, out]`` (``paddle_tpu/nn/layer/common.py``),
``torch.nn.Linear`` stores ``[out, in]``, so every ``*_proj.weight``
and ``lm_head.weight`` is transposed. ``Embedding`` keeps
``[vocab, hidden]``. Names or shapes that do not match raise.
A weight-only quantized reference model (``weight_only_int4`` or
``weight_only_int8``) carries across too: each linear whose state holds
``<name>.wq`` and ``<name>.w_scale`` becomes an ``Int4Linear`` (packed
``uint8`` codes; the group read off the shapes) or an ``Int8Linear``
(``int8`` codes, dynamic activation scales: the reference keeps a static
scale outside its state) holding those codes and scales as they are, no
re-quantization; both packages lay them out ``[in, out]``, so nothing of
theirs is transposed.

``gpt_lm_from_jax_state`` does the same for the reference's
``GPTForCausalLM``: ``qkv``, ``proj``, ``fc1``, ``fc2`` and ``lm_head``
weights are transposed; biases, ``wte``, ``wpe`` and the LayerNorms
stay as they are; weight-only quantized linears carry across with their
biases.

``gpt_trainer_from_jax_params`` takes ``GPTSpmdTrainer.params`` as
numpy and returns a ``GPTTrainer`` holding them (``gpt_params_from_numpy``
gives the tree alone, for ``trainer.params = ...``); both packages keep
matmul weights ``[in, out]``, so only names and shapes are checked.
Trainer options (``quant8``, ``moment8``, ``remat``, ...) pass through,
and ``np_opt_state`` (``GPTSpmdTrainer.opt_state`` as numpy) replaces
the fresh AdamW state: the step, and per leaf the moments, arrays or,
for the leaves with int8 moments (``moment8``), ``(q, scale)`` pairs.
``gpt_params_to_numpy`` and ``gpt_opt_state_to_numpy`` are the inverses.

``resnet_from_jax_state`` takes a reference ResNet's ``state_dict()``
(parameters and BatchNorm's ``_mean``/``_variance``, as numpy) and
returns the port's model of that architecture holding it (or loads it
into a ``model`` given, e.g. one cut to fewer blocks). The module trees
and names match one to one and both keep ``Linear`` ``[in, out]``, so
nothing is transposed; each tensor keeps the reference's dtype (bf16
after ``amp.decorate``, f32 for BatchNorm). ``resnet_state_to_numpy``
is the inverse (bf16 as f32 numpy). ``momentum_from_numpy`` /
``momentum_to_numpy`` carry the Momentum velocities the same way, keyed
by the model's parameter names.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..quantization import Int4Linear, Int8Linear
from .gpt import (GPTConfig, GPTForCausalLM, GPTTrainer, block_shapes,
                  flatten_params, top_shapes)
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["gpt_lm_from_jax_state", "gpt_opt_state_to_numpy",
           "gpt_params_from_numpy",
           "gpt_params_to_numpy", "gpt_trainer_from_jax_params",
           "llama_from_jax_state",
           "momentum_from_numpy", "momentum_to_numpy",
           "resnet_from_jax_state", "resnet_state_to_numpy"]


def _np32(arr) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)      # numpy-side bf16 (ml_dtypes)
    return a


def _is_llama_linear_weight(name: str) -> bool:
    return name.endswith("_proj.weight") or name == "lm_head.weight"


_GPT_LINEARS = (".qkv.weight", ".proj.weight", ".fc1.weight", ".fc2.weight")


def _is_gpt_linear_weight(name: str) -> bool:
    return name.endswith(_GPT_LINEARS) or name == "lm_head.weight"


def _swap_quantized(model: torch.nn.Module, np_state) -> None:
    """Replace each linear that ``np_state`` holds as weight-only codes
    (``<name>.wq``, ``<name>.w_scale``) by the quantized layer holding
    them; a name that is no linear of the model, a missing scale, an
    unknown code dtype or a shape off the linear's raises."""
    for name in sorted(n[:-3] for n in np_state if n.endswith(".wq")):
        linear = model.get_submodule(name)
        if not isinstance(linear, torch.nn.Linear):
            raise KeyError(f"{name}.wq: {name} is no linear of the model")
        wq = torch.tensor(np.asarray(np_state[name + ".wq"]))
        scale = torch.tensor(_np32(np_state[name + ".w_scale"]))
        kinds = {torch.uint8: Int4Linear, torch.int8: Int8Linear}
        if wq.dtype not in kinds:
            raise ValueError(f"{name}.wq: codes of dtype {wq.dtype}; "
                             f"expected uint8 (int4) or int8")
        layer = kinds[wq.dtype].from_codes(wq, scale, linear.bias)
        if (layer.in_features, layer.out_features) != (
                linear.in_features, linear.out_features):
            raise ValueError(
                f"{name}: codes for a {layer.in_features} x "
                f"{layer.out_features} weight; the model's linear is "
                f"{linear.in_features} x {linear.out_features}")
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent), child,
                layer.to(linear.weight.device))


def _load_lm(model, np_state, is_linear_weight):
    """``model`` holding ``np_state``: quantized linears swapped in, the
    ``[in, out]`` linear weights transposed, every name and shape
    checked by a strict load."""
    _swap_quantized(model, np_state)
    state = {}
    for name, arr in np_state.items():
        t = torch.tensor(_np32(arr))        # a copy the model owns
        state[name] = t.t() if is_linear_weight(name) else t
    model.load_state_dict(state, strict=True)
    model.eval()
    return model


def llama_from_jax_state(np_state: Dict[str, np.ndarray], cfg: LlamaConfig,
                         device=None, dtype=None) -> LlamaForCausalLM:
    return _load_lm(LlamaForCausalLM(cfg, device=device, dtype=dtype),
                    np_state, _is_llama_linear_weight)


def gpt_lm_from_jax_state(np_state: Dict[str, np.ndarray], cfg: GPTConfig,
                          device=None, dtype=None) -> GPTForCausalLM:
    """A ``GPTForCausalLM`` holding the reference ``GPTForCausalLM``'s
    ``state_dict()`` (as numpy; bf16 as the numpy-side bf16 or f32)."""
    return _load_lm(GPTForCausalLM(cfg, device=device, dtype=dtype),
                    np_state, _is_gpt_linear_weight)


def _take(src: dict, shapes: dict, where: str, device, dtype,
          lead=None) -> dict:
    """The leaves ``shapes`` names, from ``src``, as tensors; refuses a
    missing or extra name and a wrong shape (a missed transpose of a
    non-square weight). ``lead=(L, i)``: stacked ``[1, L, ...]`` leaves,
    layer ``i``."""
    if set(src) != set(shapes):
        raise KeyError(f"{where}: names {sorted(src)} are not "
                       f"{sorted(shapes)}")
    out = {}
    for name, shape in shapes.items():
        a = _np32(src[name])
        want = shape if lead is None else (1, lead[0]) + shape
        if a.shape != want:
            raise ValueError(f"{where}.{name}: shape {a.shape}, expected "
                             f"{want} (weights are [in, out])")
        if lead is not None:
            a = a[0, lead[1]]
        out[name] = torch.tensor(a, dtype=dtype, device=device)
    return out


def gpt_params_from_numpy(np_params: Dict, cfg: GPTConfig, device=None,
                          dtype=None) -> Dict:
    """The reference trainer's parameters as the port's tree of tensors
    (``GPTTrainer(params=...)``, or ``trainer.params = ...``).

    ``np_params``: ``GPTSpmdTrainer.params`` as numpy (``jax.tree.map(
    np.asarray, trainer.params)``), with ``blocks`` either per layer
    (``layer_NNN`` dicts, ``layer_unroll="full"``) or stacked (each
    leaf ``[1, L, ...]``). Matmul weights are ``[in, out]`` in both
    packages, so nothing is transposed; names and shapes must match
    exactly. ``dtype`` is the master dtype (default float32)."""
    master = resolve_dtype(dtype)
    dev = resolve_device(device)
    top = {k: v for k, v in np_params.items() if k != "blocks"}
    if "blocks" not in np_params:
        raise KeyError("np_params has no 'blocks'")
    params = _take(top, top_shapes(cfg), "params", dev, master)
    blocks = np_params["blocks"]
    L = cfg.num_layers
    names = [f"layer_{i:03d}" for i in range(L)]
    if set(blocks) == set(names):
        params["blocks"] = {n: _take(blocks[n], block_shapes(cfg),
                                     f"blocks.{n}", dev, master)
                            for n in names}
    else:
        params["blocks"] = {n: _take(blocks, block_shapes(cfg), "blocks",
                                     dev, master, lead=(L, i))
                            for i, n in enumerate(names)}
    return params


def gpt_trainer_from_jax_params(np_params: Dict, cfg: GPTConfig,
                                device=None, dtype=None, np_opt_state=None,
                                **trainer_kwargs) -> GPTTrainer:
    """A ``GPTTrainer`` holding the reference trainer's parameters
    (``np_params`` as ``gpt_params_from_numpy`` takes them; ``dtype`` the
    master dtype, default float32). ``np_opt_state``: the reference's
    ``opt_state`` as numpy (``{"step", "m", "v"}``, ``m``/``v`` trees
    shaped like ``np_params`` with per layer ``blocks``, int8-moment
    leaves as ``(q, scale)`` pairs); other keyword arguments go to
    ``GPTTrainer``."""
    dev = resolve_device(device)
    trainer = GPTTrainer(cfg, device=dev, master_dtype=resolve_dtype(dtype),
                         params=gpt_params_from_numpy(np_params, cfg, dev,
                                                      dtype),
                         **trainer_kwargs)
    if np_opt_state is not None:
        trainer.opt_state = _opt_state_from_numpy(np_opt_state, trainer)
    return trainer


def _moment_leaves(tree) -> list:
    """A moment tree's leaves in flatten order, ``(q, scale)`` pairs
    kept whole (the reference flattens with ``is_leaf=tuple``)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            out.append(node)
    walk(tree)
    return out


def _opt_state_from_numpy(np_opt_state: Dict, trainer: GPTTrainer) -> Dict:
    """The reference's opt_state as the port's: a moment for every leaf,
    of the trainer's kind (an int8 ``(q, scale)`` pair exactly where the
    trainer keeps one) and the leaf's shape."""
    state = {"step": int(np.asarray(np_opt_state["step"]))}
    paths = [path for path, _ in flatten_params(trainer.params)]
    for key in ("m", "v"):
        leaves = _moment_leaves(np_opt_state[key])
        if len(leaves) != len(paths):
            raise ValueError(f"opt_state[{key!r}] has {len(leaves)} leaves; "
                             f"the trainer has {len(paths)}")
        moments = []
        for path, have, want in zip(paths, leaves, trainer.opt_state[key]):
            if isinstance(want, tuple) != isinstance(have, tuple):
                raise ValueError(
                    f"opt_state[{key!r}] {path}: int8 (q, scale) pairs on "
                    f"one side only; build the trainer with the "
                    f"reference's moment8 setting")
            pair = have if isinstance(have, tuple) else (have,)
            ref = want if isinstance(want, tuple) else (want,)
            got = []
            for a, t in zip(pair, ref):
                a = np.asarray(a)
                if a.shape != tuple(t.shape):
                    raise ValueError(f"opt_state[{key!r}] {path}: shape "
                                     f"{a.shape}, expected "
                                     f"{tuple(t.shape)}")
                if t.dtype != torch.int8:
                    a = _np32(a)
                got.append(torch.tensor(a, dtype=t.dtype, device=t.device))
            moments.append(tuple(got) if isinstance(want, tuple) else got[0])
        state[key] = moments
    return state


def gpt_opt_state_to_numpy(trainer: GPTTrainer) -> Dict:
    """The inverse of ``np_opt_state``: the trainer's AdamW state in the
    reference's layout (``blocks`` per layer), moments as f32 numpy and
    int8-moment leaves as ``(int8 codes, f32 scales)`` pairs."""
    def np_(t):
        t = t.detach().cpu()
        return t.numpy() if t.dtype == torch.int8 else t.float().numpy()
    out = {"step": np.int32(trainer.opt_state["step"])}
    paths = [path for path, _ in flatten_params(trainer.params)]
    for key in ("m", "v"):
        tree: Dict = {}
        for path, mom in zip(paths, trainer.opt_state[key]):
            *parents, leaf = path.split(".")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = tuple(np_(t) for t in mom) \
                if isinstance(mom, tuple) else np_(mom)
        out[key] = tree
    return out


def gpt_params_to_numpy(params: Dict, layout: str = "per_layer") -> Dict:
    """The inverse of ``gpt_trainer_from_jax_params``: a trainer's
    parameters as f32 numpy in the reference's layout, ``blocks`` per
    layer or ``"stacked"`` (``[1, L, ...]`` leaves)."""
    def np_(t):
        return t.detach().float().cpu().numpy()
    out = {k: np_(v) for k, v in params.items() if k != "blocks"}
    layers = [params["blocks"][n] for n in sorted(params["blocks"])]
    if layout == "per_layer":
        out["blocks"] = {n: {k: np_(v) for k, v in params["blocks"][n]
                             .items()} for n in sorted(params["blocks"])}
    elif layout == "stacked":
        out["blocks"] = {k: np.stack([np_(bp[k]) for bp in layers])[None]
                         for k in layers[0]}
    else:
        raise ValueError(f"layout must be 'per_layer' or 'stacked'; got "
                         f"{layout!r}")
    return out


def _tensor(arr, device) -> torch.Tensor:
    """A tensor of ``arr`` on ``device`` in its dtype (numpy-side bf16,
    from ml_dtypes, comes back as torch bf16)."""
    a = np.asarray(arr)
    t = torch.tensor(_np32(a), device=device)
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t


def resnet_from_jax_state(np_state: Dict[str, np.ndarray],
                          arch: str = "resnet50", device=None, model=None,
                          **kwargs):
    """The port's ``arch`` (``vision.models.resnet50`` ...; ``kwargs``
    pass through), or ``model`` when given, holding the reference
    state ``np_state``; a missing or extra name or a wrong shape
    raises."""
    if model is None:
        from ..vision import models as vision_models
        model = getattr(vision_models, arch)(device=device, **kwargs)
    own = model.state_dict(keep_vars=True)
    if set(own) != set(np_state):
        raise KeyError(f"state names differ: missing "
                       f"{sorted(set(own) - set(np_state))}, extra "
                       f"{sorted(set(np_state) - set(own))}")
    for name, t in own.items():
        arr = np.asarray(np_state[name])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {arr.shape}, the model's "
                             f"{tuple(t.shape)}")
        t.data = _tensor(arr, t.device)
    return model


def resnet_state_to_numpy(model) -> Dict[str, np.ndarray]:
    """The inverse of ``resnet_from_jax_state``: a copy of the model's
    state as numpy (bf16 tensors as f32)."""
    return {name: np.array((t.detach().float() if t.dtype == torch.bfloat16
                            else t.detach()).cpu())
            for name, t in model.state_dict().items()}


def momentum_from_numpy(opt, model, np_velocity: Dict[str, np.ndarray]):
    """Set ``opt``'s (a ``Momentum``) velocity of each parameter that
    ``np_velocity`` names (the model's parameter names)."""
    params = dict(model.named_parameters())
    for name, arr in np_velocity.items():
        p = params[name]
        if tuple(np.shape(arr)) != tuple(p.shape):
            raise ValueError(f"{name}: velocity shape {np.shape(arr)}, the "
                             f"parameter's {tuple(p.shape)}")
        opt._accumulators.setdefault(p, {})["velocity"] = _tensor(arr,
                                                                  p.device)
    return opt


def momentum_to_numpy(opt, model) -> Dict[str, np.ndarray]:
    """A copy of ``opt``'s velocities by parameter name, as numpy (bf16
    as f32)."""
    out = {}
    for name, p in model.named_parameters():
        vel = opt._accumulators.get(p, {}).get("velocity")
        if vel is not None:
            out[name] = np.array(vel.detach().float().cpu())
    return out
