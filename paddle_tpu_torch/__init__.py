"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside ``paddle_tpu`` (the JAX/TPU reference, which
stays unchanged). Plain tensor code is PyTorch; every Pallas kernel of
the reference on a ported path is a CUDA kernel written by hand for
Hopper (``csrc/``, built with ``nvcc`` for ``sm_90a`` on first use).

The port imports ``torch`` and never ``jax`` or ``paddle_tpu``; only its
tests import both. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, which selects each kernel's plain
PyTorch version (the CPU tests' path).

This first slice serves Llama through the continuous-batching engine:

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    model = LlamaForCausalLM(cfg, dtype="bfloat16")      # on cuda
    engine = ServingEngine(model, kv_layout="contiguous", max_slots=16)
    req = engine.submit(prompt_ids, max_new_tokens=64)
    engine.run()

Later slices train GPT (``models.gpt.GPTTrainer``), serve weight-only
int4/int8 models (``quantization``), and train ResNet-50 with AMP O2
(``vision.models.resnet50``, ``amp``, ``optimizer.Momentum``,
``jit.TrainStep``).
"""
from ._device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
