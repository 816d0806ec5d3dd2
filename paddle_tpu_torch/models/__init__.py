"""Models of the port (counterpart of ``paddle_tpu/models``): Llama, the
GPT trainer, and the converters that load the reference's weights."""
from .convert import (gpt_opt_state_to_numpy, gpt_params_to_numpy,
                      gpt_trainer_from_jax_params, llama_from_jax_state)
from .gpt import GPTConfig, GPTTrainer
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel, llama_tiny_config

__all__ = ["GPTConfig", "GPTTrainer", "LlamaConfig", "LlamaForCausalLM",
           "LlamaModel", "gpt_opt_state_to_numpy", "gpt_params_to_numpy",
           "gpt_trainer_from_jax_params",
           "llama_from_jax_state", "llama_tiny_config"]
