"""Models of the port (counterpart of ``paddle_tpu/models``): Llama, GPT
(the serving model and the trainer), and the converters that load the
reference's weights (the ResNets live in ``vision.models``)."""
from .convert import (gpt_lm_from_jax_state, gpt_opt_state_to_numpy,
                      gpt_params_from_numpy, gpt_params_to_numpy,
                      gpt_trainer_from_jax_params, llama_from_jax_state,
                      momentum_from_numpy, momentum_to_numpy,
                      resnet_from_jax_state, resnet_state_to_numpy)
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM, GPTModel, GPTTrainer
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel, llama_tiny_config

__all__ = ["GPTBlock", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTTrainer", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "gpt_lm_from_jax_state", "gpt_opt_state_to_numpy",
           "gpt_params_from_numpy",
           "gpt_params_to_numpy",
           "gpt_trainer_from_jax_params", "llama_from_jax_state",
           "llama_tiny_config", "momentum_from_numpy", "momentum_to_numpy",
           "resnet_from_jax_state", "resnet_state_to_numpy"]
