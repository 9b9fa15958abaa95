"""Models of the port."""
from .convert import opt_state_from_jax, params_from_jax
from .llama import CONFIGS, LlamaConfig, llama_forward, llama_init, llama_loss

__all__ = ["CONFIGS", "LlamaConfig", "llama_forward", "llama_init",
           "llama_loss", "opt_state_from_jax", "params_from_jax"]
