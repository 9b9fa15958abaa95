"""Models of the port."""
from . import bert
from .bert import BertConfig, bert_forward, bert_init, bert_mlm_loss
from .convert import (gluon_params_from_jax, opt_state_from_jax,
                      params_from_jax)
from .llama import CONFIGS, LlamaConfig, llama_forward, llama_init, llama_loss

__all__ = ["CONFIGS", "BertConfig", "LlamaConfig", "bert", "bert_forward",
           "bert_init", "bert_mlm_loss", "gluon_params_from_jax",
           "llama_forward", "llama_init", "llama_loss", "opt_state_from_jax",
           "params_from_jax"]
