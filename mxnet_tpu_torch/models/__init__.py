"""Models of the port."""
from . import bert, dlrm, factorization
from .bert import BertConfig, bert_forward, bert_init, bert_mlm_loss
from .convert import (gluon_params_from_jax, opt_state_from_jax,
                      params_from_jax)
from .dlrm import DLRMConfig, dlrm_forward, dlrm_init, dlrm_loss
from .llama import CONFIGS, LlamaConfig, llama_forward, llama_init, llama_loss

__all__ = ["CONFIGS", "BertConfig", "DLRMConfig", "LlamaConfig", "bert",
           "bert_forward", "bert_init", "bert_mlm_loss", "dlrm",
           "dlrm_forward", "dlrm_init", "dlrm_loss", "factorization",
           "gluon_params_from_jax",
           "llama_forward", "llama_init", "llama_loss", "opt_state_from_jax",
           "params_from_jax"]
