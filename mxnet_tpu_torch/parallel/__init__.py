"""Attention kernels, the functional trainer and its checkpoints (whole,
sharded, coordinated and ZeRO), and the
multi-rank layer: rendezvous (`dist`), meshes of ranks (`mesh`), sharding
rules (`sharding`), collectives over process groups (`collectives`) and
ring attention over a ``seq`` group."""
from . import dist
from .checkpoint import (latest_committed_step, latest_step,
                         restore_sharded, restore_train_state,
                         restore_zero_state, save_sharded, save_train_state,
                         save_zero_state)
from .collectives import (all_gather, all_reduce, allreduce_bench, barrier,
                          ppermute, reduce_scatter)
from .dist import initialize, is_initialized, num_workers, rank
from .flash_attention import (flash_attention, paged_attention,
                              paged_attention_chunk)
from .mesh import (Mesh, MeshConfig, auto_mesh, create_mesh, current_mesh,
                   local_mesh, mesh_scope)
from .ring_attention import ring_attention
from .sharding import (BERT_RULES, LLAMA_RULES, P, ShardingRules,
                       logical_to_spec, replicate_pytree, shard_pytree)
from .train_step import ShardedTrainStep, adam_init, sgd_init

__all__ = ["flash_attention", "paged_attention", "paged_attention_chunk",
           "ShardedTrainStep", "adam_init", "sgd_init", "save_sharded",
           "restore_sharded", "latest_committed_step", "save_train_state",
           "restore_train_state", "save_zero_state", "restore_zero_state",
           "latest_step", "dist", "initialize",
           "is_initialized", "rank", "num_workers", "Mesh", "MeshConfig",
           "create_mesh", "current_mesh", "local_mesh", "mesh_scope",
           "auto_mesh", "ShardingRules", "LLAMA_RULES", "BERT_RULES", "P",
           "shard_pytree", "replicate_pytree", "logical_to_spec",
           "all_reduce", "all_gather", "reduce_scatter", "ppermute",
           "barrier", "allreduce_bench", "ring_attention"]
