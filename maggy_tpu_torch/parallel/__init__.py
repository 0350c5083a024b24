"""Distributed training on a mesh of ranks (``maggy_tpu/parallel``'s
counterpart): ``make_mesh`` and ``ShardingEnv`` (mesh.py), the
parameter, batch and ZeRO sharding rules and the placements from the
models' logical axes (sharding.py), parameters held as shards and read
through fsdp gathers or tp and ep blocks (sharded.py), ring and Ulysses
sequence parallelism on the flash kernels (ring_attention.py,
ulysses.py), GPipe and 1F1B pipeline parallelism (pipeline.py), every
exchange between ranks (collectives.py), and ``slice_mesh``, a gang's mesh
(``gang.py``)."""

from maggy_tpu_torch.parallel.mesh import ShardingEnv, make_mesh, slice_mesh, split_sequence
from maggy_tpu_torch.parallel.ring_attention import ring_attention
from maggy_tpu_torch.parallel.pipeline import (PipelinedLM, pipeline_1f1b_grads,
                                               pipeline_apply, stage_param_sharding)
from maggy_tpu_torch.parallel.sharding import (batch_sharding, logical_placements,
                                               param_placements, param_sharding, shard_params,
                                               shard_state_dict)
from maggy_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["ShardingEnv", "make_mesh", "slice_mesh", "split_sequence", "shard_params", "batch_sharding",
           "param_sharding", "param_placements", "ring_attention", "ulysses_attention",
           "logical_placements", "shard_state_dict", "pipeline_apply", "pipeline_1f1b_grads",
           "stage_param_sharding", "PipelinedLM"]
