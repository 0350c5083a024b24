"""Distributed training on a mesh of ranks (``maggy_tpu/parallel``'s
counterpart): ``make_mesh`` and ``ShardingEnv`` (mesh.py), the
parameter, batch and ZeRO sharding rules (sharding.py), ring and Ulysses
sequence parallelism on the flash kernels (ring_attention.py, ulysses.py)
and every exchange between ranks (collectives.py), and ``slice_mesh``, a
gang's mesh (``gang.py``). ``pipeline.py`` and expert parallelism are not
ported yet (ROADMAP queue 1 item 8)."""

from maggy_tpu_torch.parallel.mesh import ShardingEnv, make_mesh, slice_mesh, split_sequence
from maggy_tpu_torch.parallel.ring_attention import ring_attention
from maggy_tpu_torch.parallel.sharding import (batch_sharding, param_placements,
                                               param_sharding, shard_params)
from maggy_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["ShardingEnv", "make_mesh", "slice_mesh", "split_sequence", "shard_params", "batch_sharding",
           "param_sharding", "param_placements", "ring_attention", "ulysses_attention"]
