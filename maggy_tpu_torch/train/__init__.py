from maggy_tpu_torch.train.data import ShardedBatchIterator, prefetch_iterator
from maggy_tpu_torch.train.lora import is_lora_param, lora_adapter_count, only_lora
from maggy_tpu_torch.train.optim import (adam, adamw, swept_transform,
                                         warmup_cosine_decay_schedule)
from maggy_tpu_torch.train.trainer import Trainer, cross_entropy_loss
from maggy_tpu_torch.train.vmap import VmapTrainer, rebind_hyperparams_stacked, stack_trees
from maggy_tpu_torch.train.warm import clear_warm, warm_cache

__all__ = ["ShardedBatchIterator", "Trainer", "VmapTrainer", "adam", "adamw", "clear_warm",
           "cross_entropy_loss", "is_lora_param", "lora_adapter_count", "only_lora",
           "prefetch_iterator", "rebind_hyperparams_stacked", "stack_trees",
           "swept_transform", "warm_cache", "warmup_cosine_decay_schedule"]
