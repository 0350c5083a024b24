from maggy_tpu_torch.train.data import (ShardedBatchIterator, drop_feature,
                                        feature_dropping_generator, load_path_dataset,
                                        prefetch_iterator)
from maggy_tpu_torch.train.lora import is_lora_param, lora_adapter_count, only_lora
from maggy_tpu_torch.train.optim import (adam, adamw, sgd, swept_transform,
                                         warmup_cosine_decay_schedule)
from maggy_tpu_torch.train.registry import DatasetRegistry
from maggy_tpu_torch.train.trainer import Trainer, cross_entropy_loss
from maggy_tpu_torch.train.vmap import VmapTrainer, rebind_hyperparams_stacked, stack_trees
from maggy_tpu_torch.train.warm import clear_warm, warm_cache

__all__ = ["DatasetRegistry", "ShardedBatchIterator", "Trainer", "VmapTrainer", "adam", "adamw",
           "clear_warm", "cross_entropy_loss", "drop_feature", "feature_dropping_generator",
           "is_lora_param", "load_path_dataset", "lora_adapter_count", "only_lora",
           "prefetch_iterator", "rebind_hyperparams_stacked", "sgd", "stack_trees",
           "swept_transform", "warm_cache", "warmup_cosine_decay_schedule"]
