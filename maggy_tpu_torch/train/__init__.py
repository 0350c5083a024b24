from maggy_tpu_torch.train.lora import is_lora_param, lora_adapter_count, only_lora
from maggy_tpu_torch.train.optim import adamw, warmup_cosine_decay_schedule
from maggy_tpu_torch.train.trainer import Trainer, cross_entropy_loss

__all__ = ["Trainer", "adamw", "cross_entropy_loss", "is_lora_param", "lora_adapter_count",
           "only_lora", "warmup_cosine_decay_schedule"]
