from maggy_tpu_torch.ablation.ablator.abstractablator import AbstractAblator
from maggy_tpu_torch.ablation.ablator.loco import LOCO

__all__ = ["AbstractAblator", "LOCO"]
