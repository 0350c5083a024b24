"""Ablation studies: the study spec and the LOCO ablator (``ablator/``)."""

from maggy_tpu_torch.ablation.ablationstudy import AblationStudy, Features, Layers, Model

__all__ = ["AblationStudy", "Features", "Layers", "Model"]
