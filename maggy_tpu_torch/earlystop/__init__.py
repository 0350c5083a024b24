from maggy_tpu_torch.earlystop.abstractearlystop import AbstractEarlyStop
from maggy_tpu_torch.earlystop.medianrule import MedianStoppingRule
from maggy_tpu_torch.earlystop.nostop import NoStoppingRule

__all__ = ["AbstractEarlyStop", "MedianStoppingRule", "NoStoppingRule"]
