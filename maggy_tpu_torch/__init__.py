"""maggy_tpu_torch: the PyTorch/CUDA port of maggy_tpu.

Asynchronous hyperparameter optimization whose trials train PyTorch models
on NVIDIA GPUs, with the JAX package's Pallas TPU kernels rewritten as CUDA
kernels for Hopper. The JAX package ``maggy_tpu`` is the reference; this
package imports nothing of it.
"""

__version__ = "0.1.0"

from maggy_tpu_torch.config import (AblationConfig, DistributedConfig, LagomConfig,
                                    OptimizationConfig)
from maggy_tpu_torch.gang import GangSpec
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial

__all__ = ["AblationConfig", "DistributedConfig", "Searchspace", "Trial", "LagomConfig",
           "OptimizationConfig", "GangSpec"]
