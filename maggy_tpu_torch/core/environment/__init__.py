from maggy_tpu_torch.core.environment.abstractenvironment import (AbstractEnv, GCSEnv,
                                                                 LocalEnv, is_remote)
from maggy_tpu_torch.core.environment.singleton import EnvSing

__all__ = ["AbstractEnv", "GCSEnv", "LocalEnv", "EnvSing", "is_remote"]
