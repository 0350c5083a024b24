from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv
from maggy_tpu_torch.core.environment.singleton import EnvSing

__all__ = ["LocalEnv", "EnvSing"]
