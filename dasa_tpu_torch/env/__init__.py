from dasa_tpu_torch.env.obs import Obs  # noqa: F401
from dasa_tpu_torch.env.r2r_env import R2REnv  # noqa: F401
