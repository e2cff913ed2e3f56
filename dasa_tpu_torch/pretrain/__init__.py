from dasa_tpu_torch.pretrain.data import (  # noqa: F401
    PretrainBatcher,
    generate_pretrain_records,
    mask_tokens,
)
from dasa_tpu_torch.pretrain.model import (  # noqa: F401
    DicAddActionPreTrain,
    DicPMActionPreTrain,
)
