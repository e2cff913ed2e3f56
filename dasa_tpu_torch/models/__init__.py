from dasa_tpu_torch.models.policy import (  # noqa: F401
    DasaPolicy,
    DecoderState,
    StepInputs,
    bert_config_from,
)
from dasa_tpu_torch.models.bert import BertConfig, DicModel  # noqa: F401
from dasa_tpu_torch.models.encoder import (  # noqa: F401
    DicEncoder,
    EncoderLSTM,
)
from dasa_tpu_torch.models.decoder import (  # noqa: F401
    AttnDecoderLSTM,
    BAttnDecoderLSTM,
    Critic,
)
