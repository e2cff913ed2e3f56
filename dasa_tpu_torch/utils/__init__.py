from dasa_tpu_torch.utils.angles import (  # noqa: F401
    ELEVATION_INC,
    HEADING_COUNT,
    NUM_VIEWS,
    angle_feature,
    all_point_angle_feature,
    point_angle_feature,
    view_elevation,
    view_heading,
    view_index,
)
from dasa_tpu_torch.utils.vocab import (  # noqa: F401
    BASE_VOCAB,
    PAD_IDX,
    Tokenizer,
    build_vocab,
    read_vocab,
    write_vocab,
)
from dasa_tpu_torch.utils.misc import Timer, length2mask, set_seed  # noqa: F401
