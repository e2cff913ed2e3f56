from dasa_tpu_torch.data.datasets import (  # noqa: F401
    load_datasets,
    expand_instructions,
    generate_synthetic_dataset,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB, load_feature_db  # noqa: F401
