from dasa_tpu_torch.train.evaluation import Evaluation  # noqa: F401
