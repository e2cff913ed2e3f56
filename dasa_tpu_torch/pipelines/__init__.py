from dasa_tpu_torch.pipelines.depth_features import featurize_views  # noqa: F401
