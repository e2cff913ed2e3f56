from dasa_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    make_mesh,
    rank_seed,
)
