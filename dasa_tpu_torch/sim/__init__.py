from dasa_tpu_torch.sim.graph import ScanGraph, load_scan_graph, clear_graph_cache  # noqa: F401
from dasa_tpu_torch.sim.engine import (  # noqa: F401
    BatchSim,
    SimState,
    Viewpoint,
    Simulator,
)
