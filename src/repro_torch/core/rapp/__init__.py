"""RaPP in the port: the operator-graph extractor over the port's own
models, the GAT latency predictor, its dataset and its training loop.
Imports nothing of the JAX package; exports what its ``core.rapp``
exports."""
from repro_torch.core.rapp.predictor import RaPPConfig, RaPPModel, init_params
from repro_torch.core.rapp import dataset, features, train

__all__ = ["RaPPConfig", "RaPPModel", "init_params", "dataset", "features",
           "train"]
