from repro_torch.serving.batcher import Batcher, InferenceRequest
from repro_torch.serving.engine import PodEngine
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.libhas import (LibHas, MemoryBudgetExceeded,
                                       StepFootprint, measure_footprint)

__all__ = ["Batcher", "InferenceRequest", "PodEngine", "Gateway", "LibHas",
           "MemoryBudgetExceeded", "StepFootprint", "measure_footprint"]
