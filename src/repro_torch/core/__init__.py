"""HAS-GPU core in the port: the paper's contribution.

vGPU spatio-temporal allocation, the time-token scheduler, the GPU
Re-configurator, Kalman workload prediction, hybrid auto-scaling
(Algorithm 1), the baseline policies and the discrete-event cluster
simulator, copied from the JAX package's ``core/`` (numpy on the host in
both packages). It exports what the JAX package's ``core`` exports except
``TickClusterSimulator``, that package's own parity reference. RaPP, the
learned latency predictor, is ``repro_torch.core.rapp``, imported on its
own as in the JAX package.
"""
from repro_torch.configs.gpus import (DEFAULT_GPU_TYPE, GPU_TYPES, GPUType,
                                      get_gpu_type)
from repro_torch.core.autoscaler import (AutoScalerConfig, HybridAutoScaler,
                                         ScalingAction)
from repro_torch.core.baselines import (FaSTGShareLikeConfig,
                                        FaSTGShareLikePolicy,
                                        KServeLikeConfig, KServeLikePolicy)
from repro_torch.core.capacity import CapacityTable, shared_table
from repro_torch.core.faults import (FaultInjector, FaultModel,
                                     HealthTracker, ResilienceConfig)
from repro_torch.core.kalman import KalmanPredictor, LastValuePredictor
from repro_torch.core.metrics import RunMetrics, baseline_batch_of
from repro_torch.core.modelstate import (ColdStartModel, LifecycleConfig,
                                         ModelStateTracker, NodeWeightCache,
                                         WeightState)
from repro_torch.core.perf_model import (FnSpec, cost_rate, exec_time,
                                         latency, most_efficient_config,
                                         slo_baseline, throughput)
from repro_torch.core.events import EventEngine, FunctionState
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.scheduler import FleetPlacer
from repro_torch.core.simulator import ClusterSimulator, SimConfig, SimResult
from repro_torch.core.simulator_tick import TickClusterSimulator
from repro_torch.core.vgpu import (DEFAULT_WINDOW_MS, TOTAL_SLICES, Partition,
                                   PodAlloc, VirtualGPU)

__all__ = [
    "AutoScalerConfig", "HybridAutoScaler", "ScalingAction",
    "FaSTGShareLikeConfig", "FaSTGShareLikePolicy",
    "KServeLikeConfig", "KServeLikePolicy",
    "CapacityTable", "shared_table",
    "FaultInjector", "FaultModel", "HealthTracker", "ResilienceConfig",
    "KalmanPredictor", "LastValuePredictor",
    "RunMetrics", "baseline_batch_of",
    "FnSpec", "cost_rate", "exec_time", "latency", "most_efficient_config",
    "slo_baseline", "throughput",
    "Reconfigurator", "ClusterSimulator", "SimConfig", "SimResult",
    "EventEngine", "FunctionState", "TickClusterSimulator",
    "DEFAULT_WINDOW_MS", "TOTAL_SLICES", "Partition", "PodAlloc",
    "VirtualGPU",
    "GPUType", "GPU_TYPES", "DEFAULT_GPU_TYPE", "get_gpu_type",
    "FleetPlacer",
    "ColdStartModel", "LifecycleConfig", "ModelStateTracker",
    "NodeWeightCache", "WeightState",
]
