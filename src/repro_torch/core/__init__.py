"""The port's share of the HAS-GPU core: vGPU allocation, the time-token
scheduler and the roofline physics that the serving path charges by."""
from repro_torch.core.perf_model import FnSpec, exec_time, latency, throughput
from repro_torch.core.scheduler import GPUClient, HASGPUScheduler, TokenLedger
from repro_torch.core.vgpu import (DEFAULT_WINDOW_MS, TOTAL_SLICES, Partition,
                                   PodAlloc, VirtualGPU)

__all__ = ["FnSpec", "exec_time", "latency", "throughput", "GPUClient",
           "HASGPUScheduler", "TokenLedger", "DEFAULT_WINDOW_MS",
           "TOTAL_SLICES", "Partition", "PodAlloc", "VirtualGPU"]
