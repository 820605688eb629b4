"""A copy of the JAX package's ``workloads/__init__.py``, imports
rewritten; ``tests/test_torch_control_plane.py`` holds the code after
this docstring equal to it."""
from repro_torch.workloads.azure import (TraceConfig, arrivals, rate_series,
                                   standard_workload, stress_workload)
from repro_torch.workloads.generators import (diurnal, flash_crowd,
                                        homogeneous_poisson,
                                        inhomogeneous_poisson, mmpp, ramp,
                                        superpose, thin, time_shift)

__all__ = ["TraceConfig", "arrivals", "rate_series", "standard_workload",
           "stress_workload", "homogeneous_poisson", "inhomogeneous_poisson",
           "diurnal", "mmpp", "flash_crowd", "ramp", "superpose", "thin",
           "time_shift"]
