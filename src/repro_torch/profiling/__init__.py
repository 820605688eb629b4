"""Measured-profile calibration of the port: the sim-to-silicon loop.

Everything the simulator reports is derived from the analytic roofline
in ``core/perf_model.py``. This package closes the loop against the
port's serving stack: ``harness.py`` times the prefill/decode dispatch
path of ``serving.PodEngine`` (and, optionally, the CUDA kernels against
their ``kernels/ref.py`` plain versions) across a deterministic (arch,
batch, sm, quota, GPU type) grid, and ``table.py`` turns the emitted
calibration table into a latency source that
``core.capacity.CapacityTable`` can consume in place of the roofline.

CLI entry point: ``python -m repro_torch.profiling``.
"""
from repro_torch.profiling.harness import (SCHEMA, GridSpec, ProfilePoint,
                                           build_grid, check_report,
                                           error_summary, profile_kernels,
                                           run_profile, windowed_wall)
from repro_torch.profiling.table import CalibrationTable

__all__ = ["SCHEMA", "GridSpec", "ProfilePoint", "build_grid",
           "check_report", "error_summary", "profile_kernels",
           "run_profile", "windowed_wall", "CalibrationTable"]
