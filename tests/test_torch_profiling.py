"""The port's profiling harness, calibration table and capacity table
against the JAX package's (``tests/test_profiling.py`` and
``tests/test_capacity.py`` twinned on both packages), plus cross-package
checks: the port's CPU smoke report passes the JAX gate against the JAX
package's committed reference, both packages' tables give bitwise-equal
lattices and searches, and the port's new modules import neither ``jax``
nor ``repro``. No assertion depends on CPU timing."""
import ast
import copy
import importlib
import importlib.util
import json
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.profiling import check_report as jax_check_report
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.profiling import harness as port_harness
from repro_torch.profiling.__main__ import (H100_GRID, REF_CPU, REF_H100,
                                            SMOKE_GRID, main)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_REF_CPU = REPO / "benchmarks" / "ref_profile_cpu.json"


def _package(root):
    """The names these tests use, from ``root`` (``repro`` or
    ``repro_torch``)."""
    mods = {name: importlib.import_module(f"{root}.{name}") for name in (
        "configs", "configs.gpus", "core.perf_model", "core.capacity",
        "core.vgpu", "profiling", "profiling.harness")}
    prof = mods["profiling"]
    return types.SimpleNamespace(
        root=root, ARCHS=mods["configs"].ARCHS,
        reduced=mods["configs"].reduced,
        GPU_TYPES=mods["configs.gpus"].GPU_TYPES,
        get_gpu_type=mods["configs.gpus"].get_gpu_type,
        perf_model=mods["core.perf_model"],
        FnSpec=mods["core.perf_model"].FnSpec,
        CapacityTable=mods["core.capacity"].CapacityTable,
        shared_table=mods["core.capacity"].shared_table,
        TOTAL_SLICES=mods["core.vgpu"].TOTAL_SLICES,
        SCHEMA=prof.SCHEMA, GridSpec=prof.GridSpec,
        build_grid=prof.build_grid, check_report=prof.check_report,
        error_summary=prof.error_summary,
        windowed_wall=prof.windowed_wall,
        CalibrationTable=prof.CalibrationTable,
        prompt_len=mods["profiling.harness"].prompt_len)


JAX = _package("repro")
PORT = _package("repro_torch")
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


def _pt(arch, gpu, batch, sm, quota, phase, measured, analytic=1e-3):
    return {"arch": arch, "gpu": gpu, "batch": batch, "sm": sm,
            "quota": quota, "phase": phase, "measured_s": measured,
            "analytic_s": analytic,
            "rel_err": abs(measured - analytic) / max(analytic, 1e-12)}


def _report(pkg, points, seq=32, reduced_flag=True, smoke=True):
    return {"schema": pkg.SCHEMA, "smoke": smoke,
            "meta": {"backend": "cpu", "device_kind": "cpu",
                     "torch_version": "0", "reduced": reduced_flag,
                     "seq": seq, "window_ms": 20.0, "warmup": 1,
                     "iters": 3, "grid": pkg.GridSpec().grid_meta()},
            "points": points, "error": pkg.error_summary(points)}


def _load(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# grid + analytic twins (test_profiling.py, on both packages)
# ---------------------------------------------------------------------------

@BOTH
def test_build_grid_deterministic_order_and_device_width(pkg):
    spec = pkg.GridSpec(archs=("olmo-1b",), gpu_types=("t4",),
                        batches=(2, 1), sms=(2, 8), quotas=(1.0,))
    pts = pkg.build_grid(spec)
    assert pts == pkg.build_grid(spec)
    assert [(p.batch, p.sm, p.phase) for p in pts] == [
        (2, 2, "prefill"), (2, 2, "decode"),
        (1, 2, "prefill"), (1, 2, "decode")]
    assert all(p.gpu == "t4" and p.quota == 1.0 for p in pts)


@BOTH
def test_build_grid_rejects_unknown_arch(pkg):
    with pytest.raises(KeyError):
        pkg.build_grid(pkg.GridSpec(archs=("no-such-arch",)))


@BOTH
def test_windowed_wall_matches_latency_quantization(pkg):
    spec = pkg.FnSpec(pkg.ARCHS["olmo-1b"])
    for batch, sm, q in ((2, 4, 0.3), (1, 8, 0.7), (4, 2, 1.0)):
        t = pkg.perf_model.exec_time(spec, batch, sm)
        assert pkg.windowed_wall(t, q, 0.1) == pkg.perf_model.latency(
            spec, batch, sm, q)
    assert pkg.windowed_wall(0.42, 1.0, 0.1) == 0.42


@BOTH
def test_error_summary_percentiles(pkg):
    pts = [_pt("a", "v5e", 1, 2, 1.0, "prefill", m, analytic=1.0)
           for m in (1.0, 2.0, 3.0, 4.0)]
    s = pkg.error_summary(pts)
    assert s["overall"]["p50"] == pytest.approx(1.5)
    assert s["overall"]["n"] == 4
    assert set(s["per_arch"]) == {"a"}


# ---------------------------------------------------------------------------
# the CI gate
# ---------------------------------------------------------------------------

def _base_reports(pkg):
    vals = iter(range(1, 9))
    pts = [_pt("olmo-1b", "v5e", 1, sm, q, phase, next(vals) * 1e-3)
           for sm in (2, 4) for q in (0.5, 1.0)
           for phase in ("prefill", "decode")]
    ref = _report(pkg, pts)
    return copy.deepcopy(ref), ref


@BOTH
def test_check_report_identical_passes(pkg):
    new, ref = _base_reports(pkg)
    assert pkg.check_report(new, ref) == []


@BOTH
def test_check_report_uniform_machine_speed_is_cancelled(pkg):
    new, ref = _base_reports(pkg)
    for p in new["points"]:
        p["measured_s"] *= 7.0
    assert pkg.check_report(new, ref) == []


@BOTH
@pytest.mark.parametrize("mutate,expect", [
    (lambda r: r.update(schema="other/v0"), "schema mismatch"),
    (lambda r: r["meta"].update(seq=64), "meta.seq mismatch"),
    (lambda r: r["points"].reverse(), "point set/order drifted"),
    (lambda r: r["points"][2].update(analytic_s=9.9), "analytic drift"),
    (lambda r: r["points"][3].update(measured_s=4e3),
     "measured-shape drift"),
])
def test_check_report_failures(pkg, mutate, expect):
    new, ref = _base_reports(pkg)
    mutate(new)
    failures = pkg.check_report(new, ref)
    assert any(expect in f for f in failures), failures


# ---------------------------------------------------------------------------
# CalibrationTable
# ---------------------------------------------------------------------------

def _surface_report(pkg):
    vals = {(2, 0.5): 0.01, (2, 1.0): 0.02, (4, 0.5): 0.03,
            (4, 1.0): 0.04}
    pts = [_pt("olmo-1b", "v5e", 1, sm, q, "prefill", m)
           for (sm, q), m in sorted(vals.items())]
    pts.append(_pt("olmo-1b", "v5e", 1, 2, 0.5, "decode", 999.0))
    return _report(pkg, pts)


@BOTH
def test_calibration_table_exact_and_interpolated_lookup(pkg):
    tab = pkg.CalibrationTable(_surface_report(pkg))
    assert len(tab) == 1
    assert tab.latency("olmo-1b", 1, 2, 0.5) == pytest.approx(0.01)
    assert tab.latency("olmo-1b", 1, 4, 1.0) == pytest.approx(0.04)
    assert tab.latency("olmo-1b", 1, 3, 0.5) == pytest.approx(0.02)
    assert tab.latency("olmo-1b", 1, 2, 0.75) == pytest.approx(0.015)
    assert tab.latency("olmo-1b", 1, 3, 0.75) == pytest.approx(0.025)
    assert tab.latency("olmo-1b", 1, 1, 0.5) is None
    assert tab.latency("olmo-1b", 1, 5, 0.5) is None
    assert tab.latency("olmo-1b", 1, 2, 0.4) is None
    assert tab.latency("olmo-1b", 2, 2, 0.5) is None
    assert tab.latency("olmo-1b", 1, 2, 0.5,
                       gpu=pkg.get_gpu_type("t4")) is None
    assert tab.latency("qwen2.5-3b", 1, 2, 0.5) is None


@BOTH
def test_calibration_table_spec_guard_and_schema(pkg):
    tab = pkg.CalibrationTable(_surface_report(pkg))
    cfg = pkg.reduced(pkg.ARCHS["olmo-1b"])
    good = pkg.FnSpec(cfg, seq=pkg.prompt_len(cfg, 32))
    assert tab.latency(good, 1, 2, 0.5) == pytest.approx(0.01)
    assert tab.latency(pkg.FnSpec(pkg.ARCHS["olmo-1b"]), 1, 2, 0.5) is None
    assert tab.latency(pkg.FnSpec(cfg, seq=24), 1, 2, 0.5) is None
    with pytest.raises(ValueError):
        pkg.CalibrationTable({"schema": "bogus", "points": []})


@BOTH
def test_calibration_table_refuses_ragged_grid(pkg):
    pts = [_pt("olmo-1b", "v5e", 1, sm, q, "prefill", 0.01)
           for sm, q in ((2, 0.5), (2, 1.0), (4, 0.5))]
    tab = pkg.CalibrationTable(_report(pkg, pts))
    assert tab.latency("olmo-1b", 1, 2, 0.5) == pytest.approx(0.01)
    assert tab.latency("olmo-1b", 1, 3, 0.75) is None


@BOTH
def test_capacity_table_calibration_overlay(pkg):
    cfg = pkg.reduced(pkg.ARCHS["olmo-1b"])
    spec = pkg.FnSpec(cfg, seq=pkg.prompt_len(cfg, 32))
    cap = pkg.CapacityTable(
        calibration=pkg.CalibrationTable(_surface_report(pkg)))
    base = pkg.CapacityTable()
    lat_cal = cap.lattice(spec, 1)
    lat_base = base.lattice(spec, 1)
    assert lat_cal[1, 4] == pytest.approx(0.01)
    assert lat_cal[3, 9] == pytest.approx(0.04)
    assert lat_cal[2, 4] == pytest.approx(0.02)
    assert lat_cal[1, 6] == pytest.approx(0.01 + 0.01 * (0.7 - 0.5) / 0.5)
    np.testing.assert_array_equal(lat_cal[0], lat_base[0])
    np.testing.assert_array_equal(lat_cal[:, :4], lat_base[:, :4])
    np.testing.assert_array_equal(lat_cal[4:], lat_base[4:])
    assert cap.lat(spec, 1, 3, 0.75) == pytest.approx(0.025)
    assert cap.lat(spec, 1, 6, 0.55) == base.lat(spec, 1, 6, 0.55)
    np.testing.assert_array_equal(
        lat_base, pkg.perf_model.latency_lattice(spec, 1, base.sms,
                                                 base.quotas,
                                                 base.window_ms))


# ---------------------------------------------------------------------------
# the lattice control plane (test_capacity.py, on both packages)
# ---------------------------------------------------------------------------

@BOTH
def test_quota_grid_matches_loop_arithmetic(pkg):
    for step in (0.1, 0.2, 0.25, 0.5, 1.0):
        loop = [qi * step for qi in range(1, int(round(1.0 / step)) + 1)]
        assert pkg.perf_model.quota_grid(step).tolist() == loop


@BOTH
def test_latency_lattice_bitwise_equals_scalar(pkg):
    pm = pkg.perf_model
    sms = np.arange(1, pkg.TOTAL_SLICES + 1)
    quotas = pm.quota_grid(0.1)
    for cfg in list(pkg.ARCHS.values())[:4]:
        spec = pkg.FnSpec(cfg)
        for b in (1, 2, 4, 8, 16, 32):
            tab = pm.latency_lattice(spec, b, sms, quotas)
            thpt = pm.throughput_lattice(spec, b, sms, quotas,
                                         overhead_s=0.02)
            for i, sm in enumerate(sms):
                for j, q in enumerate(quotas):
                    assert tab[i, j] == pm.latency(spec, b, int(sm),
                                                   float(q))
                    assert thpt[i, j] == pm.throughput(
                        spec, b, int(sm), float(q), overhead_s=0.02)
    cost = pm.cost_rate_lattice(sms, quotas)
    for i, sm in enumerate(sms):
        for j, q in enumerate(quotas):
            assert cost[i, j] == pm.cost_rate(int(sm), float(q))


@BOTH
def test_table_searches_identical_to_scalar_loops(pkg):
    """The table-backed argmin/argmax return the scalar loops' tuples."""
    pm, table = pkg.perf_model, pkg.shared_table()
    for cfg in pkg.ARCHS.values():
        spec = pkg.FnSpec(cfg)
        for target in (0.1, 25.0, 5000.0):
            for mult in (2.0, None):
                assert table.most_efficient_config(
                    spec, target, slo_multiplier=mult) == \
                    pm.most_efficient_config(spec, target,
                                             slo_multiplier=mult)
        for b in (1, 8, 32):
            for sm in range(1, pkg.TOTAL_SLICES + 1):
                assert table.min_quota_for_slo(spec, b, sm, 2.0) == \
                    pm.min_quota_for_slo(spec, b, sm, 2.0)


@BOTH
def test_table_lat_on_and_off_lattice_and_scalar_predictor(pkg):
    pm = pkg.perf_model
    spec = pkg.FnSpec(pkg.ARCHS["qwen2.5-3b"])
    table = pkg.CapacityTable()
    for qi in range(1, 11):
        assert table.lat(spec, 8, 4, qi * 0.1) == pm.latency(spec, 8, 4,
                                                             qi * 0.1)
    assert 0.6 != 6 * 0.1
    assert table.lat(spec, 8, 4, 0.6) == pm.latency(spec, 8, 4, 0.6)
    calls = []

    def pred(spec, b, sm, q):
        calls.append((b, sm, q))
        return pm.latency(spec, b, sm, q) * 1.5

    wrapped = pkg.CapacityTable(predictor=pred)
    assert wrapped.lat(spec, 8, 4, 0.5) == pm.latency(spec, 8, 4, 0.5) * 1.5
    assert len(calls) == 80
    wrapped.lat(spec, 8, 7, 0.2)
    assert len(calls) == 80


# ---------------------------------------------------------------------------
# the port's CPU run and CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_smoke_report():
    return port_harness.run_profile(SMOKE_GRID, smoke=True, device="cpu")


def test_smoke_grid_is_the_jax_smoke_grid():
    spec = importlib.util.spec_from_file_location(
        "profile_stack", REPO / "benchmarks" / "profile_stack.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import dataclasses
    assert dataclasses.asdict(SMOKE_GRID) == dataclasses.asdict(
        mod.SMOKE_GRID)
    assert len(port_harness.build_grid(H100_GRID)) == 48


def test_port_smoke_report_passes_the_jax_gate(port_smoke_report):
    """Schema, grid, point order and the analytic column match the JAX
    package's committed CPU reference exactly; ``factor=inf`` leaves
    timing out of it."""
    report = port_smoke_report
    assert jax_check_report(report, _load(JAX_REF_CPU),
                            factor=float("inf")) == []
    assert report["meta"]["backend"] == "cpu"
    assert report["meta"]["torch_version"] == torch.__version__
    assert "jax_version" not in report["meta"]
    assert all(p["measured_s"] > 0 for p in report["points"])


def test_port_run_profile_single_point(port_smoke_report):
    cfg = PORT.reduced(PORT_ARCHS["olmo-1b"])
    spec = PORT.FnSpec(cfg, seq=PORT.prompt_len(cfg, 32))
    first = port_smoke_report["points"][0]
    assert (first["arch"], first["batch"], first["sm"], first["quota"],
            first["phase"]) == ("olmo-1b", 1, 2, 0.5, "prefill")
    assert first["analytic_s"] == PORT.perf_model.latency(
        spec, 1, 2, 0.5, window_ms=20.0)
    assert port_smoke_report["error"]["overall"]["n"] == 32
    tab = PORT.CalibrationTable(port_smoke_report)
    assert tab.latency(spec, 1, 2, 0.5) == pytest.approx(
        first["measured_s"])


def test_port_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    grid = port_harness.GridSpec(archs=("olmo-1b",), batches=(1,),
                                 sms=(2,), quotas=(1.0,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_harness.run_profile(grid)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_harness.profile_kernels()


def test_port_profile_kernels_on_cpu_runs_the_four_cases():
    recs = port_harness.profile_kernels(warmup=1, iters=1, device="cpu")
    assert [r["name"] for r in recs] == ["decode_attention",
                                          "flash_attention", "moe_gmm",
                                          "ssd_scan"]
    assert all(set(r) == {"name", "measured_s", "ref_s", "ratio"}
               for r in recs)


def test_port_cli_smoke_checks_against_committed_reference(tmp_path):
    """The CLI's gate on the CPU; ``--factor inf`` keeps CPU timing out."""
    out = tmp_path / "profile.json"
    assert main(["--smoke", "--device", "cpu", "--out", str(out),
                 "--check", REF_CPU, "--factor", "inf"]) == 0
    assert _load(out)["schema"] == PORT.SCHEMA


@BOTH
def test_committed_port_references_pass_the_gate(pkg):
    """The port's committed CPU reference passes both packages' gate
    against itself and the JAX committed reference at factor inf; the
    H100 reference, against itself, and it names its card."""
    cpu = _load(REF_CPU)
    assert pkg.check_report(copy.deepcopy(cpu), cpu) == []
    assert pkg.check_report(cpu, _load(JAX_REF_CPU),
                            factor=float("inf")) == []
    h100 = _load(REF_H100)
    assert pkg.check_report(copy.deepcopy(h100), h100) == []
    assert h100["meta"]["grid"] == H100_GRID.grid_meta()
    assert h100["meta"]["backend"] == "cuda"
    assert "H100" in h100["meta"]["device_kind"]
    assert h100["meta"]["power_limit"].endswith("W")
    assert len(h100["points"]) == 48


# ---------------------------------------------------------------------------
# cross-package: CalibrationTable and CapacityTable agree bit for bit
# ---------------------------------------------------------------------------

def _specs(pkg, report):
    """Every registered arch at the default seq, plus the arch exactly as
    ``report`` profiled it (so the overlay has points to lay over)."""
    meta = report["meta"]
    specs = [pkg.FnSpec(pkg.ARCHS[arch]) for arch in sorted(pkg.ARCHS)]
    for arch in meta["grid"]["archs"]:
        cfg = pkg.ARCHS[arch]
        cfg = pkg.reduced(cfg) if meta["reduced"] else cfg
        specs.append(pkg.FnSpec(cfg, seq=pkg.prompt_len(cfg, meta["seq"])))
    return specs


@pytest.mark.parametrize("path", [REF_CPU, REF_H100], ids=["cpu", "h100"])
def test_calibration_tables_agree_across_packages(path):
    report = _load(path)
    tabs = [pkg.CalibrationTable(report) for pkg in (JAX, PORT)]
    grid = report["meta"]["grid"]
    quotas = sorted(set(grid["quotas"]) | {0.55, 0.75, 0.9, 0.3})
    sms = range(1, 9)
    # each package's own profiled specs, which the guard must accept
    profiled = [_specs(pkg, report)[-len(grid["archs"]):]
                for pkg in (JAX, PORT)]
    hits = 0
    for gpu_name in grid["gpu_types"]:
        gpus = (JAX.get_gpu_type(gpu_name), PORT.get_gpu_type(gpu_name))
        for i, arch in enumerate(grid["archs"]):
            for b in grid["batches"]:
                for sm in sms:
                    for q in quotas:
                        got = [t.latency(arch, b, sm, q, gpu=g)
                               for t, g in zip(tabs, gpus)]
                        assert got[0] == got[1], (arch, b, sm, q, got)
                        hits += got[0] is not None
                        got = [t.latency(spec[i], b, sm, q, gpu=g)
                               for t, spec, g in zip(tabs, profiled, gpus)]
                        assert got[0] == got[1], (arch, b, sm, q, got)
    assert hits > 0


@pytest.mark.parametrize("calibration", [None, REF_CPU, REF_H100],
                         ids=["analytic", "cpu", "h100"])
def test_capacity_tables_bitwise_equal_across_packages(calibration):
    """Both packages' ``CapacityTable``: equal lattices, configuration
    searches and minimum quotas over every arch x gpu type, with and
    without a calibration table."""
    report = _load(calibration or REF_CPU)
    tables = [pkg.CapacityTable(calibration=None if calibration is None
                                else pkg.CalibrationTable(report))
              for pkg in (JAX, PORT)]
    specs = [_specs(pkg, report) for pkg in (JAX, PORT)]
    assert len(JAX.GPU_TYPES) == len(PORT.GPU_TYPES)
    for name in JAX.GPU_TYPES:
        gpus = (JAX.get_gpu_type(name), PORT.get_gpu_type(name))
        for jspec, pspec in zip(*specs):
            assert jspec.arch.name == pspec.arch.name
            for b in (1, 2, 8, 32):
                np.testing.assert_array_equal(
                    tables[0].lattice(jspec, b, gpus[0]),
                    tables[1].lattice(pspec, b, gpus[1]))
            for target in (0.5, 40.0):
                got = [t.most_efficient_config(s, target, gpu=g)
                       for t, s, g in zip(tables, (jspec, pspec), gpus)]
                assert got[0] == got[1], (name, jspec.fn_id, target, got)
            for b, sm in ((1, 2), (8, 4), (8, gpus[0].sm_total)):
                got = [t.min_quota_for_slo(s, b, sm, gpu=g)
                       for t, s, g in zip(tables, (jspec, pspec), gpus)]
                assert got[0] == got[1], (name, jspec.fn_id, b, sm, got)
    if calibration is not None:
        # the overlay reached the profiled specs' lattices: a check of the
        # plumbing only, since the h100 table's prefill walls are libhas's
        # pacing by PodEngine._cost, not steps on the card (harness.py)
        gpu = report["meta"]["grid"]["gpu_types"][0]
        ps = specs[1][-1]
        b = report["meta"]["grid"]["batches"][0]
        assert not np.array_equal(
            tables[1].lattice(ps, b, PORT.get_gpu_type(gpu)),
            PORT.CapacityTable().lattice(ps, b, PORT.get_gpu_type(gpu)))


def test_perf_model_functions_bitwise_equal_across_packages():
    pms = (JAX.perf_model, PORT.perf_model)
    sms = np.arange(1, 9)
    quotas = pms[0].quota_grid(0.1)
    assert quotas.tolist() == pms[1].quota_grid(0.1).tolist()
    for name in JAX.GPU_TYPES:
        gpus = (JAX.get_gpu_type(name), PORT.get_gpu_type(name))
        for arch in JAX_ARCHS:
            specs = (JAX.FnSpec(JAX_ARCHS[arch]),
                     PORT.FnSpec(PORT_ARCHS[arch]))
            for b in (1, 8):
                vals = [(pm.slo_baseline(s, b),
                         pm.latency_lattice(s, b, sms, quotas, gpu=g),
                         pm.throughput_lattice(s, b, sms, quotas,
                                               overhead_s=0.01, gpu=g),
                         pm.exec_time_lattice(s, b, sms, g))
                        for pm, s, g in zip(pms, specs, gpus)]
                assert vals[0][0] == vals[1][0]
                for a, c in zip(vals[0][1:], vals[1][1:]):
                    np.testing.assert_array_equal(a, c)
            got = [pm.most_efficient_config(s, 10.0, gpu=g)
                   for pm, s, g in zip(pms, specs, gpus)]
            assert got[0] == got[1]
            got = [pm.min_quota_for_slo(s, 8, 2, gpu=g)
                   for pm, s, g in zip(pms, specs, gpus)]
            assert got[0] == got[1]
        np.testing.assert_array_equal(
            pms[0].cost_rate_lattice(sms, quotas, gpus[0]),
            pms[1].cost_rate_lattice(sms, quotas, gpus[1]))
        assert pms[0].cost_rate(3, 0.7, gpus[0]) == \
            pms[1].cost_rate(3, 0.7, gpus[1])


def test_port_predictor_protocol_errors_like_the_reference():
    spec = PORT.FnSpec(PORT_ARCHS["olmo-1b"])
    with pytest.raises(TypeError, match="4-arg"):
        PORT.perf_model.most_efficient_config(
            spec, 1.0, predictor=lambda s, b, sm, q: 1.0,
            gpu=PORT.get_gpu_type("h100"))


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

PORT_FILES = sorted(
    (REPO / "src" / "repro_torch" / "profiling").glob("*.py")) + [
    REPO / "src" / "repro_torch" / "core" / "capacity.py",
    REPO / "src" / "repro_torch" / "core" / "perf_model.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_modules_import_neither_jax_nor_repro(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_h100_grid_prompt_is_two_mamba2_chunks():
    cfg = PORT_ARCHS["mamba2-2.7b"]
    L = PORT.prompt_len(cfg, H100_GRID.seq)
    assert L == 512 and L % cfg.ssm.chunk_size == 0
    assert L // cfg.ssm.chunk_size == 2
    assert not H100_GRID.reduce and H100_GRID.gpu_types == ("h100",)
    assert math.isclose(H100_GRID.window_ms, SMOKE_GRID.window_ms)
