"""The port's RaPP against the JAX package's: the numpy half byte for
byte, the GAT forward and ``RaPPModel`` within rel 1e-5, the dataset byte
for byte, on operator graphs handed over from the JAX extractor (the
port's own extractor is held in ``test_torch_rapp_extract.py``, the
training in ``test_torch_rapp_train.py``). Then the port's twins of
``tests/test_rapp.py`` and of the RaPP tests of ``tests/test_capacity.py``,
on the port's own extractor. Inputs come from seeded numpy generators.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.gpus import GPU_TYPES as JGPU_TYPES, get_gpu_type as jgpu
from repro.core.perf_model import FnSpec as JFnSpec
from repro.core.rapp import dataset as JD, features as JF, gat as JG
from repro.core.rapp import predictor as JP
from repro.profiling.harness import SCHEMA as JSCHEMA
from repro.profiling.table import CalibrationTable as JCalibration

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.gpus import GPU_TYPES, get_gpu_type
from repro_torch.core import CapacityTable, TOTAL_SLICES
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.rapp import dataset as D, features as F, gat as G
from repro_torch.core.rapp import predictor as P
from repro_torch.profiling.harness import SCHEMA
from repro_torch.profiling.table import CalibrationTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def to_port(g):
    """The JAX package's OpGraph in the port's dataclasses."""
    return F.OpGraph([F.OpNode(**dataclasses.asdict(n)) for n in g.nodes],
                     list(g.edges), g.total_flops, g.total_bytes,
                     g.class_counts.copy())


JAX_EXTRACT = JF.extract_graph   # before any test patches it


@functools.lru_cache(maxsize=None)
def jax_graph(name, batch, small=True):
    return JAX_EXTRACT(jreduced(JARCHS[name]) if small else JARCHS[name],
                       batch)


def specs(name, small=True):
    if small:
        return JFnSpec(jreduced(JARCHS[name])), FnSpec(reduced(ARCHS[name]))
    return JFnSpec(JARCHS[name]), FnSpec(ARCHS[name])


def assert_same(a, b):
    """Equal arrays of the same dtype, byte for byte."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ numpy half
@pytest.mark.parametrize("seed,arch,batch,seq,gpu", [
    (0, "olmo-1b", 4, 128, None), (7, "deepseek-moe-16b", 16, 2048, None),
    (3, "whisper-medium", 1, 128, "h100"), (0, "olmo-1b", 4, 128, "t4")])
def test_profile_rng_streams_equal(seed, arch, batch, seq, gpu):
    a = JP._profile_rng(seed, arch, batch, seq,
                        jgpu(gpu) if gpu else JP.DEFAULT_GPU_TYPE)
    b = P._profile_rng(seed, arch, batch, seq,
                       get_gpu_type(gpu) if gpu else P.DEFAULT_GPU_TYPE)
    assert_same(a.random(16), b.random(16))
    assert_same(a.lognormal(0.0, 0.05, 8), b.lognormal(0.0, 0.05, 8))


@pytest.mark.parametrize("arch,small", [
    ("deepseek-moe-16b", True), ("whisper-medium", False),
    ("jamba-v0.1-52b", True), ("olmo-1b", True)])
def test_coarsen_equals_reference(arch, small):
    g = jax_graph(arch, 4, small)
    want = JF._coarsen(g, JF.MAX_NODES)
    got = F._coarsen(to_port(g), F.MAX_NODES)
    assert [dataclasses.astuple(n) for n in got.nodes] == \
        [dataclasses.astuple(n) for n in want.nodes]
    assert list(got.edges) == list(want.edges)
    assert len(got.nodes) == min(len(g.nodes), F.MAX_NODES)
    # a second call gives the same graph (the merge works on copies)
    again = F._coarsen(to_port(g), F.MAX_NODES)
    assert [dataclasses.astuple(n) for n in again.nodes] == \
        [dataclasses.astuple(n) for n in got.nodes]


def test_feature_sizes_equal():
    for name in ("OP_CLASSES", "SM_PROFILE_POINTS", "QUOTA_PROFILE_POINTS",
                 "MAX_NODES", "NODE_STATIC_F", "NODE_RUNTIME_F", "NODE_F",
                 "GLOBAL_STATIC_F", "GLOBAL_RUNTIME_F", "GLOBAL_F",
                 "N_DEVICE_F", "PEAK_FLOPS", "HBM_BW"):
        assert getattr(F, name) == getattr(JF, name), name


@pytest.mark.parametrize("gpu", ["v5e", "h100", "t4"])
def test_op_and_graph_quota_profiles_equal(gpu):
    g = jax_graph("deepseek-moe-16b", 4)
    jspec, spec = specs("deepseek-moe-16b")
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    for jn, n in zip(g.nodes, to_port(g).nodes):
        assert_same(JF.op_profile(jn, ra, jgpu(gpu)),
                    F.op_profile(n, rb, get_gpu_type(gpu)))
    assert_same(JF.graph_quota_profile(jspec, 4, ra, jgpu(gpu)),
                F.graph_quota_profile(spec, 4, rb, get_gpu_type(gpu)))


def test_device_descriptor_equal():
    assert list(GPU_TYPES) == list(JGPU_TYPES)
    for name in GPU_TYPES:
        assert_same(JF.device_descriptor(JGPU_TYPES[name]),
                    F.device_descriptor(GPU_TYPES[name]))


@pytest.mark.parametrize("arch,gpu,with_runtime", [
    ("olmo-1b", "v5e", True), ("whisper-medium", "h100", True),
    ("mamba2-2.7b", "t4", False), ("deepseek-moe-16b", "v5e", True)])
def test_tensorize_equal(arch, gpu, with_runtime):
    g = jax_graph(arch, 4)
    jspec, spec = specs(arch)
    sa = JF.tensorize_shared(g, jspec, 4, np.random.default_rng(2),
                             with_runtime, jgpu(gpu))
    sb = F.tensorize_shared(to_port(g), spec, 4, np.random.default_rng(2),
                            with_runtime, get_gpu_type(gpu))
    for k in ("node_feats", "adj", "mask", "head", "g_rt"):
        assert_same(sa[k], sb[k])
    if with_runtime:
        assert_same(sa["prof"], sb["prof"])
    else:
        assert sa["prof"] is None and sb["prof"] is None
    points = [(sm, q) for sm in (1, 3, 8) for q in (0.1, 0.45, 1.0)]
    for sm, q in points:
        ga, pa = JF._assemble(sa, sm, q)
        gb, pb = F._assemble(sb, sm, q)
        assert_same(ga, gb)
        assert_same(pa, pb)
    la = JF.tensorize_lattice(None, jspec, 4, points, None, shared=sa)
    lb = F.tensorize_lattice(None, spec, 4, points, None, shared=sb)
    for k in la:
        assert_same(la[k], lb[k])
    ta = JF.tensorize(g, jspec, 4, 5, 0.3, np.random.default_rng(9),
                      with_runtime, jgpu(gpu))
    tb = F.tensorize(to_port(g), spec, 4, 5, 0.3, np.random.default_rng(9),
                     with_runtime, get_gpu_type(gpu))
    for k in ta:
        assert_same(ta[k], tb[k])


# ------------------------------------------------------------ GAT forward
@functools.lru_cache(maxsize=None)
def jax_params(seed=0):
    return JP.init_params(jax.random.PRNGKey(seed))


def port_params(seed=0):
    return P.params_from_jax(jax_params(seed), CPU)


@functools.lru_cache(maxsize=None)
def samples():
    """Three tensorized samples of different graphs, stacked."""
    out = []
    for i, (arch, b) in enumerate((("olmo-1b", 4), ("deepseek-moe-16b", 1),
                                   ("whisper-medium", 16))):
        jspec, _ = specs(arch)
        out.append(JF.tensorize(jax_graph(arch, b), jspec, b, 1 + 3 * i,
                                0.2 + 0.3 * i, np.random.default_rng(i)))
    return {k: np.stack([t[k] for t in out]) for k in out[0]}


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_gat_layer_and_mlp_match():
    jp, tp = jax_params(), port_params()
    s = samples()
    h_j, h_t = s["node_feats"][0], t(s["node_feats"][0])
    for jl, tl in zip(jp["gat"], tp["gat"]):
        h_j = JG.gat_layer(jl, h_j, s["adj"][0], s["mask"][0])
        h_t = G.gat_layer(tl, h_t, t(s["adj"][0]), t(s["mask"][0]))
        assert rel_err(h_t, h_j) <= 1e-5
    for final_linear in (True, False):
        want = JG.mlp(jp["global_mlp"], s["global"], final_linear)
        got = G.mlp(tp["global_mlp"], t(s["global"]), final_linear)
        assert rel_err(got, want) <= 1e-5


def test_forward_one_batch_lattice_match():
    jp, tp = jax_params(), port_params()
    s = samples()
    args = ("node_feats", "adj", "mask", "global", "prior")
    for i in range(3):
        want = jax.jit(JP.forward_one)(jp, *(s[k][i] for k in args))
        got = P.forward_one(tp, *(t(s[k][i]) for k in args))
        assert got.shape == () and rel_err(got, want) <= 1e-5
    want = jax.jit(JP.forward_batch)(jp, *(s[k] for k in args))
    got = P.forward_batch(tp, *(t(s[k]) for k in args))
    assert got.shape == (3,) and rel_err(got, want) <= 1e-5
    # one graph, 24 (sm, quota) points
    g = jax_graph("olmo-1b", 8)
    jspec, _ = specs("olmo-1b")
    sh = JF.tensorize_shared(g, jspec, 8, np.random.default_rng(4))
    lat = JF.tensorize_lattice(None, jspec, 8,
                               [(sm, q) for sm in (1, 2, 4, 8)
                                for q in (0.1, 0.3, 0.5, 0.7, 0.9, 1.0)],
                               None, shared=sh)
    want = jax.jit(JP.forward_lattice)(jp, *(lat[k] for k in args))
    got = P.forward_lattice(tp, *(t(lat[k]) for k in args))
    assert got.shape == (24,) and rel_err(got, want) <= 1e-5
    # and it equals the per-point forward
    each = torch.stack([P.forward_one(tp, t(lat["node_feats"]),
                                      t(lat["adj"]), t(lat["mask"]),
                                      t(lat["global"][i]), t(lat["prior"][i]))
                        for i in range(24)])
    assert rel_err(got, each) <= 1e-5
    ms_want = jax.jit(JP.predict_latency_ms)(jp, {k: s[k] for k in args})
    ms_got = P.predict_latency_ms(tp, {k: t(s[k]) for k in args})
    assert rel_err(ms_got, ms_want) <= 1e-5


def test_params_round_trip_and_layout():
    jp = jax_params(3)
    tp = P.params_from_jax(jp, CPU)
    back = P.params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert_same(np.asarray(leaf, np.float32), flat_b[path])
    # the port's own init has the reference's shapes
    own = P.params_to_jax(P.init_params(0, device=CPU))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, jp)


def handed_model(monkeypatch, arch, batch, module, params, seed=7):
    """A model of ``module`` whose graph of (arch, batch) is the JAX
    extractor's, put in that module's process-wide cache."""
    g = JF._coarsen(jax_graph(arch, batch, False), JF.MAX_NODES)
    key = (arch, batch, 128)
    if module is P:
        monkeypatch.setitem(P._GRAPH_CACHE, key, to_port(g))
        return P.RaPPModel(params, seed=seed, device=CPU)
    monkeypatch.setitem(JP._GRAPH_CACHE, key, g)
    return JP.RaPPModel(params, seed=seed)


@pytest.mark.parametrize("gpu", [None, "h100"])
def test_rapp_model_matches_on_handed_over_graph(monkeypatch, gpu):
    jm = handed_model(monkeypatch, "olmo-1b", 4, JP, jax_params())
    tm = handed_model(monkeypatch, "olmo-1b", 4, P, port_params())
    jspec, spec = specs("olmo-1b", small=False)
    jg, tg = (jgpu(gpu), get_gpu_type(gpu)) if gpu else (None, None)
    for sm, q in ((1, 0.1), (4, 0.5), (8, 1.0), (3, 0.35)):
        a, b = jm(jspec, 4, sm, q, jg), tm(spec, 4, sm, q, tg)
        assert isinstance(b, float) and b == pytest.approx(a, rel=1e-5)
    sms, quotas = tuple(range(1, 9)), tuple(np.round(np.arange(1, 11) / 10, 1))
    want = jm.predict_lattice(jspec, 4, sms, quotas, gpu=jg)
    got = tm.predict_lattice(spec, 4, sms, quotas, gpu=tg)
    assert got.shape == (8, 10) and got.dtype == np.float64
    assert rel_err(got, want) <= 1e-5
    # the scalar path's answers, cached first, are kept by the lattice
    assert tm(spec, 4, 4, 0.5, tg) == pytest.approx(got[3, 4], rel=1e-5)


# ------------------------------------------------------------ dataset
@pytest.fixture
def handed_graphs(monkeypatch):
    """Both packages' ``extract_graph`` return the JAX extractor's graph
    of the reduced form of each arch (variants: of the arch they vary)."""
    def base(cfg):
        name = cfg.name.split("-var")[0]
        return name

    def jax_side(cfg, batch, seq=128):
        return jax_graph(base(cfg), batch)

    def port_side(cfg, batch, seq=128):
        return to_port(jax_graph(base(cfg), batch))
    monkeypatch.setattr(JF, "extract_graph", jax_side)
    monkeypatch.setattr(F, "extract_graph", port_side)


def assert_same_dataset(a, b):
    for f in ("node_feats", "adj", "mask", "global_feats", "priors",
              "labels_logms", "arch_names"):
        assert_same(getattr(a, f), getattr(b, f))


def test_build_corpus_equal():
    want = JD.build_corpus(seed=3)
    got = D.build_corpus(seed=3)
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]


@pytest.mark.parametrize("gpu_types,with_runtime", [
    (("v5e",), True), (("v5e", "h100", "t4"), True), (("a100",), False)])
def test_generate_and_split_equal(handed_graphs, gpu_types, with_runtime):
    kw = dict(batches=(1, 4), samples_per_graph=6, seed=4,
              with_runtime=with_runtime, gpu_types=gpu_types)
    want = JD.generate([JARCHS["olmo-1b"], JARCHS["gemma-7b"]], **kw)
    got = D.generate([ARCHS["olmo-1b"], ARCHS["gemma-7b"]], **kw)
    assert len(got) == 2 * 2 * 6 * len(gpu_types)
    assert_same_dataset(got, want)
    for a, b in zip(D.split(got, holdout_archs=("gemma-7b",), seed=1),
                    JD.split(want, holdout_archs=("gemma-7b",), seed=1)):
        assert_same_dataset(a, b)


def calibration_report(schema):
    rng = np.random.default_rng(11)
    return {"schema": schema, "meta": {}, "points": [
        {"arch": "olmo-1b", "gpu": "v5e", "batch": 4, "sm": sm, "quota": q,
         "phase": "prefill", "measured_s": float(rng.uniform(0.01, 0.2))}
        for sm in (1, 2, 4, 8) for q in (0.2, 0.5, 1.0)]}


def test_generate_with_calibration_equal(handed_graphs):
    kw = dict(batches=(1, 4), samples_per_graph=10, seed=2)
    want = JD.generate([JARCHS["olmo-1b"]],
                       calibration=JCalibration(calibration_report(JSCHEMA)),
                       **kw)
    got = D.generate([ARCHS["olmo-1b"]],
                     calibration=CalibrationTable(calibration_report(SCHEMA)),
                     **kw)
    assert_same_dataset(got, want)
    plain = D.generate([ARCHS["olmo-1b"]], **kw)
    assert not np.array_equal(plain.labels_logms, got.labels_logms)


# ------------------------------------------------------------ twins
def test_tensorize_shapes():
    g = F.extract_graph(ARCHS["olmo-1b"], batch=8)
    rng = np.random.default_rng(0)
    t_ = F.tensorize(g, FnSpec(ARCHS["olmo-1b"]), 8, 4, 0.5, rng)
    assert t_["node_feats"].shape == (F.MAX_NODES, F.NODE_F)
    assert t_["adj"].shape == (F.MAX_NODES, F.MAX_NODES)
    assert t_["global"].shape == (F.GLOBAL_F,)
    assert np.isfinite(t_["node_feats"]).all()
    assert np.isfinite(t_["global"]).all()


def test_dippm_static_features_zero_runtime():
    g = F.extract_graph(ARCHS["olmo-1b"], batch=8)
    rng = np.random.default_rng(0)
    t_ = F.tensorize(g, FnSpec(ARCHS["olmo-1b"]), 8, 4, 0.5, rng,
                     with_runtime=False)
    assert (t_["node_feats"][:, F.NODE_STATIC_F:] == 0).all()
    assert (t_["global"][F.GLOBAL_STATIC_F:] == 0).all()


def test_predictor_forward():
    params = P.init_params(0, device=CPU)
    g = F.extract_graph(ARCHS["olmo-1b"], batch=8)
    rng = np.random.default_rng(0)
    t_ = F.tensorize(g, FnSpec(ARCHS["olmo-1b"]), 8, 4, 0.5, rng)
    out = P.forward_one(params, t(t_["node_feats"]), t(t_["adj"]),
                        t(t_["mask"]), t(t_["global"]))
    assert np.isfinite(float(out))


def _rapp_model():
    return P.RaPPModel(P.init_params(0, device=CPU), seed=7, device=CPU)


def test_rapp_lattice_matches_scalar_calls():
    model = _rapp_model()
    spec = FnSpec(ARCHS["olmo-1b"])
    sms = (1, 4, 8)
    quotas = (0.2, 0.5, 1.0)
    lattice = model.predict_lattice(spec, 4, sms, quotas)
    fresh = _rapp_model()  # scalar-only path, no lattice cache
    for i, sm in enumerate(sms):
        for j, q in enumerate(quotas):
            scalar = fresh(spec, 4, sm, q)
            assert lattice[i, j] == pytest.approx(scalar, rel=1e-5), \
                (sm, q, lattice[i, j], scalar)


def test_rapp_predictions_order_independent():
    spec = FnSpec(ARCHS["olmo-1b"])
    queries = [(4, 2, 0.3), (4, 8, 1.0), (4, 1, 0.1), (4, 4, 0.6)]
    a, b = _rapp_model(), _rapp_model()
    got_a = {q: a(spec, *q) for q in queries}
    got_b = {q: b(spec, *q) for q in reversed(queries)}
    assert got_a == got_b


def test_rapp_table_single_batched_fill():
    model = _rapp_model()
    spec = FnSpec(ARCHS["olmo-1b"])
    table = CapacityTable(predictor=model)
    b, sm, q = table.most_efficient_config(spec, 5.0, batches=(4,))
    assert b == 4 and 1 <= sm <= TOTAL_SLICES and 0.0 < q <= 1.0
    assert table.lat(spec, 4, sm, q) == pytest.approx(
        model(spec, 4, sm, q), rel=1e-5)


def test_rapp_modules_load_no_jax_and_no_reference_package():
    """Extracting a graph, tensorizing it and querying a RaPPModel leaves
    no ``jax`` and no ``repro`` module in a fresh interpreter."""
    code = (
        "import sys\n"
        "import repro_torch.core.rapp as R\n"
        "from repro_torch.configs import ARCHS, reduced\n"
        "from repro_torch.core import FnSpec\n"
        "m = R.RaPPModel(R.init_params(0, device='cpu'), device='cpu')\n"
        "spec = FnSpec(reduced(ARCHS['olmo-1b']))\n"
        "lat = m.predict_lattice(spec, 2, (1, 8), (0.5, 1.0))\n"
        "assert lat.shape == (2, 2)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
