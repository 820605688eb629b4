"""The port's serving path: twins of tests/test_serving.py bound to
``repro_torch`` (batcher, libhas, gateway routing, the device-blind
regressions), plus greedy-token parity of a CPU ``PodEngine`` with the
JAX one on the same weights and prompts."""
import numpy as np
import pytest

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.gpus import get_gpu_type
from repro_torch.core.perf_model import FnSpec, exec_time
from repro_torch.core.scheduler import HASGPUScheduler
from repro_torch.core.vgpu import PodAlloc, VirtualGPU
from repro_torch.serving import (Batcher, Gateway, InferenceRequest, LibHas,
                           MemoryBudgetExceeded, PodEngine, StepFootprint,
                           measure_footprint)


def _req(n=4, arrival=None):
    kw = {} if arrival is None else {"arrival": arrival}
    return InferenceRequest(prompt=np.arange(1, n + 1, dtype=np.int32),
                            **kw)


# ---------------------------------------------------------------------------
# Batcher
# ---------------------------------------------------------------------------

def test_batcher_ready_semantics_with_injected_now():
    b = Batcher(max_batch=4, max_wait_s=0.5)
    assert not b.ready(now=123.0)          # empty queue is never ready
    b.submit(_req(arrival=100.0))
    assert not b.ready(now=100.1)          # under the wait deadline
    assert b.ready(now=100.5)              # deadline reached
    assert b.ready(now=900.0)
    for _ in range(3):
        b.submit(_req(arrival=100.0))
    assert b.ready(now=100.0)              # full batch: ready immediately
    assert len(b.next_batch()) == 4
    assert not b.ready(now=100.0)


def test_batcher_pad_prompts_left_pads_with_pad_id():
    reqs = [InferenceRequest(prompt=np.array([3, 4], np.int32)),
            InferenceRequest(prompt=np.array([5, 6, 7, 8], np.int32))]
    out = Batcher.pad_prompts(reqs, pad_id=7)
    np.testing.assert_array_equal(
        out, np.array([[7, 7, 3, 4], [5, 6, 7, 8]], np.int32))
    out6 = Batcher.pad_prompts(reqs, pad_id=9, pad_to=6)
    assert out6.shape == (2, 6)
    np.testing.assert_array_equal(out6[0], [9, 9, 9, 9, 3, 4])
    assert out6.dtype == np.int32


def test_batcher_pad_prompts_none_fits_longest_prompt():
    """pad_to=None (the default) must mean "fit the batch" explicitly,
    not fall through any numeric branch."""
    reqs = [InferenceRequest(prompt=np.array([1], np.int32)),
            InferenceRequest(prompt=np.array([2, 3, 4], np.int32))]
    out = Batcher.pad_prompts(reqs, pad_id=0, pad_to=None)
    assert out.shape == (2, 3)
    np.testing.assert_array_equal(out, [[0, 0, 1], [2, 3, 4]])


def test_batcher_pad_prompts_truncates_to_trailing_tokens():
    """A prompt longer than pad_to keeps its TRAILING pad_to tokens —
    with left padding, the tail is what sits next to the decode
    position. The old code raised a broadcast error here."""
    reqs = [InferenceRequest(prompt=np.arange(1, 7, dtype=np.int32)),
            InferenceRequest(prompt=np.array([9], np.int32))]
    out = Batcher.pad_prompts(reqs, pad_id=0, pad_to=4)
    np.testing.assert_array_equal(out, [[3, 4, 5, 6], [0, 0, 0, 9]])


@pytest.mark.parametrize("bad", [0, -3])
def test_batcher_pad_prompts_rejects_nonpositive_width(bad):
    reqs = [InferenceRequest(prompt=np.array([1, 2], np.int32))]
    with pytest.raises(ValueError, match="pad_to"):
        Batcher.pad_prompts(reqs, pad_to=bad)


def test_batcher_pad_prompts_rejects_empty_batch():
    with pytest.raises(ValueError, match="empty"):
        Batcher.pad_prompts([])


# ---------------------------------------------------------------------------
# LibHas
# ---------------------------------------------------------------------------

class _FakeClient:
    def __init__(self):
        self.costs = []

    def acquire(self, cost_s):
        self.costs.append(cost_s)


def test_libhas_token_accounting_and_estimator():
    client = _FakeClient()
    lib = LibHas(client=client)
    assert lib.launch(lambda x: x + 1, 1, cost_s=0.25) == 2
    assert lib.launches == 1
    assert lib.tokens_acquired_s == pytest.approx(0.25)
    assert client.costs == [0.25]
    # no cost and no estimator: dispatch without a token acquire
    lib.launch(lambda: 0)
    assert lib.launches == 2
    assert client.costs == [0.25]
    # estimator fills in the cost when the caller doesn't pass one
    est = LibHas(client=client, cost_estimator=lambda *a, **kw: 0.5)
    est.launch(lambda x: x, 3)
    assert est.tokens_acquired_s == pytest.approx(0.5)
    assert client.costs == [0.25, 0.5]


class _Compiled:
    def __init__(self, arg_bytes, temp_bytes, out_bytes=0):
        self._m = (arg_bytes, temp_bytes, out_bytes)

    def memory_analysis(self):
        import types
        return types.SimpleNamespace(argument_size_in_bytes=self._m[0],
                                     temp_size_in_bytes=self._m[1],
                                     output_size_in_bytes=self._m[2])


def test_libhas_memory_budget():
    lib = LibHas(client=_FakeClient(), hbm_budget_bytes=100)
    lib.check_memory(_Compiled(60, 30))    # 90 <= 100: fits
    with pytest.raises(MemoryBudgetExceeded):
        lib.check_memory(_Compiled(80, 30))
    # no budget configured: never inspects the compiled object
    LibHas(client=_FakeClient()).check_memory(object())


def test_libhas_memory_budget_counts_outputs():
    # regression: the footprint must include output buffers — a step
    # that fits only when outputs are ignored has to be rejected
    lib = LibHas(client=_FakeClient(), hbm_budget_bytes=100)
    lib.check_memory(_Compiled(50, 30, 20))   # 100 <= 100: fits exactly
    with pytest.raises(MemoryBudgetExceeded):
        lib.check_memory(_Compiled(50, 30, 21))  # args+temp fit, +out not


class _FakeAllocator:
    """The four allocator counters ``measure_footprint`` reads, driven by
    the fake step below instead of a card."""

    def __init__(self, allocated):
        self.allocated = self.peak = allocated
        self.synced = 0

    def synchronize(self):
        self.synced += 1

    def memory_allocated(self):
        return self.allocated

    def reset_peak_memory_stats(self):
        self.peak = self.allocated

    def max_memory_allocated(self):
        return self.peak

    def alloc(self, n):
        self.allocated += n
        self.peak = max(self.peak, self.allocated)


def test_measure_footprint_reads_the_allocator_around_one_step():
    """Arguments from the tensors given (a storage shared by two views
    counted once), outputs = allocated after - before, temp = the rest of
    the peak above before; LibHas.check_memory reads the result as a
    compiled step's, and needs arguments + peak - before."""
    import torch
    mem = _FakeAllocator(allocated=1000)
    w = torch.zeros(64)                              # 256 B
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),  # 64 B
             "view": w[:8]}                           # w's storage again

    def step(params, batch):
        mem.alloc(500)        # scratch
        mem.alloc(-500)
        mem.alloc(120)        # the outputs it leaves
        return "logits"

    fp = measure_footprint(step, {"w": w}, batch, memory=mem)
    assert fp == StepFootprint(argument_size_in_bytes=256 + 64,
                               temp_size_in_bytes=500 - 120,
                               output_size_in_bytes=120)
    assert mem.synced == 2 and fp.memory_analysis() is fp
    need = 256 + 64 + 500
    LibHas(client=_FakeClient(), hbm_budget_bytes=need).check_memory(fp)
    with pytest.raises(MemoryBudgetExceeded):
        LibHas(client=_FakeClient(), hbm_budget_bytes=need - 1).check_memory(fp)


# ---------------------------------------------------------------------------
# Gateway routing (stub engines: routing only reads spec/pod/batcher)
# ---------------------------------------------------------------------------

class _StubEngine:
    def __init__(self, cfg, pod, max_seq=32):
        self.cfg = cfg
        self.pod = pod
        self.spec = FnSpec(cfg, seq=max_seq)
        self.batcher = Batcher(max_batch=pod.batch)

    def submit(self, req):
        self.batcher.submit(req)


def _placed_pod(gpu_name, sm=2, quota=0.5, batch=2, uid=""):
    g = VirtualGPU(f"GPU-route-{gpu_name}{uid}",
                   gpu_type=get_gpu_type(gpu_name))
    pod = PodAlloc(fn_id="f", sm=sm, quota=quota, batch=batch)
    g.place(pod)
    return pod


def test_gateway_least_backlog_routing():
    cfg = ARCHS["olmo-1b"]
    gw = Gateway()
    busy = _StubEngine(cfg, _placed_pod("v5e", uid="a"))
    idle = _StubEngine(cfg, _placed_pod("v5e", uid="b"))
    gw.register("f", busy)
    gw.register("f", idle)
    for _ in range(3):
        busy.submit(_req())
    assert gw.route("f", _req()) is idle
    assert len(idle.batcher.queue) == 1
    with pytest.raises(KeyError):
        gw.route("ghost", _req())


def test_gateway_routes_by_hosting_device_physics():
    """Regression: routing must score each pod at its OWN chip's
    throughput. At identical (batch, sm, quota) and equal backlog, the
    h100-hosted pod has the higher capability, so it must win even when
    the t4 pod registered first (device-blind scoring tied them and
    picked the t4)."""
    cfg = ARCHS["olmo-1b"]
    gw = Gateway()
    slow = _StubEngine(cfg, _placed_pod("t4"))
    fast = _StubEngine(cfg, _placed_pod("h100"))
    assert slow.pod.gpu_type.name == "t4"       # stamped at placement
    assert fast.pod.gpu_type.name == "h100"
    gw.register("f", slow)
    gw.register("f", fast)
    slow.submit(_req())
    fast.submit(_req())
    assert gw.route("f", _req()) is fast


def test_gateway_deregister_unknown_fn_is_a_noop():
    gw = Gateway()
    gw.deregister("ghost", "pod-x")
    assert gw.engines == {}                     # no empty entry created
    cfg = ARCHS["olmo-1b"]
    eng = _StubEngine(cfg, _placed_pod("v5e", uid="d"))
    gw.register("f", eng)
    gw.deregister("f", "not-this-pod")
    assert gw.engines["f"] == [eng]
    gw.deregister("f", eng.pod.pod_id)
    assert "f" not in gw.engines            # last pod gone: key pruned


# ---------------------------------------------------------------------------
# PodEngine device-blind regressions (real engines, reduced config)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def _olmo_reduced():
    from repro_torch import models
    cfg = reduced(ARCHS["olmo-1b"])
    return cfg, models.init_params(cfg, seed=0, device="cpu")


def _engine_on(gpu_name, cfg, params, quota=1.0, **kw):
    gpu = get_gpu_type(gpu_name)
    vgpu = VirtualGPU(f"GPU-eng-{gpu_name}-{id(params) % 97}",
                      window_ms=20.0, gpu_type=gpu)
    pod = PodAlloc(fn_id="f", sm=2, quota=quota, batch=2)
    vgpu.place(pod)
    return PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=32,
                     params=params, device="cpu", **kw)


def test_engine_cost_scales_with_hosting_chip(_olmo_reduced):
    """Regression: token costs must follow the hosting chip's physics —
    the same pod shape on a t4 owns more accelerator-seconds per
    dispatch than on an h100 (charging reference-device physics made
    them identical)."""
    cfg, params = _olmo_reduced
    e_t4 = _engine_on("t4", cfg, params)
    e_h100 = _engine_on("h100", cfg, params)
    c_t4, c_h100 = e_t4._cost(8), e_h100._cost(8)
    assert c_t4 > c_h100
    spec = FnSpec(cfg, seq=32)
    want = (exec_time(spec, 2, 2, get_gpu_type("t4"))
            / exec_time(spec, 2, 2, get_gpu_type("h100")))
    assert c_t4 / c_h100 == pytest.approx(want)


def test_engine_pad_id_round_trip(_olmo_reduced):
    """Regression: ``step`` must pad with the engine's configured
    ``pad_id`` (it used to silently pad with 0) and account every
    dispatch through libhas."""
    cfg, params = _olmo_reduced
    eng = _engine_on("v5e", cfg, params, pad_id=1)
    assert eng.batcher.pad_id == 1
    seen = {}
    orig = Batcher.pad_prompts

    def spy(reqs, pad_id=0, pad_to=None):
        seen["pad_id"] = pad_id
        return orig(reqs, pad_id=pad_id, pad_to=pad_to)

    eng.batcher.pad_prompts = spy
    rng = np.random.default_rng(0)
    for n in (5, 9):
        eng.submit(InferenceRequest(
            prompt=rng.integers(2, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=2))
    done = eng.step()
    assert seen["pad_id"] == 1
    assert len(done) == 2
    assert all(r.output is not None and len(r.output) == 2 for r in done)
    assert eng.libhas.launches == 1 + 2        # prefill + 2 decode steps
    assert eng.libhas.tokens_acquired_s > 0.0


# ---------------------------------------------------------------------------
# the port's engine against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_defaults_to_kernels_and_shares_steps(_olmo_reduced):
    from repro_torch.models import CallOpts
    from repro_torch.serving.engine import compiled_steps
    cfg, params = _olmo_reduced
    a = _engine_on("v5e", cfg, params)
    b = _engine_on("h100", cfg, params, quota=0.5)
    assert a.opts == CallOpts(use_kernels=True)
    assert (a._prefill, a._decode) == (b._prefill, b._decode)
    assert compiled_steps(cfg, 32, a.opts) == (a._prefill, a._decode)


def test_engine_without_card_raises(monkeypatch, _olmo_reduced):
    import torch
    cfg, params = _olmo_reduced
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vgpu = VirtualGPU("GPU-nocard", gpu_type=get_gpu_type("h100"))
    pod = PodAlloc(fn_id="f", sm=2, quota=1.0, batch=2)
    vgpu.place(pod)
    with pytest.raises(RuntimeError, match="CUDA"):
        PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=32, params=params)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_greedy_tokens_match_jax_engine(use_kernels):
    """Same weights (bridged), same left-padded unmasked prompts, f32: the
    port's CPU engine emits exactly the JAX engine's greedy tokens."""
    import dataclasses
    import jax
    from repro import models as jmodels
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.core.scheduler import HASGPUScheduler as JScheduler
    from repro.core.vgpu import PodAlloc as JPod, VirtualGPU as JVGPU
    from repro.serving import InferenceRequest as JRequest, PodEngine as JEngine
    from repro_torch.models import CallOpts
    from repro_torch.weights import params_from_jax

    jcfg = dataclasses.replace(jreduced(JARCHS["qwen2.5-3b"]), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCHS["qwen2.5-3b"]), dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(5), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (7, 12, 3)]

    jg = JVGPU("GPU-jax-parity")
    jpod = JPod(fn_id="f", sm=8, quota=1.0, batch=3)
    jg.place(jpod)
    jeng = JEngine(jcfg, jpod, jg, JScheduler(), max_seq=32, params=jparams,
                   pad_id=2)
    g = VirtualGPU("GPU-torch-parity")
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    g.place(pod)
    eng = PodEngine(cfg, pod, g, HASGPUScheduler(), max_seq=32, params=params,
                    opts=CallOpts(use_kernels=use_kernels), pad_id=2,
                    device="cpu")
    for p in prompts:
        jeng.submit(JRequest(prompt=p, max_new_tokens=6))
        eng.submit(InferenceRequest(prompt=p, max_new_tokens=6))
    want = [r.output for r in jeng.step()]
    got = [r.output for r in eng.step()]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert eng.libhas.launches == jeng.libhas.launches == 1 + 6
    assert eng.libhas.tokens_acquired_s == pytest.approx(
        jeng.libhas.tokens_acquired_s)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_engine_greedy_tokens_match_jax_engine(n_groups, use_kernels):
    """Reduced mamba2, f32, bridged weights: the port's CPU engine emits the
    JAX engine's greedy tokens for a one-chunk batch (longest prompt 12)
    and a two-chunk batch (longest prompt 128 = 2 x chunk 64), and charges
    the same token costs."""
    import dataclasses
    import jax
    from repro import models as jmodels
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.core.scheduler import HASGPUScheduler as JScheduler
    from repro.core.vgpu import PodAlloc as JPod, VirtualGPU as JVGPU
    from repro.serving import InferenceRequest as JRequest, PodEngine as JEngine
    from repro_torch.models import CallOpts
    from repro_torch.weights import params_from_jax

    def cfg_of(c):
        c = dataclasses.replace(c, dtype="float32")
        return dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, n_groups=n_groups))

    jcfg = cfg_of(jreduced(JARCHS["mamba2-2.7b"]))
    cfg = cfg_of(reduced(ARCHS["mamba2-2.7b"]))
    jparams = jmodels.init_params(jax.random.PRNGKey(6), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(6 + n_groups)

    uid = f"{n_groups}-{int(use_kernels)}"
    jg = JVGPU(f"GPU-jax-ssm-{uid}")
    jpod = JPod(fn_id="f", sm=8, quota=1.0, batch=3)
    jg.place(jpod)
    jeng = JEngine(jcfg, jpod, jg, JScheduler(), max_seq=256, params=jparams,
                   pad_id=2)
    g = VirtualGPU(f"GPU-torch-ssm-{uid}")
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    g.place(pod)
    eng = PodEngine(cfg, pod, g, HASGPUScheduler(), max_seq=256,
                    params=params, opts=CallOpts(use_kernels=use_kernels),
                    pad_id=2, device="cpu")
    assert eng._cost(3 * 128) == pytest.approx(jeng._cost(3 * 128))
    for lengths in ((7, 12, 3), (128, 70, 9)):
        for n in lengths:
            p = rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
            jeng.submit(JRequest(prompt=p, max_new_tokens=5))
            eng.submit(InferenceRequest(prompt=p, max_new_tokens=5))
        want = [r.output for r in jeng.step()]
        got = [r.output for r in eng.step()]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert eng.libhas.launches == jeng.libhas.launches == 2 * (1 + 5)
    assert eng.libhas.tokens_acquired_s == pytest.approx(
        jeng.libhas.tokens_acquired_s)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_engine_greedy_tokens_match_jax_engine(use_kernels):
    """Reduced deepseek-moe-16b, f32, bridged weights: the port's CPU
    engine emits the JAX engine's greedy tokens, with the grouped matmul
    on both sides (the JAX engine's Pallas gmm in interpret mode) or on
    neither, for two batches, and charges the same token costs."""
    import dataclasses
    import jax
    from repro import models as jmodels
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.core.scheduler import HASGPUScheduler as JScheduler
    from repro.core.vgpu import PodAlloc as JPod, VirtualGPU as JVGPU
    from repro.models import CallOpts as JCallOpts
    from repro.serving import InferenceRequest as JRequest, PodEngine as JEngine
    from repro_torch.models import CallOpts
    from repro_torch.weights import params_from_jax

    jcfg = dataclasses.replace(jreduced(JARCHS["deepseek-moe-16b"]),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(ARCHS["deepseek-moe-16b"]),
                              dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(7), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(7)

    uid = f"moe-{int(use_kernels)}"
    jg = JVGPU(f"GPU-jax-{uid}")
    jpod = JPod(fn_id="f", sm=8, quota=1.0, batch=3)
    jg.place(jpod)
    jeng = JEngine(jcfg, jpod, jg, JScheduler(), max_seq=64, params=jparams,
                   opts=JCallOpts(use_kernels=use_kernels), pad_id=2)
    g = VirtualGPU(f"GPU-torch-{uid}")
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    g.place(pod)
    eng = PodEngine(cfg, pod, g, HASGPUScheduler(), max_seq=64,
                    params=params, opts=CallOpts(use_kernels=use_kernels),
                    pad_id=2, device="cpu")
    for lengths in ((7, 12, 3), (30, 5, 18)):
        for n in lengths:
            p = rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
            jeng.submit(JRequest(prompt=p, max_new_tokens=6))
            eng.submit(InferenceRequest(prompt=p, max_new_tokens=6))
        want = [r.output for r in jeng.step()]
        got = [r.output for r in eng.step()]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert eng.libhas.launches == jeng.libhas.launches == 2 * (1 + 6)
    assert eng.libhas.tokens_acquired_s == pytest.approx(
        jeng.libhas.tokens_acquired_s)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-medium"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_stub_frontend_engine_greedy_tokens_match_jax_engine(arch, use_kernels):
    """Reduced llava-next-34b and whisper-medium, f32, bridged weights: the
    port's CPU engine feeds the stubbed frontends the reference's zeros
    (``_extra_inputs``) and decodes a VLM from position V + L + i, so it
    emits the JAX engine's greedy tokens for two batches, with attention
    kernels on both sides (the JAX engine's Pallas kernels in interpret
    mode) or on neither, and charges the same token costs."""
    import dataclasses
    import jax
    import torch
    from repro import models as jmodels
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.core.scheduler import HASGPUScheduler as JScheduler
    from repro.core.vgpu import PodAlloc as JPod, VirtualGPU as JVGPU
    from repro.models import CallOpts as JCallOpts
    from repro.serving import InferenceRequest as JRequest, PodEngine as JEngine
    from repro_torch.models import CallOpts
    from repro_torch.weights import params_from_jax

    jcfg = dataclasses.replace(jreduced(JARCHS[arch]), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    jparams = jmodels.init_params(jax.random.PRNGKey(8), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(8)

    uid = f"{arch}-{int(use_kernels)}"
    jg = JVGPU(f"GPU-jax-{uid}")
    jpod = JPod(fn_id="f", sm=8, quota=1.0, batch=3)
    jg.place(jpod)
    jeng = JEngine(jcfg, jpod, jg, JScheduler(), max_seq=64, params=jparams,
                   opts=JCallOpts(use_kernels=use_kernels), pad_id=2)
    g = VirtualGPU(f"GPU-torch-{uid}")
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    g.place(pod)
    eng = PodEngine(cfg, pod, g, HASGPUScheduler(), max_seq=64,
                    params=params, opts=CallOpts(use_kernels=use_kernels),
                    pad_id=2, device="cpu")
    extra = eng._extra_inputs(3)
    want_keys = {"visual_embeds"} if cfg.num_visual_tokens else {"frame_embeds"}
    assert set(extra) == want_keys
    for key, x in extra.items():
        assert x.dtype == torch.bfloat16 and not x.any()
        assert tuple(x.shape) == tuple(jeng._extra_inputs(3)[key].shape)
    seen = []
    decode = eng._decode

    def spy(params_, tok, pos, cache):
        seen.append(pos)
        return decode(params_, tok, pos, cache)

    eng._decode = spy
    for lengths in ((7, 12, 3), (20, 5, 9)):
        for n in lengths:
            p = rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
            jeng.submit(JRequest(prompt=p, max_new_tokens=5))
            eng.submit(InferenceRequest(prompt=p, max_new_tokens=5))
        want = [r.output for r in jeng.step()]
        got = [r.output for r in eng.step()]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    v = cfg.num_visual_tokens
    assert seen == [v + 12 + i for i in range(5)] + [v + 20 + i for i in range(5)]
    assert eng.libhas.launches == jeng.libhas.launches == 2 * (1 + 5)
    assert eng.libhas.tokens_acquired_s == pytest.approx(
        jeng.libhas.tokens_acquired_s)
