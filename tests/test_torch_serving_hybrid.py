"""Greedy-token parity of the port's CPU ``PodEngine`` with the JAX one for
the two models that one card serves only at cut depth: reduced
jamba-v0.1-52b (SSD, attention and MoE layers in one stack) and reduced
dbrx-132b (attention and 16-expert top-4 MoE), f32 on the same bridged
weights and prompts."""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.scheduler import HASGPUScheduler
from repro_torch.core.vgpu import PodAlloc, VirtualGPU
from repro_torch.serving import InferenceRequest, PodEngine

# batches of prompt lengths. With the kernels on, the JAX engine's Pallas
# gmm asserts that a group's rows fit its block, so its prompts stay short;
# without them a batch whose longest prompt is 128 runs reduced jamba's SSD
# scan over two chunks of 64, so the carried state is used
BATCHES = {True: ((7, 12, 3), (30, 5, 18)),
           False: ((7, 12, 3), (30, 5, 18), (128, 70, 9))}
NEW_TOKENS = 5


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "dbrx-132b"])
def test_hybrid_and_moe_engine_greedy_tokens_match_jax_engine(arch,
                                                              use_kernels):
    """The port's engine emits the JAX engine's greedy tokens batch by
    batch, with the kernels on both sides (the JAX package's Pallas
    kernels in interpret mode) or on neither, and both count the same
    LibHas launches and charge the same token seconds."""
    import jax
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
    jparams = jmodels.init_params(jax.random.PRNGKey(9), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(9)

    uid = f"{arch}-{int(use_kernels)}"
    jg = JVGPU(f"GPU-jax-{uid}")
    jpod = JPod(fn_id="f", sm=8, quota=1.0, batch=3)
    jg.place(jpod)
    jeng = JEngine(jcfg, jpod, jg, JScheduler(), max_seq=256, params=jparams,
                   opts=JCallOpts(use_kernels=use_kernels), pad_id=2)
    g = VirtualGPU(f"GPU-torch-{uid}")
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    g.place(pod)
    eng = PodEngine(cfg, pod, g, HASGPUScheduler(), max_seq=256,
                    params=params, opts=CallOpts(use_kernels=use_kernels),
                    pad_id=2, device="cpu")
    batches = BATCHES[use_kernels]
    for lengths in batches:
        for n in lengths:
            p = rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
            jeng.submit(JRequest(prompt=p, max_new_tokens=NEW_TOKENS))
            eng.submit(InferenceRequest(prompt=p, max_new_tokens=NEW_TOKENS))
        want = [r.output for r in jeng.step()]
        got = [r.output for r in eng.step()]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert (eng.libhas.launches == jeng.libhas.launches
            == len(batches) * (1 + NEW_TOKENS))
    assert eng.libhas.tokens_acquired_s == pytest.approx(
        jeng.libhas.tokens_acquired_s)
