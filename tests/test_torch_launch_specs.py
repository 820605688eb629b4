"""The port's dry-run cases (``launch/specs.py``) against the JAX
package's: ``call_opts``, ``kv_len_for``, ``default_microbatches``, the
scan trip hints, ``combo_is_supported`` and the token-batch shapes, for
every arch x shape x production mesh (duck-typed meshes: no devices, no
process group). Then the fp8 cache probe: the decode case at
``CallOpts.cache_dtype="float8_e4m3fn"``, the only place the reference
reads it, traced shape-only in both packages."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES

from repro_torch import configs, models
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import specs
from repro_torch.launch.mesh import HostMesh



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
COMBOS = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES]


def meshes(name):
    axes, shape = MESHES[name]
    return (types.SimpleNamespace(mesh_dim_names=axes, shape=shape),
            types.SimpleNamespace(axis_names=axes,
                                  devices=np.empty(shape, np.int8)))


@pytest.mark.parametrize("arch,shape,mesh", COMBOS)
def test_case_parameters_match_reference(arch, shape, mesh):
    cfg, shp = ARCHS[arch], SHAPES[shape]
    jcfg, jshp = JARCHS[arch], JSHAPES[shape]
    pm, jm = meshes(mesh)
    assert configs.combo_is_supported(arch, shape) == \
        jconfigs.combo_is_supported(arch, shape)
    assert dataclasses.asdict(specs.call_opts(cfg, shp, pm)) == \
        dataclasses.asdict(jspecs.call_opts(jcfg, jshp, jm))
    assert dataclasses.asdict(specs.call_opts(cfg, shp)) == \
        dataclasses.asdict(jspecs.call_opts(jcfg, jshp))
    assert specs.kv_len_for(cfg, shp) == jspecs.kv_len_for(jcfg, jshp)
    assert specs.default_microbatches(cfg, shp, pm) == \
        jspecs.default_microbatches(jcfg, jshp, jm)
    assert specs._scan_hints(cfg, shp) == jspecs._scan_hints(jcfg, jshp)
    with FakeTensorMode():
        batch = specs.token_batch_specs(cfg, shp)
    want = jspecs.token_batch_specs(jcfg, jshp)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in batch.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_build_case_refuses_unsupported_combo():
    with pytest.raises(ValueError, match="not supported"):
        specs.build_case(ARCHS["whisper-medium"], SHAPES["long_500k"],
                         HostMesh(torch.device("cpu")))


def test_host_mesh_case_is_plain():
    """On the 1x1 host mesh the arguments stay plain tensors, and the
    argument bytes are every leaf's."""
    cfg = configs.reduced(ARCHS["olmo-1b"])
    mesh = HostMesh(torch.device("cpu"))
    with FakeTensorMode():
        case = specs.build_case(cfg, SHAPES["decode_32k"], mesh, batch=2)
        assert specs.distribute_case(case, mesh) is case.args
    leaves = torch.utils._pytree.tree_leaves(case.args)
    assert specs.argument_bytes(case, mesh) == sum(
        t.numel() * t.element_size() for t in leaves)
    assert case.step_name == "decode_step" and case.donate_argnums == (3,)
    assert case.args[2].shape == () and case.args[2].dtype == torch.int32


def fp8_cases(arch):
    shp = dataclasses.replace(SHAPES["decode_32k"], global_batch=2,
                              seq_len=64)
    jshp = dataclasses.replace(JSHAPES["decode_32k"], global_batch=2,
                               seq_len=64)
    jcfg = JARCHS[arch]
    jcase = jspecs.build_case(jcfg, jshp, meshes("16x16")[1],
                              opts=jspecs.call_opts(
                                  jcfg, jshp, cache_dtype="float8_e4m3fn"))
    return shp, jcase


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-medium"])
def test_fp8_cache_attention_decode_traces_in_both(arch):
    """The reference builds the decode case's cache at
    ``CallOpts.cache_dtype`` (``launch/specs.py:175``). At float8_e4m3fn
    an attention model's decode traces in both packages (shape only,
    full width, B 2, kv 64) to the same logits shape and an f8 cache of
    the same size: the port converts the f8 ring after its read."""
    cfg = ARCHS[arch]
    shp, jcase = fp8_cases(arch)
    jout = jax.eval_shape(jcase.fn, *jcase.args)
    jcache = [l for l in jax.tree.leaves(jout[1]) if l.dtype != jnp.float32]
    assert jcache and all(l.dtype == jnp.float8_e4m3fn for l in jcache)
    mesh = HostMesh(torch.device("cpu"))
    with FakeTensorMode():
        case = specs.build_case(cfg, shp, mesh, opts=specs.call_opts(
            cfg, shp, cache_dtype="float8_e4m3fn"))
        logits, cache = case.fn(*case.args)
    assert tuple(logits.shape) == tuple(jout[0].shape)
    leaves = [t for t in torch.utils._pytree.tree_leaves(cache)
              if t.dtype != torch.float32]
    assert leaves and all(t.dtype == torch.float8_e4m3fn for t in leaves)
    # the reference stacks its period layers: compare the f8 elements
    assert sum(t.numel() for t in leaves) == sum(l.size for l in jcache)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_fp8_cache_ssm_decode_refused_by_both(arch):
    """An SSM layer's decode joins its f8 conv state to the new bf16 input:
    JAX refuses the implicit f8 promotion when it traces the reference's
    case, and torch's ``cat`` refuses it when the port's decode runs (on
    the reduced config, eager on the CPU)."""
    from repro_torch.configs import reduced
    _, jcase = fp8_cases(arch)
    with pytest.raises(Exception, match="8-bit floats do not support"):
        jax.eval_shape(jcase.fn, *jcase.args)
    cfg = reduced(ARCHS[arch])
    params = models.init_params(cfg, seed=0, device="cpu")
    cache = models.init_cache(cfg, 2, 16, torch.float8_e4m3fn, "cpu")
    with pytest.raises(RuntimeError, match="Promotion for Float8"):
        models.decode_step(params, cfg, torch.zeros((2, 1), dtype=torch.int32),
                           3, cache)
