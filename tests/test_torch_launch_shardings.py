"""The port's sharding rules (``launch/shardings.py``) against the JAX
package's, leaf by leaf, on all ten archs at full width and both
production meshes: param specs (FSDP on and off), optimizer-state specs,
the batch specs of every shape's batch, and the cache specs of both
decode shapes' caches with ``long_context`` off and on.

Both sides are shape only (FakeTensors, ``jax.eval_shape``) and both get a
duck-typed mesh (axis names and a device grid), so JAX never sees 256
devices and no process group is made. The port's trees are unstacked: a
period layer's spec is held to the reference's stacked spec past its
leading (layer) dim, which the reference leaves unsharded, except on an
SSM ``conv`` cache leaf (``shardings.cache_specs`` says why). DTensor's
order over two mesh dims (``to_placements``) is held to the
reference's major-to-minor ``P(("pod", "data"))`` in a subprocess with a
fake group, one rank's offsets at a time.
"""
import functools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import models as jmodels
from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.launch import shardings as jsh, specs as jspecs
from repro.training import optimizer as jopt

from repro_torch import models
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import shardings as sh, specs
from repro_torch.training import optimizer as opt_mod
from repro_torch.weights import jax_layout

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def jax_mesh(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, np.int8))


def port_mesh(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


@functools.lru_cache(maxsize=None)
def port_params(arch):
    with FakeTensorMode():
        return specs.params_struct(ARCHS[arch])


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jspecs.params_struct(JARCHS[arch])


def stacked(per_layer):
    """The spec of a stacked leaf from its layers' specs (all equal)."""
    assert all(s == per_layer[0] for s in per_layer), per_layer
    return ("stacked",) + tuple(per_layer[0])


def assert_same(got, want, path=""):
    """``got`` (the port's specs in the JAX layout, stacked leaves tagged)
    equals ``want`` (the reference's PartitionSpecs)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, jax.sharding.PartitionSpec):
        want = tuple(want)
        if got and got[0] == "stacked":
            lead, want = want[0], want[1:]
            assert lead is None or path.endswith("/conv"), (path, lead)
            got = got[1:]
        assert tuple(got) == want, (path, got, want)
    else:
        assert isinstance(want, (list, tuple)), (path, type(want))
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}/{i}")


def in_jax_layout(tree, cfg):
    return jax_layout(tree, cfg, stacked)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_opt_specs_match_reference(arch, mesh):
    cfg = ARCHS[arch]
    for fsdp in (True, False):
        got = sh.param_specs(port_params(arch), port_mesh(mesh), fsdp=fsdp)
        want = jsh.param_specs(jax_params(arch), jax_mesh(mesh), fsdp=fsdp)
        assert_same(in_jax_layout(got, cfg), want)
    with FakeTensorMode():
        opt = opt_mod.init_opt_state(port_params(arch))
    p_spec = sh.param_specs(port_params(arch), port_mesh(mesh))
    got = sh.opt_state_specs(opt, p_spec, port_mesh(mesh))
    jopt_state = jax.eval_shape(jopt.init_opt_state, jax_params(arch))
    want = jsh.opt_state_specs(jopt_state, jsh.param_specs(
        jax_params(arch), jax_mesh(mesh)), jax_mesh(mesh))
    assert got.step == tuple(want.step) == ()
    for g, w in ((got.mu, want.mu), (got.nu, want.nu)):
        assert_same(in_jax_layout(g, cfg), w)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_specs_match_reference(arch, mesh):
    for shape in SHAPES:
        with FakeTensorMode():
            batch = specs.token_batch_specs(ARCHS[arch], SHAPES[shape])
        jbatch = jspecs.token_batch_specs(JARCHS[arch], JSHAPES[shape])
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in jbatch.items()}
        assert_same(sh.batch_specs(batch, port_mesh(mesh)),
                    jsh.batch_specs(jbatch, jax_mesh(mesh)))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_specs_match_reference(arch, mesh):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for shape in ("decode_32k", "long_500k"):
        B = SHAPES[shape].global_batch
        kv = specs.kv_len_for(cfg, SHAPES[shape])
        assert kv == jspecs.kv_len_for(jcfg, JSHAPES[shape])
        with FakeTensorMode():
            cache = models.init_cache(cfg, B, kv, torch.bfloat16, "cpu")
        jcache = jax.eval_shape(
            lambda: jmodels.init_cache(jcfg, B, kv, jnp.bfloat16))
        for long_ctx in (False, True):
            got = sh.cache_specs(cache, port_mesh(mesh),
                                 long_context=long_ctx, cfg=cfg)
            want = jsh.cache_specs(jcache, jax_mesh(mesh),
                                   long_context=long_ctx)
            if not cfg.is_encoder_decoder:
                got = in_jax_layout({"layers": got}, cfg)["stack"]
            assert_same(got, want)


def test_cache_specs_need_cfg_for_layer_lists():
    with FakeTensorMode():
        cache = models.init_cache(ARCHS["olmo-1b"], 2, 8, torch.bfloat16,
                                  "cpu")
    with pytest.raises(ValueError, match="needs cfg"):
        sh.cache_specs(cache, port_mesh("16x16"))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = port_mesh("2x16x16")
    assert sh.to_placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.to_placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        sh.to_placements((("data", "pod"),), mesh)
    assert sh.local_shape((64, 32, 48), (("pod", "data"), None, "model"),
                          mesh) == (2, 32, 3)


_OFFSETS = r"""
import sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import shardings as sh
for rank in map(int, sys.argv[1:]):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    shape, offset = compute_local_shape_and_global_offset(
        (16, 6), mesh, sh.to_placements((("pod", "data"), "model"), mesh))
    print(rank, tuple(shape), tuple(offset))
    dist.destroy_process_group()
"""
RANKS = (0, 3, 5, 6)


@functools.lru_cache(maxsize=None)
def rank_offsets():
    """Each rank's (local shape, global offset) on a fake 2x2x2 group: one
    subprocess, each rank's group made and destroyed in turn."""
    out = subprocess.run([sys.executable, "-c", _OFFSETS, *map(str, RANKS)],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return {int(line.split(" ", 1)[0]): line.split(" ", 1)[1]
            for line in out.stdout.splitlines() if line[:1].isdigit()}


@pytest.mark.parametrize("rank", RANKS)
def test_dtensor_order_is_major_to_minor(rank):
    """Rank r sits at mesh coordinate (pod, data, model) = bits of r; a
    dim on ("pod", "data") puts its chunk pod * 2 + data there, as the
    reference's P(("pod", "data")) does."""
    pod, data, model = rank >> 2 & 1, rank >> 1 & 1, rank & 1
    assert rank_offsets()[rank] == \
        f"{(4, 3)} {((pod * 2 + data) * 4, model * 3)}"
