"""The port's sharding against the JAX reference's, and DTensor at world size 1.

For all ten archs at full width: ``model_specs`` and ``cache_specs`` equal
the JAX package's leaf for leaf; ``abstract_params`` has the shapes and
dtypes of JAX's ``abstract_params`` (``jax.eval_shape``), compared by
path; ``rules_for`` and ``resolve_spec`` give the reference's mesh axes for
every leaf of the params and the decode cache on the 1×1, 16×16 and
2×16×16 meshes under each rule knob. The port's meshes are
``DeviceMesh``es over the fake process-group backend (``launch.mesh``);
JAX's ``resolve_spec`` reads only a mesh's ``shape`` and ``axis_names``, so
it gets a stub and needs no 512 devices. Each test that starts a process
group destroys it.

At world size 1 (gloo over a ``HashStore``): placements put a reduced
model's leaves onto a 1×1 mesh with ``distribute_tensor``, and
``checkpoint.restore`` with placements gives back the saved values as
DTensors with those placements.
"""
import dataclasses
import functools
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.runtime import sharding as jsh
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.runtime import checkpoint
from repro_torch.runtime import sharding as sh
from repro_torch.tree import is_spec, leaves, paths

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESHES = {"1x1": ((1, 1), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KNOBS = [dict(zip(("fsdp", "shard_kv_seq", "expert_parallel", "tensor_parallel"), v))
         for v in itertools.product((False, True), repeat=4)]


@functools.cache
def jax_trees(arch):
    """JAX's abstract params (as {path: (shape, dtype)}), model specs and cache specs."""
    jcfg = jax_get_config(arch)
    abstract = {p: (tuple(a.shape), str(a.dtype))
                for p, a in paths(JM.abstract_params(jcfg))}
    return abstract, JM.model_specs(jcfg), JM.cache_specs(jcfg)


@pytest.fixture
def fake_world():
    """The port's three meshes in the fake world of 512 ranks (1×1 on rank 0)."""
    from torch.distributed.device_mesh import DeviceMesh

    meshes = {"16x16": mesh_lib.make_production_mesh(),
              "2x16x16": mesh_lib.make_production_mesh(multi_pod=True)}
    meshes["1x1"] = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.long),
                               mesh_dim_names=("data", "model"))
    yield meshes
    dist.destroy_process_group()


@pytest.fixture
def world_of_one():
    mesh = mesh_lib.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def canonical(spec):
    """A resolved spec with each 1-tuple of axes as its one name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


def jax_mesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_and_cache_specs_equal_jax(arch):
    _, jspecs, jcache = jax_trees(arch)
    cfg = get_config(arch)
    assert dict(paths(M.model_specs(cfg), is_leaf=is_spec)) == dict(paths(jspecs, is_leaf=is_spec))
    assert (dict(paths(M.cache_specs(cfg), is_leaf=is_spec))
            == dict(paths(jcache, is_leaf=is_spec)))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax_shapes_and_dtypes(arch):
    want, _, _ = jax_trees(arch)
    got = M.abstract_params(get_config(arch))
    assert all(t.device.type == "meta" for t in leaves(got))
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in paths(got)}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_resolve_spec_equal_jax(arch, fake_world):
    cfg = get_config(arch)
    trees = [(M.abstract_params(cfg), M.model_specs(cfg)),
             (M.init_cache(cfg, 128, 32768, device="meta"), M.cache_specs(cfg))]
    leaves_specs = [(tuple(a.shape), s) for tree, specs in trees
                    for a, s in zip(leaves(tree), leaves(specs, is_leaf=is_spec), strict=True)]
    n_sharded = 0
    for name, knobs in itertools.product(MESHES, KNOBS):
        mesh, jmesh = fake_world[name], jax_mesh(name)
        rules = sh.rules_for(mesh, **knobs)
        assert rules == jsh.rules_for(jmesh, **knobs)
        for shape, spec in leaves_specs:
            got = sh.resolve_spec(spec, shape, mesh, rules)
            want = canonical(tuple(jsh.resolve_spec(spec, shape, jmesh, rules)))
            assert got == want, (name, knobs, spec, shape)
            places = sh.placements(got, mesh)
            n_sharded += any(p.is_shard() for p in places)
            local = sh.local_shape(shape, places, mesh)
            assert np.prod(local) * mesh.size() >= np.prod(shape)
    assert n_sharded > 0


def test_local_shape_agrees_with_dtensor_and_refuses_uneven_shards(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    cfg = get_config("mixtral_8x7b")
    for name in ("16x16", "2x16x16"):
        mesh = fake_world[name]
        params = M.abstract_params(cfg)
        places = sh.tree_shardings(params, M.model_specs(cfg), mesh,
                                   sh.rules_for(mesh, fsdp=True))
        for t, p in zip(leaves(params), leaves(places, is_leaf=sh.is_placements), strict=True):
            want, _ = compute_local_shape_and_global_offset(tuple(t.shape), mesh, list(p))
            assert sh.local_shape(tuple(t.shape), p, mesh) == tuple(want)
    # torch would give some devices 63 rows of 1000; the guard never asks for that
    with pytest.raises(AssertionError, match="uneven"):
        sh.local_shape((1000, 64), (Shard(0), Replicate()), fake_world["16x16"])
    assert sh.resolve_spec(("vocab", "embed"), (1000, 64), fake_world["16x16"],
                           sh.rules_for(fake_world["16x16"], fsdp=True)) == (None, "data")


def test_batch_sharding_and_replicated(fake_world):
    mesh = fake_world["2x16x16"]
    assert [p.is_shard(0) for p in sh.batch_sharding(mesh, 2, 256)] == [True, True, False]
    assert all(p.is_replicate() for p in sh.batch_sharding(mesh, 2, 1))  # long_500k's batch
    assert all(p.is_replicate() for p in sh.replicated(mesh))


def _reduced_tree():
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")), n_heads=4, n_kv_heads=2)
    return cfg, M.init_model(cfg, seed=1, device="cpu")


def test_placements_hold_at_world_size_one(world_of_one):
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = world_of_one
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    cfg, params = _reduced_tree()
    places = sh.tree_shardings(params, M.model_specs(cfg), mesh, sh.rules_for(mesh, fsdp=True))
    flat = leaves(places, is_leaf=sh.is_placements)
    assert any(p.is_shard() for pl in flat for p in pl)  # every axis divides on a 1x1 mesh
    for t, pl in zip(leaves(params), flat, strict=True):
        d = distribute_tensor(t, mesh, list(pl))
        assert isinstance(d, DTensor) and tuple(d.placements) == pl
        assert torch.equal(d.to_local(), t) and torch.equal(d.full_tensor(), t)
        assert sh.local_bytes(t, pl, mesh) == t.numel() * t.element_size()


def test_restore_puts_leaves_onto_the_mesh(world_of_one, tmp_path):
    from torch.distributed.tensor import DTensor

    mesh = world_of_one
    cfg, params = _reduced_tree()
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, params, step=7)
    places = sh.tree_shardings(params, M.model_specs(cfg), mesh, sh.rules_for(mesh, fsdp=True))
    tree, step = checkpoint.restore(path, params, places, mesh)
    assert step == 7
    for got, want, pl in zip(leaves(tree), leaves(params),
                             leaves(places, is_leaf=sh.is_placements), strict=True):
        assert isinstance(got, DTensor) and tuple(got.placements) == pl
        assert torch.equal(got.full_tensor(), want)
