"""The port's ``dist/`` rule trees against the JAX package's, in one process.

Spec trees are compared entry for entry (a ``P`` against the tuple of a
``PartitionSpec``) for every architecture's parameters and its ``TRAIN_4K``
and ``DECODE_32K`` inputs, on the ``(1, 1)``, ``(16, 16)`` and
``(2, 16, 16)`` meshes (abstract on both sides: the rules read only names
and sizes), with the stand-ins' shapes equal to the reference's
``eval_shape``.  ``named`` is held on a ``DeviceMesh`` over an in-process
fake process group of 256 and 512 ranks, which each test destroys.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core import scenarios as jax_scenarios
from repro.core import stack_scenarios as jax_stack_scenarios
from repro.dist import sharding as jax_sharding
from repro.models import DECODE_32K as JAX_DECODE_32K
from repro.models import TRAIN_4K as JAX_TRAIN_4K
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import scenarios, stack_scenarios
from repro_torch.dist import (
    AbstractMesh, P, activation_shardings, campaign_pspec_tree,
    current_state, distribute, input_pspec_tree, named, param_pspec_tree,
    placements, rules_for_mesh, shard_act)
from repro_torch.dist.sharding import spec_leaves
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import DECODE_32K, TRAIN_4K, build_model
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _jax_mesh(shape, axes):
    try:
        return JaxAbstractMesh(shape, axes)               # jax >= 0.5
    except TypeError:
        return JaxAbstractMesh(tuple(zip(axes, shape)))   # jax 0.4.x


def _jax_flat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JaxP))
    return {jax_sharding._path_str(p): tuple(s) for p, s in flat}


def _port_flat(specs, path=()) -> dict:
    if isinstance(specs, P):
        return {tree.key(path): tuple(specs)}
    out = {}
    for k, v in specs.items():
        out.update(_port_flat(v, path + (k,)))
    return out


def _shapes_jax(values) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(values)
    return {jax_sharding._path_str(p): tuple(v.shape) for p, v in flat}


def _shapes_port(values) -> dict:
    return {tree.key(p): tuple(v.shape)
            for p, v in tree.leaves_with_path(values)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_the_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh, mesh = _jax_mesh(shape, axes), AbstractMesh(axes, shape)
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch))
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    shapes = model.param_specs()
    assert _shapes_port(shapes) == _shapes_jax(jshapes)
    assert (_port_flat(param_pspec_tree(shapes, mesh))
            == _jax_flat(jax_sharding.param_pspec_tree(jshapes, jmesh)))
    for jcell, cell in ((JAX_TRAIN_4K, TRAIN_4K), (JAX_DECODE_32K, DECODE_32K)):
        jspecs, specs = jmodel.input_specs(jcell), model.input_specs(cell)
        assert _shapes_port(specs) == _shapes_jax(jspecs), cell.name
        assert (_port_flat(input_pspec_tree(specs, mesh))
                == _jax_flat(jax_sharding.input_pspec_tree(jspecs, jmesh))), \
            cell.name


def test_fsdp_strategy_matches_the_reference():
    for shape, axes in MESHES.values():
        jmesh, mesh = _jax_mesh(shape, axes), AbstractMesh(axes, shape)
        for strategy in ("2d", "fsdp"):
            want = jax_sharding.rules_for_mesh(jmesh, strategy)
            got = rules_for_mesh(mesh, strategy)
            assert (got.tp, got.dp, got.batch, got.fsdp) == (
                want.tp, want.dp, tuple(want.batch), tuple(want.fsdp))
    shapes = build_model(get_config("qwen3-32b")).param_specs()
    jshapes = jax.eval_shape(jax_build_model(jax_get_config("qwen3-32b")).init,
                             jax.random.PRNGKey(0))
    mesh, jmesh = AbstractMesh(("data", "model"), (16, 16)), \
        _jax_mesh((16, 16), ("data", "model"))
    assert (_port_flat(param_pspec_tree(shapes, mesh, "fsdp"))
            == _jax_flat(jax_sharding.param_pspec_tree(jshapes, jmesh,
                                                       "fsdp")))
    with pytest.raises(ValueError, match="strategy"):
        rules_for_mesh(mesh, "3d")


@pytest.mark.parametrize("dim,cands,sizes", [
    (16, ("pod", "data"), {"pod": 2, "data": 16}),
    (8, ("pod", "data"), {"pod": 2, "data": 16}),
    (51866, ("model",), {"model": 16}),
    (48, ("data", "pod"), {"pod": 2, "data": 16}),
    (6, ("pod", "data", "model"), {"pod": 2, "data": 4, "model": 3}),
])
def test_resolve_dim_matches_the_reference(dim, cands, sizes):
    from repro_torch.dist.sharding import resolve_dim

    used = {"model"} if "model" in sizes else set()    # already taken
    jused = set(used)
    assert resolve_dim(dim, cands, sizes, used) == \
        jax_sharding._resolve_dim(dim, cands, sizes, jused)
    assert used == jused


def test_whisper_vocab_falls_back_to_replication():
    """51,866 rows do not divide 16: the embedding is not split on V."""
    specs = param_pspec_tree(build_model(get_config("whisper-large-v3"))
                             .param_specs(),
                             AbstractMesh(("data", "model"), (16, 16)))
    assert specs["embed"] == P(None, "data")


def test_qwen3_moe_experts_shard_e_over_model_and_f_over_data():
    specs = param_pspec_tree(
        build_model(get_config("qwen3-moe-235b-a22b")).param_specs(),
        AbstractMesh(("data", "model"), (16, 16)))
    assert specs["periods"]["sub0"]["mlp"]["w_gate"] == \
        P(None, "model", None, "data")
    assert specs["periods"]["sub0"]["mlp"]["w_down"] == \
        P(None, "model", "data", None)


@pytest.mark.parametrize("n,mesh_shape", [(8, (4, 1)), (6, (4, 1)),
                                          (8, (2, 2))])
def test_campaign_specs_match_the_reference(n, mesh_shape):
    axes = ("data", "model")
    batched = stack_scenarios([scenarios.fig4_scenario(i % 2, i // 2 % 2,
                                                       device="cpu")
                               for i in range(n)])
    jbatched = jax_stack_scenarios([jax_scenarios.fig4_scenario(i % 2,
                                                                i // 2 % 2)
                                    for i in range(n)])
    mesh, jmesh = AbstractMesh(axes, mesh_shape), _jax_mesh(mesh_shape, axes)
    got = [tuple(s) for s in spec_leaves(campaign_pspec_tree(batched, mesh))]
    want = [tuple(s) for s in jax.tree.leaves(
        jax_sharding.campaign_pspec_tree(jbatched, jmesh),
        is_leaf=lambda x: isinstance(x, JaxP))]
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    lead = "data" if n % mesh_shape[0] == 0 else None
    assert {s[0] for s in got if s} == {lead}


def test_run_campaign_refuses_a_mesh_that_does_not_fit():
    """The reference's checks: the axis exists and divides the rows each
    run shards (the whole campaign, or a chunk)."""
    from repro_torch.core import run_campaign

    batched = stack_scenarios([scenarios.fig4_scenario(0, 0, device="cpu")
                               for _ in range(6)])
    mesh = AbstractMesh(("data", "model"), (4, 1))
    with pytest.raises(ValueError, match="no axis 'pod'"):
        run_campaign(batched, device="cpu", mesh=mesh, axis="pod")
    with pytest.raises(ValueError, match="6 rows is not divisible"):
        run_campaign(batched, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="3 rows is not divisible"):
        run_campaign(batched, chunk_size=3, device="cpu", mesh=mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_campaign(batched, chunk_size=2, device="cpu",
                     mesh=AbstractMesh(("data", "model"), (2, 1)))


# ------------------------------------------------------------- placements
@pytest.fixture
def fake_world():
    """An in-process fake process group; ``fake_world(n)`` makes one of n
    ranks (rank 0), destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_named_gives_dtensor_placements_on_the_pod(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    fake_world(256)
    mesh = make_production_mesh()
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (16, 16)
    shapes = build_model(get_config("qwen3-moe-235b-a22b")).param_specs()
    pl = named(mesh, param_pspec_tree(shapes, mesh))
    assert pl["periods"]["sub0"]["mlp"]["w_gate"] == (Shard(3), Shard(1))
    assert pl["periods"]["sub0"]["mlp"]["router"] == (Replicate(),
                                                      Replicate())
    assert pl["embed"] == (Shard(1), Shard(0))


def test_named_on_the_multi_pod_mesh_checks_axis_order(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    fake_world(512)
    mesh = make_production_mesh(multi_pod=True)
    assert tuple(mesh.shape) == (2, 16, 16)
    spec = input_pspec_tree({"tokens": torch.empty(256, 4)}, mesh)["tokens"]
    assert spec == P(("pod", "data"), None)
    assert placements(mesh, spec) == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="order"):
        placements(mesh, P(("data", "pod"), None))


def test_production_mesh_is_abstract_without_a_matching_world():
    assert not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=True)
    assert isinstance(mesh, AbstractMesh)
    assert (mesh.mesh_dim_names, mesh.shape) == (("pod", "data", "model"),
                                                 (2, 16, 16))


# ------------------------------------------------------------ shard_act
def test_shard_act_is_identity_outside_the_context():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert current_state() is None
    assert shard_act(x, ("batch", None, "model")) is x


def test_context_sets_and_restores_state():
    mesh = AbstractMesh(("data", "model"), (1, 1))
    with activation_shardings(mesh, sequence_parallel=True) as st:
        mesh_, rules, seq_par = current_state()
        assert st == (mesh_, rules, seq_par)
        assert mesh_ is mesh and seq_par is True
        assert rules.tp == "model" and rules.batch == ("data",)
        with activation_shardings(mesh, strategy="fsdp"):
            assert current_state()[1].tp is None
        assert current_state() == st
        x = torch.zeros(4, 4)
        assert shard_act(x, ("batch", "model")) is x   # a plain tensor
        with pytest.raises(ValueError, match="logical"):
            shard_act(x, ("batch", "modle"))
    assert current_state() is None


def test_dtensors_on_a_world_of_one(tmp_path):
    """One gloo rank: ``distribute`` lays a parameter tree out by its specs
    (``full_tensor()`` gives each leaf back), and ``shard_act`` lays a
    DTensor out by the resolved placements."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1))
        params = build_model(get_config("granite-moe-1b-a400m", smoke=True)
                             ).init(torch.Generator().manual_seed(0))
        specs = param_pspec_tree(params, mesh)
        shards = distribute(mesh, params, specs)
        pl = named(mesh, specs)
        for (path, x), d in zip(tree.leaves_with_path(params),
                                tree.leaves(shards)):
            want = pl
            for k in path:
                want = want[k]
            assert tuple(d.placements) == want, tree.key(path)
            assert torch.equal(d.full_tensor(), x), tree.key(path)
        x = torch.arange(24.0).reshape(2, 3, 4)
        d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        with activation_shardings(mesh):
            y = shard_act(d, ("batch", None, "model"))
        assert y.placements == placements(mesh, P("data", None, "model"))
        assert torch.equal(y.full_tensor(), x)
    finally:
        dist.destroy_process_group()
