"""salamander_tpu_torch.parallel.mesh, mirroring tests/test_distributed.py:
the mesh factoring (hybrid_mesh_shape, _factor) value for value against
the JAX package, slice_groups on descriptors with a slice_index, the
refusals of ragged nodes and of counts that do not divide, the
(restarts, samples) grids of make_mesh and make_hybrid_mesh (a node's
ranks stand in for JAX's slice), the DeviceMeshes they build on a world of
one, the placements of restart_sharding, the collective helpers on a
world of one, and init_distributed's idempotence. The spawned worlds of
test_torch_sharding.py and test_torch_multiprocess.py run the helpers
across ranks."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import salamander_tpu_torch as port
from salamander_tpu_torch.parallel import mesh

torch.set_num_threads(1)


@pytest.fixture
def world_of_one():
    """make_mesh without a process group brings up a world of one; it
    ends with the test."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def host_ranks(grid) -> np.ndarray:
    """The rank ids of a grid of rows."""
    return np.asarray([[int(getattr(d, "id", d)) for d in row]
                       for row in grid])


def ranks_on_nodes(n_nodes, per_node):
    return [mesh.RankDevice(i, i // per_node)
            for i in range(n_nodes * per_node)]


@pytest.mark.parametrize("per_slice, n_slices, sample_ways", [
    (8, 4, None), (8, 2, 8), (4, 2, 2), (6, 1, None), (3, 5, None),
    (1, 3, 1), (12, 2, 3),
])
def test_hybrid_mesh_shape_places_samples_inside_slice(per_slice, n_slices,
                                                       sample_ways):
    from salamander_tpu.parallel import hybrid_mesh_shape

    got = port.hybrid_mesh_shape(per_slice, n_slices, sample_ways)
    assert got == hybrid_mesh_shape(per_slice, n_slices, sample_ways)
    (restarts_per_slice, ways), dcn = got
    assert restarts_per_slice * ways == per_slice
    assert dcn == (n_slices, 1)  # samples never cross a node


@pytest.mark.parametrize("n_devices", range(1, 17))
def test_factor_matches_jax(n_devices):
    from salamander_tpu.parallel.mesh import _factor

    assert mesh._factor(n_devices) == _factor(n_devices)
    assert mesh._factor(n_devices, 8) == _factor(n_devices, 8)


def test_hybrid_mesh_shape_rejects_indivisible():
    from salamander_tpu.parallel import hybrid_mesh_shape

    with pytest.raises(ValueError, match="divisible") as expected:
        hybrid_mesh_shape(8, 2, sample_ways=3)
    with pytest.raises(ValueError, match=str(expected.value)):
        port.hybrid_mesh_shape(8, 2, sample_ways=3)


def test_slice_groups_orders_by_slice_index():
    devices = [SimpleNamespace(id=i, slice_index=i % 3) for i in range(12)]
    groups = port.slice_groups(devices)
    assert len(groups) == 3
    assert all(len(group) == 4 for group in groups)
    assert all(d.slice_index == 0 for d in groups[0])
    assert all(d.slice_index == 2 for d in groups[2])
    # a node's ranks keep their order
    assert [d.id for d in groups[1]] == [1, 4, 7, 10]


def test_slice_groups_single_group_without_slice_index():
    groups = port.slice_groups(range(4))
    assert groups == [[0, 1, 2, 3]]


@pytest.mark.parametrize("sample_ways", [None, 1, 2, 4, 8])
def test_grid_of_make_mesh_is_the_jax_factoring(sample_ways):
    """make_mesh's grid is the JAX package's: the ranks in order, row by
    row, (restart_ways, sample_ways) as it factors its devices."""
    import jax

    from salamander_tpu.parallel import make_mesh

    grid = mesh.mesh_grid(range(8), sample_ways)
    expected = make_mesh(jax.devices()[:8], sample_ways)
    assert np.array_equal(
        host_ranks(grid),
        np.vectorize(lambda d: d.id)(expected.devices))


def test_make_mesh_rejects_counts_that_do_not_divide():
    import jax

    from salamander_tpu.parallel import make_mesh

    with pytest.raises(ValueError, match="divisible") as expected:
        make_mesh(jax.devices()[:6], sample_ways=4)
    with pytest.raises(ValueError, match=str(expected.value)):
        mesh.mesh_grid(range(6), 4)


def test_make_hybrid_mesh_single_slice_equals_make_mesh():
    devices = ranks_on_nodes(1, 8)
    assert mesh.hybrid_grid(devices, 2) == mesh.mesh_grid(devices, 2)
    assert host_ranks(mesh.hybrid_grid(devices, 2)).shape == (4, 2)


def test_make_hybrid_mesh_rejects_ragged_slices():
    devices = [mesh.RankDevice(i, 0) for i in range(3)] + [
        mesh.RankDevice(9, 1)]
    with pytest.raises(ValueError, match="different device counts"):
        port.make_hybrid_mesh(devices, device="cpu")
    assert not dist.is_initialized()  # refused before any process group


def test_make_hybrid_mesh_multislice_branch_executes():
    """Two nodes of 4 ranks: every sample-axis row stays inside one node,
    only the restart axis crosses nodes (the JAX package's ICI/DCN
    split), every rank used once."""
    grid = mesh.hybrid_grid(ranks_on_nodes(2, 4))
    assert host_ranks(grid).shape == (2, 4)
    for row in grid:
        assert len({d.slice_index for d in row}) == 1
    assert sorted(d.id for row in grid for d in row) == list(range(8))


def test_make_hybrid_mesh_multislice_restarts_span_nodes():
    grid = mesh.hybrid_grid(ranks_on_nodes(2, 4), sample_ways=2)
    assert host_ranks(grid).shape == (4, 2)
    row_slices = []
    for row in grid:
        slices = {d.slice_index for d in row}
        assert len(slices) == 1
        row_slices.append(slices.pop())
    assert row_slices == [0, 0, 1, 1]


def test_world_devices_read_torchruns_node_size(monkeypatch, world_of_one):
    port.init_distributed(device="cpu")
    assert mesh.world_devices() == [mesh.RankDevice(0, 0)]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert mesh.world_devices() == [mesh.RankDevice(0, 0)]


@pytest.mark.parametrize("build", [port.make_mesh, port.make_hybrid_mesh])
def test_meshes_on_a_world_of_one(build, world_of_one):
    device_mesh = build(device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert tuple(device_mesh.mesh_dim_names) == (mesh.RESTART_AXIS,
                                                 mesh.SAMPLE_AXIS)
    assert tuple(device_mesh.shape) == (1, 1)
    assert mesh.require_axes(device_mesh) == (1, 1)
    assert mesh.is_writer(device_mesh)
    assert mesh.mesh_meta(device_mesh) == [["restarts", 1], ["samples", 1]]
    with pytest.raises(ValueError, match="divisible"):
        build(sample_ways=2, device="cpu")


def test_restart_sharding_keys_and_placements(world_of_one):
    import jax

    from salamander_tpu.parallel import make_mesh
    from salamander_tpu.parallel.mesh import restart_sharding

    got = port.restart_sharding(port.make_mesh(device="cpu"))
    expected = restart_sharding(make_mesh(jax.devices()[:1]))
    assert set(got) == set(expected) == set(mesh.KLNMF_LAYOUT)
    assert got["W"] == (Shard(0), Replicate())
    assert got["H"] == (Shard(0), Shard(2))
    assert got["X"] == (Replicate(), Shard(1))
    assert got["replicated"] == (Replicate(), Replicate())
    for key, placements in got.items():  # one placement per mesh axis
        spec = expected[key].spec
        for axis, placement in zip((mesh.RESTART_AXIS, mesh.SAMPLE_AXIS),
                                   placements):
            dims = [i for i, entry in enumerate(spec) if entry == axis]
            assert (placement.dim if isinstance(placement, Shard)
                    else None) == (dims[0] if dims else None)


def test_helpers_on_a_world_of_one_call_nothing(monkeypatch, world_of_one):
    """On an axis of size 1 the helpers are the identity and call no
    collective."""
    device_mesh = port.make_mesh(device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a collective on an axis of size 1")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.sample_sum(t, device_mesh) is t
    assert mesh.gather_restarts(t, device_mesh, 2) is t
    assert mesh.gather_samples(t, device_mesh, 3) is t
    assert mesh.lane_range(8, device_mesh) == (0, 8)
    assert mesh.sample_range(5, device_mesh) == (0, 5)
    mesh.barrier(device_mesh)
    H = torch.arange(24.0).reshape(2, 3, 4)
    dims = mesh.KLNMF_LAYOUT["H"]
    assert torch.equal(mesh.local_block(H, device_mesh, dims), H)
    assert torch.equal(mesh.gather_block(H, device_mesh, dims, H.shape), H)


def test_helpers_refuse_what_is_not_a_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        mesh.sample_range(4, object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.restart_sharding("auto")
    assert mesh.axis_size(None, mesh.SAMPLE_AXIS) == 1
    assert mesh.is_writer(None) and mesh.mesh_meta(None) is None


def test_init_distributed_is_idempotent(world_of_one):
    """A second call keeps the process group (the JAX package's guard on
    jax.distributed.is_initialized()); without torchrun's environment a
    plain process is a world of one, with the timeout always set."""
    port.init_distributed(device="cpu")
    group = dist.group.WORLD
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    port.init_distributed(device="cpu")
    port.init_distributed(coordinator_address="127.0.0.1:1",
                          num_processes=2, process_id=0, device="cpu")
    assert dist.group.WORLD is group and dist.get_world_size() == 1


def test_init_distributed_needs_the_rank_with_an_address():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        port.init_distributed(coordinator_address="127.0.0.1:1",
                              device="cpu")
    assert not dist.is_initialized()


def test_collectives_are_all_reduce_and_broadcast_alone():
    """The module calls no collective but all_reduce and broadcast (the
    ones gloo takes CUDA tensors for)."""
    import ast
    import inspect

    calls = {
        node.func.attr for node in ast.walk(ast.parse(inspect.getsource(
            mesh)))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "dist"
    }
    assert calls <= {"all_reduce", "broadcast", "init_process_group",
                     "is_initialized", "get_world_size", "HashStore"}
    assert "all_reduce" in calls
