"""(restarts, samples) device meshes over torch.distributed, held against
salamander_tpu/parallel/mesh.py.

Axes:
  'restarts' - independent fits (multi-start lanes, rank-scan points): each
               rank fits its own block of lanes, and the only communication
               is gathering the results at the end.
  'samples'  - the D axis of X and H: each rank holds a block of samples.
               The W-update numerator (aux @ H^T) and every objective sum
               over D, so those sums are all-reduced over this axis.

The JAX package shards one SPMD program and XLA inserts its collectives.
PyTorch has no such compiler: the port runs one process per card (a rank),
every rank of a mesh calls the same driver, and the sums over D call their
collective explicitly (sample_sum). Only all_reduce is used (a barrier is
an all_reduce too), since gloo takes CUDA tensors for all_reduce and
broadcast alone. A helper calls nothing on an axis of size 1.

Multi-node: init_distributed() brings up the process group, and
make_hybrid_mesh() keeps every sample-axis row inside one node (JAX's
slice), so only the communication-free restart axis crosses nodes.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

RESTART_AXIS = "restarts"
SAMPLE_AXIS = "samples"

# every process group gets one: a rank that stops calling fails the run
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _backend(device: torch.device) -> str:
    return "gloo" if device.type == "cpu" else "nccl"


def _resolve(device) -> torch.device:
    from ..models.signature_nmf import resolve_device

    return resolve_device(device)


def _init_world_of_one(device: torch.device) -> None:
    """A process group of this process alone, on an in-process store: the
    counterpart of a single JAX process, which sees its own devices."""
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(_backend(device), store=dist.HashStore(),
                            rank=0, world_size=1, timeout=DEFAULT_TIMEOUT)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    **kwargs,
) -> None:
    """Bring up torch.distributed, one process per card (idempotent: an
    initialized process group is kept).

    With coordinator_address='host:port', num_processes and process_id the
    ranks rendezvous on tcp://host:port. With none, torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) is read; a
    plain process without it is a world of one. device=None means the card
    (backend nccl; raises without one), device='cpu' the CPU (gloo);
    `backend`, `timeout`, `store` and the other arguments of
    init_process_group pass through `kwargs`. On a card the process takes
    card LOCAL_RANK (else process_id), modulo the visible cards, so
    resolve_device(None) is that rank's card. A timeout is always set: a
    rank that stops calling fails the run instead of hanging it.
    """
    if dist.is_initialized():
        return
    device = _resolve(device)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and "store" not in kwargs \
            and not torchrun:
        _init_world_of_one(device)
        return
    if coordinator_address is not None or "store" in kwargs:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed needs num_processes and "
                             "process_id with a coordinator_address or a "
                             "store")
        rank, world_size = int(process_id), int(num_processes)
        if coordinator_address is not None:
            kwargs["init_method"] = f"tcp://{coordinator_address}"
    else:
        rank, world_size = int(os.environ["RANK"]), int(
            os.environ["WORLD_SIZE"])
        kwargs.setdefault("init_method", "env://")
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kwargs.setdefault("backend", _backend(device))
    kwargs.setdefault("timeout", DEFAULT_TIMEOUT)
    dist.init_process_group(rank=rank, world_size=world_size, **kwargs)


class RankDevice(NamedTuple):
    """One rank of the world and the node (JAX's slice) it runs on."""

    id: int
    slice_index: int


def world_devices() -> list[RankDevice]:
    """Every rank of the process group with its node. Under torchrun the
    nodes are LOCAL_WORLD_SIZE ranks each, in rank order; elsewhere one
    node holds every rank."""
    world_size = dist.get_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return [RankDevice(rank, rank // per_node) for rank in range(world_size)]


def slice_groups(devices) -> list[list]:
    """Group devices by node (one group when they carry no
    slice_index)."""
    groups: dict[int, list] = {}
    for device in devices:
        groups.setdefault(getattr(device, "slice_index", 0), []).append(device)
    return [groups[index] for index in sorted(groups)]


def hybrid_mesh_shape(
    n_devices_per_slice: int,
    n_slices: int,
    sample_ways: int | None = None,
) -> tuple[tuple[int, int], tuple[int, int]]:
    """Factor a multi-node deployment into (per-node shape, cross-node
    shape) for a (restarts, samples) mesh.

    The sample axis all-reduces every iteration, so it never crosses a
    node: its full extent lives inside one node. Restarts communicate only
    at the end, so they take every node plus the leftover ranks of each.
    Returns ((restarts_per_slice, sample_ways), (n_slices, 1)).
    """
    if sample_ways is None:
        _, sample_ways = _factor(n_devices_per_slice)
    if n_devices_per_slice % sample_ways:
        raise ValueError(
            f"{n_devices_per_slice} devices per slice not divisible by "
            f"sample_ways={sample_ways}"
        )
    return (n_devices_per_slice // sample_ways, sample_ways), (n_slices, 1)


def _factor(n_devices: int, max_sample_ways: int = 4) -> tuple[int, int]:
    """Split n_devices into (restart_ways, sample_ways): prefer a modest
    sample-sharding degree and put the rest on restarts."""
    for sample_ways in range(min(max_sample_ways, n_devices), 0, -1):
        if n_devices % sample_ways == 0:
            return n_devices // sample_ways, sample_ways
    return n_devices, 1


def mesh_grid(devices, sample_ways: int | None = None) -> list[list]:
    """The (restart_ways, sample_ways) grid of make_mesh: the devices in
    order, row by row."""
    devices = list(devices)
    n = len(devices)
    if sample_ways is None:
        restart_ways, sample_ways = _factor(n)
    else:
        if n % sample_ways:
            raise ValueError(
                f"{n} devices not divisible by sample_ways={sample_ways}")
        restart_ways = n // sample_ways
    return [devices[row * sample_ways:(row + 1) * sample_ways]
            for row in range(restart_ways)]


def hybrid_grid(devices, sample_ways: int | None = None) -> list[list]:
    """The grid of make_hybrid_mesh: node by node, each node's ranks cut
    into rows of `sample_ways`, so a row never crosses a node."""
    groups = slice_groups(devices)
    if len(groups) == 1:
        return mesh_grid(groups[0], sample_ways)
    per_slice = len(groups[0])
    if any(len(group) != per_slice for group in groups):
        raise ValueError("Slices expose different device counts.")
    (restarts_per_slice, ways), _ = hybrid_mesh_shape(
        per_slice, len(groups), sample_ways)
    return [group[row * ways:(row + 1) * ways]
            for group in groups for row in range(restarts_per_slice)]


def _device_mesh(grid, device) -> DeviceMesh:
    device = _resolve(device)
    if not dist.is_initialized():
        _init_world_of_one(device)
    ranks = [[int(getattr(d, "id", d)) for d in row] for row in grid]
    return DeviceMesh(device.type, torch.tensor(ranks, dtype=torch.int),
                      mesh_dim_names=(RESTART_AXIS, SAMPLE_AXIS))


def make_mesh(devices=None, sample_ways: int | None = None,
              device=None) -> DeviceMesh:
    """A (restarts, samples) DeviceMesh over the given ranks (default: the
    whole world), factored as the JAX package factors its devices. device
    =None means the card, 'cpu' the CPU (gloo). Without a process group it
    brings up a world of one. Every rank of the world calls it."""
    if devices is None:
        devices = (range(dist.get_world_size()) if dist.is_initialized()
                   else [0])
    return _device_mesh(mesh_grid(devices, sample_ways), device)


def make_hybrid_mesh(devices=None, sample_ways: int | None = None,
                     device=None) -> DeviceMesh:
    """A (restarts, samples) DeviceMesh whose sample-axis rows each stay
    inside one node and whose restart axis alone crosses nodes. devices
    default to world_devices(); a single node is make_mesh's layout;
    nodes of different sizes are refused."""
    if devices is None:
        if not dist.is_initialized():
            _init_world_of_one(_resolve(device))
        devices = world_devices()
    return _device_mesh(hybrid_grid(devices, sample_ways), device)


# The batched KLNMF state on a (restarts, samples) mesh: for each leaf, the
# tensor dimension the restart axis and the sample axis split (None: the
# axis replicates it). The drivers slice and gather by these.
KLNMF_LAYOUT = {
    "W": (0, None),      # (R, V, K) restart-sharded, replicated over samples
    "H": (0, 2),         # (R, K, D) restart- and sample-sharded
    "X": (None, 1),      # (V, D) replicated over restarts, sample-sharded
    "mask": (0, None),   # (R, K)
    "per_restart": (0, None),
    "replicated": (None, None),
}


def restart_sharding(mesh: DeviceMesh) -> dict[str, tuple]:
    """KLNMF_LAYOUT as torch.distributed placements, one per mesh axis:
    Shard(dim) where an axis splits a dimension, Replicate() where it
    splits none. (torch.distributed.tensor is imported here, not with the
    module and not on a driver's path: its first import takes seconds.)"""
    from torch.distributed.tensor import Replicate, Shard

    check_mesh(mesh)
    return {name: tuple(Replicate() if dim is None else Shard(dim)
                        for dim in dims)
            for name, dims in KLNMF_LAYOUT.items()}


# ---------------------------------------------------------------------- #
# the collectives XLA inserted for the JAX package
# ---------------------------------------------------------------------- #
def check_mesh(mesh) -> DeviceMesh:
    """Refuse what is not a DeviceMesh."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= takes a torch.distributed DeviceMesh "
            f"(parallel.make_mesh), not {type(mesh).__name__}")
    return mesh


def _axis(mesh: DeviceMesh, name: str) -> int | None:
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """The mesh's extent along axis `name` (1 without a mesh or axis)."""
    if mesh is None:
        return 1
    axis = _axis(check_mesh(mesh), name)
    return 1 if axis is None else mesh.size(axis)


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along axis `name` (0 without the axis)."""
    axis = _axis(mesh, name)
    return 0 if axis is None else mesh.get_local_rank(axis)


def require_axes(mesh: DeviceMesh) -> tuple[int, int]:
    """(restart_ways, sample_ways) of a (restarts, samples) mesh; a mesh
    that lacks either axis is refused."""
    check_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if RESTART_AXIS not in names or SAMPLE_AXIS not in names:
        raise ValueError(
            f"mesh has axes {names}; the batched drivers expect "
            f"'{RESTART_AXIS}' and '{SAMPLE_AXIS}' axes "
            "(parallel.make_mesh)")
    return axis_size(mesh, RESTART_AXIS), axis_size(mesh, SAMPLE_AXIS)


def check_divides(mesh: DeviceMesh, n_lanes: int,
                  n_samples: int | None) -> None:
    """The JAX package's refusal of lanes or samples that the mesh's ways
    do not divide (n_samples None: the samples are not split)."""
    restart_ways, sample_ways = require_axes(mesh)
    if n_lanes % restart_ways or (n_samples is not None
                                  and n_samples % sample_ways):
        samples = "" if n_samples is None else f" and {n_samples} samples"
        raise ValueError(
            f"mesh ({restart_ways} restart x {sample_ways} sample ways) "
            f"must divide the {n_lanes} lanes{samples}"
        )


def _block(n: int, mesh: DeviceMesh, name: str) -> tuple[int, int]:
    ways = axis_size(mesh, name)
    if n % ways:
        what = "lanes" if name == RESTART_AXIS else "samples"
        raise ValueError(f"the mesh's {ways} {name} ways must divide the "
                         f"{n} {what}; pad them to a multiple of {ways}")
    size = n // ways
    index = axis_index(mesh, name)
    return index * size, (index + 1) * size


def lane_range(n_lanes: int, mesh: DeviceMesh) -> tuple[int, int]:
    """[lo, hi) of this rank's lanes of n_lanes."""
    return _block(n_lanes, mesh, RESTART_AXIS)


def sample_range(n_samples: int, mesh: DeviceMesh) -> tuple[int, int]:
    """[lo, hi) of this rank's samples of n_samples."""
    return _block(n_samples, mesh, SAMPLE_AXIS)


def _all_reduce(tensor: torch.Tensor, mesh: DeviceMesh, name: str):
    if axis_size(mesh, name) > 1:
        dist.all_reduce(tensor, group=mesh.get_group(_axis(mesh, name)))
    return tensor


def sample_sum(tensor: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum over the sample axis of each rank's partial sums, the SAME
    bits on every rank (nothing is called on an axis of size 1).

    A plain all_reduce SUM may add the partials in another order on each
    rank (gloo does), so the ranks of a sample row could read values a bit
    apart and take different branches of a data-dependent loop (a line
    search, a Newton early exit, the convergence test), one of them then
    calling a collective that the others never join. Instead each rank
    writes its partial into its row of a zero-filled (ways, ...) buffer,
    the all_reduce fills every row exactly (one nonzero addend an
    element), and every rank adds the rows in the same order."""
    ways = axis_size(mesh, SAMPLE_AXIS)
    if ways == 1:
        return tensor
    rows = tensor.new_zeros((ways,) + tuple(tensor.shape))
    rows[axis_index(mesh, SAMPLE_AXIS)] = tensor
    return _all_reduce(rows, mesh, SAMPLE_AXIS).sum(0)


def samples_reducer(mesh: DeviceMesh):
    """The reduce_samples hook of the ops (ops/klnmf.py) over the mesh's
    sample axis."""
    return lambda partial: sample_sum(partial, mesh)


def restart_sum(tensor: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum over the restart axis (in place): the gather of rows that
    each rank of a sample row wrote into a zero-filled buffer."""
    return _all_reduce(tensor, mesh, RESTART_AXIS)


def _gather(local: torch.Tensor, mesh: DeviceMesh, name: str, axis: int,
            n: int) -> torch.Tensor:
    """The whole of `n` along `axis` from every rank's block: an all_reduce
    SUM of a zero-filled buffer in which each rank writes its own block.
    Exact, as each element has one nonzero addend (NaN stays NaN)."""
    if axis_size(mesh, name) == 1:
        return local
    axis = axis % local.dim()
    lo, hi = _block(n, mesh, name)
    dtype = local.dtype
    wide = local if dtype.is_floating_point else local.to(torch.float64)
    shape = list(local.shape)
    shape[axis] = n
    full = wide.new_zeros(shape)
    full.narrow(axis, lo, hi - lo).copy_(wide)
    _all_reduce(full, mesh, name)
    return full if dtype.is_floating_point else full.to(dtype)


def gather_restarts(local: torch.Tensor, mesh: DeviceMesh,
                    n_lanes: int) -> torch.Tensor:
    """The (n_lanes, ...) tensor of every rank's lanes (axis 0)."""
    return _gather(local, mesh, RESTART_AXIS, 0, n_lanes)


def gather_samples(local: torch.Tensor, mesh: DeviceMesh, n_samples: int,
                   axis: int = -1) -> torch.Tensor:
    """The tensor of every rank's samples along `axis`."""
    return _gather(local, mesh, SAMPLE_AXIS, axis, n_samples)


def local_block(tensor: torch.Tensor, mesh: DeviceMesh,
                dims) -> torch.Tensor:
    """This rank's block of a whole tensor whose dimensions `dims` (one per
    mesh axis, a KLNMF_LAYOUT entry) the axes split: a contiguous slice."""
    for name, dim in zip((RESTART_AXIS, SAMPLE_AXIS), dims):
        if dim is not None:
            lo, hi = _block(tensor.shape[dim], mesh, name)
            tensor = tensor.narrow(dim, lo, hi - lo)
    return tensor.contiguous()


def gather_block(local: torch.Tensor, mesh: DeviceMesh, dims,
                 shape) -> torch.Tensor:
    """The whole tensor of `shape` from every rank's local_block: samples
    first, then restarts, each by _gather."""
    for name, dim in reversed(list(zip((RESTART_AXIS, SAMPLE_AXIS), dims))):
        if dim is not None:
            local = _gather(local, mesh, name, dim, shape[dim])
    return local


def barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the mesh: an all_reduce along each axis (a
    rank leaves the second only once every rank has entered the first)."""
    flag = torch.zeros(1, device=mesh.device_type)
    _all_reduce(flag, mesh, RESTART_AXIS)
    _all_reduce(flag, mesh, SAMPLE_AXIS)


def is_writer(mesh: DeviceMesh | None) -> bool:
    """Whether this rank writes shared outputs (stores, files): the mesh's
    first rank, or the only process without a mesh."""
    if mesh is None:
        return True
    return all(c == 0 for c in (mesh.get_coordinate() or (1,)))


def first_rank_copy(tree: dict, mesh: DeviceMesh) -> dict:
    """Every leaf of a (nested) dict of tensors as the mesh's first rank
    holds it. Each rank draws the whole init, and a draw without a seed
    (sklearn's nndsvd takes numpy's global generator, which every process
    seeds on its own) would differ by rank: the first rank's is taken. One
    all_reduce an axis of a float64 buffer that the first rank alone fills
    (exact: one nonzero addend an element)."""
    from ..engine.tree import tree_flatten, tree_unflatten

    if mesh.size() == 1:
        return tree
    flat = tree_flatten(tree)
    buffer = torch.cat([leaf.reshape(-1).to(torch.float64)
                        for leaf in flat.values()])
    if not is_writer(mesh):
        buffer.zero_()
    for name in (RESTART_AXIS, SAMPLE_AXIS):
        _all_reduce(buffer, mesh, name)
    out, at = {}, 0
    for path, leaf in flat.items():
        out[path] = buffer[at:at + leaf.numel()].reshape(leaf.shape).to(
            leaf.dtype)
        at += leaf.numel()
    return tree_unflatten(out)


def mesh_meta(mesh: DeviceMesh | None):
    """JSON-safe mesh identity for checkpoint metas (axis name/size pairs;
    None off-mesh)."""
    if mesh is None:
        return None
    return [[str(name), int(size)]
            for name, size in zip(mesh.mesh_dim_names, mesh.shape)]


class MeshStore:
    """A checkpoint.ChunkStore shared by the ranks of a mesh: the mesh's
    first rank opens it first (and so alone discards another run's store)
    and writes every entry; a barrier follows each, so every rank then
    loads what was written."""

    def __init__(self, directory, meta: dict, mesh: DeviceMesh):
        from ..checkpoint import ChunkStore

        self.mesh = mesh
        self.writer = is_writer(mesh)
        store = ChunkStore(directory, meta) if self.writer else None
        barrier(mesh)
        self.store = store or ChunkStore(directory, meta)

    def load(self, name: str, match: dict | None = None):
        return self.store.load(name, match)

    def save(self, name: str, match: dict | None = None,
             **arrays: Any) -> None:
        if self.writer:
            self.store.save(name, match, **arrays)
        barrier(self.mesh)


def open_store(directory, meta: dict, mesh: DeviceMesh | None):
    """A ChunkStore, or a MeshStore under a mesh."""
    if mesh is None:
        from ..checkpoint import ChunkStore

        return ChunkStore(directory, meta)
    return MeshStore(directory, meta, mesh)
