"""The device mesh over ``torch.distributed``, and its collectives.

Counterpart of ``blackhole_simulation_tpu/parallel/mesh.py``:
``local_device_count`` (:14), ``make_mesh`` (:18), ``make_host_chip_mesh``
(:26) and ``initialize_multihost`` (:38).

JAX drives a mesh of devices from one controller; ``torch.distributed`` runs
one process per device. So a port ``Mesh`` is this process's view of the
world: its process group, its rank and its one device. Every rank must make
the same collective calls in the same order, and a rank that raises before
a collective leaves the others waiting until the group's timeout.

* ``make_mesh`` spans the initialised world, or is this process's one
  device when ``torch.distributed`` is not initialised. A mesh of 1 inside
  a larger world is this rank alone and runs no collective. Subgroups are
  not offered: ``dist.new_group`` needs every rank to call it.
* ``make_host_chip_mesh`` has the shape (hosts, chips) = (WORLD_SIZE //
  LOCAL_WORLD_SIZE, LOCAL_WORLD_SIZE); its collectives run over the whole
  group, as JAX's psum over both axes does.
* ``initialize_multihost`` starts the process group over
  ``tcp://<coordinator>``: NCCL for the card, gloo for the CPU.

Collectives by backend (``all_gather``, ``all_reduce_sum``): NCCL gathers
and reduces the tensors where they are, on the card. Gloo works on host
copies: each call copies the tensor to the host, runs the collective there
and copies the result back to the tensor's device. Every gloo call takes
that path, whatever the device, so nothing chooses it at run time (on a
CPU tensor the copies are the tensor itself and a clone).

The collectives are differentiable (``torch.autograd.Function``s), under
the convention of JAX's ``shard_map`` with replicated outputs: every rank
computes the same thing from a collective's result, so each holds the
whole cotangent of it. ``all_gather``'s backward gives a rank its own
slice of that cotangent; ``all_reduce_sum``'s the cotangent itself (the
sum's derivative in each rank's own term); ``replicate`` is the identity
on replicated inputs (a scene's leaves), whose backward all-reduces the
gradients that each rank's shard contributes, so that every rank holds
the whole gradient, as ``shard_map`` psums the cotangent of a replicated
input. A backward that all-reduces is a collective too: every rank must
run the backward, and ``replicate`` makes one all-reduce for all its
tensors, so the order is the same on every rank.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's view of the device mesh.

    ``group``: the process group of the mesh (the world's), or None for a
    one-device mesh, which runs no collective. ``axis_names`` and ``shape``
    name and size the mesh's axes, (n,) or (hosts, chips). ``rank`` is this
    process's place in the mesh and ``device`` its one device. ``backend``:
    ``"nccl"``, ``"gloo"`` or None without a group."""

    group: object | None
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    device: torch.device
    backend: str | None

    @property
    def size(self) -> int:
        """The number of devices (JAX's ``mesh.devices.size``)."""
        return math.prod(self.shape)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def local_device_count() -> int:
    """The devices of this host: ``torch.cuda.device_count()``. On a machine
    without CUDA, where each process drives one CPU device, it is the local
    world size (``LOCAL_WORLD_SIZE``, 1 when unset)."""
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    return _env_int("LOCAL_WORLD_SIZE", 1)


def _mesh_device(device) -> torch.device:
    """``device`` resolved for this process: None and an unindexed ``cuda``
    mean ``cuda:LOCAL_RANK``; ``cpu`` is asked for explicitly. Raises where
    CUDA is absent and the card is asked for."""
    from blackhole_simulation_tpu_torch.render.pipeline import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
    return dev


def _check_one_device(device) -> None:
    """A process without a process group drives one device: with several
    CUDA devices visible it must be told which (or be one rank of many)."""
    wants_cuda = device is None or torch.device(device).type == "cuda"
    if wants_cuda and torch.cuda.device_count() > 1:
        raise RuntimeError(
            f"this process sees {torch.cuda.device_count()} CUDA devices and "
            "torch.distributed is not initialised: start one process per "
            "device (torchrun --nproc_per_node N ...), or ask for a mesh of "
            "one device (n_devices=1)")


def _world_mesh(axis_names, shape, device) -> Mesh:
    backend = dist.get_backend()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the mesh runs on nccl or gloo")
    dev = _mesh_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL mesh needs a CUDA device")
    return Mesh(dist.group.WORLD, tuple(axis_names), tuple(shape),
                dist.get_rank(), dev, backend)


def _alone(axis_names, device) -> Mesh:
    return Mesh(None, tuple(axis_names), (1,) * len(axis_names), 0,
                _mesh_device(device), None)


def make_mesh(n_devices: int | None = None, axis_name: str = "devices",
              device=None) -> Mesh:
    """A 1-D mesh: the initialised world (``n_devices`` None or the world
    size), or this rank alone (``n_devices`` 1). Without an initialised
    process group the mesh is this process's one device. ``device``: this
    rank's device, ``cuda:LOCAL_RANK`` by default; ``"cpu"`` runs the
    kernels' plain versions (gloo)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, world, 1):
            raise ValueError(
                f"n_devices={n_devices}: a mesh spans the world of {world} "
                "processes (one device each) or this rank alone (1)")
        if n_devices == 1 and world > 1:
            return _alone((axis_name,), device)
        return _world_mesh((axis_name,), (world,), device)
    if n_devices not in (None, 1):
        raise ValueError(
            f"n_devices={n_devices}: torch.distributed is not initialised, so "
            "the world is this one process; start one process per device "
            "(torchrun --nproc_per_node N ...)")
    if n_devices is None:
        _check_one_device(device)
    return _alone((axis_name,), device)


def make_host_chip_mesh(axis_names=("hosts", "chips"), device=None) -> Mesh:
    """A 2-D (hosts, chips) mesh over the initialised world: LOCAL_WORLD_SIZE
    processes per host. Its collectives reduce over both axes at once.
    Without a process group it is (1, 1), this process's one device."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        local = _env_int("LOCAL_WORLD_SIZE", world)
        if local < 1 or world % local:
            raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the "
                             f"world of {world}")
        return _world_mesh(axis_names, (world // local, local), device)
    _check_one_device(device)
    return _alone(axis_names, device)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None) -> None:
    """Start ``torch.distributed`` over ``tcp://<coordinator>`` (host:port;
    MASTER_ADDR:MASTER_PORT when None) for ``num_processes`` processes, this
    one ``process_id`` (RANK when None): NCCL when this process's device is
    a card, after selecting ``cuda:LOCAL_RANK``; gloo for ``"cpu"``. Three
    attempts, then RuntimeError. A no-op for at most one process."""
    if num_processes is None or num_processes <= 1:
        return
    dev = _mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator is None:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if process_id is None:
        process_id = _env_int("RANK", 0)
    last = None
    for _ in range(3):
        try:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id,
            )
            return
        except Exception as e:  # noqa: BLE001 - the init races; retry
            last = e
    raise RuntimeError(f"multi-host init failed after retries: {last}")


def _gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    host = mesh.backend == "gloo"
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=0).to(x.device)


def _reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    host = mesh.backend == "gloo"
    buf = (x.detach().cpu() if host else x.detach()).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _gather(mesh, x)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.rows
        return None, g[lo:lo + ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        return _reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        like = next(g for g in gs if g is not None)
        flat = torch.cat([
            (g if g is not None else like.new_zeros(shape)).reshape(-1)
            .to(like.dtype) for g, shape in zip(gs, ctx.shapes)])
        total = _reduce(ctx.mesh, flat)
        out, at = [], 0
        for g, shape in zip(gs, ctx.shapes):
            k = math.prod(shape)
            part = total[at:at + k].reshape(shape)
            out.append(part.to(g.dtype) if g is not None else part)
            at += k
        return (None, *out)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, on ``x``'s device; ``x`` itself on a mesh without a group.
    Differentiable: the backward gives this rank the rows of the cotangent
    that its ``x`` filled."""
    if mesh.group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(mesh, x)
    return _gather(mesh, x)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor on ``x``'s device);
    ``x`` itself on a mesh without a group. Differentiable: the backward
    passes this rank's cotangent of the sum to its ``x``."""
    if mesh.group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(mesh, x)
    return _reduce(mesh, x)


def replicate(mesh: Mesh, xs):
    """The tensors ``xs`` (replicated: the same on every rank) as they are,
    for the forward; in the backward, every rank's gradients of them
    summed over the mesh in one all-reduce (in the gradients' dtype), so
    that each rank holds the whole gradient of what all the shards computed
    from them. ``xs`` itself on a mesh without a group, or where none of
    them requires grad. Every rank must pass the same tensors, and run the
    backward."""
    xs = list(xs)
    if (mesh.group is None or not torch.is_grad_enabled()
            or not any(x.requires_grad for x in xs)):
        return xs
    return list(_Replicate.apply(mesh, *xs))
