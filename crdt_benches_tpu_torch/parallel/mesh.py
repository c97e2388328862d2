"""Replicas sharded over devices (the JAX package's ``parallel/mesh.py``).

JAX shards the simulated replicas over a ``replicas`` mesh axis with
``shard_map`` and agrees on convergence with ``pmin``/``pmax``.  The port
runs one process per device on ``torch.distributed``: each rank holds
R/world of the replicas on its own device, exchanges op logs with
``all_gather`` and reduces its digests with ``all_reduce`` MIN and MAX.
The backend is NCCL for CUDA tensors and gloo on the CPU; a group on a CUDA
device that is not NCCL, or more ranks than visible GPUs, raises
(:func:`replica_mesh`).  ``parallel/launch.py run_ranks`` starts the ranks.

Each ``sharded_*`` function takes the mesh and the static sizes, as JAX's
does, and returns a step that every rank calls on its own shard of the
inputs (:func:`shard_rows`) and the replicated rest (:func:`sharded_call`
runs a step from global host inputs).  A step returns this rank's state,
this rank's digests int32[r_local, 3] and the converged flag, which every
rank shares.  Gathering is tiled: the ranks' shards
concatenated in rank order, then flattened, which is the order of JAX's
``all_gather(..., tiled=True).reshape(-1)``.

JAX's ``nbits`` (the roll cascade of its run merge) has no counterpart:
the port's applies expand with one gather.

The serve fleet's mesh (:class:`FleetMesh`, :func:`fleet_mesh`,
:func:`fleet_sharding`) is another thing: one process keeps shard s's rows
of every ``DocPool`` bucket on shard s's device and launches the serve
kernels once a shard.  Resolve and apply are row-local, so the fleet step
needs no collective and no process group.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..engine.downstream import down_packed_init, init_down_state
from ..engine.merge import merge_oplogs, merge_oplogs_packed
from ..engine.merge_range import delete_fold, merge_runlogs
from ..engine.replay import replay_units
from ..ops.apply import DocState, init_state
from ..utils.digest import doc_digest, doc_digest_packed


@dataclass(frozen=True)
class ReplicaMesh:
    """This process's place in the replica mesh: its rank, the world size
    and the device its replicas live on."""

    rank: int
    world: int
    device: torch.device


def replica_mesh(device: str | torch.device = "cuda") -> ReplicaMesh:
    """The replica mesh of the initialized default process group.  On CUDA
    the group must be NCCL and rank r runs on GPU r (one host); on the CPU
    it must be gloo.  Anything else raises: nothing falls back to the CPU
    or to gloo."""
    if not dist.is_initialized():
        raise RuntimeError("replica_mesh: no process group is initialized "
                           "(parallel/launch.py run_ranks starts one)")
    dev = resolve_device(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    if dev.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(f"replica_mesh: a CUDA mesh needs the nccl "
                               f"backend, the group is {backend}")
        if world > torch.cuda.device_count():
            raise RuntimeError(f"replica_mesh: {world} ranks, "
                               f"{torch.cuda.device_count()} visible GPUs")
        dev = torch.device("cuda", rank)
    elif dev.type == "cpu":
        if backend != "gloo":
            raise RuntimeError(f"replica_mesh: a CPU mesh needs the gloo "
                               f"backend, the group is {backend}")
    else:
        raise ValueError(f"replica_mesh: unsupported device {dev}")
    return ReplicaMesh(rank, world, dev)


@dataclass(frozen=True)
class FleetMesh:
    """The serve fleet's mesh: one device per shard, in shard order (the
    port's ``Mesh`` of JAX's docs-over-mesh layout)."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        """The placement in words, e.g. ``8 shards on 1 GPU: cuda:0``."""
        used = sorted({str(d) for d in self.devices})
        if self.devices[0].type != "cuda":
            return f"{self.size} shards on the CPU"
        n = len(used)
        return (f"{self.size} shards on {n} GPU{'s' if n > 1 else ''}: "
                + ", ".join(used))


def fleet_mesh(n: int, device: str | torch.device = "cuda") -> FleetMesh:
    """A mesh of ``n`` shards (``n >= 2``; fewer is no mesh).  On the CPU
    every shard lives on the CPU (JAX's virtual CPU mesh); on CUDA shard s
    lives on ``cuda:(s mod G)``, G the visible GPUs, so the shards always
    number ``n`` whatever the card count."""
    if n < 2:
        raise ValueError(f"fleet_mesh: a mesh needs 2 or more shards, got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        g = torch.cuda.device_count()
        return FleetMesh(tuple(torch.device("cuda", s % g) for s in range(n)))
    if dev.type != "cpu":
        raise ValueError(f"fleet_mesh: unsupported device {dev}")
    return FleetMesh((torch.device("cpu"),) * n)


def fleet_sharding(mesh: FleetMesh) -> tuple[torch.device, ...]:
    """The docs-over-mesh layout of every ``DocPool`` bucket (JAX's
    ``NamedSharding(mesh, P(AXIS))``): the row axis splits into
    ``mesh.size`` equal blocks, block s on ``fleet_sharding(mesh)[s]``."""
    return mesh.devices


def device_memory_stats(n_devices: int | None = None,
                        device: str | torch.device = "cuda",
                        devices=None) -> list[dict | None]:
    """Allocator stats of the first ``n_devices`` devices (all visible ones
    by default), or of each device of ``devices`` (a mesh's shards, one
    entry a shard): ``torch.cuda.memory_stats`` for each GPU, and None for
    the CPU, which has no allocator telemetry (as JAX answers for its
    virtual CPU mesh).  A local query, not a sync."""
    if devices is not None:
        return [torch.cuda.memory_stats(d) if d.type == "cuda" else None
                for d in devices]
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [None] * (1 if n_devices is None else n_devices)
    n = torch.cuda.device_count()
    return [torch.cuda.memory_stats(i)
            for i in range(n if n_devices is None else min(n, n_devices))]


def shard_rows(mesh: ReplicaMesh, x) -> torch.Tensor:
    """This rank's rows of ``x`` (an array or tensor whose leading axis
    splits evenly over the ranks), contiguous on the mesh's device: the
    port's ``device_put`` with ``P("replicas")``."""
    n = len(x)
    if n % mesh.world:
        raise ValueError(f"shard_rows: {n} rows do not split over "
                         f"{mesh.world} ranks")
    k = n // mesh.world
    return _device_copy(mesh, x[mesh.rank * k:(mesh.rank + 1) * k])


def _device_copy(mesh: ReplicaMesh, x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))  # a copy: x may be read-only
    return x.contiguous().to(mesh.device)


def gather_tiled(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along the leading
    axis, then flattened (JAX's ``all_gather(x, tiled=True).reshape(-1)``)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts).reshape(-1)


def converged(digests: torch.Tensor) -> bool:
    """Whether every replica on every rank has the same digest: the minimum
    and maximum over the local replicas, reduced over the ranks (int32
    values as the digest wraps them), must agree."""
    lo = digests.amin(dim=0).contiguous()
    hi = digests.amax(dim=0).contiguous()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return bool((lo == hi).all())


def _to_device(mesh: ReplicaMesh, x, shard: bool):
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a state
        return type(x)(*(_to_device(mesh, f, shard) for f in x))
    return shard_rows(mesh, x) if shard else _device_copy(mesh, x)


def sharded_call(mesh: ReplicaMesh, make_step, step_args: tuple,
                 sharded: tuple, replicated: tuple):
    """``make_step(mesh, *step_args)(*sharded, *replicated)`` with global
    host inputs: this rank's rows of each ``sharded`` input (a state's
    fields each) and a device copy of each ``replicated`` one, as a JAX
    step takes global arrays under its in_specs.  With ``run_ranks``, a
    step runs over the ranks from the host."""
    step = make_step(mesh, *step_args)
    return step(*(_to_device(mesh, x, True) for x in sharded),
                *(_to_device(mesh, x, False) for x in replicated))


def make_sharded_state(mesh: ReplicaMesh, n_replicas: int, capacity: int,
                       n_init: int = 0) -> DocState:
    """This rank's n_replicas/world fresh replica rows (the v1 ``DocState``)
    on its device."""
    if n_replicas % mesh.world:
        raise ValueError(f"n_replicas={n_replicas} not divisible by mesh "
                         f"size {mesh.world}")
    return init_state(n_replicas // mesh.world, capacity, n_init,
                      device=mesh.device)


def sharded_replay_and_digest(mesh: ReplicaMesh):
    """The sharded replay: ``step(state, kind_b, pos_b, slot_b, chars) ->
    (state, digests, converged)``.  Every rank replays its replicas through
    all op batches (int32[N, B], replicated; K5 then the v1 apply, batch by
    batch), digests them and agrees on convergence with the other ranks."""

    def step(state: DocState, kind_b, pos_b, slot_b, chars):
        state = replay_units(state, kind_b, pos_b, slot_b, engine="v1")
        digests = doc_digest(state.order, state.visible, state.length, chars)
        return state, digests, converged(digests)

    return step


def sharded_merge_and_converge(mesh: ReplicaMesh, capacity: int,
                               n_base: int, batch: int):
    """The update exchange and v1 merge: ``step(lamport, agent, kind, elem,
    origin, ch, chars) -> (states, digests, converged)`` with this rank's
    op-log rows int32[r_local, N] (N a multiple of ``batch``).  The six
    fields are gathered over the ranks, and every local replica integrates
    the whole union from the shared base (``engine/merge.py
    merge_oplogs``)."""

    def step(lam, ag, kind, elem, orig, ch, chars):
        union = [gather_tiled(x) for x in (lam, ag, kind, elem, orig, ch)]
        st = init_down_state(lam.shape[0], capacity, n_base,
                             device=mesh.device)
        st = merge_oplogs(st, *union, batch=batch)
        digests = doc_digest(st.order, st.visible, st.length, chars)
        return st, digests, converged(digests)

    return step


def sharded_merge_packed(mesh: ReplicaMesh, capacity: int, n_base: int,
                         batch: int, epoch: int = 4,
                         max_unique: int | None = None):
    """:func:`sharded_merge_and_converge` on the packed path: the same
    exchange, then ``merge_oplogs_packed`` (K7 a batch) into this rank's
    ``DownPacked`` replicas."""

    def step(lam, ag, kind, elem, orig, ch, chars):
        union = [gather_tiled(x) for x in (lam, ag, kind, elem, orig, ch)]
        st = merge_oplogs_packed(
            down_packed_init(lam.shape[0], capacity, n_base,
                             device=mesh.device),
            *union, batch=batch, epoch=epoch, max_unique=max_unique)
        digests = doc_digest_packed(st.doc, st.length, chars)
        return st, digests, converged(digests)

    return step


def _sharded_runs_step(mesh: ReplicaMesh, capacity: int, n_base: int,
                       batch: int, epoch: int, *, gather: bool,
                       r_per_shard: int):
    """The two run-granular paths: the concurrent merge (``gather``: each
    rank holds a shard of the run wire and the union is gathered) and the
    single-writer downstream (the wire replicated, the subscribers
    sharded).  Both integrate with ``merge_runlogs`` (K7 a batch) and the
    one-pass delete fold."""

    def step(lam, ag, s0, rl, orig, dlo, dhi, chars):
        if gather:
            lam, ag, s0, rl, orig, dlo, dhi = (
                gather_tiled(x) for x in (lam, ag, s0, rl, orig, dlo, dhi))
        st = merge_runlogs(
            down_packed_init(r_per_shard, capacity, n_base,
                             device=mesh.device),
            lam, ag, s0, rl, orig, batch=batch, epoch=epoch)
        st = delete_fold(st, dlo, dhi)
        digests = doc_digest_packed(st.doc, st.length, chars)
        return st, digests, converged(digests)

    return step


def sharded_merge_runs(mesh: ReplicaMesh, capacity: int, n_base: int,
                       batch: int, epoch: int):
    """The run merge over the mesh, one replica a rank: ``step(lamport,
    agent, slot0, rlen, origin, dlo, dhi, chars)`` with this rank's shard
    of the five run arrays and of the delete intervals (their lengths
    divisible by the world size; pad runs with rlen == 0 and intervals
    with dlo == -1, both no-ops end to end)."""
    return _sharded_runs_step(mesh, capacity, n_base, batch, epoch,
                              gather=True, r_per_shard=1)


def sharded_downstream_runs(mesh: ReplicaMesh, capacity: int, n_base: int,
                            batch: int, epoch: int, r_per_shard: int):
    """The single-writer downstream over the mesh: the run wire is
    replicated (the broadcast fan-out, nothing gathered) and each rank
    integrates all of it into its ``r_per_shard`` subscriber replicas.
    Same step signature as :func:`sharded_merge_runs`."""
    return _sharded_runs_step(mesh, capacity, n_base, batch, epoch,
                              gather=False, r_per_shard=r_per_shard)
