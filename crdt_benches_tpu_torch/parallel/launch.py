"""Run a function on ``n`` ranks of a replica mesh (``parallel/mesh.py``).

    from crdt_benches_tpu_torch.parallel.launch import run_ranks
    results = run_ranks(fn, 4, *args, device="cpu")   # fn(mesh, *args)

- World size 1 runs in this process over a ``dist.HashStore``, and the
  group is destroyed afterwards.
- On the CPU, ``n`` processes are spawned (the ``spawn`` start method),
  joined over gloo through a ``dist.FileStore`` in a temporary directory.
- On CUDA, one process per GPU over NCCL; more ranks than visible GPUs
  raise.

``fn`` must be importable by the children (a module-level function of
this package, so that no child imports anything else).  Results come back
in rank order with every tensor turned into a host numpy array
(:func:`to_host`).  A rank that raises, exits, or does not answer within
``timeout`` seconds makes the call raise, after every child is stopped.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device
from .mesh import replica_mesh


def to_host(obj):
    """``obj`` with every tensor replaced by a numpy copy on the host,
    through tuples (named ones keep their type), lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_host(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _init_group(dev: torch.device, store, rank: int, world: int) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world,
                                device_id=torch.device("cuda", rank))
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)


def _rank_main(fn, rank: int, world: int, dev_type: str, store_path: str,
               args: tuple, results) -> None:
    """One spawned rank: join the group, run ``fn``, put (rank, ok,
    result or traceback) on ``results``."""
    torch.set_num_threads(1)
    dev = torch.device(dev_type)
    try:
        _init_group(dev, dist.FileStore(store_path, world), rank, world)
        try:
            out = to_host(fn(replica_mesh(dev), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, n: int, *args, device: str | torch.device = "cuda",
              timeout: float = 300.0) -> list:
    """``fn(mesh, *args)`` on each of ``n`` ranks; the ranks' results
    (host form) in rank order."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"run_ranks: n={n}")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"run_ranks: {n} ranks, "
                           f"{torch.cuda.device_count()} visible GPUs")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"run_ranks: unsupported device {dev}")
    if n == 1:
        if dist.is_initialized():
            raise RuntimeError("run_ranks: a process group already exists")
        _init_group(torch.device(dev.type), dist.HashStore(), 0, 1)
        try:
            return [to_host(fn(replica_mesh(dev), *args))]
        finally:
            dist.destroy_process_group()
    return _spawn(fn, n, dev.type, args, timeout)


def _spawn(fn, n: int, dev_type: str, args: tuple, timeout: float) -> list:
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="crdt_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, dev_type, os.path.join(tmp, "store"),
                               args, results), daemon=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    out: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n:  # drain the queue before joining
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"run_ranks: rank(s) {dead} exited with "
                        f"{[procs[r].exitcode for r in dead]} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_ranks: ranks {sorted(set(range(n)) - set(out))}"
                        f" gave no result within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {n} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for r, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"run_ranks: rank {r} exited with "
                                   f"{p.exitcode}")
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
