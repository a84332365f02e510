"""Processes that share one global mesh (port of
`upmix_tpu/parallel/distributed.py` on `torch.distributed`).

A mesh over the devices of one process needs nothing from this module
(`make_mesh`).  Several processes, each owning some devices, first bring
up `torch.distributed` once per process; after that every process knows
the global device list, in process order, and `make_mesh()` with no
devices builds over it.  A sequence-sharded run on such a mesh moves its
halos between processes by send and receive
(`parallel/sharded.py::build_sharded_offline_fn`).

- `init_distributed()`: idempotent `torch.distributed.init_process_group`
  (a coordinator's ``HOST:PORT`` for manual launches, torchrun's
  environment otherwise), returning a small info record.
- `is_initialized()`, `process_index()`, `process_count()`: 0 and 1
  before init, as in the JAX package.
- `global_devices()`: every process's local devices as (process, device)
  pairs, gathered once at init.
- `local_file_shard(paths)`: process i takes paths[i::n].

NCCL moves CUDA tensors between cards; gloo moves CPU tensors, and CUDA
tensors only through host memory, which the caller asks for by naming
the backend.  Two processes on one card run under gloo (NCCL refuses two
ranks on one device).  `parallel/pod_check.py` is the proof harness.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import sys

import torch
import torch.distributed as dist

# How long a process waits for its peers (rendezvous, a collective, a
# receive) before it raises: a lost peer fails the run instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=120)

_INIT_INFO: dict | None = None
_GLOBAL_DEVICES: list | None = None


def is_initialized() -> bool:
    """True once this process's process group is up (through this module
    or the launcher's own `init_process_group`)."""
    return _INIT_INFO is not None or (dist.is_available() and dist.is_initialized())


def _local_devices(local_device_ids) -> list:
    """Device names or CUDA indices -> torch.device; a bare "cuda" is the
    card of LOCAL_RANK.  Entries may repeat, as a mesh's may."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if local_device_ids is None:
        local_device_ids = [local_rank]
    out = []
    for d in local_device_ids:
        dev = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank)
        out.append(dev)
    if not out:
        raise ValueError("local_device_ids is empty")
    return out


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    backend: str | None = None,
) -> dict:
    """Bring up `torch.distributed` (idempotent).

    Manual launches pass the coordinator's ``HOST:PORT`` (process 0
    listens there), the process count and this process's id.  With no
    arguments the group comes from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).  `local_device_ids` are
    this process's mesh entries: device names or CUDA indices, repeats
    allowed; default cuda:LOCAL_RANK.  `backend` defaults to "nccl" when
    every local device is a CUDA device and "gloo" otherwise; "gloo" with
    CUDA devices is taken when asked for, and halos then pass through
    host memory.  Every wait is bounded by `TIMEOUT`.

    Returns {"process_index", "process_count", "local_devices",
    "global_devices"} (counts); `global_devices()` lists the entries.  A
    second call returns the same record.  A group brought up here is
    destroyed at exit.
    """
    global _INIT_INFO, _GLOBAL_DEVICES
    if _INIT_INFO is not None:
        return dict(_INIT_INFO)
    local = _local_devices(local_device_ids)
    on_cuda = all(d.type == "cuda" for d in local)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if on_cuda else "gloo"
        if backend == "nccl" and not on_cuda:
            raise ValueError(f"backend nccl needs CUDA devices, got {[str(d) for d in local]}")
        if backend == "gloo" and any(d.type == "cuda" for d in local):
            print("init_distributed: backend gloo with CUDA devices: halos pass through host memory",
                  file=sys.stderr, flush=True)
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator address needs num_processes and process_id")
            init_method = f"tcp://{coordinator_address}"
        else:
            missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
            if missing:
                raise ValueError(f"no coordinator address and no {' '.join(missing)} in the environment "
                                 "(launch with torchrun, or pass coordinator_address)")
            init_method = "env://"
        world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
        rank = process_id if process_id is not None else os.environ.get("RANK")
        if world is None or rank is None:
            raise ValueError("the process count and id come from num_processes and process_id, "
                             "or from WORLD_SIZE and RANK")
        # NCCL binds the group to this process's first card (barriers run
        # there); the caller's current device is left as it was.
        bound = {"device_id": local[0]} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT,
                                world_size=int(world), rank=int(rank), **bound)
        atexit.register(_shutdown)
    gathered = [None] * dist.get_world_size()
    # Object collectives under NCCL stage on the current device: make it
    # this process's first card for the gather alone.
    with torch.cuda.device(local[0]) if dist.get_backend() == "nccl" else contextlib.nullcontext():
        dist.all_gather_object(gathered, [str(d) for d in local])
    _GLOBAL_DEVICES = [(p, torch.device(d)) for p, names in enumerate(gathered) for d in names]
    _INIT_INFO = {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": len(local),
        "global_devices": len(_GLOBAL_DEVICES),
    }
    return dict(_INIT_INFO)


def _shutdown():
    """Tear the group down before the interpreter does: a gloo group left
    to the interpreter's exit can abort the process."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_devices() -> list:
    """Every process's mesh entries as (process, torch.device) pairs, in
    process order: the default devices of `make_mesh`.  Before init, this
    process's visible CUDA devices (process 0)."""
    if _GLOBAL_DEVICES is not None:
        return list(_GLOBAL_DEVICES)
    return [(0, torch.device("cuda", i)) for i in range(torch.cuda.device_count())]


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_file_shard(paths, index: int | None = None, count: int | None = None):
    """This process's slice of a shared work list (round-robin
    ``paths[i::n]``: balanced for homogeneous files and stable under
    appends).  Files are independent, so no process talks to another."""
    i = process_index() if index is None else int(index)
    n = process_count() if count is None else int(count)
    if not 0 <= i < n:
        raise ValueError(f"process index {i} out of range [0, {n})")
    return list(paths)[i::n]
