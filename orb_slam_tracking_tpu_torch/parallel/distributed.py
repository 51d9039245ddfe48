"""Process groups and the dim-0 layout of the multi-device modes
(counterpart of ``parallel/distributed.py``).

The JAX package forms its process group with ``jax.distributed`` and
lays arrays over a ``Mesh``; XLA compiles the collectives. Here a
``torch.distributed`` process group takes the mesh's place: every rank
runs the same program on its own device, holds its contiguous dim-0
slice of a sharded array, and the sharded modules
(``matcher_sharded``, ``ba_sharded``, ``pipeline`` and the multi-sequence
runners' ``group``) call the collectives themselves:

- ``psum`` -> ``dist.all_reduce``;
- ``all_gather`` -> the list form of ``dist.all_gather`` (``all_gather``
  below). The flat-tensor form, ``all_gather_into_tensor``, is deprecated
  in recent torch releases, and the list form is what gloo and NCCL both
  take for CPU and CUDA tensors;
- ``ppermute`` and the pipeline's stage switch -> ``dist.broadcast`` from
  the sending rank (``broadcast``).

The backend is the caller's choice and nothing falls back to another:
``"nccl"`` for one rank per card, ``"gloo"`` for CPU ranks and for several
ranks that share one card (NCCL refuses two ranks on one GPU; gloo moves
CUDA tensors through the host). A rank whose device does not fit its
backend raises.

- ``initialize_from_env``: the group from torch's launcher variables
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``, as ``torchrun`` sets them), a no-op for one process;
- ``global_mesh``: the group, its axis name, this rank, the size and the
  rank's device;
- ``make_global_array`` / ``replicate``: the rank's slice of a full host
  array, or all of it, on the rank's device;
- ``spawn``: ``world_size`` ranks as new processes (the spawn start
  method, since CUDA cannot be initialized again in a forked child), each
  in a group whose store is a file in a fresh temporary directory, and
  their results in rank order;
- ``single_process_group``: a group of one in this process, on the same
  kind of store.

A file store, not a TCP port: a port found free and then released can be
taken by another process before rank 0's store binds it, and groups
formed at once (parallel test workers) would then join each other's
store or fail to bind.

The CUDA kernels are built at first use under a file lock
(``kernels._build``), so ranks that reach their first kernel together
build the library once and load it.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "initialize_from_env", "process_index", "process_count", "global_mesh",
           "group_rank_size", "make_global_array", "replicate", "all_gather", "broadcast",
           "spawn", "single_process_group"]


class Mesh(NamedTuple):
    group: Optional[dist.ProcessGroup]  # the ranks' group
    axis: str
    rank: int                           # this process's rank in ``group``
    size: int                           # ranks in ``group``
    device: torch.device                # this rank's device


def initialize_from_env(init_method: Optional[str] = None, world_size: Optional[int] = None,
                        rank: Optional[int] = None, backend: str = "nccl") -> bool:
    """Form the default process group from the arguments or from torch's
    launcher variables (``MASTER_ADDR`` / ``MASTER_PORT`` give
    ``tcp://addr:port`` when ``init_method`` is None; ``WORLD_SIZE``;
    ``RANK``). Returns True when a group of more than one process is up,
    False for one process (a no-op). Safe to call twice: a second call
    returns True without forming another group. With ``"nccl"`` the rank
    first takes the card ``LOCAL_RANK % device_count``."""
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "0") or 0)
    rank = rank if rank is not None else int(os.environ.get("RANK", "-1") or -1)
    if init_method is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if not init_method or world <= 1:
        return False
    if dist.is_initialized():
        return True
    kw = {}
    if backend == "nccl":
        kw["device_id"] = _local_cuda_device()
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    return True


def process_index(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_count(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _local_cuda_device() -> torch.device:
    resolve_device("cuda")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def group_rank_size(group: Optional[dist.ProcessGroup], device: torch.device):
    """(rank, size) of this process in ``group`` (None = the default
    group), after checking that a group is up and that ``device`` fits its
    backend (NCCL takes CUDA tensors only)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_from_env or "
                           "torch.distributed.init_process_group first")
    if dist.get_backend(group) == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"the NCCL backend takes CUDA tensors, got a tensor on {device}")
    return dist.get_rank(group), dist.get_world_size(group)


def global_mesh(axis: str = "points", group: Optional[dist.ProcessGroup] = None,
                device: torch.device | str | None = None) -> Mesh:
    """The 1-D mesh over every rank of ``group`` (None: the default group,
    which ``Mesh.group`` then names, ``dist.group.WORLD``): this rank's
    device is ``device``, or by default the card ``LOCAL_RANK %
    device_count``."""
    device = _local_cuda_device() if device is None else resolve_device(device)
    rank, size = group_rank_size(group, device)
    return Mesh(dist.group.WORLD if group is None else group, axis, rank, size, device)


def make_global_array(mesh: Mesh, host_array) -> torch.Tensor:
    """This rank's contiguous dim-0 slice of the full ``host_array``
    (every rank passes the same full array), on the rank's device."""
    a = np.asarray(host_array)
    n = a.shape[0]
    if n % mesh.size:
        raise ValueError(f"dim 0 of {n} rows does not divide over {mesh.size} ranks")
    per = n // mesh.size
    return torch.tensor(a[mesh.rank * per:(mesh.rank + 1) * per], device=mesh.device)


def replicate(mesh: Mesh, host_array) -> torch.Tensor:
    """The whole ``host_array`` on this rank's device (camera blocks, K,
    masks)."""
    return torch.tensor(np.asarray(host_array), device=mesh.device)


def all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup], size: int) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) stacked along a new dim
    0 in rank order: JAX's ``all_gather`` (``[D, ...]``). A bool tensor
    travels as uint8 (the same byte), so no backend has to take bool."""
    if t.dtype == torch.bool:
        return all_gather(t.to(torch.uint8), group, size).to(torch.bool)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def broadcast(t: torch.Tensor, group_src: int, group: Optional[dist.ProcessGroup]) -> None:
    """``t`` of the group's rank ``group_src`` into every rank's ``t``, in
    place."""
    src = group_src if group is None else dist.get_global_rank(group, group_src)
    dist.broadcast(t, src=src, group=group)


@contextlib.contextmanager
def _file_store():
    """A ``file://`` init method in a fresh temporary directory, removed on
    exit."""
    tmp = tempfile.mkdtemp(prefix="osltt_group_")
    try:
        yield "file://" + os.path.join(tmp, "store")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def single_process_group(backend: str, device: torch.device | str):
    """A default group of one rank in this process on a file store,
    destroyed on exit; yields its ``global_mesh``."""
    device = resolve_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    with _file_store() as init_method:
        dist.init_process_group(backend, init_method=init_method, world_size=1, rank=0, **kw)
        try:
            yield global_mesh(group=None, device=device)
        finally:
            dist.destroy_process_group()


def _to_host(obj):
    """Tensors to numpy arrays, through tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world_size, backend, device, init_method, args, results):
    """One spawned rank: join the group, run ``fn(mesh, *args)``, put
    (rank, traceback or None, result) on ``results``, then leave the group.
    The report goes first: a failing rank's teardown aborts its peers'
    collectives, and their reports must not be the only ones the parent
    sees."""
    error, value = None, None
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        if torch.device(device).type == "cuda":
            dev = _local_cuda_device()
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, **kw)
        value = _to_host(fn(global_mesh(group=None, device=dev), *args))
    except Exception:  # reported to the parent, which raises
        error = traceback.format_exc()
    results.put((rank, error, value))
    if dist.is_initialized():
        dist.destroy_process_group()


# what a rank reports when a peer's failure tore its collective down (gloo,
# NCCL): not a root cause
_ABORT_MARKS = ("Connection closed by peer", "Connection reset by peer", "Broken pipe",
                "NCCL communicator was aborted", "ncclRemoteError", "DistBackendError",
                "DistNetworkError")
# seconds ``spawn`` waits, after the first failure, for the other ranks' reports
FAILURE_GRACE = 5.0


def _is_abort(error: str) -> bool:
    return any(mark in error for mark in _ABORT_MARKS)


def _failure_message(errors: dict, died: dict, silent: List[int], waited: str) -> str:
    """Every failed rank's traceback, root causes (errors that are not a
    collective abort) first, then by rank; then the ranks that died, and
    those that gave no report."""
    parts = [f"rank {r} failed" + (" (a collective torn down by a failing peer)"
                                   if _is_abort(errors[r]) else "") + f":\n{errors[r]}"
             for r in sorted(errors, key=lambda r: (_is_abort(errors[r]), r))]
    parts += [f"rank {r} exited with code {c}" for r, c in sorted(died.items())]
    if silent:
        parts.append(f"ranks {silent} gave no report within {waited}")
    return "\n".join(parts)


def spawn(fn: Callable[..., Any], world_size: int, backend: str,
          device: torch.device | str = "cuda", args: Sequence = (),
          timeout: float = 900.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes that form a
    default group of ``backend`` on a file store in a fresh temporary
    directory; rank r's device is ``device`` (``"cuda"``: the card ``r %
    device_count``). ``fn`` and ``args`` are pickled (``fn`` by import
    path). Returns each rank's result in rank order, tensors as numpy
    arrays.

    If a rank fails or dies, ``spawn`` waits up to ``FAILURE_GRACE``
    seconds for the other ranks' reports, stops the ranks still running and
    raises with every failed rank's traceback, the root cause first: a rank
    whose error is not a collective aborted by its peer's failure. After
    ``timeout`` seconds it raises naming the ranks that have not reported,
    and stops them."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out, errors, died = {}, {}, {}
    with _file_store() as init_method:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, str(device),
                                                      init_method, tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline, first_failure = time.monotonic() + timeout, None
        try:
            while len(out) + len(errors) + len(died) < world_size:
                try:
                    rank, error, value = results.get(timeout=0.2)
                    died.pop(rank, None)
                    if error is None:
                        out[rank] = value
                    else:
                        errors[rank] = error
                except queue_mod.Empty:
                    died.update((r, p.exitcode) for r, p in enumerate(procs)
                                if r not in out and r not in errors and p.exitcode not in (None, 0))
                if (errors or died) and first_failure is None:
                    first_failure = time.monotonic()
                    deadline = min(deadline, first_failure + FAILURE_GRACE)
                if time.monotonic() > deadline:
                    break
        finally:
            failed = len(out) < world_size
            for p in procs:
                p.join(timeout=1 if failed else 30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if len(out) < world_size:
        silent = [r for r in range(world_size) if r not in out and r not in errors and r not in died]
        waited = f"{timeout} s" if first_failure is None else \
            f"{FAILURE_GRACE} s of the first failure"
        raise RuntimeError(_failure_message(errors, died, silent, waited))
    return [out[r] for r in range(world_size)]
