"""Ranks, meshes and collectives of the port's multi-device paths.

The JAX package runs one process over a `jax.sharding.Mesh` of devices,
`shard_map` gives each device its block, and `ppermute` / `psum` move
data between them. PyTorch runs one process per rank over
torch.distributed instead. This module is the only one of the package
that calls torch.distributed:

- spawn(fn, n_ranks, ...) starts the ranks (the `spawn` start method, a
  FileStore rendezvous in a fresh temporary directory, a timeout) and
  returns rank 0's result;
- make_mesh(shape, names) wraps torch's init_device_mesh; the dimension
  names are JAX's axis names ("dp" for the μ batch, "sp" for grid rows);
- shift_south, psum and all_gather are JAX's ppermute i -> i+1 with a
  zero ghost on the first rank, psum, and the gather of the blocks in rank
  order.

Backends: on CUDA with one rank per card the ranks use NCCL. Ranks that
share a card must ask for gloo by name (NCCL refuses two ranks on one
card); gloo is never chosen as a fallback. Gloo's send and recv of a CUDA
tensor abort the process (its all_reduce and all_gather take one), so on
a gloo group every collective of a CUDA tensor goes through a host
buffer: a stated path for ranks that share a card. On the CPU the ranks
use gloo.

psum gathers every rank's value and sums them in rank order on each rank,
so every rank holds the same bits: stopping decisions taken from summed
norms agree on all ranks, and every rank makes the same collectives in
the same order.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT = 900.0   # seconds: spawn's default; a hang becomes an error

# point-to-point exchanges this process made (shift_south calls with a
# neighbour), for the per-exchange times the smoke run prints
EXCHANGES = 0

_RANK_DEVICE = torch.device("cpu")


def _backend(device_type: str, n_ranks: int, backend: str | None) -> str:
    """The backend of `n_ranks` ranks on `device_type` (module docstring)."""
    if device_type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU; the CPU "
                             f"ranks use gloo")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"unknown device {device_type!r}; use 'cuda' or "
                         f"'cpu'")
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or "
                         f"'gloo'")
    n_cards = torch.cuda.device_count()
    if n_ranks > n_cards:
        raise ValueError(
            f"{n_ranks} NCCL ranks need {n_ranks} CUDA devices, "
            f"{n_cards} visible: NCCL puts one rank on a card; pass "
            f"backend='gloo' for ranks that share a card, or run on the "
            f"CPU")
    return "nccl"


def rank_device() -> torch.device:
    """This rank's device: its card in a CUDA spawn, else the CPU."""
    return _RANK_DEVICE


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """A named mesh of ranks; this rank's tensors live on rank_device().

    `device_mesh` is torch's DeviceMesh, or None for the local 1-rank
    mesh of `local_mesh` (every axis of size 1, no communication).
    """

    def __init__(self, device_mesh, names):
        self.device_mesh = device_mesh
        self.names = tuple(names)
        self.device = rank_device()

    @property
    def shape(self) -> tuple:
        if self.device_mesh is None:
            return (1,) * len(self.names)
        return tuple(self.device_mesh.shape)

    def _dim(self, axis: str) -> int:
        if axis not in self.names:
            raise ValueError(f"no axis {axis!r} in the mesh {self.names}")
        return self.names.index(axis)

    def size(self, axis: str) -> int:
        return self.shape[self._dim(axis)]

    def rank(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        self._dim(axis)
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinates (None on a local mesh)."""
        self._dim(axis)
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def make_mesh(shape, names) -> Mesh:
    """A mesh of `shape` over the initialised world, its dimensions named
    `names` (row-major: rank = dp_index * sp + sp_index for ("dp", "sp")).
    Every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    # a gloo mesh holds CPU groups whatever the tensors' device (the
    # collectives below stage CUDA tensors through the host)
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(mesh_type, shape, mesh_dim_names=names)
    return Mesh(dm, names)


def local_mesh(names) -> Mesh:
    """A mesh of one rank, this one, with every axis of size 1: the
    collectives degenerate (no halo, a sum of one term)."""
    return Mesh(None, names)


def _staged(x: torch.Tensor, group) -> bool:
    """Does a collective of x on `group` go through a host buffer?"""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def shift_south(x: torch.Tensor, mesh: Mesh, axis: str,
                dim: int = 0) -> torch.Tensor:
    """x shifted by one along `dim` across the ranks of `axis`: index j
    takes j - 1, the first index of rank i takes the last of rank i - 1,
    and rank 0 takes zeros (JAX's ppermute i -> i + 1)."""
    global EXCHANGES
    n, i, group = mesh.size(axis), mesh.rank(axis), mesh.group(axis)
    length = x.shape[dim]
    halo = None
    if n > 1:
        staged = _staged(x, group)
        send = x.narrow(dim, length - 1, 1).contiguous()
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        ops = []
        if i + 1 < n:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, i + 1), group))
        if i > 0:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, i - 1), group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        EXCHANGES += 1
        if i > 0:
            halo = recv.to(x.device) if staged else recv
    if halo is None:
        halo = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat((halo, x.narrow(dim, 0, length - 1)), dim=dim)


def _gather_group(x: torch.Tensor, group) -> list:
    """Every rank's x (same shape) on `group`, in rank order."""
    if group is None or dist.get_world_size(group) == 1:
        return [x]
    staged = _staged(x, group)
    src = (x.detach().cpu() if staged else x.detach()).contiguous()
    flat = src.reshape(-1)
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    parts = [p.reshape(x.shape) for p in parts]
    return [p.to(x.device) for p in parts] if staged else parts


def group_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group` (None: x), added in rank
    order, the same bits on every rank."""
    parts = _gather_group(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """JAX's lax.psum over `axis` (group_psum)."""
    return group_psum(x, mesh.group(axis))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The blocks x of the ranks of `axis`, concatenated along `dim` in
    rank order (every rank's block has x's shape)."""
    return torch.cat(_gather_group(x, mesh.group(axis)), dim=dim)


def _to_host(obj):
    """obj with every tensor moved to the CPU (tuples, lists, dicts and
    NamedTuples walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _worker(rank, n_ranks, backend, device_type, store_path, timeout, fn,
            args, results):
    """One rank: set its device, join the world, run fn(*args), report
    (a failure with its traceback, then raised again)."""
    global _RANK_DEVICE
    try:
        if device_type == "cuda":
            index = rank % torch.cuda.device_count()
            torch.cuda.set_device(index)
            _RANK_DEVICE = torch.device("cuda", index)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n_ranks), rank=rank,
            world_size=n_ranks,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        if device_type == "cuda":
            torch.cuda.synchronize()
        # by value: a tensor shared through the queue would need this
        # process alive when the parent unpickles it
        results.put((rank, "ok",
                     pickle.dumps(_to_host(out) if rank == 0 else None)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n_ranks: int, *args, device="cuda", backend: str | None = None,
          timeout: float = SPAWN_TIMEOUT):
    """Run fn(*args) on `n_ranks` new processes, one rank each, and return
    rank 0's result with its tensors on the CPU.

    fn and args must pickle (fn a module-level function). device "cuda"
    puts rank r on card r % device_count() and uses NCCL, which needs a
    card a rank; backend="gloo" lets ranks share a card. device "cpu"
    uses gloo (the ranks read OMP_NUM_THREADS for their torch threads). A
    rank that raises or dies makes spawn raise with its traceback; a run
    longer than `timeout` seconds raises TimeoutError. Either way every
    rank is killed.
    """
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    device_type = torch.device(device).type
    backend = _backend(device_type, n_ranks, backend)
    if device_type == "cuda":
        # one build in the parent; the ranks load the library it made
        from finitedifference_tpu_torch.ops import _build
        _build.build()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fd_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_worker,
        args=(rank, n_ranks, backend, device_type,
              os.path.join(tmp, "store"), timeout, fn, args, results))
        for rank in range(n_ranks)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        got = {}
        while len(got) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n_ranks} ranks of {fn.__name__}: no "
                                   f"end after {timeout:g} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0][0]} of {fn.__name__} exited with "
                        f"code {dead[0][1]}")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return pickle.loads(got[0])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
