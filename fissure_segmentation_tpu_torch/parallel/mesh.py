"""The port's mesh: one process a rank in a torch.distributed group
(counterpart of parallel/mesh.py, whose GSPMD mesh places the shards and
inserts the collectives; here each rank runs its own share and calls the
collectives itself).

  * `make_mesh(device, group)`: the group, its size, this rank and the
    rank's device; every function of the layer takes the mesh, and through
    it an explicit group and device;
  * `shard_along(x, mesh, dim)`: this rank's contiguous chunk of `dim`;
  * `replicate(x, mesh)`: rank 0's `x` on every rank (a broadcast);
  * `ppermute(x, mesh, perm)`: the counterpart of `jax.lax.ppermute`, one
    `batch_isend_irecv` of the (source, destination) pairs; a rank that
    receives nothing gets zeros, as in JAX;
  * `all_gather(x, mesh, dim)`: the ranks' chunks concatenated along `dim`;
  * `spawn(fn, world_size, backend, device)`: start the ranks.

Layouts: NCCL with one card a rank is the production one; gloo runs the
CPU tests, and several ranks on one card (NCCL refuses two ranks on one
device). gloo's all_reduce, broadcast and all_gather take CUDA tensors;
its send and receive take CPU tensors only, so on a CUDA device under
gloo `ppermute` stages its tensors through pinned host copies
(`Mesh.staged` names them). That is decided by the backend, never by
catching a failure.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.collectives import global_rank


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: object           # torch.distributed ProcessGroup
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> tuple[str, ...]:
        """The collectives that go through pinned host copies."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return ("send", "recv")
        return ()

    def src(self, rank: int) -> int:
        """The default group's rank of this mesh's rank `rank`."""
        return global_rank(self.group, rank)


def make_mesh(device, group=None) -> Mesh:
    """The mesh of this process: `group` (default: the default process
    group, taken here once, so nothing later depends on a default) and the
    rank's `device`."""
    group = dist.group.WORLD if group is None else group
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group),
                device, str(dist.get_backend(group)))


def shard_along(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's chunk of `dim` (which must divide by the mesh's size)."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"shard_along: size {n} of dim {dim} not divisible "
                         f"by the mesh's {mesh.size} ranks")
    share = n // mesh.size
    return x.narrow(dim, mesh.rank * share, share)


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's `x` on every rank (every rank passes a tensor of the same
    shape and dtype; returns a copy on the mesh's device)."""
    out = x.detach().to(mesh.device, copy=True).contiguous()
    dist.broadcast(out, src=mesh.src(0), group=mesh.group)
    return out


def _host(t: torch.Tensor, staged: bool) -> torch.Tensor:
    if not staged:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return host.copy_(t)


def ppermute(x: torch.Tensor, mesh: Mesh,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """`jax.lax.ppermute`: each (source, destination) pair sends the
    source rank's `x` to the destination rank. Returns what this rank
    receives, zeros where it receives nothing."""
    x = x.contiguous()
    dst = [d for s, d in perm if s == mesh.rank]
    src = [s for s, d in perm if d == mesh.rank]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if dst and src and dst[0] == mesh.rank:
        return x.clone()
    staged = bool(mesh.staged)
    ops, recv = [], None
    if dst:
        ops.append(dist.P2POp(dist.isend, _host(x, staged), mesh.src(dst[0]),
                              mesh.group))
    if src:
        recv = torch.empty(x.shape, dtype=x.dtype,
                           device="cpu" if staged else x.device,
                           pin_memory=staged and x.is_cuda)
        ops.append(dist.P2POp(dist.irecv, recv, mesh.src(src[0]),
                              mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if recv is None:
        return torch.zeros_like(x)
    return recv.to(x.device) if staged else recv


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (all of one shape) concatenated along `dim`, in rank
    order, on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim)


# ---------------------------------------------------------------- launcher

def _rank_main(rank: int, fn, world_size: int, backend: str, devices,
               init_file: str, out_dir: str, timeout_s: float, threads,
               tf32, args) -> None:
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(make_mesh(device), *args)
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str = "gloo",
          device="cpu", args: tuple = (), timeout_s: float = 60.0,
          threads: int | None = None) -> list:
    """Run ``fn(mesh, *args)`` on `world_size` ranks, one process each,
    started with the *spawn* method (a parent holding a CUDA context cannot
    fork) in a group on a ``file://`` store, and return the ranks' results
    (``torch.save``-able) in rank order. The ranks take this process's
    TF32 settings (matmul and cuDNN), so they compute as it would.

    :param fn: a module-level function (the ranks import it by name)
    :param device: every rank's device ("cpu", "cuda:0", ...), or a list
        with one a rank (NCCL: one card a rank)
    :param timeout_s: the group's timeout: a rank that fails makes the
        others fail after at most this long instead of hanging
    :param threads: torch's intra-op threads in each rank (None: the
        host's cores shared out among the ranks; ranks that each take every
        core spin against each other on the CPU)
    """
    devices = (list(device) if isinstance(device, (list, tuple))
               else [device] * world_size)
    if len(devices) != world_size:
        raise ValueError(f"spawn: {len(devices)} devices for {world_size} "
                         "ranks")
    devices = [str(d) for d in devices]
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    # the ranks compute with this process's TF32 settings
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        mp.start_processes(
            _rank_main, nprocs=world_size, join=True, start_method="spawn",
            args=(fn, world_size, backend, devices, init_file, tmp,
                  timeout_s, threads, tf32, args))
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
