"""Multi-process bring-up: the fleet over processes with torch.distributed.

Counterpart of gem_tpu/multirobot/distributed.py (`jax.distributed`).  The
port keeps the contract, not the mechanism: instead of JAX's single
program over a global device mesh, one process runs per card, every
process runs the same code on its own share of the robot axis, and the
processes are joined by a `torch.distributed` process group (NCCL for CUDA
tensors, gloo for CPU tensors).  Rank r computes on `cuda:{local rank}`
with NCCL and on the CPU with gloo.

The fleet step needs no collective (robots are independent); the
collectives of the port are `ring_shift` (the counterpart of `ppermute`
around a ring, used by the sharded loop closure and the halo exchange),
`all_reduce` of a count and `barrier`.

Constraints of the backends, handled here:
  * NCCL deadlocks on a send to self: with one rank, `ring_shift` is a
    local copy.
  * NCCL refuses two ranks on one card: several ranks on a one-card machine
    run gloo on CPU tensors.
  * every process group gets a timeout, so a hang fails within it.
"""

from __future__ import annotations

import datetime
import re

import torch
import torch.distributed as dist

from gem_tpu_torch.utils.tree import tree_map

DEFAULT_TIMEOUT_S = 600


def tcp_address(coordinator: str) -> tuple[str, int] | None:
    """(host, port) when `coordinator` is `host:port` with an integer port;
    None for anything else, which `initialize` takes as a file path."""
    m = re.fullmatch(r"([^/\\]+):(\d+)", coordinator)
    return (m.group(1), int(m.group(2))) if m else None


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group.  `coordinator` is `host:port` of process 0
    (a TCPStore there), or else a file path (a FileStore: processes of one
    host, no port to pick).  `backend` defaults to NCCL when CUDA is
    available, else gloo; with NCCL the process binds
    `cuda:{process_id mod cards}`."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    addr = tcp_address(coordinator)
    if addr is None:
        store = dist.FileStore(coordinator, num_processes)
    else:
        store = dist.TCPStore(*addr, num_processes,
                              is_master=process_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def global_group():
    """The group of every process (the counterpart of `global_mesh`)."""
    return dist.group.WORLD


def rank_and_size(group=None) -> tuple[int, int]:
    """(this process's rank in `group`, the group's size); (0, 1) when no
    process group was initialised."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def device(group=None) -> torch.device | None:
    """The device of this rank's tensors: `cuda:{current}` under NCCL, the
    CPU under gloo; None without a process group (tensors stay where the
    caller put them)."""
    if not dist.is_initialized():
        return None
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def to_rank_device(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` on this rank's device; `x` itself without a process group."""
    dev = device(group)
    return x if dev is None else x.to(dev)


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Block until every process reaches the barrier `name`, through the
    group's key-value store (no collective).  Use each name once.  No-op
    without a process group."""
    if not dist.is_initialized():
        return
    store = dist.distributed_c10d._get_default_store()
    key = f"gem_barrier/{name}"
    if store.add(key, 1) == dist.get_world_size():
        store.set(key + "/done", "1")
    store.wait([key + "/done"], datetime.timedelta(milliseconds=timeout_ms))


def local_robots(n_robots: int, group=None) -> range:
    """This rank's even share of the robot axis.  Raises unless the group
    size divides `n_robots`."""
    rank, world = rank_and_size(group)
    if n_robots % world:
        raise ValueError(f"{n_robots} robots do not divide evenly over "
                         f"{world} processes")
    n = n_robots // world
    return range(rank * n, (rank + 1) * n)


def distribute_fleet(tree, group=None):
    """This process's robots of a fleet tree (leading robot axis = robots
    it owns) on the rank's device (without a process group, where they
    are).  Every rank must own as many robots: the robot axis splits
    evenly, as on a mesh."""
    leaves = []
    tree_map(leaves.append, tree)
    n = leaves[0].shape[0]
    rank, world = rank_and_size(group)
    if world > 1:
        counts = torch.tensor([n, -n], dtype=torch.int64,
                              device=device(group))
        dist.all_reduce(counts, op=dist.ReduceOp.MIN, group=group)
        if int(counts[0]) != n or -int(counts[1]) != n:
            raise ValueError("distribute_fleet: ranks own different robot "
                             "counts")
    return tree_map(lambda x: to_rank_device(x, group), tree)


def local_values(tree):
    """This process's leaves as NumPy arrays (for inspection and IO)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def all_reduce_sum(value, group=None) -> int:
    """Sum of an integer over the group's ranks."""
    t = torch.as_tensor(value, dtype=torch.int64, device=device(group))
    t = t.reshape(())
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        t = t.clone()
        dist.all_reduce(t, group=group)
    return int(t)


def ring_shift(tensor: torch.Tensor, group=None,
               direction: int = 1) -> torch.Tensor:
    """Send `tensor` to rank (r + direction) mod n of `group` and return the
    tensor received from rank (r - direction) mod n: the port's only
    counterpart of `ppermute`.  One rank: a local copy."""
    rank, world = rank_and_size(group)
    if world == 1:
        return tensor.clone()
    src = tensor.contiguous()
    out = torch.empty_like(src)
    peer = lambda r: dist.get_global_rank(group, r) if group is not None \
        else r
    ops = [dist.P2POp(dist.isend, src, peer((rank + direction) % world),
                      group=group),
           dist.P2POp(dist.irecv, out, peer((rank - direction) % world),
                      group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_shift_tensors(tensors: list, group=None, direction: int = 1
                       ) -> list:
    """`ring_shift` of several tensors of mixed dtypes (bool included) as
    one contiguous byte tensor: one send/receive pair per shift.  The
    received tensors have the shapes and dtypes of `tensors`."""
    if rank_and_size(group)[1] == 1:
        return [t.clone() for t in tensors]
    # widest elements first, so every slice is aligned for its dtype
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    flat = [tensors[i].contiguous().reshape(-1).view(torch.uint8)
            for i in order]
    got = ring_shift(torch.cat(flat), group, direction)
    out, at = [None] * len(tensors), 0
    for i, f in zip(order, flat):
        t = tensors[i]
        out[i] = got[at:at + f.numel()].view(t.dtype).reshape(t.shape)
        at += f.numel()
    return out
