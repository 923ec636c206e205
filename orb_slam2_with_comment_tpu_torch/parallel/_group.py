"""The process group a parallel routine runs over: the counterpart of the
JAX package's 1-D device mesh. ``None`` means the default group; without an
initialized default group a routine runs as a world of one."""
from __future__ import annotations

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_size(group=None) -> tuple[int, int]:
    """(this process's rank, the world size) of ``group``."""
    if not initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, in place (jax.lax.psum)."""
    if initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def psum_all(parts: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """psum of several tensors through one all-reduce of their
    concatenation."""
    flat = psum(torch.cat([p.reshape(-1) for p in parts]), group)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


def shard_rows(n: int, group=None) -> slice:
    """This rank's contiguous block of ``n`` rows; ``n`` must divide by the
    world size (the sharding of a mesh axis)."""
    rank, size = rank_and_size(group)
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} ranks")
    k = n // size
    return slice(rank * k, (rank + 1) * k)


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order."""
    _, size = rank_and_size(group)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
