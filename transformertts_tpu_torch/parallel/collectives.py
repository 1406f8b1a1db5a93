"""The collectives of a sharded step, as autograd functions over a process
group (Megatron-LM's f / g and their sequence-parallel forms).

The JAX package gets these from GSPMD; here each is written out:

- ``copy_to(x, g)``: identity forward, all-reduce backward (f, before a
  column-parallel product: each rank's partial input gradient is summed);
- ``reduce_from(x, g)``: all-reduce forward, identity backward (g, after a
  row-parallel product: the partial outputs are summed);
- ``gather_seq(x, g)``: all-gather along time forward, reduce-scatter
  backward (sequence parallelism, before a block that needs all of T);
- ``scatter_seq(x, g)``: reduce-scatter along time forward, all-gather
  backward (after the block, in place of g);
- ``sum_both(x, g)``: all-reduce forward and backward (a sum every rank's
  loss depends on, as BatchNorm's batch moments).

A group of one process (or ``None``) makes each of them the identity with
no call.  Every call adds one to ``COUNTS[op]`` (``op + ".bwd"`` in a
backward), which the collectives audit reads.

Each is called on the tensors' own device: NCCL for CUDA tensors, and
gloo for CPU tensors or for two ranks on one card (gloo takes CUDA
tensors for all three collectives).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

COUNTS: Counter = Counter()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def reset_counts() -> None:
    COUNTS.clear()


def all_reduce(x: torch.Tensor, group, tag: str = "all_reduce") -> torch.Tensor:
    """The sum of ``x`` over ``group`` as a new tensor (``x`` untouched)."""
    COUNTS[tag] += 1
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int, tag: str = "all_gather") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    COUNTS[tag] += 1
    n = group_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int,
                   tag: str = "reduce_scatter") -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over ``group``."""
    COUNTS[tag] += 1
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of {x.shape[dim]} along dim {dim} over {n} ranks")
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.group, "all_reduce.bwd"), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return reduce_scatter(dy, ctx.group, ctx.dim, "reduce_scatter.bwd"), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.group, ctx.dim, "all_gather.bwd"), None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.group, "all_reduce.bwd"), None


def copy_to(x, group):
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_seq(x, group, dim: int = 1):
    return x if group_size(group) == 1 else _GatherSeq.apply(x, group, dim)


def scatter_seq(x, group, dim: int = 1):
    return x if group_size(group) == 1 else _ScatterSeq.apply(x, group, dim)


def sum_both(x, group):
    return x if group_size(group) == 1 else _SumBoth.apply(x, group)
