"""The collectives that GSPMD inserts for the JAX package, called
explicitly.

Every function takes a process group, or None for a mesh axis of size 1,
where it does nothing.  Gloo reduces and broadcasts CUDA tensors but does
not gather or scatter them, so on gloo a CUDA tensor's all-gather goes
through host memory (NCCL, and gloo on CPU tensors, gather directly), and a
reduce-scatter is an all-reduce followed by a slice on every backend.  `routes` counts the
calls by operation and route ("all_gather host", "reduce_scatter
all_reduce", ...), so a run can show which ran.

The two Megatron pairs for tensor parallelism are autograd functions:
`all_reduce_fwd` (all-reduce forward, identity backward: the row-parallel
output whose loss every tp rank computes) and `reduce_scatter_fwd`
(reduce-scatter forward, all-gather backward: the row-parallel ->
column-parallel transition between the hidden layers).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

routes: Counter = Counter()


def _on_gloo_cuda(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group`, in place; returns `x`."""
    if group is not None:
        dist.all_reduce(x, group=group)
        routes["all_reduce direct"] += 1
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[group size, *x.shape]: every rank's `x`, in group-rank order."""
    if group is None:
        return x[None]
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    if src.dtype == torch.bool:  # gathered as bytes
        return all_gather(src.to(torch.uint8), group).to(torch.bool)
    host = _on_gloo_cuda(src, group)
    if host:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    routes["all_gather host" if host else "all_gather direct"] += 1
    return torch.stack(out).to(x.device)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in group-rank order."""
    return torch.cat(list(all_gather(x, group)), dim) if group is not None else x


def reduce_scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The sum of `x` over `group`, cut into group-size chunks along `dim`:
    this rank's chunk.  Taken as an all-reduce and a slice on every
    backend: gloo has no reduce-scatter of CUDA tensors."""
    if group is None:
        return x
    n, me = dist.get_world_size(group), dist.get_rank(group)
    total = x.detach().clone()
    dist.all_reduce(total, group=group)
    routes["reduce_scatter all_reduce"] += 1
    return total.chunk(n, dim)[me].contiguous()


class _AllReduceIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceScatterAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad.contiguous(), ctx.group, dim=-1), None


def all_reduce_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` forward, identity backward."""
    return x if group is None else _AllReduceIdentity.apply(x, group)


def reduce_scatter_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter along the last dim forward, all-gather backward."""
    return x if group is None else _ReduceScatterAllGather.apply(x, group)
