"""Megatron's autograd collectives over an axis communicator
(`parallel/mesh.ProcessMesh.axis_comm`), and the all-to-all that MoE
differentiates through.

JAX gets these from GSPMD, which inserts the collectives of the sharded
train step and their transposes. PyTorch differentiates what it runs, so
each collective of a tensor-parallel training step is a
`torch.autograd.Function` whose backward is the collective's transpose
(Shoeybi et al., "Megatron-LM", 2019, §3, the f and g operators):

  - `copy_to_tp`: identity forward, all-reduce of the gradient backward
    (the input of a layer split by head or by column: every rank's
    partial input gradient summed);
  - `reduce_from_tp`: all-reduce forward, identity backward (the partial
    product of a layer split by row, before its bias);
  - `gather_from_tp`: all-gather of the last dim forward, the rank's
    slice of the gradient backward (a column-split layer whose consumer
    is not split by row: the ``col_gather`` mode of
    `inference/sharding.shard_modes`);
  - `all_to_all`: JAX's tiled all-to-all forward, the reverse all-to-all
    backward.

Each works on a fresh tensor: an in-place collective on a tensor autograd
saved would corrupt the backward. Outside autograd (no grad enabled, or
an input that needs none) `copy_to_tp` is the identity and
`reduce_from_tp` / `gather_from_tp` run the communicator's plain
collective, so the no-grad decode path (`inference/sharding.py`) runs
as it did: an in-place all-reduce and the gather.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _tracked(x: Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone()), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        ctx.width = x.shape[-1]
        return comm.all_gather(x, -1)

    @staticmethod
    def backward(ctx, g):
        c = ctx.width
        return g.narrow(-1, ctx.comm.rank * c, c).contiguous(), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim):
        ctx.comm = comm
        ctx.dims = (split_dim, concat_dim)
        return comm.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (ctx.comm.all_to_all(g.contiguous(), concat_dim, split_dim),
                None, None, None)


def copy_to_tp(comm, x: Tensor) -> Tensor:
    """Identity forward; the gradient all-reduced over ``comm`` backward."""
    if comm is None or comm.size == 1 or not _tracked(x):
        return x
    return _CopyToTp.apply(x, comm)


def reduce_from_tp(comm, x: Tensor) -> Tensor:
    """``x`` summed over ``comm``; the gradient passes unchanged. Without
    autograd, the communicator's in-place all-reduce of ``x``."""
    if comm is None or comm.size == 1:
        return x
    if not _tracked(x):
        return comm.all_reduce(x)
    return _ReduceFromTp.apply(x, comm)


def gather_from_tp(comm, x: Tensor) -> Tensor:
    """The ranks' ``x`` concatenated on the last dim; backward, this
    rank's slice of the gradient."""
    if comm is None or comm.size == 1:
        return x
    if not _tracked(x):
        return comm.all_gather_last(x)
    return _GatherFromTp.apply(x, comm)


def all_to_all(comm, x: Tensor, split_dim: int, concat_dim: int) -> Tensor:
    """`mesh._Comm.all_to_all` that autograd differentiates (backward: the
    reverse exchange)."""
    if not _tracked(x):
        return comm.all_to_all(x, split_dim, concat_dim)
    return _AllToAll.apply(x, comm, split_dim, concat_dim)
