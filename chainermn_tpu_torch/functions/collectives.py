"""Differentiable collective communication.

Port of ``chainermn_tpu/functions/collectives.py`` (:27-107).  The JAX
functions are named wrappers over ``lax`` collectives inside
``shard_map`` (``check_vma=False``), and JAX generates each transpose;
here every one is a ``torch.autograd.Function`` over the communicator,
one process per rank, and its backward is the transpose JAX generates:

- ``psum``: the sum over the ranks; backward the sum of the cotangents;
- ``pmean``: the mean (:func:`allreduce_mean`); backward the mean;
- ``pmax``/``pmin``: the elementwise max/min; no backward (it raises,
  as JAX has no rule for them);
- ``all_gather``: every rank's ``x`` along ``axis``; backward the sum of
  the cotangents, this rank's block;
- ``all_to_all``: block j of ``split_axis`` to rank j, the blocks
  received joined along ``concat_axis``; backward the same with the two
  axes swapped;
- ``ppermute``: the ``x`` of the rank paired with this one in ``perm``
  (zeros if none); backward by the inverted pairs;
- ``bcast``: root's ``x``; backward the sum of the cotangents, on the
  root only;
- ``gather``: every rank's ``x`` joined, on the root (zeros elsewhere);
  backward the root's cotangent, this rank's block;
- ``scatter``: block ``rank`` of root's ``x``; backward every rank's
  cotangent joined, on the root only;
- ``reduce_scatter``: block ``rank`` of the sum; backward ``all_gather``.

Blocks are ``size`` equal chunks along an axis (it must divide).  As in
the JAX functions, every rank passes a tensor of the same shape, and a
rank that gets nothing gets zeros of that shape.
"""

from __future__ import annotations

import torch


def _blocks(x: torch.Tensor, comm, axis: int) -> tuple:
    """``x`` in ``size`` equal blocks along ``axis``."""
    if x.shape[axis] % comm.size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"into {comm.size} blocks")
    return x.chunk(comm.size, axis)


def _block(x: torch.Tensor, comm, axis: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis``."""
    return _blocks(x, comm, axis)[comm.rank]


def _joined(stack: torch.Tensor, axis: int, tiled: bool) -> torch.Tensor:
    """A ``(size, ...)`` stack joined along ``axis`` (``tiled``) or
    stacked at it."""
    if tiled:
        return torch.cat(list(stack.unbind(0)), dim=axis)
    return stack.movedim(0, axis)


def _sum(x: torch.Tensor, comm) -> torch.Tensor:
    return comm.allreduce(x.contiguous(), "sum")


def _on_root(x: torch.Tensor, comm, root: int) -> torch.Tensor:
    return x if comm.rank == root else torch.zeros_like(x)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _mean(x, comm)

    @staticmethod
    def backward(ctx, grad):
        return _mean(grad, ctx.comm), None


def _mean(x: torch.Tensor, comm) -> torch.Tensor:
    allreduce_mean.calls += 1
    return comm.allreduce(x.contiguous(), "mean")


def allreduce_mean(x: torch.Tensor, comm) -> torch.Tensor:
    """The mean of ``x`` over ``comm``'s ranks (all-reduce, then a divide
    by the size, as ``lax.pmean``); differentiable, with the mean
    all-reduce of the gradient as its backward (synchronized BatchNorm's
    statistics go through it).

    ``allreduce_mean.calls`` counts the all-reduces, forward and
    backward."""
    return _AllReduceMean.apply(x, comm)


allreduce_mean.calls = 0
pmean = allreduce_mean


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _sum(x, comm)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.comm), None


def psum(x: torch.Tensor, comm) -> torch.Tensor:
    """The sum of ``x`` over the ranks; its backward sums the
    cotangents (every rank's loss counts)."""
    return _PSum.apply(x, comm)


class _PExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, op):
        ctx.op = op
        return comm.allreduce(x.contiguous(), op)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            f"Differentiation rule for 'p{ctx.op}' not implemented (as "
            f"in JAX, lax.p{ctx.op} has none)")


def pmax(x: torch.Tensor, comm) -> torch.Tensor:
    """Elementwise max over the ranks.  Not differentiable, as
    ``lax.pmax`` is not: a backward through it raises."""
    return _PExtreme.apply(x, comm, "max")


def pmin(x: torch.Tensor, comm) -> torch.Tensor:
    """Elementwise min over the ranks (the agreement primitive).  Not
    differentiable, as ``lax.pmin`` is not."""
    return _PExtreme.apply(x, comm, "min")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, tiled):
        ctx.comm, ctx.axis, ctx.tiled = comm, axis, tiled
        return _joined(comm.allgather(x.contiguous()), axis, tiled)

    @staticmethod
    def backward(ctx, grad):
        total = _sum(grad, ctx.comm)
        mine = (_block(total, ctx.comm, ctx.axis) if ctx.tiled
                else total.select(ctx.axis, ctx.comm.rank))
        return mine, None, None, None


def all_gather(x: torch.Tensor, comm, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` joined along ``axis`` (``tiled``) or stacked
    at it, on every rank.  Backward: the reduce-scatter of the
    cotangent."""
    return _AllGather.apply(x, comm, axis, tiled)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return _all_to_all(x, comm, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(grad, ctx.comm, concat_axis, split_axis),
                None, None, None)


def _all_to_all(x, comm, split_axis, concat_axis):
    blocks = torch.stack(_blocks(x, comm, split_axis))
    return _joined(comm.alltoall(blocks), concat_axis, True)


def all_to_all(x: torch.Tensor, comm, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Block j of ``split_axis`` goes to rank j; the blocks received
    join along ``concat_axis`` in rank order (the tiled
    ``lax.all_to_all``).  Backward: the inverse all-to-all."""
    return _AllToAll.apply(x, comm, split_axis, concat_axis)


def _permute(x, comm, perm):
    me = comm.rank
    dest = next((d for s, d in perm if s == me), None)
    source = next((s for s, d in perm if d == me), None)
    got = comm.sendrecv(x.contiguous(), dest, source)
    return torch.zeros_like(x) if got is None else got


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, perm):
        ctx.comm, ctx.perm = comm, perm
        return _permute(x, comm, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(grad, ctx.comm, inverse), None, None


def ppermute(x: torch.Tensor, comm, perm) -> torch.Tensor:
    """``perm``: ``(source, dest)`` pairs; this rank gets the ``x`` of
    the rank paired to it, or zeros.  Backward: the inverted pairs."""
    return _PPermute.apply(x, comm, [tuple(p) for p in perm])


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root):
        ctx.comm, ctx.root = comm, root
        return comm.bcast(x.contiguous(), root)

    @staticmethod
    def backward(ctx, grad):
        return _on_root(_sum(grad, ctx.comm), ctx.comm, ctx.root), None, None


def bcast(x: torch.Tensor, comm, root: int = 0) -> torch.Tensor:
    """Root's ``x`` on every rank.  Backward: the cotangents summed onto
    the root (zeros elsewhere)."""
    return _Bcast.apply(x, comm, root)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root, axis):
        ctx.comm, ctx.root, ctx.axis = comm, root, axis
        g = _joined(comm.allgather(x.contiguous()), axis, True)
        return _on_root(g, comm, root)

    @staticmethod
    def backward(ctx, grad):
        rooted = ctx.comm.bcast(grad.contiguous(), ctx.root)
        return _block(rooted, ctx.comm, ctx.axis), None, None, None


def gather(x: torch.Tensor, comm, root: int = 0,
           axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` joined along ``axis`` on the root, zeros of
    that shape elsewhere.  Backward: the root's cotangent, this rank's
    block."""
    return _Gather.apply(x, comm, root, axis)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root, axis):
        ctx.comm, ctx.root, ctx.axis = comm, root, axis
        return _block(comm.bcast(x.contiguous(), root), comm, axis).clone()

    @staticmethod
    def backward(ctx, grad):
        joined = _joined(ctx.comm.allgather(grad.contiguous()), ctx.axis, True)
        return _on_root(joined, ctx.comm, ctx.root), None, None, None


def scatter(x: torch.Tensor, comm, root: int = 0,
            axis: int = 0) -> torch.Tensor:
    """Block ``rank`` of root's ``x`` along ``axis``.  Backward: every
    rank's cotangent joined, on the root (zeros elsewhere)."""
    return _Scatter.apply(x, comm, root, axis)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return _block(_sum(x, comm), comm, axis).clone()

    @staticmethod
    def backward(ctx, grad):
        joined = _joined(ctx.comm.allgather(grad.contiguous()), ctx.axis, True)
        return joined, None, None


def reduce_scatter(x: torch.Tensor, comm,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """Block ``rank`` (along ``scatter_dimension``) of the sum over the
    ranks: the bandwidth half of an all-reduce.  Backward:
    ``all_gather``."""
    return _ReduceScatter.apply(x, comm, scatter_dimension)
