"""Differentiable point-to-point communication.

Port of ``chainermn_tpu/functions/point_to_point.py`` (``send`` :39,
``recv`` :52, ``exchange`` :59, ``pseudo_connect`` :70).  The JAX
package moves a shard with ``lax.ppermute`` inside one SPMD program and
lets JAX generate the transpose; the port keeps ChainerMN's one process
per rank, so these are ``torch.autograd.Function``\\ s over the
communicator's eager ``send``/``recv``, with ChainerMN's semantics:

* ``send(x, comm, dest)`` sends ``x`` (a tensor or a tuple of tensors)
  and returns a zero-size *delegate*; its backward receives the
  gradient of ``x`` from ``dest``;
* ``recv(comm, source, delegate=None)`` returns what ``source`` sent; its
  backward sends the gradient back.  A ``delegate`` becomes an input,
  so that the backward of whatever made it (an earlier ``send``) runs
  after this one: the order that keeps two ranks' backward transfers
  matched;
* ``pseudo_connect(delegate, actual)`` returns ``actual`` and gives
  ``delegate`` a zero gradient, value-neutral, as in the JAX package;
* ``exchange(x, comm, shift)``: rank r sends to ``(r + shift) % size``;
  its backward is the rotation by ``-shift`` (the ppermute transpose).

Every floating-point tensor that crosses carries a gradient back, and
every integer one none: both sides read that from the dtype alone, so
the two ranks' backward transfers always pair up.  The delegate always
requires grad (grad mode on), whatever ``x`` does.
"""

from __future__ import annotations

from typing import Optional

import torch


def _leaves(x):
    return (list(x), True) if isinstance(x, (tuple, list)) else ([x], False)


def _anchor(device) -> torch.Tensor:
    """A zero-size leaf that requires grad: it puts a send or a recv in
    the graph whatever its payload requires."""
    return torch.empty(0, device=device, requires_grad=True)


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, comm, dest, as_tuple, *xs):
        ctx.comm, ctx.dest = comm, dest
        ctx.floats = [x.is_floating_point() for x in xs]
        ctx.device = xs[0].device
        comm.send(tuple(xs) if as_tuple else xs[0], dest)
        return anchor.new_empty(0)

    @staticmethod
    def backward(ctx, _delegate_grad):
        got = iter(ctx.comm.recv(ctx.dest, ctx.device)
                   if any(ctx.floats) else ())
        return (None, None, None, None,
                *[next(got) if f else None for f in ctx.floats])


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, comm, source, device, arity):
        # ``arity`` is filled in: whether the sender sent a tuple
        ctx.comm, ctx.source = comm, source
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        data, arity["tuple"] = _leaves(comm.recv(source, device))
        ctx.floats = [t.is_floating_point() for t in data]
        ctx.mark_non_differentiable(
            *[t for t, f in zip(data, ctx.floats) if not f])
        return tuple(data)

    @staticmethod
    def backward(ctx, *grads):
        back = tuple(g.contiguous() for g, f in zip(grads, ctx.floats) if f)
        if back:
            ctx.comm.send(back, ctx.source)
        shape, dtype, device = ctx.anchor
        return (torch.zeros(shape, dtype=dtype, device=device), None, None,
                None, None)


class _PseudoConnect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delegate, *actual):
        ctx.delegate = (delegate.shape, delegate.dtype, delegate.device)
        out = tuple(a.view_as(a) for a in actual)
        ctx.mark_non_differentiable(
            *[o for o in out if not o.is_floating_point()])
        return out

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, device = ctx.delegate
        return (torch.zeros(shape, dtype=dtype, device=device), *grads)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, shift):
        ctx.comm, ctx.shift = comm, shift
        return _rotate(x, comm, shift)

    @staticmethod
    def backward(ctx, grad):
        return _rotate(grad, ctx.comm, -ctx.shift), None, None


def _rotate(x, comm, shift):
    n, r = comm.size, comm.rank
    return comm.sendrecv(x, (r + shift) % n, (r - shift) % n)


def send(x, comm, dest: int) -> torch.Tensor:
    """Send ``x`` (a tensor or a tuple of tensors) to rank ``dest``;
    returns the zero-size delegate whose backward receives ``x``'s
    gradient from ``dest`` (ChainerMN's ``functions.send``)."""
    xs, as_tuple = _leaves(x)
    return _Send.apply(_anchor(xs[0].device), comm, dest, as_tuple, *xs)


def recv(comm, source: int, delegate: Optional[torch.Tensor] = None,
         device=None):
    """What rank ``source`` sent with :func:`send` (a tensor or a
    tuple), on ``device`` (default: the communicator's).  Its backward
    sends the gradient to ``source``.  ``delegate``: a tensor whose
    producer's backward must run after this recv's (ChainerMN's
    ``delegate_variable``)."""
    device = torch.device(device) if device is not None else comm.device
    anchor = (delegate if delegate is not None and delegate.requires_grad
              else _anchor(device))
    arity = {}
    out = _Recv.apply(anchor, comm, source, device, arity)
    return out if arity["tuple"] else out[0]


def pseudo_connect(delegate: torch.Tensor, *actual):
    """``actual`` unchanged (one tensor, or a tuple for several), with
    ``delegate`` tied into the graph: its gradient is zeros of its
    shape, so that the backward of what made it (a :func:`send`) runs
    once this one has."""
    out = _PseudoConnect.apply(delegate, *actual)
    return out[0] if len(actual) == 1 else out


def exchange(x: torch.Tensor, comm, shift: int = 1) -> torch.Tensor:
    """Ring rotation by ``shift``: rank r sends ``x`` to
    ``(r + shift) % size`` and returns what ``(r - shift) % size`` sent.
    Differentiable: the backward is the rotation by ``-shift``."""
    return _Exchange.apply(x, comm, shift)
