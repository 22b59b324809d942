"""MultiNodeChainList: model-parallel stage composition.

Port of ``chainermn_tpu/link.py`` (``PlacedModule`` :45,
``MultiNodeChainList`` :70, ``_StageOptimizer`` :273), with the JAX
package's declaration semantics and ChainerMN's execution:

* ``add_link(module, rank_in, rank_out, rank=None)`` declares a stage.
  Its rank defaults to ``len(stages) % comm.size`` and it runs on the
  process of rank ``rank % comm.size``.  ``rank_in``: ``None`` (the
  external input), a rank, or a list of them, one positional argument
  of the module per entry; a ``None`` inside the list is the external
  input again.  The edge from rank r is the output of the latest stage
  placed on r before this one; an edge's value is a tensor or a tuple of
  tensors (an LSTM's ``(h, c)``), one argument either way.  ``rank_out``
  is kept for parity: the consumers' ``rank_in`` routes the edges.
* Every rank declares every stage and walks the whole list in
  declaration order, running only its own stages (registered under
  ``local``, on ``device``).  An edge between two ranks is
  ``functions.send`` on the producer's and ``functions.recv`` on the
  consumer's, made at the consumer's place in the walk, so that every
  pair of ranks sees its transfers in the same order; an edge within a
  rank is the tensor itself.
* Each send or recv takes the rank's previous one as its delegate
  (``recv(..., delegate=)``, ``pseudo_connect`` before a send), so a
  rank's backward runs its transfers in exactly the reverse order, as
  its partners' do: a chain that visits a rank twice (0 -> 1 -> 0 -> 1)
  cannot deadlock.  The backward is one ``backward()`` a rank: from the
  loss (tied to the last transfer) on the last stage's rank, from the
  last transfer elsewhere.  Cotangents from several consumers add up; a
  stage whose output nobody uses gets zero gradients, as in the JAX
  package.

For homogeneous stages and microbatches see ``parallel.pipeline``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
from torch import nn

from .functions.point_to_point import pseudo_connect, recv, send


@dataclasses.dataclass
class PlacedModule:
    """A module bundled with its routing, as factories that take the
    reference's ``(comm, rank_in, rank_out)`` return it
    (``links.create_multi_node_n_step_rnn``): ``add_link(placed)``
    reads the edges from here; explicit arguments override them."""

    module: nn.Module
    rank_in: Any = None  # None | int | list
    rank_out: Any = None  # None | int | list
    rank: Optional[int] = None  # explicit placement (default: next free)


@dataclasses.dataclass
class _Stage:
    module: nn.Module
    rank_in: Any
    rank_out: Any
    index: int
    rank: int


def _tie(tail, value):
    """``value`` (a tensor or a tuple) tied to ``tail`` by
    ``pseudo_connect``."""
    if tail is None:
        return value
    if isinstance(value, (tuple, list)):
        out = pseudo_connect(tail, *value)
        return out if len(value) > 1 else (out,)
    return pseudo_connect(tail, value)


class MultiNodeChainList(nn.Module):
    """Modules across ranks with explicit activation routing (see the
    module docstring).  ``device``: where this rank's stages run
    (default: the communicator's)."""

    def __init__(self, comm, device=None):
        super().__init__()
        self._comm = comm
        self.device = (torch.device(device) if device is not None
                       else comm.device)
        self._stages: List[_Stage] = []
        self.local = nn.ModuleList()

    # -- graph construction -------------------------------------------
    def add_link(self, module, rank_in=None, rank_out=None,
                 rank: Optional[int] = None) -> "MultiNodeChainList":
        if isinstance(module, PlacedModule):
            rank_in = rank_in if rank_in is not None else module.rank_in
            rank_out = rank_out if rank_out is not None else module.rank_out
            rank = rank if rank is not None else module.rank
            module = module.module
        n = len(self._stages)
        st = _Stage(module, rank_in, rank_out, n,
                    rank if rank is not None else n % self._comm.size)
        self._stages.append(st)
        if self._runs_here(st):
            self.local.append(module.to(self.device))
        return self

    @property
    def n_stages(self) -> int:
        return len(self._stages)

    @property
    def stage_modules(self) -> List[nn.Module]:
        """Every stage's module, in declaration order (only this rank's
        are registered and on ``device``)."""
        return [st.module for st in self._stages]

    def stage_rank(self, index: int) -> int:
        """The process rank that runs stage ``index``."""
        return self._stages[index].rank % self._comm.size

    def _runs_here(self, st: _Stage) -> bool:
        return st.rank % self._comm.size == self._comm.rank

    def _find_producer(self, rank: int, before: int) -> _Stage:
        for st in reversed(self._stages[:before]):
            if st.rank == rank:
                return st
        raise ValueError(
            f"no stage placed on rank {rank} precedes stage {before}")

    def _edges(self, st: _Stage) -> list:
        """The producer of each incoming edge (None: the external
        input), checked on every rank before anything is sent."""
        if st.rank_in is None:
            return [None]
        ranks = (st.rank_in if isinstance(st.rank_in, (list, tuple))
                 else [st.rank_in])
        return [None if r is None else self._find_producer(r, st.index)
                for r in ranks]

    # -- execution -------------------------------------------------------
    def _walk(self, x):
        """Run this rank's stages; returns the last stage's output (None
        where it is not this rank's) and the rank's last transfer (the
        backward's root where there is no loss)."""
        comm = self._comm
        edges = [self._edges(st) for st in self._stages]
        outputs: dict = {}
        tail = None
        for st, producers in zip(self._stages, edges):
            here = self._runs_here(st)
            dest = st.rank % comm.size
            ins = []
            for src in producers:
                if src is None:
                    ins.append(x)
                    continue
                source = src.rank % comm.size
                if source == dest:
                    if here:
                        ins.append(outputs[src.index])
                elif comm.rank == source:
                    delegate = send(_tie(tail, outputs[src.index]), comm, dest)
                    tail = delegate if delegate.requires_grad else tail
                elif here:
                    got = recv(comm, source, delegate=tail, device=self.device)
                    leaves = got if isinstance(got, tuple) else (got,)
                    tail = next((t for t in leaves if t.requires_grad), tail)
                    ins.append(got)
            if here:
                outputs[st.index] = st.module(*ins)
        return outputs.get(self._stages[-1].index), tail

    def forward(self, x):
        """The final stage's output on its rank, None on the others.
        Every rank calls it with the same external input.  For training
        use :meth:`value_and_grad`; called in grad mode, every rank must
        run a backward of its own (the transfers' gradients pair up)."""
        return self._walk(x)[0]

    def value_and_grad(self, loss_fn: Callable):
        """``step(x, *loss_args) -> loss``: the forward on every rank,
        ``loss_fn(final_output, *loss_args)`` on the last stage's rank,
        one backward a rank, gradients accumulated into ``.grad`` of this
        rank's stages (zeros for a stage no loss depends on).  Returns the
        loss, detached, broadcast to every rank (fp32, 0-dim)."""

        def step(x, *loss_args):
            last = self.stage_rank(len(self._stages) - 1)
            y, tail = self._walk(x)
            if self._comm.rank == last:
                loss = loss_fn(y, *loss_args)
                _tie(tail, loss).backward()
                value = loss.detach().float()
            else:
                if tail is not None:
                    tail.backward(torch.zeros_like(tail))
                value = torch.zeros((), device=self.device)
            for p in self.local.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            return self._comm.bcast(value, root=last)

        return step

    # -- optimization --------------------------------------------------
    def optimizer(self, optimizer_cls, **kwargs) -> "StageOptimizer":
        """One ``optimizer_cls(stage parameters, **kwargs)`` per stage of
        this rank (ChainerMN: every rank runs its own local optimizer
        over its part of the model)."""
        return StageOptimizer(
            [m for m in self.local if any(True for _ in m.parameters())],
            optimizer_cls, **kwargs)


class StageOptimizer:
    """Per-stage ``torch.optim`` optimizers of a rank's stages (the
    counterpart of the JAX ``_StageOptimizer``: one state per stage)."""

    def __init__(self, modules, optimizer_cls, **kwargs):
        self.optimizers = [optimizer_cls(m.parameters(), **kwargs)
                           for m in modules]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers:
            opt.step()
