"""Communicator API over ``torch.distributed``.

Port of ``chainermn_tpu/communicators/communicator_base.py``.  The JAX
package works on *stacked* arrays (one controller holds every rank's
value, ``x[r]`` is rank r's); the port runs one process per card, as
ChainerMN did, so every collective takes this rank's own tensor and
returns what ChainerMN's MPI call left in this rank's buffer:

* ``allreduce(x, op)``: the reduction (``sum``, ``mean``, ``max``,
  ``min``, ``prod``);
* ``bcast(x, root)``: root's value;
* ``gather(x, root)``: the ``(size, ...)`` stack on root, ``None``
  elsewhere; ``allgather(x)``: the stack everywhere;
* ``scatter(x, root)``: row ``rank`` of root's ``(size, ...)`` ``x``
  (other ranks may pass ``None``);
* ``alltoall(x)``: ``x`` is ``(size, ...)``, row j going to rank j; the
  result's row j came from rank j;
* ``reduce_scatter(x, op)``: block ``rank`` of the reduction of a
  ``(n,)`` tensor, ``n`` divisible by ``size`` (``sum`` or ``mean``);
* the ``*_obj`` forms on the c10d object collectives (pickled), and
  ``sync_seed``, one seed agreed by every rank;
* point to point, as ChainerMN's per-rank ``send``/``recv``:
  ``send(x, dest)`` of a tensor or a tuple of tensors, preceded by one
  small int64 header (arity, then each tensor's dtype, ndim and shape) so
  that ``recv(source)`` can allocate; ``sendrecv(x, dest, source)`` (both
  at once, for rings); ``send_obj``/``recv_obj`` (pickled);
* ``bcast_data(model)``: rank 0's parameters and buffers, in place;
* ``allreduce_grad(model)``: every ``p.grad`` averaged in place.

A communicator spans the whole default process group, which the caller
initialises (``torch.distributed.init_process_group``).  ``split``
waits for ROADMAP Queue 1 "Communicators, tier 2".
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ._topology import Topology

REDUCE_OPS = ("sum", "mean", "max", "min", "prod")
_DIST_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
             "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
             "prod": dist.ReduceOp.PRODUCT}

# A point-to-point header: HEADER_SLOTS int64, [arity (-1: one bare
# tensor), then per tensor its dtype's index in P2P_DTYPES, ndim, shape]
HEADER_SLOTS = 64
P2P_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
              torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
              torch.bool)


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """``allreduce_grad_dtype`` as a torch dtype: accepts a torch dtype,
    a numpy dtype or a numpy name (``"bfloat16"`` too), or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(
        np.dtype(dtype), "name", str(dtype))
    got = getattr(torch, str(name), None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return got


class CommunicatorBase:
    """A world of one process per card, with ChainerMN's rank model and
    collectives (see the module docstring for the per-rank semantics).

    ``no_exchange``: True for the ``dummy`` communicator, whose train
    step is built the same but leaves the gradient exchange out.
    """

    no_exchange = False

    def __init__(self, allreduce_grad_dtype=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialised: call "
                "torch.distributed.init_process_group (NCCL for cards, "
                "gloo for the CPU) before create_communicator"
            )
        self._group = self._make_group()
        self._rank = dist.get_rank()
        self._size = dist.get_world_size()
        self.allreduce_grad_dtype = as_torch_dtype(allreduce_grad_dtype)
        self._topology = Topology.create(self._rank, self._size,
                                         self.allgather_obj)

    def _make_group(self):
        """The process group the collectives run on (None: the default
        group)."""
        return None

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the group's backend takes it (host staging hook)."""
        return x

    # ------------------------------------------------------------------
    # Rank model
    # ------------------------------------------------------------------
    @property
    def topology(self) -> Topology:
        return self._topology

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def intra_rank(self) -> int:
        return self._topology.intra_rank

    @property
    def intra_size(self) -> int:
        return self._topology.intra_size

    @property
    def inter_rank(self) -> int:
        return self._topology.inter_rank

    @property
    def inter_size(self) -> int:
        return self._topology.inter_size

    @property
    def mesh_shape(self) -> dict:
        """``{axis name: size}`` of the sync axes the gradient wire plans
        against, named as the JAX package's mesh names them: one flat
        axis ``"mn"`` over every rank (``XlaCommunicatorBase._build_mesh``),
        so ``comm_wire.plan_wire`` plans every bucket ``flat`` and hashes
        as the reference's flat mesh does."""
        return {"mn": self._size}

    @property
    def axis_names(self) -> tuple:
        return tuple(self.mesh_shape)

    @property
    def wire_groups(self):
        """The ``(intra, inter)`` process groups of a multi-hop schedule,
        or None (a flat communicator stages nothing)."""
        return None

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self._group))

    @property
    def device(self) -> torch.device:
        """The card this rank drives, ``cuda:<intra_rank>`` (ChainerMN's
        ``device = comm.intra_rank``); the CPU only in a gloo world."""
        if dist.get_backend() == "gloo":
            return torch.device("cpu")
        return torch.device("cuda", self.intra_rank)

    # ------------------------------------------------------------------
    # Tensor collectives
    # ------------------------------------------------------------------
    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if op not in REDUCE_OPS:
            raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")
        out = self._to_wire(x).clone()
        dist.all_reduce(out, op=_DIST_OPS[op], group=self._group)
        if op == "mean":
            out /= self._size
        return out.to(x.device)

    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        out = self._to_wire(x).clone()
        dist.broadcast(out, src=root, group=self._group)
        return out.to(x.device)

    def gather(self, x: torch.Tensor, root: int = 0) -> Optional[torch.Tensor]:
        w = self._to_wire(x).contiguous()
        parts = ([torch.empty_like(w) for _ in range(self._size)]
                 if self._rank == root else None)
        dist.gather(w, parts, dst=root, group=self._group)
        return None if parts is None else torch.stack(parts).to(x.device)

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        w = self._to_wire(x).contiguous()
        parts = [torch.empty_like(w) for _ in range(self._size)]
        dist.all_gather(parts, w, group=self._group)
        return torch.stack(parts).to(x.device)

    def scatter(self, x: Optional[torch.Tensor], root: int = 0) -> torch.Tensor:
        meta = None
        if self._rank == root:
            if x.shape[0] != self._size:
                raise ValueError(f"scatter needs ({self._size}, ...) on the "
                                 f"root, got {tuple(x.shape)}")
            meta = (tuple(x.shape[1:]), str(x.dtype).split(".")[-1],
                    x.device.type)
        shape, dtype, kind = self.bcast_obj(meta, root=root)
        # each rank's row lands on its own card (the current device)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if kind == "cuda" else torch.device(kind))
        like = torch.empty(shape, dtype=getattr(torch, dtype), device=device)
        out = self._to_wire(like)
        parts = (list(self._to_wire(x).contiguous().unbind(0))
                 if self._rank == root else None)
        dist.scatter(out, parts, src=root, group=self._group)
        return out.to(device)

    def alltoall(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() < 1 or x.shape[0] != self._size:
            raise ValueError(f"alltoall expects ({self._size}, ...); got "
                             f"{tuple(x.shape)}")
        w = self._to_wire(x).contiguous()
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self._group)
        return out.to(x.device)

    def reduce_scatter(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Block ``rank`` of the reduction (an all-reduce, then this
        rank's block: the same values on every backend)."""
        if op not in ("sum", "mean"):
            raise ValueError(f"reduce_scatter supports sum/mean, got {op!r}")
        if x.dim() != 1 or x.shape[0] % self._size:
            raise ValueError(f"reduce_scatter needs (n,) with n divisible "
                             f"by {self._size}; got {tuple(x.shape)}")
        return self.allreduce(x, op).chunk(self._size)[self._rank].clone()

    def barrier(self) -> None:
        dist.barrier(group=self._group)

    # ------------------------------------------------------------------
    # Point to point (one process per rank, as ChainerMN's MPI calls)
    # ------------------------------------------------------------------
    def send(self, x, dest: int) -> None:
        """Send a tensor, or a tuple/list of tensors, to rank ``dest``:
        one header, then one message per non-empty tensor."""
        leaves = list(x) if isinstance(x, (tuple, list)) else [x]
        if not leaves:
            raise ValueError("send needs a tensor or a non-empty tuple")
        header = [len(leaves) if isinstance(x, (tuple, list)) else -1]
        for t in leaves:
            if t.dtype not in P2P_DTYPES:
                raise ValueError(f"send cannot carry {t.dtype}")
            header += [P2P_DTYPES.index(t.dtype), t.dim(), *t.shape]
        if len(header) > HEADER_SLOTS:
            raise ValueError(f"send's header needs {len(header)} slots, "
                             f"more than {HEADER_SLOTS}")
        header += [0] * (HEADER_SLOTS - len(header))
        dist.send(self._to_wire(torch.tensor(header, dtype=torch.int64,
                                             device=leaves[0].device)),
                  dest, group=self._group)
        for t in leaves:
            if t.numel():
                dist.send(self._to_wire(t.detach()).contiguous(), dest,
                          group=self._group)

    def recv(self, source: int, device=None):
        """What ``source`` sent with :meth:`send` (a tensor or a
        tuple), on ``device`` (default: this rank's :attr:`device`)."""
        device = torch.device(device) if device is not None else self.device
        hdr = self._to_wire(torch.empty(HEADER_SLOTS, dtype=torch.int64,
                                        device=device))
        dist.recv(hdr, source, group=self._group)
        header = hdr.tolist()
        arity, pos, out = header[0], 1, []
        for _ in range(max(arity, 1)):
            dtype, ndim = P2P_DTYPES[header[pos]], header[pos + 1]
            shape = header[pos + 2:pos + 2 + ndim]
            pos += 2 + ndim
            t = self._to_wire(torch.empty(shape, dtype=dtype, device=device))
            if t.numel():
                dist.recv(t, source, group=self._group)
            out.append(t.to(device))
        return out[0] if arity == -1 else tuple(out)

    def sendrecv(self, x: torch.Tensor, dest: Optional[int],
                 source: Optional[int]) -> Optional[torch.Tensor]:
        """Send ``x`` to ``dest`` and receive a tensor of its shape and
        dtype from ``source``, both posted at once, so that a ring or a
        permutation cannot deadlock.  Either side may be None (nothing
        sent, or None returned)."""
        if dest == self._rank and source == self._rank:
            return x.clone()
        w = self._to_wire(x.detach()).contiguous()
        out = None if source is None else torch.empty_like(w)
        ops = ([] if dest is None else
               [dist.P2POp(dist.isend, w, dest, group=self._group)])
        if out is not None:
            ops.append(dist.P2POp(dist.irecv, out, source, group=self._group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return None if out is None else out.to(x.device)

    def send_obj(self, obj: Any, dest: int) -> None:
        dist.send_object_list([obj], dest, group=self._group)

    def recv_obj(self, source: int) -> Any:
        box = [None]
        dist.recv_object_list(box, source, group=self._group)
        return box[0]

    # ------------------------------------------------------------------
    # Object collectives (pickled, on the c10d object collectives)
    # ------------------------------------------------------------------
    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=root, group=self._group)
        return box[0]

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[list]:
        out = [None] * self._size if self._rank == root else None
        dist.gather_object(obj, out, dst=root, group=self._group)
        return out

    def allgather_obj(self, obj: Any) -> list:
        out = [None] * self._size
        dist.all_gather_object(out, obj, group=self._group)
        return out

    def allreduce_obj(self, obj: Any, op: Optional[Callable] = None) -> Any:
        """``op(list of every rank's obj)``; by default their sum."""
        objs = self.allgather_obj(obj)
        if op is not None:
            return op(objs)
        out = objs[0]
        for o in objs[1:]:
            out = out + o
        return out

    @property
    def sync_seed(self) -> int:
        """A seed every rank of this communicator agrees on (parity:
        the seed broadcast of ChainerMN's synchronized iterator): drawn
        once, rank 0's draw broadcast with ``bcast_obj``."""
        if getattr(self, "_sync_seed", None) is None:
            seed = int(np.random.randint(0, 2**31 - 1))
            self._sync_seed = int(self.bcast_obj(seed, root=0))
        return self._sync_seed

    def world_descriptor(self) -> dict:
        """The world a checkpoint's manifest names: ``world_size``, the
        ``process_count`` (one process per rank) and the sync axes
        (``mesh_shape``)."""
        return {"world_size": int(self._size),
                "process_count": int(self._size),
                "mesh_axes": {str(k): int(v)
                              for k, v in self.mesh_shape.items()}}

    # ------------------------------------------------------------------
    # Model-level helpers
    # ------------------------------------------------------------------
    @torch.no_grad()
    def bcast_data(self, model: nn.Module) -> nn.Module:
        """Copy rank 0's parameters and buffers into every rank's
        ``model``, in place (parity: ``bcast_data(model)``, the initial
        weight sync).  Returns ``model``."""
        for t in model.state_dict().values():
            t.copy_(self.bcast(t, root=0))
        return model

    @torch.no_grad()
    def allreduce_grad(self, model: nn.Module, *, mean: bool = True) -> None:
        """Average (or sum) every parameter's ``.grad`` over the ranks,
        in place, one collective per parameter (parity:
        ``allreduce_grad(model)``; the train step syncs through the
        bucketed wire instead).  With ``allreduce_grad_dtype`` the
        gradient travels in that dtype and is cast back before the
        divide, as the wire codecs do."""
        wire = self.allreduce_grad_dtype
        for p in model.parameters():
            if p.grad is None:
                continue
            g = p.grad if wire is None else p.grad.to(wire)
            summed = self.allreduce(g, "sum").to(p.grad.dtype)
            p.grad.copy_(summed / self._size if mean else summed)

    def __repr__(self):
        return (f"<{type(self).__name__} rank={self.rank} size={self.size} "
                f"inter={self.inter_size}x{self.intra_size}>")
