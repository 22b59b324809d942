"""Workers of the model-parallel port's gloo worlds
(``tests/test_torch_model_parallel.py``, ``test_torch_pipeline.py`` and
``test_torch_seq2seq.py``): each runs in a spawned process of
``test_torch_world.run_world`` and imports only torch, numpy and the
port, so the processes start without JAX.  Inputs and results are numpy
arrays (row r of a stacked input is rank r's)."""

from __future__ import annotations

import torch
from torch import nn


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def jobs_worker(rank, world_size, jobs):
    """Several workers of this module in one world, in turn: ``jobs``
    is a list of ``(worker name, args)``; returns their results."""
    return [globals()[name](rank, world_size, *args) for name, args in jobs]


# ----------------------------------------------------------------------
# Point to point and the collectives
# ----------------------------------------------------------------------
COLLECTIVES = ("psum", "pmean", "pmax", "pmin", "all_gather",
               "all_gather_stacked", "all_to_all", "ppermute", "bcast",
               "gather", "scatter", "reduce_scatter")
PERM = [(0, 2), (2, 1)]  # rank 0 receives nothing, rank 1 sends nothing


def port_collective(name, x, comm):
    from chainermn_tpu_torch import functions as F_

    return {
        "psum": lambda: F_.psum(x, comm),
        "pmean": lambda: F_.pmean(x, comm),
        "pmax": lambda: F_.pmax(x, comm),
        "pmin": lambda: F_.pmin(x, comm),
        "all_gather": lambda: F_.all_gather(x, comm, axis=0),
        "all_gather_stacked": lambda: F_.all_gather(x, comm, axis=1,
                                                    tiled=False),
        "all_to_all": lambda: F_.all_to_all(x, comm, split_axis=0,
                                            concat_axis=1),
        "ppermute": lambda: F_.ppermute(x, comm, PERM),
        "bcast": lambda: F_.bcast(x, comm, root=2),
        "gather": lambda: F_.gather(x, comm, root=1, axis=0),
        "scatter": lambda: F_.scatter(x, comm, root=0, axis=0),
        "reduce_scatter": lambda: F_.reduce_scatter(x, comm),
    }[name]()


def functions_worker(rank, world_size, x, weights):
    """Every differentiable collective on row ``rank`` of ``x``: its
    value, and the gradient of ``sum(value * weights[name][rank])`` (or
    the error its backward raises); then point to point (a tensor from
    1 to the last rank, a tuple from the last rank to 0; gradients of
    weighted sums) and ``pseudo_connect``."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.functions import pseudo_connect, recv, send

    comm = create_communicator("pure_nccl")
    out = {}
    for name in COLLECTIVES:
        xr = torch.tensor(x[rank], requires_grad=True)
        y = port_collective(name, xr, comm)
        res = {"value": _np(y)}
        try:
            (y * torch.from_numpy(weights[name][rank])).sum().backward()
            res["grad"] = _np(xr.grad)
        except NotImplementedError as e:
            res["error"] = str(e)
        out[name] = res

    # a tensor from 1 to the last rank (the JAX test's send), then a
    # tuple with an int leaf from the last rank to 0
    last = world_size - 1
    xr = torch.tensor(x[rank], requires_grad=True)
    if rank == 1:
        send(xr, comm, last).backward(torch.empty(0))
    elif rank == last:
        y = recv(comm, 1)
        out["p2p_value"] = _np(y)
        (y * 3.0).sum().backward()
    out["p2p_grad"] = _np(xr.grad)
    xr = torch.tensor(x[rank], requires_grad=True)
    if rank == last:
        ints = torch.arange(5, dtype=torch.int32)
        send((xr * 2.0, ints, xr), comm, 0).backward(torch.empty(0))
    elif rank == 0:
        h, ints, c = recv(comm, last)
        out["tuple_value"] = (_np(h), _np(ints), _np(c))
        out["tuple_int_requires_grad"] = ints.requires_grad
        ((h * 5.0).sum() + (c * 7.0).sum()).backward()
    out["tuple_grad"] = _np(xr.grad)
    if rank == 0:
        comm.send_obj({"from": 0, "x": x[0]}, last)
    elif rank == last:
        out["obj"] = comm.recv_obj(0)

    d = torch.ones(3, requires_grad=True)
    a = torch.arange(4.0, requires_grad=True)
    y = pseudo_connect(d, a)
    (y ** 2).sum().backward()
    out["pseudo"] = (_np(y), _np(d.grad), _np(a.grad))
    return out


def exchange_worker(rank, world_size, x, w, shifts):
    """``exchange`` of row ``rank`` of ``x`` for each shift: the value
    and the gradient of ``sum(value * w[rank])``."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.functions import exchange

    comm = create_communicator("pure_nccl")
    out = {}
    for shift in shifts:
        xr = torch.tensor(x[rank], requires_grad=True)
        y = exchange(xr, comm, shift)
        (y * torch.from_numpy(w[rank])).sum().backward()
        out[shift] = (_np(y), _np(xr.grad))
    return out


# ----------------------------------------------------------------------
# MultiNodeChainList
# ----------------------------------------------------------------------
class Block(nn.Module):
    """``tanh(Dense(x))``, the JAX tests' ``Block``."""

    def __init__(self, params):
        super().__init__()
        k = params["Dense_0"]["kernel"]
        self.dense = nn.Linear(*k.shape)
        with torch.no_grad():
            self.dense.weight.copy_(torch.from_numpy(k.T))
            self.dense.bias.copy_(torch.from_numpy(params["Dense_0"]["bias"]))

    def forward(self, x):
        return torch.tanh(self.dense(x))


class Join(Block):
    """``Dense(concat(a, b))``, the JAX tests' ``Join``."""

    def forward(self, a, b):
        return self.dense(torch.cat([a, b], dim=-1))


class PairBlock(Block):
    """A stage with a tuple output: ``(tanh(Dense(x)), x)``."""

    def forward(self, x):
        return torch.tanh(self.dense(x)), x


class FromPair(nn.Module):
    def forward(self, pair):
        return pair[0] * pair[1]


STAGE_KINDS = {"block": Block, "join": Join, "pair": PairBlock}


def _make(kind, params):
    return FromPair() if kind == "from_pair" else STAGE_KINDS[kind](params)


def chain_worker(rank, world_size, graphs, x):
    """Each graph (a list of ``(kind, params, rank_in, rank)`` stages)
    as a ``MultiNodeChainList``: the output on the last rank, the loss
    ``sum(y ** 2)`` broadcast to every rank, and each local stage's
    gradients (flax layout: Dense kernels transposed).  A graph whose
    declaration is invalid gives the error each rank raises."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.link import MultiNodeChainList

    comm = create_communicator("pure_nccl")
    out = {}
    for gname, stages in graphs.items():
        chain = MultiNodeChainList(comm)
        for kind, params, rank_in, r in stages:
            chain.add_link(_make(kind, params), rank_in=rank_in, rank=r)
        xt = torch.from_numpy(x)
        try:
            with torch.no_grad():
                y = chain(xt)
            loss = chain.value_and_grad(lambda y: (y ** 2).sum())(xt)
        except ValueError as e:
            out[gname] = {"error": str(e)}
            continue
        grads = {}
        for i, m in enumerate(chain.stage_modules):
            if chain.stage_rank(i) == rank and hasattr(m, "dense"):
                grads[i] = (_np(m.dense.weight.grad).T,
                            _np(m.dense.bias.grad))
        out[gname] = {"y": _np(y), "loss": float(loss), "grads": grads}
    return out


# ----------------------------------------------------------------------
# The seq2seq chain, its data-parallel twin's step, the pipelines
# ----------------------------------------------------------------------
def _stage_grads(module):
    return {k: _np(p.grad) for k, p in module.named_parameters()}


def _stage_params(module):
    return {k: _np(p) for k, p in module.state_dict().items()}


def seq2seq_chain_run(comm, cfg, params, batches, lr):
    """The ``seq2seq_mp1`` chain on ``comm``: per step the loss, the
    first step's gradients of this rank's stages, and every local
    stage's parameters after the last step."""
    from chainermn_tpu_torch.examples.train_seq2seq_mp1 import make_chain
    from chainermn_tpu_torch.models import seq2seq_loss, teacher_forcing

    chain = make_chain(comm, cfg["vocab"], cfg["units"], cfg["layers"],
                       params=params)
    opt = chain.optimizer(torch.optim.Adam, lr=lr)
    step = chain.value_and_grad(seq2seq_loss)
    losses, grads = [], None
    for xs, ys in batches:
        ys_in, ys_out = teacher_forcing(torch.from_numpy(ys))
        opt.zero_grad()
        losses.append(float(step([torch.from_numpy(xs), ys_in], ys_out)))
        if grads is None:
            grads = {i: _stage_grads(m) for i, m in
                     enumerate(chain.stage_modules)
                     if chain.stage_rank(i) == comm.rank}
        opt.step()
    final = {i: _stage_params(m) for i, m in enumerate(chain.stage_modules)
             if chain.stage_rank(i) == comm.rank}
    return {"losses": losses, "grads": grads, "params": final}


def seq2seq_chain_worker(rank, world_size, cfg, params, batches, lr):
    from chainermn_tpu_torch.communicators import create_communicator

    return seq2seq_chain_run(create_communicator("pure_nccl"), cfg, params,
                             batches, lr)


def seq2seq_dp_run(comm, cfg, params, batches, lr):
    """The data-parallel twin's step (``train_seq2seq.loss_of`` through
    ``build_train_step`` with the multi-node Adam) on this rank's rows of
    each global batch: the losses and the parameters after the steps."""
    from chainermn_tpu_torch import (build_train_step,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.examples.train_seq2seq import loss_of
    from chainermn_tpu_torch.models import Seq2Seq, seq2seq_params_from_flax

    model = Seq2Seq(cfg["vocab"], cfg["vocab"], cfg["units"], cfg["layers"])
    model.load_state_dict(seq2seq_params_from_flax(params))
    opt = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=lr), comm)
    step = build_train_step(comm, loss_of(model), opt)
    losses = []
    for xs, ys in batches:
        per = len(xs) // comm.size
        rows = slice(comm.rank * per, (comm.rank + 1) * per)
        losses.append(float(step((torch.from_numpy(xs[rows]),
                                   torch.from_numpy(ys[rows])))["loss"]))
    return {"losses": losses, "params": _stage_params(model)}


def seq2seq_dp_worker(rank, world_size, cfg, params, batches, lr):
    from chainermn_tpu_torch.communicators import create_communicator

    return seq2seq_dp_run(create_communicator("pure_nccl"), cfg, params,
                          batches, lr)


def gpipe_worker(rank, world_size, ws, x, w_loss):
    """``gpipe`` of ``tanh(h @ W)`` stages: ``psum`` of the outputs, and
    the gradient of this rank's ``W`` for ``pmean(sum(psum(out)**2 *
    w_loss))``, with and without remat."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.functions import pmean, psum
    from chainermn_tpu_torch.parallel import gpipe

    comm = create_communicator("pure_nccl")
    out = {}
    for remat in (False, True):
        w = torch.tensor(ws[rank], requires_grad=True)
        y = psum(gpipe(lambda p, h: torch.tanh(h @ p), w,
                       torch.from_numpy(x), comm, remat=remat), comm)
        pmean((y ** 2 * torch.from_numpy(w_loss)).sum(), comm).backward()
        out[remat] = (_np(y), _np(w.grad))
    return out


def _mse(y, t):
    return ((y - t) ** 2).mean()


def pipeline_step_worker(rank, world_size, ws, x, t, lr, n_steps, runs):
    """``build_pipeline_train_step`` of ``tanh(h @ W)`` stages with Adam:
    the losses and this rank's ``W`` after ``n_steps``, for each
    ``(remat, eps)`` of ``runs``."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.parallel import (build_pipeline_train_step,
                                              place_stage_params)

    comm = create_communicator("pure_nccl")
    out = {}
    for remat, eps in runs:
        w = place_stage_params(ws, comm)
        step = build_pipeline_train_step(
            comm, lambda p, h: torch.tanh(h @ p), _mse,
            torch.optim.Adam([w], lr=lr, eps=eps), n_micro=x.shape[0],
            remat=remat)
        batch = (torch.from_numpy(x), torch.from_numpy(t))
        losses = [float(step(w, batch)["loss"]) for _ in range(n_steps)]
        out[remat, eps] = (losses, _np(w))
    return out


def seq2seq_pipeline_run(comm, cfg, stacked, packed, lr, n_steps, eps=1e-8):
    """The encoder|decoder pipeline (``parallel.seq2seq_pipeline``) with
    Adam on ``comm``: the losses and this rank's union parameters after
    ``n_steps`` on the packed batch."""
    from chainermn_tpu_torch.parallel import (build_pipeline_train_step,
                                              place_stage_params)
    from chainermn_tpu_torch.parallel.seq2seq_pipeline import (
        Seq2SeqStages, pipeline_loss)

    stages = Seq2SeqStages(comm, cfg["vocab"], cfg["units"], cfg["layers"],
                           cfg["seqlen"])
    sp = place_stage_params(stacked, comm)
    step = build_pipeline_train_step(
        comm, stages, pipeline_loss,
        torch.optim.Adam(sp.values(), lr=lr, eps=eps),
        n_micro=packed.shape[0], remat=cfg.get("remat", False))
    batch = (torch.from_numpy(packed), None)
    losses = [float(step(sp, batch)["loss"]) for _ in range(n_steps)]
    return {"losses": losses, "params": {k: _np(v) for k, v in sp.items()}}


def seq2seq_pipeline_worker(rank, world_size, cfg, stacked, packed, lr,
                            n_steps, epss):
    """:func:`seq2seq_pipeline_run` for each Adam ``eps`` of ``epss``."""
    from chainermn_tpu_torch.communicators import create_communicator

    comm = create_communicator("pure_nccl")
    return {eps: seq2seq_pipeline_run(comm, cfg, stacked, packed, lr, n_steps,
                                      eps) for eps in epss}
