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


# ----------------------------------------------------------------------
# Optimizer tier 2: double buffering, ZeRO, overlap
# ----------------------------------------------------------------------
def quad_loss(params):
    """``0.5 * sum((w - mean(x, 0))**2)`` over the leaves: the gradient of
    leaf i is ``w_i - mean(x_i)`` on this rank's rows."""
    def loss(batch):
        return sum(0.5 * ((w - x.mean(0)) ** 2).sum()
                   for w, x in zip(params, batch))
    return loss


def _rows(xs, i, rank, world_size):
    """Rank ``rank``'s rows of step ``i``'s global batch (one array per
    leaf, ``(steps, rows, ...)``)."""
    per = xs[0].shape[1] // world_size
    return tuple(torch.from_numpy(x[i, rank * per:(rank + 1) * per].copy())
                 for x in xs)


def _inner(params, kind, lr):
    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if kind == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    return torch.optim.Adam(params, lr=lr)


def quad_run(comm, rank, world_size, w0, xs, inner, lr, opt_kw):
    """``create_multi_node_optimizer(inner, **opt_kw)`` through
    ``build_train_step`` on :func:`quad_loss`: per step the parameters
    (and the double-buffering buffer), and at the end the optimizer."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig

    kw = dict(opt_kw)
    if isinstance(kw.get("wire"), dict):
        kw["wire"] = WireConfig(**kw["wire"])
    params = [nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    opt = cmn.create_multi_node_optimizer(_inner(params, inner, lr), comm,
                                          **kw)
    step = cmn.build_train_step(comm, quad_loss(params), opt)
    out = {"params": [], "buffer": [], "losses": []}
    for i in range(xs[0].shape[0]):
        out["losses"].append(float(step(_rows(xs, i, rank,
                                              world_size))["loss"]))
        out["params"].append([_np(p).copy() for p in params])
        if hasattr(opt, "buffer"):
            out["buffer"].append([_np(b.float()).copy() for b in opt.buffer])
    return out, params, opt


def quad_cases_worker(rank, world_size, cases, env=None):
    """Each case ``name -> (w0, xs, inner, lr, opt_kw, checks)`` through
    :func:`quad_run`.  ``checks``: ``"skip"`` adds a step whose last rank
    has a NaN loss under ``nonfinite="skip"``; ``"zero"`` adds the
    shards' state (``{name: array}`` per leaf, ``(1, k)``), the bytes
    this rank holds, the plain wrapper's parameters on the same inputs,
    the hier warning (if any) and ``reshard_state``'s error."""
    import os
    import warnings

    os.environ.update(env or {})
    import chainermn_tpu_torch as cmn

    comm = cmn.create_communicator(
        "hierarchical" if env else "pure_nccl")
    out = {}
    for name, (w0, xs, inner, lr, opt_kw, checks) in cases.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res, params, opt = quad_run(comm, rank, world_size, w0, xs,
                                        inner, lr, opt_kw)
        res["warnings"] = [str(w.message) for w in caught]
        if "skip" in checks:
            before = ([b.clone() for b in opt.buffer],
                      [p.detach().clone() for p in params])
            loss = quad_loss(params)

            def poisoned(b):
                v = loss(b)
                return v * float("nan") if rank == world_size - 1 else v

            skip = cmn.build_train_step(comm, poisoned, opt,
                                        nonfinite="skip")
            res["skip_finite"] = skip(_rows(xs, 0, rank,
                                            world_size))["grads_finite"]
            res["skip_kept"] = (
                all(torch.equal(a, b) for a, b in zip(before[0],
                                                      opt.buffer))
                and all(torch.equal(a, b) for a, b in zip(before[1],
                                                          params)))
        if "zero" in checks:
            state = opt.shard_optimizer.state
            res["state"] = [{k: _np(v).copy() for k, v in state[s].items()
                             if v.dim()} for s in opt.shards]
            res["hbm"] = opt.hbm_bytes_per_rank()
            res["n_scalars"] = sum(1 for s in opt.shards
                                   for v in state[s].values()
                                   if not v.dim())
            res["schedules"] = opt.wire_plan().schedules
            kw = {k: v for k, v in opt_kw.items() if k != "zero_redundancy"}
            plain, _, _ = quad_run(comm, rank, world_size, w0, xs, inner,
                                   lr, kw)
            res["plain_params"] = plain["params"]
            try:
                opt.reshard_state(opt.state_dict(), world_size + 1)
            except NotImplementedError as e:
                res["reshard_error"] = str(e)
        out[name] = res
    return out


def mlp_db_worker(rank, world_size, variables, data, steps, runs):
    """The flax-layout MNIST MLP with double buffering: for each ``(inner,
    lr)`` of ``runs``, ``steps`` steps of ``per`` rows a rank; the
    losses and the parameters (flax order)."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy
    from test_torch_world import FlaxLayoutMLP

    comm = cmn.create_communicator("pure_nccl")
    x, y = data
    per = len(x) // (steps * world_size)
    out = {}
    for inner, lr in runs:
        model = FlaxLayoutMLP(variables)
        opt = cmn.create_multi_node_optimizer(
            _inner(list(model.parameters()), inner, lr), comm,
            double_buffering=True)
        step = cmn.build_train_step(
            comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]), opt)
        losses = []
        for i in range(steps):
            lo = (i * world_size + rank) * per
            losses.append(float(step((torch.from_numpy(x[lo:lo + per]),
                                      torch.from_numpy(y[lo:lo + per])))
                                ["loss"]))
        out[inner] = {"losses": losses,
                      "params": [_np(p).copy() for p in model.parameters()]}
    return out


class _WithUnused(nn.Module):
    """A model with a parameter no loss reaches: its hook never fires."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.unused = nn.Parameter(torch.ones(3))

    def forward(self, x):
        return self.inner(x)


def overlap_worker(rank, world_size, variables, data, steps, cases):
    """The flax-layout MNIST MLP, SGD with momentum, for each case
    ``(name, wire, accum_steps, unused)``: the synchronous wire and
    ``overlap="bucket"`` on the same batches; each run's parameters,
    error-feedback residual, losses and the overlapped run's issue
    record of every step."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy
    from test_torch_world import FlaxLayoutMLP

    comm = cmn.create_communicator("pure_nccl")
    x, y = data
    per = len(x) // (steps * world_size)
    out = {}
    for name, wire, accum, unused in cases:
        runs = {}
        for mode in ("none", "bucket"):
            model = FlaxLayoutMLP(variables)
            if unused:
                model = _WithUnused(model)
            opt = cmn.create_multi_node_optimizer(
                torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
                comm, wire=WireConfig(**wire), overlap=mode)
            step = cmn.build_train_step(
                comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]),
                opt, accum_steps=accum)
            losses, reports = [], []
            for i in range(steps):
                lo = (i * world_size + rank) * per
                losses.append(float(step((torch.from_numpy(x[lo:lo + per]),
                                          torch.from_numpy(y[lo:lo + per])))
                                    ["loss"]))
                reports.append([tuple(r) for r in opt.issue_report])
            runs[mode] = {
                "losses": losses, "reports": reports,
                "params": [_np(p).copy() for p in model.parameters()],
                "residual": [_np(r).copy() for r in opt.wire_residual],
                "n_buckets": opt.wire_plan().n_buckets,
                "schedules": opt.wire_plan().schedules}
        out[name] = runs
    return out


def tier2_checkpoint_worker(rank, world_size, root, w0, xs, runs):
    """For each ``(name, inner, lr, opt_kw)`` of ``runs``: 2 steps of
    :func:`quad_loss`, a snapshot of the parameters and the optimizer's
    state through the multi-node checkpointer, 2 more steps; then a
    fresh model and optimizer resumed from the snapshot take the same 2
    steps.  Returns both runs' final parameters and the snapshot's
    optimizer-state keys."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig

    comm = cmn.create_communicator("pure_nccl")
    out = {}
    for name, inner, lr, opt_kw in runs:
        kw = dict(opt_kw, wire=WireConfig(**opt_kw["wire"]))
        ckpt = cmn.create_multi_node_checkpointer(name, comm, path=root)

        def build():
            params = [nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
            opt = cmn.create_multi_node_optimizer(
                _inner(params, inner, lr), comm, **kw)
            return params, opt, cmn.build_train_step(
                comm, quad_loss(params), opt)

        params, opt, step = build()
        for i in range(2):
            step(_rows(xs, i, rank, world_size))
        ckpt.save(2, {"params": [p.detach() for p in params],
                      "opt": opt.state_dict()})
        for i in range(2, 4):
            step(_rows(xs, i, rank, world_size))
        ckpt.wait_until_finished()
        params2, opt2, step2 = build()
        at, state = ckpt.resume()
        with torch.no_grad():
            for p, s in zip(params2, state["params"]):
                p.copy_(s)
        opt2.load_state_dict(state["opt"])
        for i in range(at, 4):
            step2(_rows(xs, i, rank, world_size))
        out[name] = {"uninterrupted": [_np(p).copy() for p in params],
                     "resumed": [_np(p).copy() for p in params2],
                     "at": at, "keys": sorted(state["opt"])}
        ckpt.finalize()
    return out


def tier2_card_worker(rank, world_size, w0, xs, env):
    """The tier-2 paths on card ``rank`` over NCCL (on the CPU in a gloo
    world), SGD with momentum on
    :func:`quad_loss`: the plain wrapper, ``overlap="bucket"`` (bf16
    wire), double buffering (bf16 wire; the parameters after its first
    two steps) and ZeRO (``none`` wire; ``hier_rs_ag`` over the
    hierarchical communicator when ``env`` groups the ranks into
    nodes)."""
    import os

    import torch.distributed as dist

    os.environ.update(env)
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig

    device = (torch.device("cpu") if dist.get_backend() == "gloo"
              else torch.device("cuda", rank))
    comm = cmn.create_communicator("hierarchical" if env else "pure_nccl")
    knobs = dict(bucket_bytes=64, max_buckets=0)
    out = {"device": str(device), "mesh_shape": comm.mesh_shape}
    for name, kw in (
            ("plain_bf16", dict(wire=WireConfig("bf16", **knobs))),
            ("overlap_bf16", dict(wire=WireConfig("bf16", **knobs),
                                  overlap="bucket")),
            ("db_bf16", dict(wire=WireConfig("bf16", **knobs),
                             double_buffering=True)),
            ("plain_none", dict(wire=WireConfig("none", **knobs))),
            ("zero_none", dict(zero_redundancy=True, wire=WireConfig(
                "none", schedule="hier_rs_ag" if env else "flat",
                **knobs)))):
        params = [nn.Parameter(torch.from_numpy(w.copy()).to(device))
                  for w in w0]
        opt = cmn.create_multi_node_optimizer(
            torch.optim.SGD(params, lr=0.5, momentum=0.5), comm, **kw)
        step = cmn.build_train_step(comm, quad_loss(params), opt)
        per_step = []
        for i in range(xs[0].shape[0]):
            step(tuple(x.to(device) for x in _rows(xs, i, rank, world_size)))
            per_step.append([p.detach().cpu().numpy().copy() for p in params])
        out[name] = {"params": per_step,
                     "schedules": opt.wire_plan().schedules,
                     "report": [tuple(r) for r in opt.issue_report]}
    return out
