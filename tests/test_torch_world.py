"""A real small world of the PyTorch port: N spawned processes joined
in one process group (gloo on the CPU, NCCL across cards), each running
a worker function of this module.

Parity: the reference's distributed tests are real multi-process runs
(``mpiexec -n 2 pytest``); the port keeps ChainerMN's process model (one
process per card), so its tests spawn ``world_size`` processes, each
calling ``torch.distributed.init_process_group("gloo", ...)`` on a
``file://`` store in a temporary directory.  The module imports only
torch, numpy and the port, so the workers start without JAX.

``run_world(worker, world_size, *args, timeout=...)`` returns each
rank's return value, in rank order; a worker's exception, a dead
worker, or a world that outlives ``timeout`` fails the caller (the
processes are killed), so a hang fails one test instead of the whole
run's clock.  The tests at the end of this module pin that; the other
``test_torch_*`` files import the module for ``run_world`` and its
workers.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(worker, rank, world_size, init, args, results, env, timeout,
           backend):
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)  # one card per rank
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = worker(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))


def run_world(worker, world_size: int, *args, timeout: float = 180.0,
              env=None, backend: str = "gloo") -> list:
    """Run ``worker(rank, world_size, *args)`` in ``world_size``
    processes of one ``backend`` group (``"nccl"``: rank r on card r);
    return their results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry,
                             args=(worker, r, world_size, init, args,
                                   results, dict(env or {}), timeout,
                                   backend),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        finished = False
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {world_size} did not finish within "
                        f"{timeout:.0f} s (ranks done: {sorted(out)})")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in out
                            and p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
            finished = True
        finally:
            # a failed world is killed at once; a finished one exits
            for p in procs:
                if finished:
                    p.join(timeout=max(deadline - time.monotonic(), 1.0))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
        assert not any(p.is_alive() for p in procs)
    return [out[r] for r in range(world_size)]


# ----------------------------------------------------------------------
# Workers
# ----------------------------------------------------------------------
def collectives_worker(rank, world_size, inputs, names):
    """Every ported communicator's collectives on this rank's row of the
    shared inputs; the rank model with and without the fake-node knob."""
    from chainermn_tpu_torch.communicators import (
        FAKE_NODE_SIZE_ENV, create_communicator)

    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    for name in names:
        comm = create_communicator(name)
        x = t["x"][rank]
        res = {
            "rank": comm.rank, "size": comm.size, "device": str(comm.device),
            "intra": (comm.intra_rank, comm.intra_size),
            "inter": (comm.inter_rank, comm.inter_size),
            "allreduce": {op: comm.allreduce(t[f"x_{op}"][rank], op).numpy()
                          for op in ("sum", "mean", "max", "min", "prod")},
            "bcast": {root: comm.bcast(x, root).numpy() for root in (0, 3)},
            "allgather": comm.allgather(x).numpy(),
            "gather": comm.gather(x, root=2),
            "scatter": comm.scatter(t["x"] if rank == 1 else None,
                                    root=1).numpy(),
            "alltoall": comm.alltoall(t["a2a"][rank]).numpy(),
            "reduce_scatter": comm.reduce_scatter(t["rs"][rank]).numpy(),
            "multidim": comm.allreduce(t["x45"][rank]).numpy(),
            "bcast_obj": comm.bcast_obj({"from": rank}, root=3),
            "gather_obj": comm.gather_obj(rank * 10, root=0),
            "allgather_obj": comm.allgather_obj(("r", rank)),
            "allreduce_obj": comm.allreduce_obj(rank + 1),
        }
        if res["gather"] is not None:
            res["gather"] = res["gather"].numpy()
        model = torch.nn.Linear(3, 2)
        with torch.no_grad():
            model.weight.fill_(float(rank))
        comm.bcast_data(model)
        model.weight.grad = t["grad"][rank].clone()
        comm.allreduce_grad(model)
        res["bcast_data"] = model.weight.detach().numpy()
        res["allreduce_grad"] = model.weight.grad.numpy()
        comm.barrier()
        out[name] = res
    os.environ[FAKE_NODE_SIZE_ENV] = "2"
    fake = create_communicator("flat")
    out["fake_nodes"] = {
        "intra": (fake.intra_rank, fake.intra_size),
        "inter": (fake.inter_rank, fake.inter_size),
        "keys": fake.topology.node_keys,
    }
    try:
        create_communicator("single_node")
        out["single_node_raised"] = False
    except ValueError:
        out["single_node_raised"] = True
    return out


def wire_worker(rank, world_size, buckets):
    """``reduce_buckets`` of this rank's row of each bucket, per codec,
    and the fused cast/scale calls of each codec's cast legs (input
    dtype, output dtype, scale)."""
    from chainermn_tpu_torch.comm_wire import WireConfig, codecs, reduce_buckets

    calls = []
    kernel = codecs.fused_cast_scale

    def recording(x, scale, dtype):
        calls.append((str(x.dtype), str(dtype), scale))
        return kernel(x, scale, dtype)

    codecs.fused_cast_scale = recording
    mine = [b[rank].clone() for b in buckets]
    out = {"calls": {}}
    for codec in ("none", "f32", "bf16", "f16"):
        calls.clear()
        means, _ = reduce_buckets(mine, world_size, WireConfig(codec=codec))
        out[codec] = [(m.float().numpy(), str(m.dtype)) for m in means]
        out["calls"][codec] = list(calls)
    return out


def _lm(cfg, state, dtype):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention_fn

    lm = TransformerLM(cfg["vocab"], cfg["d_model"], cfg["n_heads"],
                       cfg["n_layers"], max_len=cfg["max_len"],
                       dtype=getattr(torch, dtype),
                       attention_fn=flash_attention_fn())
    lm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return lm


def training_worker(rank, world_size, cfg, state, dataset, steps, dtype):
    """The port's training path at world size 2: the data-parallel run
    the JAX step is compared with, then the non-finite guard."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import flax_ordered_parameters, lm_loss
    from chainermn_tpu_torch.resilience import StepDivergedError

    comm = cmn.create_communicator("pure_nccl")
    # rank 1 starts from other weights: bcast_data must overwrite them
    lm = _lm(cfg, state, dtype)
    if rank:
        with torch.no_grad():
            for p in lm.parameters():
                p.add_(1.0)
    comm.bcast_data(lm)
    shard = cmn.scatter_dataset(dataset, comm, shuffle=True, seed=cfg["seed"])
    inner = torch.optim.AdamW([p for _, p in flax_ordered_parameters(lm)],
                              lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=0.01)
    opt = cmn.create_multi_node_optimizer(inner, comm)
    step = cmn.build_train_step(
        comm, lambda toks: lm_loss(lm(toks), toks), opt)
    per = cfg["batch"] // world_size
    losses = []
    for i in range(steps):
        rows = [shard[j] for j in range(i * per, (i + 1) * per)]
        toks = torch.from_numpy(np.stack(rows).astype(np.int64))
        losses.append(float(step(toks)["loss"]))
    result = {
        "indices": shard.indices.copy(),
        "losses": losses,
        "params": {k: v.detach().float().numpy().copy()
                   for k, v in lm.state_dict().items()},
        "plan_hash": opt.wire_plan().plan.plan_hash(),
    }

    # the non-finite guard: rank 1 alone sees a NaN loss; both ranks
    # must agree to skip (params unchanged) or, under "abort", to raise
    poison = {"on": True}

    def loss_fn(toks):
        loss = lm_loss(lm(toks), toks)
        if poison["on"] and rank == 1:
            loss = loss * float("nan")
        return loss

    toks = torch.from_numpy(np.stack([shard[0]] * per).astype(np.int64))
    before = {k: v.detach().clone() for k, v in lm.state_dict().items()}
    skip = cmn.build_train_step(comm, loss_fn, opt, nonfinite="skip")
    m = skip(toks)
    result["skip_finite"] = m["grads_finite"]
    result["skip_unchanged"] = all(
        torch.equal(before[k], v) for k, v in lm.state_dict().items())
    try:
        cmn.build_train_step(comm, loss_fn, opt, nonfinite="abort")(toks)
        result["abort_raised"] = False
    except StepDivergedError:
        result["abort_raised"] = True
    poison["on"] = False
    m = skip(toks)
    result["clean_finite"] = m["grads_finite"]
    result["clean_changed"] = not all(
        torch.equal(before[k], v) for k, v in lm.state_dict().items())

    # a hand-written loop: backward, then the optimizer's own step (sync,
    # then AdamW); ranks fed different rows stay equal
    opt.zero_grad(set_to_none=True)
    mine = toks if rank == 0 else toks.flip(1)
    lm_loss(lm(mine), mine).backward()
    opt.step()
    result["manual_params"] = {k: v.detach().numpy().copy()
                               for k, v in lm.state_dict().items()}
    return result


def dp_card_worker(rank, world_size, cfg, state, dataset, steps):
    """The data-parallel step on this rank's card (or the CPU in a gloo
    world): bf16 LM with the flash hook, shards from scatter_dataset,
    AdamW through the multi-node optimizer."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import flax_ordered_parameters, lm_loss
    from chainermn_tpu_torch.ops import flash_attention as fa

    comm = cmn.create_communicator("pure_nccl")
    lm = _lm(cfg, state, "bfloat16").to(comm.device)
    comm.bcast_data(lm)
    shard = cmn.scatter_dataset(dataset, comm, shuffle=True, seed=cfg["seed"])
    opt = cmn.create_multi_node_optimizer(torch.optim.AdamW(
        [p for _, p in flax_ordered_parameters(lm)], lr=3e-4, eps=1e-8,
        weight_decay=0.01), comm)
    step = cmn.build_train_step(comm, lambda t: lm_loss(lm(t), t), opt)
    per = cfg["batch"] // world_size
    n0 = fa.flash_forward.launches
    losses = []
    for i in range(steps):
        rows = [shard[j] for j in range(i * per, (i + 1) * per)]
        toks = torch.from_numpy(np.stack(rows).astype(np.int64))
        losses.append(float(step(toks.to(comm.device))["loss"]))
    return {"device": str(comm.device), "losses": losses,
            "launches": fa.flash_forward.launches - n0,
            "params": {k: v.detach().float().cpu().numpy()
                       for k, v in lm.state_dict().items()}}


def image_dp_worker(rank, world_size, arch, variables, data, steps, lr,
                    momentum, dtype):
    """The port's image data-parallel path at this world size: the model
    from the flax variables (numpy), bcast_data, scatter_dataset shards,
    SGD (momentum) over the flax-ordered leaves through the bf16 wire,
    the running statistics mean-reduced after each update; then the
    multi-node evaluator and the persistent-state all-reduce."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.extensions import AllreducePersistent, Evaluator
    from chainermn_tpu_torch.iterators import EpochIterator
    from chainermn_tpu_torch.models import (
        MLP, ResNet50, flax_ordered_parameters, mlp_params_from_flax,
        resnet_params_from_flax)
    from chainermn_tpu_torch.ops.losses import accuracy, softmax_cross_entropy

    comm = cmn.create_communicator("pure_nccl",
                                   allreduce_grad_dtype=torch.bfloat16)
    if arch == "mlp":
        model = MLP(n_units=64, dtype=getattr(torch, dtype))
        model.load_state_dict(mlp_params_from_flax(variables))
    else:
        model = ResNet50(num_classes=10, num_filters=8,
                         dtype=getattr(torch, dtype))
        model.load_state_dict(resnet_params_from_flax(variables))
    if rank:  # rank 1 starts elsewhere: bcast_data must overwrite it
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    comm.bcast_data(model)
    x, y = data
    dataset = list(zip(x, y))
    shard = cmn.scatter_dataset(dataset, comm, shuffle=True, seed=5)
    opt = cmn.create_multi_node_optimizer(torch.optim.SGD(
        [p for _, p in flax_ordered_parameters(model)], lr=lr,
        momentum=momentum), comm)
    step = cmn.build_train_step(
        comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]), opt,
        model_state=list(model.buffers()))
    per = len(shard) // steps
    losses = []
    for i in range(steps):
        rows = [shard[j] for j in range(i * per, (i + 1) * per)]
        batch = (torch.from_numpy(np.stack([r[0] for r in rows])),
                 torch.from_numpy(np.stack([r[1] for r in rows])))
        losses.append(float(step(batch)["loss"]))
    out = {"indices": shard.indices.copy(), "losses": losses,
           "state": {k: v.detach().numpy().copy()
                     for k, v in model.state_dict().items()},
           "plan_hash": opt.wire_plan().plan_hash(),
           "codec": opt.wire.codec}

    # the non-finite guard: rank 1 alone sees a NaN loss; "skip" must
    # leave the parameters and the running statistics as they were
    def poisoned(b):
        loss = softmax_cross_entropy(model(b[0]), b[1])
        return loss * float("nan") if rank == 1 else loss

    before = {k: v.clone() for k, v in model.state_dict().items()}
    skip = cmn.build_train_step(comm, poisoned, opt, nonfinite="skip",
                                model_state=list(model.buffers()))
    out["skip_finite"] = skip(batch)["grads_finite"]
    out["skip_unchanged"] = all(torch.equal(before[k], v)
                                for k, v in model.state_dict().items())

    def metric(b):
        logits = model(b[0])
        return {"loss": softmax_cross_entropy(logits, b[1]),
                "accuracy": accuracy(logits, b[1])}

    ev = Evaluator(lambda: EpochIterator(shard, per), metric, comm,
                   model=model)
    out["local_eval"] = Evaluator(lambda: EpochIterator(shard, per), metric,
                                  _Local(comm), model=model).evaluate()
    out["eval"] = ev.evaluate()
    out["training_after_eval"] = model.training
    with torch.no_grad():
        for b in model.buffers():
            b.fill_(float(rank))
    AllreducePersistent(model, comm)()
    out["persistent"] = sorted({float(b.flatten()[0])
                                for b in model.buffers()})
    return out


def codec_worker(rank, world_size, buckets, residuals, cases, comm_name="",
                 env=None, wire_kw=None):
    """``reduce_buckets`` (``comm_name`` empty) or, over that
    communicator, ``reduce_wire`` under ``plan_wire`` of the buckets as
    leaves (``wire_kw``: the plan's knobs), of this rank's row of each
    bucket, for each ``(codec, error feedback, carry the given
    residuals)`` case; and the all-reduces each case issued (dtype,
    elements, sum or max)."""
    os.environ.update(env or {})
    from chainermn_tpu_torch.comm_wire import (
        WireConfig, plan_wire, reduce_buckets, reduce_wire)

    calls = []
    real = dist.all_reduce

    def counting(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append((str(t.dtype).split(".")[-1], t.numel(),
                      "max" if op == dist.ReduceOp.MAX else "sum"))
        return real(t, op=op, group=group, async_op=async_op)

    mine = [b[rank].clone() for b in buckets]
    carry = [r[rank].clone() for r in residuals]
    out = {}
    comm = None
    if comm_name:
        import chainermn_tpu_torch as cmn

        comm = cmn.create_communicator(comm_name)
        out["mesh_shape"] = comm.mesh_shape
    dist.all_reduce = counting
    try:
        for codec, ef, with_carry in cases:
            calls.clear()
            cfg = WireConfig(codec=codec, error_feedback=ef,
                             **(wire_kw or {}))
            res = carry if with_carry else None
            if comm is None:
                means, new = reduce_buckets(mine, world_size, cfg, res)
            else:
                wplan = plan_wire(mine, cfg, comm)
                means, new = reduce_wire(mine, wplan, world_size, cfg, res,
                                         groups=comm.wire_groups)
                out["plan"] = (wplan.plan_hash(), wplan.schedules)
            out[(codec, ef, with_carry)] = {
                "means": [(m.float().numpy(), str(m.dtype)) for m in means],
                "residuals": [(r.float().numpy(), str(r.dtype))
                              for r in new],
                "calls": list(calls)}
    finally:
        dist.all_reduce = real
    return out


class FlaxLayoutMLP(torch.nn.Module):
    """The MNIST MLP's arithmetic (fp32) with its parameters in flax's
    layout and order (``Dense_k`` bias, then its ``(in, out)`` kernel),
    so that a bucket holds each value where the JAX package's does."""

    def __init__(self, variables):
        super().__init__()
        p = variables["params"]
        self.leaves = torch.nn.ParameterList(
            torch.nn.Parameter(torch.from_numpy(np.array(p[f"Dense_{i}"][k],
                                                         np.float32)))
            for i in range(3) for k in ("bias", "kernel"))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(3):
            b, w = self.leaves[2 * i], self.leaves[2 * i + 1]
            x = x @ w + b
            if i < 2:
                x = torch.relu(x)
        return x


def hier_comm_worker(rank, world_size, env, x):
    """The hierarchical communicator in this world: its rank model, sync
    axes and subgroups, and its plain collectives beside the flat
    communicator's; the communicators still waiting raise."""
    import warnings

    os.environ.update(env)
    import chainermn_tpu_torch as cmn

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hier = cmn.create_communicator("hierarchical")
    flat = cmn.create_communicator("pure_nccl")
    mine = torch.from_numpy(x[rank])
    out = {"mesh_shape": hier.mesh_shape, "axis_names": hier.axis_names,
           "flat_mesh_shape": flat.mesh_shape,
           "intra": (hier.intra_rank, hier.intra_size),
           "inter": (hier.inter_rank, hier.inter_size),
           "warnings": [str(w.message) for w in caught],
           "groups": [dist.get_process_group_ranks(g)
                      for g in hier.wire_groups]}
    for name, comm in (("hier", hier), ("flat", flat)):
        out[name] = {"sum": comm.allreduce(mine).numpy(),
                     "mean": comm.allreduce(mine, "mean").numpy(),
                     "max": comm.allreduce(mine, "max").numpy(),
                     "bcast": comm.bcast(mine, root=world_size - 1).numpy(),
                     "allgather": comm.allgather(mine).numpy()}
    out["waiting"] = []
    for name in ("two_dimensional", "non_cuda_aware", "hybrid", "mesh"):
        try:
            cmn.create_communicator(name)
        except NotImplementedError as e:
            out["waiting"].append(("ROADMAP" in str(e), name))
    return out


def ragged_worker(rank, world_size, env):
    """The hierarchical communicator on a ragged topology: its axes, and
    the plan of an explicit hier_rs_ag request, with the warnings."""
    import warnings

    os.environ.update(env)
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig, plan_wire

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        comm = cmn.create_communicator("hierarchical")
        plan = plan_wire([((20000,), "float32")],
                         WireConfig("bf16", schedule="hier_rs_ag"), comm)
    return (comm.mesh_shape, plan.schedules, plan.plan_hash(),
            [str(w.message) for w in caught])


def wire_train_worker(rank, world_size, comm_name, variables, data, steps,
                      lr, wire, env):
    """SGD on the flax-layout MLP through create_communicator(comm_name)
    -> create_multi_node_optimizer(wire=WireConfig(**wire)) ->
    build_train_step, rank r taking rows r of each step's global batch;
    then a step the non-finite guard skips, and the optimizer's
    state_dict."""
    os.environ.update(env)
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

    comm = cmn.create_communicator(comm_name)
    model = FlaxLayoutMLP(variables)
    opt = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=lr), comm,
        wire=WireConfig(**wire))
    step = cmn.build_train_step(
        comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]), opt)
    x, y = data
    per = len(x) // (steps * world_size)
    losses = []

    def batch(i):
        lo = (i * world_size + rank) * per
        return (torch.from_numpy(x[lo:lo + per]),
                torch.from_numpy(y[lo:lo + per]))

    for i in range(steps):
        losses.append(float(step(batch(i))["loss"]))
    wplan = opt.wire_plan()
    out = {"params": [p.detach().numpy().copy() for p in model.parameters()],
           "residual": [r.numpy().copy() for r in opt.wire_residual],
           "losses": losses, "plan_hash": wplan.plan_hash(),
           "schedules": wplan.schedules, "mesh_shape": comm.mesh_shape,
           "state_dict_residual": all(
               torch.equal(a, b) for a, b in zip(
                   opt.state_dict()["wire_residual"], opt.wire_residual))}
    again = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=lr), comm,
        wire=WireConfig(**wire))
    again.load_state_dict(opt.state_dict())
    out["loaded_residual"] = (
        len(again.wire_residual) == len(opt.wire_residual) and all(
            torch.equal(a, b)
            for a, b in zip(again.wire_residual, opt.wire_residual)))

    def poisoned(b):
        loss = softmax_cross_entropy(model(b[0]), b[1])
        return loss * float("nan") if rank == world_size - 1 else loss

    before = [r.clone() for r in opt.wire_residual]
    params = [p.detach().clone() for p in model.parameters()]
    skip = cmn.build_train_step(comm, poisoned, opt, nonfinite="skip")
    out["skip_finite"] = skip(batch(0))["grads_finite"]
    out["skip_kept_residual"] = (
        len(before) == len(opt.wire_residual) and all(
            torch.equal(a, b) for a, b in zip(before, opt.wire_residual)))
    out["skip_kept_params"] = all(
        torch.equal(a, b) for a, b in zip(params, model.parameters()))
    return out


def mnbn_layer_worker(rank, world_size, x, c, variables, dtype, env):
    """MultiNodeBatchNormalization over this rank's rows of ``x`` (NCHW)
    in a world of ``world_size``: the output, the running statistics,
    the gradients of ``sum(y * c) / rows`` (c: this rank's rows of the
    cotangent), and the all-reduces counted; then eval mode."""
    os.environ.update(env)
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.functions import allreduce_mean
    from chainermn_tpu_torch.links import MultiNodeBatchNormalization

    comm = cmn.create_communicator("hierarchical")
    per = x.shape[0] // world_size
    xr = torch.from_numpy(x[rank * per:(rank + 1) * per]).requires_grad_()
    cr = torch.from_numpy(c[rank * per:(rank + 1) * per])
    layer = MultiNodeBatchNormalization(x.shape[1], comm,
                                        dtype=getattr(torch, dtype))
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(variables["scale"]))
        layer.bias.copy_(torch.from_numpy(variables["bias"]))
    n0 = allreduce_mean.calls
    y = layer(xr)
    ((y.float() * cr).sum() / per).backward()
    out = {"y": y.detach().float().numpy(), "dx": xr.grad.numpy(),
           "dscale": layer.weight.grad.numpy(),
           "dbias": layer.bias.grad.numpy(),
           "mean": layer.running_mean.numpy().copy(),
           "var": layer.running_var.numpy().copy(),
           "calls": allreduce_mean.calls - n0}
    layer.eval()
    n0 = allreduce_mean.calls
    with torch.no_grad():
        out["y_eval"] = layer(xr).float().numpy()
    out["eval_calls"] = allreduce_mean.calls - n0
    return out


def mnbn_resnet_worker(rank, world_size, variables, data, steps, lr,
                       momentum, env, grad_dtype="bfloat16"):
    """The MNBN image path: a fp32 ResNet-50 (flax variables of the
    synchronized model) through create_communicator("hierarchical",
    allreduce_grad_dtype=grad_dtype) -> create_mnbn_model ->
    create_multi_node_optimizer(SGD momentum) ->
    build_train_step(model_state=running statistics)."""
    os.environ.update(env)
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import plan_wire
    from chainermn_tpu_torch.functions import allreduce_mean
    from chainermn_tpu_torch.links import create_mnbn_model
    from chainermn_tpu_torch.models import (
        ResNet50, flax_leaf_specs, flax_ordered_parameters,
        resnet_params_from_flax)
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

    comm = cmn.create_communicator("hierarchical",
                                   allreduce_grad_dtype=grad_dtype)
    model = create_mnbn_model(
        ResNet50(num_classes=10, num_filters=8, dtype=torch.float32), comm)
    model.load_state_dict(resnet_params_from_flax(variables))
    comm.bcast_data(model)
    x, y = data
    shard = cmn.scatter_dataset(list(zip(x, y)), comm, shuffle=True, seed=5)
    opt = cmn.create_multi_node_optimizer(torch.optim.SGD(
        [p for _, p in flax_ordered_parameters(model)], lr=lr,
        momentum=momentum), comm)
    step = cmn.build_train_step(
        comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]), opt,
        model_state=list(model.buffers()))
    per = len(shard) // steps
    losses, calls = [], []
    for i in range(steps):
        rows = [shard[j] for j in range(i * per, (i + 1) * per)]
        batch = (torch.from_numpy(np.stack([r[0] for r in rows])),
                 torch.from_numpy(np.stack([r[1] for r in rows])))
        n0 = allreduce_mean.calls
        losses.append(float(step(batch)["loss"]))
        calls.append(allreduce_mean.calls - n0)
    return {"indices": shard.indices.copy(), "losses": losses,
            "calls": calls, "mesh_shape": comm.mesh_shape,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()},
            "flax_plan_hash": plan_wire(flax_leaf_specs(model), opt.wire,
                                        comm).plan_hash(),
            "codec": opt.wire.codec}


def mnbn_googlenet_worker(rank, world_size, variables, data, steps, lr,
                          momentum, env):
    """The synchronized GoogLeNetBN's path (fp32, dropout off): the
    model from the flax variables of the synchronized JAX model through
    create_communicator("hierarchical") -> create_mnbn_model ->
    create_multi_node_optimizer(SGD momentum) ->
    build_train_step(model_state=running statistics)."""
    os.environ.update(env)
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import plan_wire
    from chainermn_tpu_torch.functions import allreduce_mean
    from chainermn_tpu_torch.links import create_mnbn_model
    from chainermn_tpu_torch.models import (
        GoogLeNetBN, flax_leaf_specs, flax_ordered_parameters,
        googlenet_params_from_flax)
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

    comm = cmn.create_communicator("hierarchical")
    model = create_mnbn_model(
        GoogLeNetBN(num_classes=10, dtype=torch.float32), comm)
    model.load_state_dict(googlenet_params_from_flax(variables))
    comm.bcast_data(model)
    x, y = data
    shard = cmn.scatter_dataset(list(zip(x, y)), comm, shuffle=True, seed=5)
    opt = cmn.create_multi_node_optimizer(torch.optim.SGD(
        [p for _, p in flax_ordered_parameters(model)], lr=lr,
        momentum=momentum), comm)
    step = cmn.build_train_step(
        comm, lambda b: softmax_cross_entropy(
            model(b[0], deterministic=True), b[1]), opt,
        model_state=list(model.buffers()))
    per = len(shard) // steps
    losses, calls = [], []
    for i in range(steps):
        rows = [shard[j] for j in range(i * per, (i + 1) * per)]
        batch = (torch.from_numpy(np.stack([r[0] for r in rows])),
                 torch.from_numpy(np.stack([r[1] for r in rows])))
        n0 = allreduce_mean.calls
        losses.append(float(step(batch)["loss"]))
        calls.append(allreduce_mean.calls - n0)
    return {"indices": shard.indices.copy(), "losses": losses,
            "calls": calls,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()},
            "flax_plan_hash": plan_wire(flax_leaf_specs(model), opt.wire,
                                        comm).plan_hash()}


def input_pipeline_worker(rank, world_size, data, weights):
    """The input pipeline at this world size: the agreed seed, two
    synchronized iterators (each rank starting from its own seed), a
    multi-node iterator over rank-shifted streams, every rank's shard at
    once and this rank's shard rescattered under ``weights``."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.datasets import rescatter, scatter_dataset_all
    from chainermn_tpu_torch.iterators import (
        SerialIterator, create_multi_node_iterator,
        create_synchronized_iterator)

    comm = cmn.create_communicator("pure_nccl")
    ds = [(np.full(1, i), np.int32(i % 3)) for i in range(16)]
    orders = []
    for _ in range(2):
        it = create_synchronized_iterator(
            SerialIterator(ds, 4, shuffle=True, seed=rank), comm)
        orders.append([next(it)[0].ravel().tolist() for _ in range(12)])
    shifted = [(np.full(1, i + 100 * rank), np.int32(0)) for i in range(16)]
    mn = create_multi_node_iterator(SerialIterator(shifted, 4, shuffle=False),
                                    comm)
    stream = [next(mn)[0].ravel().tolist() for _ in range(5)]
    shard = cmn.scatter_dataset(data, comm, shuffle=True, seed=7)
    return {"sync_seed": comm.sync_seed, "orders": orders,
            "master_stream": stream, "batch_size": mn.batch_size,
            "all": [list(s.indices) for s in scatter_dataset_all(
                data, comm, shuffle=True, seed=7)],
            "shard": list(shard.indices),
            "rescattered": list(rescatter(shard, weights).indices)}


def checkpoint_agreement_worker(rank, world_size, root, drop_newest_on):
    """Each rank saves steps 1-3 under ``root``; rank
    ``drop_newest_on`` then loses its newest step; the agreement elects
    the newest step every rank holds, and resume loads it."""
    import shutil

    import chainermn_tpu_torch as cmn

    comm = cmn.create_communicator("pure_nccl")
    ckpt = cmn.create_multi_node_checkpointer("agree", comm, path=root)
    for s in (1, 2, 3):
        ckpt.save(s, {"w": torch.full((3,), float(s + 10 * rank)),
                      "step": s})
    own = ckpt._available_steps()
    comm.barrier()
    if rank == drop_newest_on:
        shutil.rmtree(ckpt._step_dir(3))
    comm.barrier()
    step, state = ckpt.resume()
    return {"own": own, "root": ckpt._root, "newest": step,
            "w": state["w"].tolist(), "step": state["step"]}


class _Local:
    """A communicator of one rank's own view: the evaluator's per-rank
    metrics before the mean."""

    def __init__(self, comm):
        self.device = comm.device

    def allreduce(self, x, op="sum"):
        return x.clone()


# ----------------------------------------------------------------------
# The harness itself
# ----------------------------------------------------------------------
def _raising_worker(rank, world_size):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def _sleeping_worker(rank, world_size, seconds):
    time.sleep(seconds)
    return rank


def test_run_world_returns_ranks_in_order():
    assert run_world(_sleeping_worker, 3, 0.0, timeout=60) == [0, 1, 2]


def test_run_world_fails_fast_on_a_worker_error_or_a_hang():
    """A worker's exception fails the caller with its traceback, and a
    world that outlives its timeout is killed."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_world(_raising_worker, 2, timeout=60)
    with pytest.raises(TimeoutError, match="did not finish within 3 s"):
        run_world(_sleeping_worker, 2, 600.0, timeout=3)
    assert time.monotonic() - t0 < 50
