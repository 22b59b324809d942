#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Run from the repository root, with one card.  Phases:

1. the card's name and power limit (``nvidia-smi``), then every
   kernel source under ``chainermn_tpu_torch/ops/csrc`` built (one
   ``nvcc`` each, in parallel), with registers, shared memory and
   spills;
2. the split-K decode kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it, with the tolerance
   stated, its splits and chunk, and timed beside the plain version, one
   PyTorch library call computing the same function (timed here only, as
   a yardstick) and the least time the card could take (its bound);
3. the serving path: the full-width TransformerLM served through
   ``ContinuousBatcher`` -> ``DecodeEngine(attention_impl="flash")``, with
   every kernel's launch count set to 0 just before and read just after;
   then the same stream through the dense attend, and a lockstep check
   of the two engines' logits on identical inputs;
4. a ``torch.profiler`` breakdown of a steady decode step for both
   attends (device time by kernel, launches per step, idle share, host
   ops), and the page allocator's host time per decode step;
5. the flash-attention training kernels (forward, dq, dk/dv; bf16 on
   the tensor cores, fp32 on the CUDA cores) against their plain
   versions at the training shape (bf16 and fp32), a ragged causal
   shape and a non-causal cross shape, timed at the training shape
   beside their plain versions, scaled_dot_product_attention and their
   bounds, with each kernel's achieved TFLOP/s, share of its bound,
   design (tensor-core or CUDA-core products, copy ring), shared memory
   and registers (a spill in the bf16 kernels fails the run);
6. the training main path: the full-width TransformerLM trained on
   batch 8 x 2048 tokens through ``create_communicator`` ->
   ``bcast_data`` -> ``create_multi_node_optimizer(AdamW)`` ->
   ``build_train_step`` on a 1-rank NCCL group, the flash kernels'
   counts set to 0 just before the timed steps and read just after; a
   ``torch.profiler`` step with the flash kernels' share of it; flash
   vs dense attend on identical params and batch;
7. the fused cast/scale kernel (K1) against its plain version, bit for
   bit, at every dtype pair, ragged sizes, an odd-offset view and each
   bucket of ResNet-50's wire plan, then timed at those buckets beside
   its plain version, ``Tensor.to`` and its bound;
8. the image main path: ResNet-50 at full width (batch 128 of 224 x 224
   NHWC images, 1000 classes) trained through ``create_communicator(
   "pure_nccl", allreduce_grad_dtype=bfloat16)`` -> ``bcast_data`` ->
   ``create_multi_node_optimizer(SGD momentum)`` -> ``build_train_step``
   with the BatchNorm state on a 1-rank NCCL group, K1's count set to 0
   just before the timed steps and read just after (2 launches a bucket
   a step); a ``torch.profiler`` step; the same step on the codec-
   ``none`` wire;
9. the MNBN image path: the same ResNet-50 with synchronized BatchNorm
   through ``create_communicator("hierarchical",
   allreduce_grad_dtype=bfloat16)`` -> ``create_mnbn_model`` ->
   ``create_multi_node_optimizer(SGD momentum)`` -> ``build_train_step``
   with the MNBN running statistics, K1's count and the MNBN all-reduce
   count set to 0 just before the timed steps and read just after (2
   launches a bucket a step; 53 + 53 all-reduces a step); a
   ``torch.profiler`` step; then ``WireConfig("int8",
   error_feedback=True)`` (no K1 launch) and ``WireConfig("bf16",
   error_feedback=True)`` (3 launches a bucket a step) for a few steps
   each, with the residual's norm; one step's sync timed alone under
   each codec;
10. the Trainer path: the MNIST example's twin (MLP, bf16 wire) through
   ``Trainer`` + ``Evaluator`` + the reports for a few epochs, then the
   ImageNet example's twin with ResNet-50 for a few iterations, each
   with K1's count set to 0 just before and read just after;
11. the checkpointed image path: VGG16 at full width (batch 64 of 224 x
   224, 1000 classes) through ``create_communicator("pure_nccl",
   allreduce_grad_dtype=bfloat16)`` -> ``create_multi_node_optimizer(SGD
   momentum)`` -> ``build_train_step`` on a 1-rank NCCL group, K1's
   count set to 0 just before the timed steps and read just after, a
   profiled step; the same step fed through ``Updater`` from an
   in-memory dataset with ``prefetch_to_device`` depth 0 and 2 (host ms
   a step, idle share, the copies' stream and overlap); the
   checkpointer's save (sync and async) and resume of that state, bit
   for bit; the ImageNet twin with VGG16, ``--prefetch 2 --checkpoint``
   for one epoch, then resumed for a second, its batches held against
   an uninterrupted run's, a snapshot with a flipped byte not elected;
   then the twin with AlexNet, NIN, GoogLeNet, GoogLeNetBN and
   GoogLeNetBN with MNBN over the hierarchical communicator, each with
   K1's count set to 0 just before and read just after.  After each of
   these runs, outside its counting window, K1 is held bit for bit
   against its plain version at every bucket size of the run's wire
   plan that no earlier phase held;
12. model parallelism: the JAX bench's seq2seq configuration at full
   width (bench.py:991-994: vocab 8192, 512 units, 2 LSTM layers,
   sequence 40, batch 64, Adam 1e-3) through ``MultiNodeChainList`` with
   the ``seq2seq_mp1`` encoder|decoder split (both stages on the one
   card), TF32 off: the chain's loss and gradients against the
   monolithic ``Seq2Seq`` on the same weights, 1 + 6 steps (median step
   ms, tokens/s, peak memory), a profiled step (device ms and launches by
   kind, idle share), greedy ``translate`` of one batch timed per token,
   a one-stage ``build_pipeline_train_step`` with 4 microbatches held
   against the unpipelined step; then the seq2seq examples' twins
   (data-parallel through ``Trainer``, and ``seq2seq_mp1``).  No kernel
   of the port is on this path (the LSTM is cuDNN's, as XLA generated
   the JAX one);
13. the optimizer's tier 2, at world 1 (one card: nothing moves on the
   wire, so double buffering and overlap hide nothing; the phase proves
   the paths and measures their cost): VGG16 at full width (batch 64,
   224^2, bf16 wire, SGD momentum, seeded dropout, cuDNN's deterministic
   algorithms) plain, with ``double_buffering=True`` (BASELINE config 3:
   step 1 leaves every parameter unchanged, step 2 equals the plain
   step 1 bit for bit; K1 3 launches a bucket a step) and with
   ``overlap="bucket"`` (its parameters equal the synchronous leg's bit
   for bit; every bucket issued from the backward, in reverse plan
   order), each with K1's count set to 0 just before its timed steps and
   read just after, a profiled step; then the headline TransformerLM at
   batch 16 x 2048 (``transformer_mfu.py``'s ``b16_remat``): plain,
   ``remat=True`` (within the LM bound of plain), ``zero_redundancy=
   True`` (bit-equal to plain), ``accum_steps=2`` (within 2 lr a step of
   plain: its bf16 weight gradients round per microbatch) and all three
   (within the LM bound of ``accum_steps=2``), with K2-K4's counts set to
   0 just before the timed steps and read just after (K2 twice a
   microbatch under remat).

Any failed check raises, so the script exits non-zero.  Without CUDA it
exits non-zero before printing any result.  The last two lines are the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

import chainermn_tpu_torch
from chainermn_tpu_torch.models import TransformerLM, lm_loss
from chainermn_tpu_torch.ops import _build
from chainermn_tpu_torch.ops import flash_attention as fa
from chainermn_tpu_torch.ops import fused_cast_scale as fcs
from chainermn_tpu_torch.ops.flash_decode import (
    TOLERANCE, flash_decode, paged_decode_reference)
from chainermn_tpu_torch.ops.flash_decode import design as decode_design
from chainermn_tpu_torch.serving import ContinuousBatcher, DecodeEngine, Request

# The repo's "shipping" TransformerLM (benchmarks/transformer_mfu.py:53,76),
# bf16 compute over fp32 parameters.
VOCAB, D_MODEL, N_LAYERS, N_HEADS, MAX_LEN = 32768, 1024, 8, 8, 2048
# Serving geometry of benchmarks/decode_bench.py:105,111: pages_per_slot
# = 2048 / 16 = 128, num_pages = 8 * 128 + 1 = 1025.
CAPACITY, PAGE = 8, 16
N_REQUESTS, NEW_TOKENS, PROMPT_MIN, PROMPT_MAX = 16, 32, 64, 1024
LOCKSTEP_STEPS = 4
SEED = 0

# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s and
# dense rates by input type (bf16 on the tensor cores, fp32 without).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Flash vs dense attend on the full model: the dense attend rounds the
# QK scores and the softmax weights to bf16, the kernel keeps them fp32;
# over 8 layers that moves the logits by ~3e-2 (measured on an H100), so
# the bound is about 4x that.  The kernel itself is held to its plain
# version within flash_decode's TOLERANCE (one bf16 ulp of each element).
LOGITS_GAP_BOUND = 0.1


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """A failed check raises (and so exits non-zero) under ``-O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_time_ms(fn, n_layers, iters):
    """Mean device ms per call of fn(layer), cycling through the layers
    so the working set (all layers' live pages) exceeds the 50 MB L2
    cache as in a decode step: CUDA events around ``iters`` calls queued
    behind a spin kernel, so the card runs them back to back and the
    host's launch time does not show where a kernel is shorter than its
    Python wrapper."""
    for i in range(2 * n_layers):
        fn(i % n_layers)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
    start.record()
    for i in range(iters):
        fn(i % n_layers)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def decode_inputs(dtype, lengths, device, seed):
    """One decode step's flash_decode inputs at the serving shapes: all
    layers' page pools, each slot's own pages in a shuffled block
    table."""
    g = torch.Generator(device=device).manual_seed(seed)
    d_head = D_MODEL // N_HEADS
    pps = MAX_LEN // PAGE
    num_pages = CAPACITY * pps + 1
    pool = (N_LAYERS, num_pages, PAGE, N_HEADS, d_head)
    q = torch.randn(CAPACITY, N_HEADS, d_head, generator=g, device=device,
                    dtype=dtype)
    k = torch.randn(pool, generator=g, device=device, dtype=dtype)
    v = torch.randn(pool, generator=g, device=device, dtype=dtype)
    perm = np.random.RandomState(seed).permutation(CAPACITY * pps) + 1
    tables = torch.tensor(perm.reshape(CAPACITY, pps), dtype=torch.int32,
                          device=device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k, v, tables, lens


def flash_decode_bound(lengths, dtype):
    """Least time for one launch: live K/V rows, q and out each moved
    once (plus the live table entries and lengths) over HBM bandwidth,
    against 4 * live * d flops per head over the type's peak."""
    d_head = D_MODEL // N_HEADS
    elem = torch.finfo(dtype).bits // 8
    live = sum(min(int(n), MAX_LEN) for n in lengths)
    live_pages = sum(-(-min(int(n), MAX_LEN) // PAGE) for n in lengths)
    nbytes = (2 * live * N_HEADS * d_head * elem
              + 2 * CAPACITY * N_HEADS * d_head * elem
              + 4 * live_pages + 4 * CAPACITY)
    ops = 4 * live * N_HEADS * d_head
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(lengths):
    """flash_decode vs paged_decode_reference at the serving shapes in
    bf16 and fp32: ragged lengths, a length-0 slot, NaN-poisoned dead
    pages.  Returns the kernel's record (bf16, the main path's type)."""
    dev = torch.device("cuda")
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, tables, lens = decode_inputs(dtype, lengths, dev, SEED)
        design = decode_design(dtype, q.shape[-1], CAPACITY, N_HEADS,
                               tables.shape[1], dev)
        design.update(PTXAS.get(("flash_decode", TYPE_TAG[dtype],
                                 q.shape[-1]), {}))
        ref = [paged_decode_reference(q, k[i], v[i], tables, lens)
               for i in range(N_LAYERS)]
        out = [flash_decode(q, k[i], v[i], tables, lens)
               for i in range(N_LAYERS)]
        torch.cuda.synchronize()
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(out, ref))
        rel = max(float(((o.float() - r.float()).abs()
                         / r.float().abs().clamp_min(1e-3)).max())
                  for o, r in zip(out, ref))
        tol = TOLERANCE[dtype]
        # the largest error as a share of what the tolerance allows there
        used = max(float(((o.float() - r.float()).abs()
                          / (tol["atol"] + tol["rtol"] * r.float().abs()))
                         .max()) for o, r in zip(out, ref))
        name = str(dtype).replace("torch.", "")
        log(f"flash_decode {name}: max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} tolerance rtol={tol['rtol']:.3e} "
            f"atol={tol['atol']:.0e}; largest error {used:.1%} of its limit")
        for o, r in zip(out, ref):
            torch.testing.assert_close(o.float(), r.float(), **tol)
        for o, n in zip(out[0], lengths):
            check(n > 0 or bool(torch.all(o == 0)), "length-0 slot not zero")

        ms = cuda_time_ms(
            lambda i: flash_decode(q, k[i], v[i], tables, lens),
            N_LAYERS, 25 * N_LAYERS)
        host_ms = host_enqueue_ms(
            lambda: flash_decode(q, k[0], v[0], tables, lens), 50)
        plain_ms = cuda_time_ms(
            lambda i: paged_decode_reference(q, k[i], v[i], tables, lens),
            N_LAYERS, 5 * N_LAYERS)
        library_ms = None
        if dtype == torch.bfloat16:
            library_ms = sdpa_time_ms(q, k, v, tables, lens)
        bound_ms, bound_by = flash_decode_bound(lengths, dtype)
        log(f"flash_decode {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms, library {library_ms} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of bound (device time); "
            f"the wrapper's host time {host_ms:.4f} ms a call; "
            f"{design['splits']} splits ({design['blocks']} blocks), merged "
            f"by the {design['merge']} (no merge kernel); design "
            f"{json.dumps(design)}")

        # dead pages (past each slot's length) poisoned with NaN: the
        # kernel never reads them, so its output must not move at all
        for s, n in enumerate(lengths):
            dead = tables[s, -(-int(n) // PAGE):].long()
            k[:, dead] = float("nan")
            v[:, dead] = float("nan")
        for i in range(N_LAYERS):
            again = flash_decode(q, k[i], v[i], tables, lens)
            check(torch.equal(again, out[i]), "dead pages changed output")
        log(f"flash_decode {name}: NaN-poisoned dead pages leave the "
            f"output bit-identical to the first call's")
        rec[dtype] = dict(max_abs_err=err, share_of_tolerance=used, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, design=design,
                          host_ms_per_launch=host_ms)
        del q, k, v, ref, out
        torch.cuda.empty_cache()
    return rec


def sdpa_time_ms(q, k, v, tables, lens):
    """One library call computing the same function: scaled dot-product
    attention of the single query against each slot's pages, gathered
    and masked beforehand (outside the timing)."""
    b, h, d = q.shape
    kg, vg = [], []
    for i in range(N_LAYERS):
        kg.append(k[i][tables.long()].reshape(b, -1, h, d)
                  .transpose(1, 2).contiguous())
        vg.append(v[i][tables.long()].reshape(b, -1, h, d)
                  .transpose(1, 2).contiguous())
    pos = torch.arange(kg[0].shape[2], device=q.device)
    mask = (pos[None, :] < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_time_ms(lambda i: sdpa(q4, kg[i], vg[i], attn_mask=mask),
                      N_LAYERS, 20 * N_LAYERS)
    del kg, vg
    return ms


def requests(seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(PROMPT_MIN, PROMPT_MAX + 1, N_REQUESTS)
    prompts = [rng.randint(0, VOCAB, int(n)).tolist() for n in lens]
    return [Request(p, NEW_TOKENS, id=f"r{i}") for i, p in enumerate(prompts)]


def warm_up(engine):
    """One untimed, uncounted pass of the same stream: the first cuBLAS
    call for each prompt bucket and the allocator's growth stay out of
    the timed run, so the two attends are timed alike."""
    ContinuousBatcher(engine).serve(requests(SEED))


def serve(engine, reqs):
    """Serve ``reqs`` through a fresh batcher, timed end to end."""
    batcher = ContinuousBatcher(engine)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = [batcher.finished[r.id] for r in reqs]
    for r in out:
        check(r.state == "done", f"{r.id} {r.state}: {r.error}")
        check(len(r.tokens) == NEW_TOKENS, f"{r.id}: {len(r.tokens)} tokens")
        check(all(0 <= t < VOCAB for t in r.tokens), f"{r.id}: token ids")
    return out, batcher.latency_report(), wall


def lockstep_gap(a, b, prompts):
    """Both engines prefill the same prompts and decode the same tokens
    (the first engine's greedy choices) for LOCKSTEP_STEPS steps; returns
    the largest |logits gap| over the active rows of every step."""
    slots = [[e.admit(len(p) + LOCKSTEP_STEPS + 1) for p in prompts]
             for e in (a, b)]
    check(slots[0] == slots[1], f"slots differ: {slots}")
    toks = np.zeros(CAPACITY, np.int64)
    gap = 0.0
    for s, p in zip(slots[0], prompts):
        la, lb = a.prefill(s, p), b.prefill(s, p)
        gap = max(gap, float(np.abs(la - lb).max()))
        toks[s] = int(np.argmax(la))
    for _ in range(LOCKSTEP_STEPS):
        la, lb = a.decode_step(toks), b.decode_step(toks)
        rows = slots[0]
        check(np.all(np.isfinite(la[rows])) and np.all(np.isfinite(lb[rows])),
              "non-finite decode logits")
        gap = max(gap, float(np.abs(la[rows] - lb[rows]).max()))
        toks[rows] = np.argmax(la[rows], axis=-1)
    for e in (a, b):
        for s in slots[0]:
            e.release(s)
    return gap


def profile_decode(engine, reqs, steps=8):
    """Where a steady decode step's time goes: all slots active, ``steps``
    decode steps timed without the profiler (host clock, synchronized),
    then again under ``torch.profiler`` for device time by kernel.  Idle
    share = 1 - device time / step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slots = [engine.admit(len(r.prompt) + 2 * steps + 2)
             for r in reqs[:CAPACITY]]
    toks = np.zeros(CAPACITY, np.int64)
    for s, r in zip(slots, reqs):
        toks[s] = int(np.argmax(engine.prefill(s, r.prompt)))
    engine.decode_step(toks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.decode_step(toks)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.decode_step(toks)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    for s in slots:
        engine.release(s)
    log(f"profile {engine.attention_impl}: decode step {step_ms:.3f} ms "
        f"(host clock, unprofiled); device busy {device_ms:.3f} ms per "
        f"step in {launches:.0f} kernel launches; idle share "
        f"{1 - device_ms / step_ms:.1%}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.4f} ms/step "
            f"x{e.count / steps:.0f}  {e.key[:90]}")
    host_ops = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
    log(f"profile {engine.attention_impl}: host ops by self time (under "
        f"the profiler)")
    for e in sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"  {e.self_cpu_time_total / 1e3 / steps:8.4f} ms/step "
            f"x{e.count / steps:.0f}  {e.key[:90]}")


# the allocator's methods the batcher and engine call on a serve
ALLOCATOR_OPS = ("lookup_prefix", "can_admit", "admit", "register_prefix",
                 "cow_for_write", "advance", "release")


def allocator_host_ms(engine):
    """Host time in the page allocator per decode step: one more serve
    of the stream with the cache's methods wrapped in host-clock timers
    (a run of its own, so the timers stay out of the timed serves)."""
    cache = engine.cache
    spent = [0.0]

    def timed(fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[0] += time.perf_counter() - t
        return call

    for name in ALLOCATOR_OPS:
        setattr(cache, name, timed(getattr(cache, name)))
    steps0 = engine.steps
    try:
        serve(engine, requests(SEED))
    finally:
        for name in ALLOCATOR_OPS:
            delattr(cache, name)
    return spent[0] * 1e3 / (engine.steps - steps0)


def serve_phase():
    t0 = time.perf_counter()
    lm = TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, max_len=MAX_LEN,
                       dtype=torch.bfloat16, seed=SEED)
    n_params = sum(p.numel() for p in lm.parameters())
    flash = DecodeEngine(lm, capacity=CAPACITY, page_size=PAGE,
                         attention_impl="flash", device="cuda")
    check(flash.pages_per_slot == 128 and flash.cache.num_pages == 1025,
          "serving geometry")
    kv_bytes = 2 * flash.cache.k_pages.numel() * flash.cache.k_pages.element_size()
    log(f"model: {n_params} params (fp32), KV pool {kv_bytes / 1e6:.1f} MB, "
        f"set up in {time.perf_counter() - t0:.1f}s")

    reqs = requests(SEED)
    warm_up(flash)
    # the main path: every count set to 0 just before, read just after
    flash_decode.launches = 0
    flash.steps = 0
    out, report, wall = serve(flash, reqs)
    launches, steps = flash_decode.launches, flash.steps
    check(steps > 0 and launches == N_LAYERS * steps,
          f"flash_decode launches {launches} != {N_LAYERS} x {steps} steps")
    tokens = report["tokens_generated"]
    log(f"serve flash: {len(out)} requests, {tokens} tokens in {wall:.3f}s "
        f"= {tokens / wall:.1f} tokens/s; decode steps {steps}; "
        f"flash_decode launches {launches} = n_layers x steps "
        f"({N_LAYERS} x {steps})")
    log("serve flash latency: " + json.dumps(report))

    dense = DecodeEngine(lm, capacity=CAPACITY, page_size=PAGE,
                         attention_impl="dense", device="cuda")
    warm_up(dense)
    out_d, report_d, wall_d = serve(dense, requests(SEED))
    log(f"serve dense: {report_d['tokens_generated']} tokens in "
        f"{wall_d:.3f}s = {report_d['tokens_generated'] / wall_d:.1f} "
        f"tokens/s")
    log("serve dense latency: " + json.dumps(report_d))
    same = sum(int(x == y) for r, s in zip(out, out_d)
               for x, y in zip(r.tokens, s.tokens))
    share = same / (N_REQUESTS * NEW_TOKENS)
    gap = lockstep_gap(flash, dense, [r.prompt for r in reqs[:CAPACITY]])
    log(f"flash vs dense: identical greedy tokens {share:.1%}; max logits "
        f"gap over prefill + {LOCKSTEP_STEPS} lockstep decode steps "
        f"{gap:.3e} (bound {LOGITS_GAP_BOUND})")
    check(gap <= LOGITS_GAP_BOUND, f"flash vs dense logits gap {gap}")
    for engine in (flash, dense):
        profile_decode(engine, reqs)
    alloc_ms = allocator_host_ms(flash)
    log(f"allocator host time: {alloc_ms:.4f} ms per decode step (flash "
        f"serve of the same stream, host clock)")
    tl = report["serving.token_latency"]
    return {
        "launches": launches, "decode_steps": steps,
        "tokens_per_s": tokens / wall, "token_p50_ms": tl["p50_ms"],
        "token_p99_ms": tl["p99_ms"],
        "prefill_p50_ms": report["serving.prefill_latency"]["p50_ms"],
        "dense_tokens_per_s": report_d["tokens_generated"] / wall_d,
        "same_token_share": share, "logits_gap": gap,
        "allocator_ms_per_step": alloc_ms,
    }


# ----------------------------------------------------------------------
# Training slice: the flash-attention kernels (K2-K4) and the
# data-parallel step
# ----------------------------------------------------------------------
# bench.py:784 config_transformer_lm: batch 8 x seq 2048 per chip
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_WARMUP, TRAIN_STEPS = 1, 4
# (batch, s_q, s_k, heads, d, causal): the training path's shape, a
# ragged causal one and a non-causal cross one
FLASH_SHAPES = [
    (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, N_HEADS, D_MODEL // N_HEADS, True),
    (TRAIN_BATCH, 2000, 2000, N_HEADS, D_MODEL // N_HEADS, True),
    (TRAIN_BATCH, 1000, 1500, N_HEADS, D_MODEL // N_HEADS, False),
]
FLASH_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
# where each kernel's TPU original is, and how many fp32 products of
# (pairs x d) it does: QK and PV; QK, dO.V and dS.K; QK, dO.V, P.dO and
# dS.Q
FLASH_REPLACES = {
    "flash_forward": "chainermn_tpu/ops/pallas_attention.py:367",
    "flash_backward_dq": "chainermn_tpu/ops/pallas_attention.py:619",
    "flash_backward_dkv": "chainermn_tpu/ops/pallas_attention.py:747",
}
FLASH_PRODUCTS = {"flash_forward": 2, "flash_backward_dq": 3,
                  "flash_backward_dkv": 4}
# Flash vs dense attend on the full model, identical params and batch:
# the dense attend rounds the scores and the softmax weights to bf16
# (about 2^-9 relative per element), the kernels keep them fp32.  On an
# H100 that moved the loss (~9.4) by 9.5e-6 and a parameter's gradient
# norm by at most 2.2e-4 relative; the bounds are 100x and 45x those.
# They catch a wrong mask or scale: in a 2-layer bf16 LM at d_model 256
# on the CPU, dropping the causal mask moved the loss by 8.3e-3 and
# scale 1 by 2.2e-2, against 4.8e-6 for the dense attend.  A kernel that
# rounds P to bf16 fails its tolerance in the kernel phase instead.
LOSS_GAP_BOUND = 1e-3
GRAD_NORM_GAP_BOUND = 1e-2


def event_ms(fn, iters):
    """Mean device ms per call of fn() (``cuda_time_ms`` with one
    working set)."""
    return cuda_time_ms(lambda _: fn(), 1, iters)


def live_pairs(s_q, s_k, causal):
    """(query, key) pairs the function needs: top-left causal masking
    keeps key j for query i when j <= i."""
    if not causal:
        return s_q * s_k
    return sum(min(i + 1, s_k) for i in range(s_q))


def flash_ops(name, shape):
    """The operations one launch's products need (the function's, not
    the hi/lo split's)."""
    b, s_q, s_k, h, d, causal = shape
    return 2 * FLASH_PRODUCTS[name] * b * h * live_pairs(s_q, s_k, causal) * d


def flash_bound(name, shape, dtype):
    """Least time for one launch: the operations its products need over
    the input type's peak, against each input read once and each output
    written once over HBM bandwidth."""
    b, s_q, s_k, h, d, causal = shape
    elt = torch.finfo(dtype).bits // 8
    ops = flash_ops(name, shape)
    rows_q, rows_k = {"flash_forward": (2, 2), "flash_backward_dq": (3, 2),
                      "flash_backward_dkv": (2, 4)}[name]
    row_bytes = {"flash_forward": 4, "flash_backward_dq": 8,
                 "flash_backward_dkv": 8}[name]  # lse (and delta) fp32
    nbytes = elt * b * h * d * (rows_q * s_q + rows_k * s_k) \
        + row_bytes * b * h * s_q
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_inputs(shape, dtype, seed):
    b, s_q, s_k, h, d, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s_q, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s_k, h, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, s_k, h, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, s_q, h, d, generator=g, device="cuda").to(dtype)
    return q, k, v, do


def share_of_tolerance(got, ref):
    """The largest error as a share of what the tolerance allows there."""
    tol = fa.tolerance(ref)
    err = (got.float() - ref.float()).abs()
    return float((err / (tol["atol"] + tol["rtol"] * ref.float().abs()))
                 .max())


def flash_kernel_phase():
    """K2, K3 and K4 against their plain versions at every shape in bf16
    and fp32 (the backward kernels get the plain forward's lse and
    delta), then timed at the training shape beside their plain
    versions, scaled_dot_product_attention and their bounds.  Returns
    the records of the training shape, by dtype then kernel."""
    rec = {}
    for shape in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = flash_inputs(shape, dtype, SEED + shape[1])
            scale = q.shape[-1] ** -0.5
            causal = shape[5]
            b, s_q, h = q.shape[0], q.shape[1], q.shape[2]
            ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal,
                                                          scale)
            delta = ((do.float() * ref_out.float()).sum(-1).transpose(1, 2)
                     .reshape(b * h, s_q).contiguous())
            args = (q, k, v, do, ref_lse, delta, causal, scale)
            plain = {
                "flash_forward": lambda: fa.flash_forward_reference(
                    q, k, v, causal, scale),
                "flash_backward_dq": lambda: fa.flash_backward_dq_reference(
                    *args),
                "flash_backward_dkv": lambda: fa.flash_backward_dkv_reference(
                    *args),
            }
            kernel = {
                "flash_forward": lambda: fa.flash_forward(q, k, v, causal,
                                                          scale),
                "flash_backward_dq": lambda: fa.flash_backward_dq(*args),
                "flash_backward_dkv": lambda: fa.flash_backward_dkv(*args),
            }
            tag = (f"{'x'.join(map(str, shape[:5]))} "
                   f"{'causal' if causal else 'non-causal'} "
                   f"{str(dtype).split('.')[-1]}")
            main = shape == FLASH_SHAPES[0]
            for name in FLASH_KERNELS:
                refs = plain[name]()
                outs = kernel[name]()
                torch.cuda.synchronize()
                refs = refs if isinstance(refs, tuple) else (refs,)
                outs = outs if isinstance(outs, tuple) else (outs,)
                err, used = 0.0, 0.0
                for o, r in zip(outs, refs):
                    check(o.dtype == r.dtype and o.shape == r.shape,
                          f"{name} {tag}: output {o.dtype} {tuple(o.shape)}")
                    torch.testing.assert_close(o, r, **fa.tolerance(r))
                    err = max(err, float((o.float() - r.float()).abs().max()))
                    used = max(used, share_of_tolerance(o, r))
                line = (f"{name} {tag}: max_abs_err={err:.3e}, largest "
                        f"error {used:.1%} of its tolerance")
                if main:
                    ms = event_ms(kernel[name], 10)
                    plain_ms = event_ms(plain[name], 3)
                    bound_ms, bound_by = flash_bound(name, shape, dtype)
                    tflops = flash_ops(name, shape) / ms / 1e9
                    design = fa.design(name, dtype, shape[4])
                    design.update(PTXAS.get(
                        (name, TYPE_TAG[dtype], shape[4]), {}))
                    rec.setdefault(dtype, {})[name] = dict(
                        max_abs_err=err, share_of_tolerance=used, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None,
                        tflops=tflops, share_of_bound=bound_ms / ms,
                        design=design)
                    line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                             f" bound {bound_ms:.4f} ms ({bound_by}), "
                             f"{bound_ms / ms:.1%} of bound, {tflops:.1f} "
                             f"TFLOP/s; design {json.dumps(design)}")
                log(line)
                del refs, outs
            if main and dtype == torch.bfloat16:
                fwd_ms, bwd_ms = sdpa_train_ms(q, k, v, do)
                log(f"scaled_dot_product_attention {tag}: forward "
                    f"{fwd_ms:.4f} ms, backward (dq, dk, dv) {bwd_ms:.4f} ms")
                rec[dtype]["flash_forward"]["library_ms"] = fwd_ms
                rec[dtype]["flash_backward_dq"]["library_ms"] = bwd_ms
                rec[dtype]["flash_backward_dkv"]["library_ms"] = bwd_ms
            del q, k, v, do, ref_out, ref_lse, delta, args, plain, kernel
            torch.cuda.empty_cache()
    census = fa.block_census(TRAIN_SEQ, TRAIN_SEQ, fa.BLOCK_Q, fa.BLOCK_K,
                             True)
    live = census["interior"] + census["masked"]
    log(f"block census at {fa.BLOCK_Q}x{fa.BLOCK_K} tiles, s {TRAIN_SEQ} "
        f"causal: {json.dumps(census)}; live tiles {live / (live + census['dead']):.2%}"
        f", live (q, k) pairs "
        f"{live_pairs(TRAIN_SEQ, TRAIN_SEQ, True) / TRAIN_SEQ ** 2:.2%}")
    return rec


def sdpa_train_ms(q, k, v, do):
    """The library yardstick (never on the path): causal
    scaled_dot_product_attention forward, and its backward through
    torch.autograd.grad, on the same inputs in (b, h, s, d) layout."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd_ms = event_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 10)
    out = sdpa(qt, kt, vt, is_causal=True)
    bwd_ms = event_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    return fwd_ms, bwd_ms


def flash_counts():
    return {name: getattr(fa, name).launches for name in FLASH_KERNELS}


def reset_flash_counts():
    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0


def grads_of(lm, tokens):
    """Loss and every parameter's gradient (fp32 copies) of one forward
    and backward of lm_loss."""
    lm.zero_grad(set_to_none=True)
    loss = lm_loss(lm(tokens), tokens)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in lm.named_parameters()}
    lm.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def flash_vs_dense(lm, tokens):
    """On identical params and batch: the loss gap and the largest
    relative gap in a parameter's gradient norm between the flash hook
    and the dense attend."""
    loss_f, g_f = grads_of(lm, tokens)
    hooks = [blk.attn.attention_fn for blk in lm.blocks]
    for blk in lm.blocks:
        blk.attn.attention_fn = None
    try:
        loss_d, g_d = grads_of(lm, tokens)
    finally:
        for blk, fn in zip(lm.blocks, hooks):
            blk.attn.attention_fn = fn
    gap = 0.0
    for key in g_f:
        nf, nd = float(g_f[key].norm()), float(g_d[key].norm())
        gap = max(gap, abs(nf - nd) / max(nd, 1e-30))
    return abs(loss_f - loss_d), gap, loss_f, loss_d


def profile_train_step(step, tokens):
    """Device time of one training step by kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return busy, wall, sum(e.count for e in kernels), kernels


def train_phase():
    """The main training path: the full-width TransformerLM through
    create_communicator -> bcast_data -> create_multi_node_optimizer ->
    build_train_step on a 1-rank NCCL group, every flash kernel count
    set to 0 just before the timed steps and read just after."""
    import torch.distributed as dist

    from chainermn_tpu_torch import (build_train_step, create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models import flax_ordered_parameters

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = create_communicator("pure_nccl")
        t0 = time.perf_counter()
        check(comm.device == torch.device("cuda", 0), f"{comm.device}")
        lm = TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS,
                           max_len=MAX_LEN, dtype=torch.bfloat16, seed=SEED,
                           attention_fn=fa.flash_attention_fn()
                           ).to(comm.device)
        comm.bcast_data(lm)
        opt = create_multi_node_optimizer(
            torch.optim.AdamW([p for _, p in flax_ordered_parameters(lm)],
                              lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=0.01), comm)
        plan = opt.wire_plan()
        log(f"train: {comm!r}, backend {comm.backend}; wire "
            f"{opt.wire.codec}, {plan.describe()}; set up in "
            f"{time.perf_counter() - t0:.1f}s")
        step = build_train_step(comm, lambda t: lm_loss(lm(t), t), opt)
        tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, VOCAB, (TRAIN_BATCH, TRAIN_SEQ))).to(comm.device)

        for _ in range(TRAIN_WARMUP):
            check(np.isfinite(float(step(tokens)["loss"])),
                  "warm-up loss not finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: every count set to 0 just before, read just after
        reset_flash_counts()
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            m = step(tokens)
            losses.append(float(m["loss"]))  # reads the loss: synchronizes
            times.append(time.perf_counter() - t)
        launches = flash_counts()
        peak = torch.cuda.max_memory_allocated()
        for name, n in launches.items():
            check(n == N_LAYERS * TRAIN_STEPS,
                  f"{name} launches {n} != {N_LAYERS} x {TRAIN_STEPS} steps")
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        step_ms = [1e3 * t for t in times]
        mean_ms = float(np.mean(step_ms))
        tps = TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3)
        log(f"train: {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens:"
            f" losses {losses}; step ms {[round(t, 3) for t in step_ms]} "
            f"(mean {mean_ms:.3f}); {tps:.1f} tokens/s; peak memory "
            f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)} = "
            f"n_layers x steps ({N_LAYERS} x {TRAIN_STEPS})")

        busy, wall, n_kernels, kernels = profile_train_step(step, tokens)
        attn = {}
        for e in kernels:
            m = re.search(r"(flash_[a-z_]+?(?:_sm90)?)_kernel", e.key)
            if m:
                attn[m[1]] = (attn.get(m[1], 0.0)
                              + e.self_device_time_total / 1e3)
        attn_ms = sum(attn.values())
        # the bf16 step runs K2, K3 and K4 on the tensor cores, and
        # nothing else of the flash kernels
        check(sorted(attn) == ["flash_bwd_dkv_sm90", "flash_bwd_dq_sm90",
                               "flash_fwd_sm90"],
              f"flash kernels in the profiled step: {sorted(attn)}")
        log(f"profile train step: device busy {busy:.3f} ms in {n_kernels} "
            f"kernel launches over the profiled step's {wall:.3f} ms (host "
            f"clock; unprofiled mean {mean_ms:.3f} ms); idle share "
            f"{1 - busy / wall:.1%}; flash attention kernels "
            f"{attn_ms:.3f} ms ({attn_ms / busy:.1%} of device time): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(attn.items())))
        for e in kernels[:10]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} "
                f"{e.key[:90]}")

        loss_gap, grad_gap, loss_f, loss_d = flash_vs_dense(lm, tokens)
        log(f"flash vs dense attend on identical params and batch: loss "
            f"{loss_f:.6f} vs {loss_d:.6f}, gap {loss_gap:.3e} (bound "
            f"{LOSS_GAP_BOUND}); largest relative gradient-norm gap "
            f"{grad_gap:.3e} (bound {GRAD_NORM_GAP_BOUND})")
        check(loss_gap <= LOSS_GAP_BOUND, f"flash vs dense loss gap {loss_gap}")
        check(grad_gap <= GRAD_NORM_GAP_BOUND,
              f"flash vs dense gradient-norm gap {grad_gap}")
        return {"launches": launches, "steps": TRAIN_STEPS,
                "losses": losses, "step_ms": step_ms,
                "tokens_per_s": tps, "peak_gib": peak / 2**30,
                "device_busy_ms": busy, "profiled_step_ms": wall,
                "idle_share": 1 - busy / wall, "attention_ms": attn_ms,
                "attention_share": attn_ms / busy, "loss_gap": loss_gap,
                "grad_norm_gap": grad_gap}
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# Image slice: the fused cast/scale kernel (K1) in the gradient wire, and
# ResNet-50 trained data-parallel through the Trainer's pieces
# ----------------------------------------------------------------------
# bench.py:212-259, 348-365: ResNet-50, 224 x 224 NHWC images, batch 128
# per chip, SGD lr 0.1 momentum 0.9, a resident synthetic batch
IMAGE, IMAGE_BATCH, N_CLASSES = 224, 128, 1000
IMAGE_WARMUP, IMAGE_STEPS = 1, 6
CAST_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
CAST_SCALES = (1.0, 0.5, 1.0 / 3.0)


def cast_input(n, dtype, seed):
    """n values over many binades, with NaN, +-inf, -0, fp16 overflow
    and fp32 subnormals among them, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * torch.exp2(
        torch.randint(-30, 30, (n,), generator=g, device="cuda").float())
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            7e4, -7e4, 1e-40, 3.0e-8], device="cuda")
    x[:min(n, len(special))] = special[:n]
    return x.to(dtype)


def cast_bound(n, src, dst):
    """Least time for one launch: n elements read once and written once
    over HBM bandwidth, against n fp32 multiplies."""
    t_bytes = n * (src.itemsize + dst.itemsize) / HBM_BYTES_PER_S
    t_ops = n / PEAK_OPS_PER_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def resnet50_plan():
    """ResNet-50's wire plan over its flax-ordered leaves (the running
    statistics among them)."""
    from chainermn_tpu_torch.comm_wire import make_plan
    from chainermn_tpu_torch.models import ResNet50, flax_leaf_specs

    return make_plan(flax_leaf_specs(ResNet50(num_classes=N_CLASSES)))


# K1 against its plain version: the cases and the largest error over the
# finite outputs, by the path whose bucket sizes they cover
CAST_EXACT = {}


def cast_exact(path, bucket_sizes, small=False):
    """K1 against its plain version, bit for bit (NaN positions as
    positions), for every dtype pair at every bucket size of ``path``
    (each a view into one buffer), at each scale; with ``small``, also
    at sizes 1, 7 and 1027 and an odd-offset view.  Run outside every
    counting window.  Records into CAST_EXACT and returns the largest
    error over the finite outputs."""
    big = max(bucket_sizes)
    n_cases, err = 0, 0.0
    for src in CAST_DTYPES:
        buf = cast_input(big + 8, src, 1)
        xs = [buf[:n] for n in bucket_sizes]
        if small:
            xs += [cast_input(n, src, n) for n in (1, 7, 1027)]
            xs.append(buf[3:3 + 70001])  # odd element offset
        for dst in CAST_DTYPES:
            for x in xs:
                for scale in CAST_SCALES:
                    got = fcs.fused_cast_scale(x, scale, dst)
                    want = fcs.cast_scale_reference(x, scale, dst)
                    check(fcs.same_bits(got, want),
                          f"fused_cast_scale {src}->{dst} n={x.numel()} "
                          f"offset={x.storage_offset()} scale={scale}")
                    finite = torch.isfinite(want)
                    err = max(err, float((got.float() - want.float())[finite]
                                         .abs().max()) if finite.any() else 0.0)
                    n_cases += 1
        del buf, xs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    CAST_EXACT[path] = {"bucket_sizes": list(bucket_sizes), "cases": n_cases,
                        "max_abs_err": err}
    log(f"fused_cast_scale ({path}): bit-exact against its plain version in "
        f"{n_cases} cases, max_abs_err={err} over the finite outputs (3 x 3 "
        f"dtype pairs, the buckets {list(bucket_sizes)}"
        + (", sizes 1, 7, 1027 and an odd-offset view of 70001" if small
           else "")
        + f", scales {[round(s, 6) for s in CAST_SCALES]})")
    return err


def cast_exact_covering(path, bucket_sizes):
    """``cast_exact`` at the bucket sizes of ``path`` that no earlier
    call held."""
    held = {n for r in CAST_EXACT.values() for n in r["bucket_sizes"]}
    new = [n for n in bucket_sizes if n not in held]
    if new:
        cast_exact(path, new)


def cast_kernel_phase(bucket_sizes):
    """K1 against its plain version (``cast_exact``) at ResNet-50's bucket
    sizes and the small cases; then timed on the main path's launches
    (each bucket fp32 -> bf16 to the wire, bf16 -> fp32 back; scale 1 at
    world 1) beside its plain version, Tensor.to (the one PyTorch call
    computing the scale-1 leg) and its bound.  Returns the record:
    per-launch means over one step's launches."""
    err = cast_exact("resnet50", bucket_sizes, small=True)

    grads = [torch.randn(n, device="cuda") * 1e-3 for n in bucket_sizes]
    wire = [g.bfloat16() for g in grads]
    legs = ([(g, torch.bfloat16) for g in grads]
            + [(w, torch.float32) for w in wire])
    bound_by = "bytes"
    for x, dst in legs:
        ms = event_ms(lambda: fcs.fused_cast_scale(x, 1.0, dst), 50)
        bound_ms, bound_by = cast_bound(x.numel(), x.dtype, dst)
        log(f"fused_cast_scale {str(x.dtype)[6:]}->{str(dst)[6:]} "
            f"n={x.numel()}: kernel {ms:.4f} ms alone (its input "
            f"{x.numel() * x.element_size() / 1e6:.1f} MB, L2-resident "
            f"where it fits), bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound")

    def each_leg(fn):
        return lambda: [fn(x, dst) for x, dst in legs]

    # a step's launches in the step's order (every bucket to the wire,
    # then every bucket back: 2 x 102 MB of fp32, beyond the L2 cache)
    n = len(legs)
    step = {
        "ms": event_ms(each_leg(
            lambda x, dst: fcs.fused_cast_scale(x, 1.0, dst)), 20),
        "plain_ms": event_ms(each_leg(
            lambda x, dst: fcs.cast_scale_reference(x, 1.0, dst)), 20),
        "library_ms": event_ms(each_leg(lambda x, dst: x.to(dst)), 20),
        "bound_ms": sum(cast_bound(x.numel(), x.dtype, dst)[0]
                        for x, dst in legs),
    }
    host_ms = host_enqueue_ms(each_leg(
        lambda x, dst: fcs.fused_cast_scale(x, 1.0, dst)), 20)
    rec = {k: v / n for k, v in step.items()}
    rec.update(bound_by=bound_by, max_abs_err=err, share_of_tolerance=None,
               per_step_ms=step["ms"], per_step_bound_ms=step["bound_ms"],
               host_ms_per_launch=host_ms / n)
    log(f"fused_cast_scale per step ({n} launches, device time): kernel "
        f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, Tensor.to "
        f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms "
        f"({step['bound_ms'] / step['ms']:.1%} of bound); the wrapper's host "
        f"time {host_ms / n:.4f} ms a launch")
    del grads, wire, legs
    torch.cuda.empty_cache()
    return rec


def host_enqueue_ms(fn, iters):
    """Host ms per call of fn() (enqueue only, host clock)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def image_batch(device, n=IMAGE_BATCH):
    """The resident synthetic batch of bench.py:249-256 (seed 0 images,
    seed 1 labels)."""
    x = np.random.RandomState(0).randn(n, IMAGE, IMAGE, 3)
    y = np.random.RandomState(1).randint(0, N_CLASSES, (n,))
    return (torch.from_numpy(x).to(device, torch.bfloat16),
            torch.from_numpy(y).to(device))


def timed_steps(step, batch, n):
    losses, times = [], []
    for _ in range(n):
        t = time.perf_counter()
        m = step(batch)
        losses.append(float(m["loss"]))  # reads the loss: synchronizes
        times.append(1e3 * (time.perf_counter() - t))
    return losses, times


# kinds of kernel in a ResNet-50 step, by name (first match wins): the
# convolutions (cuDNN's and the GEMM kernels it picks), the fused
# cast/scale kernel, the optimizer's multi-tensor updates, NCCL, the
# reductions (BatchNorm statistics, the mean pool, the loss), the
# remaining elementwise passes (BatchNorm arithmetic, casts, ReLU,
# residual adds, copies)
KERNEL_KINDS = (
    ("convolution and GEMM", ("conv", "cudnn", "xmma", "implicit", "nhwc",
                              "gemm", "nvjet", "cutlass", "sm90_", "sm80_",
                              "dgrad", "wgrad")),
    ("fused_cast_scale", ("fused_cast_scale",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("nccl", ("nccl",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise and copies", ("",)),
)


def kernel_categories(kernels, kinds=KERNEL_KINDS):
    """{kind: (device ms, launches)} of profiled kernels."""
    out = {k: [0.0, 0] for k, _ in kinds}
    for e in kernels:
        name = e.key.lower()
        kind = next(k for k, pats in kinds
                    if any(p in name for p in pats))
        out[kind][0] += e.self_device_time_total / 1e3
        out[kind][1] += e.count
    return {k: tuple(v) for k, v in out.items()}


def image_step_profile(tag, step, batch, median_ms):
    """One profiled step: its device time, its idle share against the
    unprofiled steps' median, its ten longest kernels and its device
    time by kind, logged under ``tag``."""
    busy, wall, n_kernels, kernels = profile_train_step(step, batch)
    # the profiler's own cost per launch stretches the profiled step
    # (thousands of launches), not the kernels: idle share against the
    # unprofiled steps
    idle = 1 - busy / median_ms
    log(f"profile {tag} step: device busy {busy:.3f} ms in "
        f"{n_kernels} kernel launches; the profiled step took {wall:.3f}"
        f" ms on the host clock, the unprofiled ones {median_ms:.3f} ms "
        f"(median): idle share {idle:.1%} of an unprofiled step")
    for e in kernels[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} "
            f"{e.key[:90]}")
    shares = kernel_categories(kernels)
    log(f"profile {tag} step by kind: " + ", ".join(
        f"{k} {ms:.3f} ms ({ms / busy:.1%}, {n} launches)"
        for k, (ms, n) in shares.items()))
    return busy, wall, idle, shares


def resnet_train_phase():
    """The image main path: ResNet-50 at full width through
    create_communicator("pure_nccl", allreduce_grad_dtype=bf16) ->
    bcast_data -> create_multi_node_optimizer(SGD momentum) ->
    build_train_step(model_state=running statistics) on a 1-rank NCCL
    group; K1's count set to 0 just before the timed steps and read just
    after.  Then the same step on the codec-none wire, in turns."""
    import torch.distributed as dist

    from chainermn_tpu_torch import (build_train_step, create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models import ResNet50, flax_ordered_parameters
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = create_communicator("pure_nccl",
                                   allreduce_grad_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        model = ResNet50(num_classes=N_CLASSES).to(comm.device)
        comm.bcast_data(model)
        leaves = [p for _, p in flax_ordered_parameters(model)]

        def make_step(wire):
            opt = create_multi_node_optimizer(
                torch.optim.SGD(leaves, lr=0.1, momentum=0.9), comm, wire=wire)
            step = build_train_step(
                comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]), opt,
                model_state=list(model.buffers()))
            return opt, step

        opt, step = make_step("auto")
        _, step_none = make_step("none")
        plan = opt.wire_plan()
        n_params = sum(p.numel() for p in model.parameters())
        batch = image_batch(comm.device)
        log(f"resnet50: {n_params} params, {len(leaves)} wire leaves; "
            f"{comm!r}, backend {comm.backend}; wire {opt.wire.codec}, "
            f"{plan.describe()}; set up in {time.perf_counter() - t0:.1f}s")

        for _ in range(IMAGE_WARMUP):
            check(np.isfinite(float(step(batch)["loss"])),
                  "warm-up loss not finite")
            check(np.isfinite(float(step_none(batch)["loss"])),
                  "warm-up loss (codec none) not finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: every count set to 0 just before, read just after
        fcs.fused_cast_scale.launches = 0
        losses, times = timed_steps(step, batch, IMAGE_STEPS)
        launches = fcs.fused_cast_scale.launches
        peak = torch.cuda.max_memory_allocated()
        want = 2 * plan.n_buckets * IMAGE_STEPS
        check(launches == want, f"fused_cast_scale launches {launches} != "
              f"2 x {plan.n_buckets} buckets x {IMAGE_STEPS} steps")
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        # the median step: a first timed step can stall (allocator
        # growth, clocks), and the mean would carry it
        median_ms = float(np.median(times))
        ips = IMAGE_BATCH / (median_ms / 1e3)
        log(f"resnet50 bf16 wire: {IMAGE_STEPS} steps of {IMAGE_BATCH} x "
            f"{IMAGE}^2: losses {losses}; step ms "
            f"{[round(t, 3) for t in times]} (median {median_ms:.3f}, mean "
            f"{np.mean(times):.3f}); "
            f"{ips:.1f} images/s; peak memory {peak / 2**30:.2f} GiB; "
            f"fused_cast_scale launches {launches} = 2 x {plan.n_buckets} "
            f"buckets x {IMAGE_STEPS} steps")

        # the codec-none wire (no K1) and the bf16 wire again, in turns
        n0 = fcs.fused_cast_scale.launches
        losses_none, times_none = timed_steps(step_none, batch, IMAGE_STEPS)
        check(fcs.fused_cast_scale.launches == n0,
              "the codec-none wire launched fused_cast_scale")
        check(all(np.isfinite(losses_none)), f"non-finite loss: {losses_none}")
        _, times_again = timed_steps(step, batch, IMAGE_STEPS)
        none_ms = float(np.median(times_none))
        again_ms = float(np.median(times_again))
        log(f"resnet50 codec none: step ms "
            f"{[round(t, 3) for t in times_none]} (median {none_ms:.3f}, "
            f"{IMAGE_BATCH / none_ms * 1e3:.1f} images/s); bf16 wire again: "
            f"median {again_ms:.3f} ms; bf16 - none = "
            f"{(median_ms + again_ms) / 2 - none_ms:+.3f} ms a step (medians)")

        busy, wall, idle, shares = image_step_profile("resnet50", step, batch,
                                                      median_ms)
        return {"launches": launches, "steps": IMAGE_STEPS,
                "buckets": plan.n_buckets, "losses": losses,
                "step_ms": times, "images_per_s": ips,
                "peak_gib": peak / 2**30, "device_busy_ms": busy,
                "profiled_step_ms": wall, "idle_share": idle,
                "device_ms_by_kind": {k: v[0] for k, v in shares.items()},
                "none_step_ms": times_none, "bf16_again_step_ms": times_again}
    finally:
        dist.destroy_process_group()


# the int8 phase's steps (after one warm-up step)
INT8_STEPS = 3


def wire_ms(buckets, wire):
    """Device ms of one step's gradient sync, ``reduce_buckets`` over
    ``buckets`` with ``wire`` on the 1-rank group (at world 1 the
    all-reduces move nothing: what is timed are the codec's legs), and
    the means and residuals of one call."""
    from chainermn_tpu_torch.comm_wire import reduce_buckets, uses_error_feedback

    res = ([torch.zeros_like(b) for b in buckets]
           if uses_error_feedback(wire) else None)
    ms = event_ms(lambda: reduce_buckets(buckets, 1, wire, res), 10)
    return ms, reduce_buckets(buckets, 1, wire, res)


def mnbn_train_phase():
    """The MNBN image path: ResNet-50 at full width through
    create_communicator("hierarchical", allreduce_grad_dtype=bf16) ->
    create_mnbn_model -> bcast_data -> create_multi_node_optimizer(SGD
    momentum) -> build_train_step(model_state=MNBN running statistics)
    on a 1-rank NCCL group: the bf16 wire (K1's count and the MNBN
    all-reduce count set to 0 just before the timed steps and read just
    after), a profiled step; then WireConfig("int8",
    error_feedback=True) and WireConfig("bf16", error_feedback=True)
    for a few steps each, counted the same way; and one step's wire
    timed alone under each codec."""
    import torch.distributed as dist

    from chainermn_tpu_torch import (build_train_step, create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.comm_wire import WireConfig
    from chainermn_tpu_torch.functions import allreduce_mean
    from chainermn_tpu_torch.links import (MultiNodeBatchNormalization,
                                           create_mnbn_model)
    from chainermn_tpu_torch.models import ResNet50, flax_ordered_parameters
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = create_communicator("hierarchical",
                                   allreduce_grad_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        model = create_mnbn_model(
            ResNet50(num_classes=N_CLASSES).to(comm.device), comm)
        n_norms = sum(isinstance(m, MultiNodeBatchNormalization)
                      for m in model.modules())
        check(n_norms == 53, f"{n_norms} synchronized BatchNorms, not 53")
        comm.bcast_data(model)
        leaves = [p for _, p in flax_ordered_parameters(model)]

        def make_step(wire):
            opt = create_multi_node_optimizer(
                torch.optim.SGD(leaves, lr=0.1, momentum=0.9), comm, wire=wire)
            step = build_train_step(
                comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]), opt,
                model_state=list(model.buffers()))
            return opt, step

        opt, step = make_step("auto")
        plan = opt.wire_plan()
        check(opt.wire.codec == "bf16", f"wire {opt.wire.codec}, not bf16")
        check(comm.mesh_shape == {"mn_inter": 1, "mn_intra": 1},
              f"axes {comm.mesh_shape}")
        check(set(plan.schedules) == {"flat"}, f"schedules {plan.schedules}")
        batch = image_batch(comm.device)
        log(f"mnbn resnet50: {n_norms} MultiNodeBatchNormalization, "
            f"{len(leaves)} wire leaves; {comm!r}, backend {comm.backend}, "
            f"axes {comm.mesh_shape}; wire {opt.wire.codec}, "
            f"{plan.describe()}, plan_hash {plan.plan_hash()[:16]}; set up "
            f"in {time.perf_counter() - t0:.1f}s")

        for _ in range(IMAGE_WARMUP):
            check(np.isfinite(float(step(batch)["loss"])),
                  "MNBN warm-up loss not finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: every count set to 0 just before, read just after
        fcs.fused_cast_scale.launches = 0
        allreduce_mean.calls = 0
        losses, times = timed_steps(step, batch, IMAGE_STEPS)
        launches = fcs.fused_cast_scale.launches
        reduces = allreduce_mean.calls
        peak = torch.cuda.max_memory_allocated()
        check(launches == 2 * plan.n_buckets * IMAGE_STEPS,
              f"MNBN fused_cast_scale launches {launches} != 2 x "
              f"{plan.n_buckets} buckets x {IMAGE_STEPS} steps")
        check(reduces == 2 * n_norms * IMAGE_STEPS,
              f"MNBN all-reduces {reduces} != 2 x {n_norms} x {IMAGE_STEPS}")
        check(all(np.isfinite(losses)), f"non-finite MNBN loss: {losses}")
        median_ms = float(np.median(times))
        ips = IMAGE_BATCH / (median_ms / 1e3)
        log(f"mnbn resnet50 bf16 wire: {IMAGE_STEPS} steps of {IMAGE_BATCH} "
            f"x {IMAGE}^2: losses {losses}; step ms "
            f"{[round(t, 3) for t in times]} (median {median_ms:.3f}, mean "
            f"{np.mean(times):.3f}); {ips:.1f} images/s; peak memory "
            f"{peak / 2**30:.2f} GiB; fused_cast_scale launches {launches} = "
            f"2 x {plan.n_buckets} buckets x {IMAGE_STEPS} steps; MNBN "
            f"all-reduces {reduces} = ({n_norms} forward + {n_norms} "
            f"backward) x {IMAGE_STEPS} steps")

        busy, wall, idle, shares = image_step_profile("mnbn resnet50", step,
                                                      batch, median_ms)

        # the int8 wire with error feedback, then bf16 with error feedback
        lossy = {}
        for name, wire, k1_per_bucket in (
                ("int8_ef", WireConfig("int8", error_feedback=True), 0),
                ("bf16_ef", WireConfig("bf16", error_feedback=True), 3)):
            opt_w, step_w = make_step(wire)
            check(len(opt_w.wire_residual) == plan.n_buckets,
                  f"{name}: {len(opt_w.wire_residual)} residuals")
            check(np.isfinite(float(step_w(batch)["loss"])),
                  f"{name} warm-up loss not finite")
            torch.cuda.synchronize()
            fcs.fused_cast_scale.launches = 0
            allreduce_mean.calls = 0
            w_losses, w_times = timed_steps(step_w, batch, INT8_STEPS)
            w_launches = fcs.fused_cast_scale.launches
            w_reduces = allreduce_mean.calls
            check(w_launches == k1_per_bucket * plan.n_buckets * INT8_STEPS,
                  f"{name} fused_cast_scale launches {w_launches} != "
                  f"{k1_per_bucket} x {plan.n_buckets} x {INT8_STEPS}")
            check(w_reduces == 2 * n_norms * INT8_STEPS,
                  f"{name} MNBN all-reduces {w_reduces}")
            check(all(np.isfinite(w_losses)), f"non-finite {name} loss")
            norm = float(torch.sqrt(sum(
                r.float().square().sum() for r in opt_w.wire_residual)))
            check(np.isfinite(norm) and norm > 0,
                  f"{name} residual norm {norm}")
            lossy[name] = {"losses": w_losses, "step_ms": w_times,
                           "launches": w_launches, "all_reduces": w_reduces,
                           "residual_norm": norm}
            log(f"mnbn resnet50 {name}: {INT8_STEPS} steps: losses "
                f"{w_losses}; step ms {[round(t, 3) for t in w_times]} "
                f"(median {np.median(w_times):.3f}); fused_cast_scale "
                f"launches {w_launches} = {k1_per_bucket} x {plan.n_buckets} "
                f"buckets x {INT8_STEPS}; MNBN all-reduces {w_reduces}; "
                f"residual norm {norm:.6g}")
            del opt_w, step_w

        # one step's sync alone under each codec (device time)
        grads = [torch.randn(b.size, device=comm.device) * 1e-3
                 for b in plan.buckets]
        sync = {}
        for name, wire in (("bf16", WireConfig("bf16")),
                           ("bf16_ef", WireConfig("bf16", error_feedback=True)),
                           ("int8", WireConfig("int8")),
                           ("int8_ef", WireConfig("int8",
                                                  error_feedback=True)),
                           ("none", WireConfig("none"))):
            sync[name], (means, res) = wire_ms(grads, wire)
            check(all(bool(torch.isfinite(m).all()) for m in means + res),
                  f"non-finite {name} sync")
        check(all(torch.equal(m, g) for m, g in zip(means, grads)),
              "codec none at world 1 changed a gradient")
        log("wire sync of one step's " + str(plan.n_buckets) + " buckets ("
            + str(sum(b.size for b in plan.buckets)) + " fp32 elements), "
            "device ms: " + ", ".join(f"{k} {v:.4f}" for k, v in sync.items()))
        del grads
        return {"n_norms": n_norms, "launches": launches,
                "all_reduces": reduces, "steps": IMAGE_STEPS,
                "buckets": plan.n_buckets, "plan_hash": plan.plan_hash(),
                "losses": losses, "step_ms": times, "images_per_s": ips,
                "peak_gib": peak / 2**30, "device_busy_ms": busy,
                "profiled_step_ms": wall, "idle_share": idle,
                "device_ms_by_kind": {k: v[0] for k, v in shares.items()},
                "lossy_wires": lossy, "sync_ms": sync}
    finally:
        dist.destroy_process_group()


def trainer_phase(resnet_buckets):
    """The Trainer path on the card: the MNIST example's twin (MLP 1000,
    bf16 wire) for a few epochs through Trainer + Evaluator + LogReport /
    PrintReport / Throughput, then the ImageNet example's twin with
    ResNet-50 for a few iterations; K1's count set to 0 just before each
    and read just after."""
    from chainermn_tpu_torch.comm_wire import make_plan
    from chainermn_tpu_torch.examples import train_imagenet, train_mnist
    from chainermn_tpu_torch.models import MLP, flax_leaf_specs

    mlp_buckets = make_plan(flax_leaf_specs(MLP(n_units=1000))).n_buckets
    epochs, n_train, batch = 3, 8192, 512
    fcs.fused_cast_scale.launches = 0
    entries = train_mnist.main([
        "--epoch", str(epochs), "--n-train", str(n_train), "--n-test", "2048",
        "--batchsize", str(batch), "--allreduce-grad-dtype", "bfloat16"])
    launches = fcs.fused_cast_scale.launches
    for e in entries:
        log("mnist epoch: " + json.dumps(e))
    losses = [e["loss"] for e in entries]
    check(len(entries) == epochs, f"{len(entries)} log entries")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"MNIST loss does not fall epoch over epoch: {losses}")
    accuracy = entries[-1]["val/accuracy"]
    check(accuracy > 0.1, f"validation accuracy {accuracy} at chance")
    iters = entries[-1]["iteration"]
    check(launches == 2 * mlp_buckets * iters,
          f"MNIST fused_cast_scale launches {launches} != 2 x {mlp_buckets} "
          f"buckets x {iters} iterations")
    log(f"mnist twin: losses {losses}, fused_cast_scale launches {launches}"
        f" = 2 x {mlp_buckets} buckets x {iters} iterations")

    fcs.fused_cast_scale.launches = 0
    entries = train_imagenet.main([
        "--arch", "resnet50", "--batchsize", str(IMAGE_BATCH), "--n-train",
        str(4 * IMAGE_BATCH), "--n-val", str(IMAGE_BATCH),
        "--allreduce-grad-dtype", "bfloat16"])
    im_launches = fcs.fused_cast_scale.launches
    final = entries[-1]
    log("imagenet twin: " + json.dumps(final))
    check(np.isfinite(final["loss"]) and np.isfinite(final["val/loss"]),
          f"non-finite ImageNet twin losses: {final}")
    check(im_launches == 2 * resnet_buckets * final["iteration"],
          f"ImageNet twin launches {im_launches} != 2 x {resnet_buckets} "
          f"buckets x {final['iteration']} iterations")
    return {"mnist_losses": losses, "mnist_launches": launches,
            "mnist_val_accuracy": accuracy,
            "imagenet_final": final, "imagenet_launches": im_launches}


# Phase 11, the checkpointed image path: VGG16 at the batch of
# bench.py:565-595 (config_vgg16_overlap, 64 a card), SGD momentum at
# lr 0.01 (the dense archs have no BatchNorm, and 0.1 sends AlexNet's
# synthetic-data loss to NaN within an epoch on the CPU)
VGG_BATCH, VGG_STEPS, IMAGE_LR = 64, 6, 0.01
# the prefetch A/B's timed updates (after two warm-up updates) and the
# in-memory dataset's batches
FEED_STEPS, FEED_BATCHES = 8, 4
# the checkpointed twin's batches an epoch; the other archs' runs take
# (ARCH_BATCHES_AN_EPOCH + 1) iterations: an epoch of the serial
# iterator ends on the draw that starts the next one
TWIN_EPOCH_BATCHES, ARCH_BATCHES_AN_EPOCH = 6, 2
OTHER_ARCHS = ("alex", "nin", "googlenet", "googlenetbn",
               "googlenetbn --mnbn --communicator hierarchical")


def chrome_trace_shares(prof, path):
    """From a profile's chrome trace: device busy ms (the union of every
    kernel's interval, any stream), the batches' host-to-device copies'
    ms, the share of that copy time that ran under a kernel, and the
    streams of the kernels and of those copies."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    # the batches' copies (a MiB or more; a step's scalar copies apart)
    batch_copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                    and "HtoD" in e.get("name", "")
                    and e["args"].get("bytes", 0) >= 1 << 20]
    copies = [(e["ts"], e["ts"] + e["dur"]) for e in batch_copies]
    streams = {"kernels": sorted({e["args"].get("stream") for e in events
                                  if e.get("cat") == "kernel"}),
               "copies": sorted({e["args"].get("stream")
                                 for e in batch_copies})}
    merged = []
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e3
    copy_ms = sum(b - a for a, b in copies) / 1e3
    under = sum(max(0.0, min(b, kb) - max(a, ka))
                for a, b in copies for ka, kb in merged) / 1e3
    return busy, copy_ms, (under / copy_ms if copy_ms else None), streams


def feed_phase(step, model, dataset, prefetch):
    """Host ms a step of ``Updater.update`` over ``SerialIterator``
    batches of ``dataset``, fed directly (``prefetch`` 0) or through
    ``prefetch_to_device(device_placer)``: FEED_STEPS updates back to back,
    one synchronize at the end (the loop's own pace, as the Trainer
    runs it); then a profiled window of 3 updates for the device's busy
    time, its idle share and the copies' overlap with the kernels."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from chainermn_tpu_torch.iterators import (
        SerialIterator, device_placer, prefetch_to_device)
    from chainermn_tpu_torch.training import Updater

    it = SerialIterator(dataset, VGG_BATCH, shuffle=True, seed=1)
    placer = None
    if prefetch:
        placer = device_placer(torch.device("cuda", 0))
        it = prefetch_to_device(it, placer, depth=prefetch)
    upd = Updater(it, step, model=model)
    for _ in range(2):
        upd.update()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(FEED_STEPS):
        upd.update()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / FEED_STEPS
    check(np.isfinite(float(upd.last_metrics["loss"])),
          f"prefetch {prefetch}: loss not finite")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            upd.update()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        busy, copy_ms, under, streams = chrome_trace_shares(
            prof, os.path.join(tmp, "trace.json"))
    out = {"prefetch": prefetch, "step_ms": ms,
           "device_busy_ms_a_step": busy / 3,
           "idle_share": 1 - busy / 3 / ms, "h2d_ms_a_step": copy_ms / 3,
           "h2d_share_under_kernels": under, "streams": streams}
    if placer is not None:
        check(streams["copies"] and not set(streams["copies"])
              & set(streams["kernels"]),
              f"prefetch copies not on their own stream: {streams}")
        out["side_stream_copies"] = placer.copies
    log(f"vgg16 feed, prefetch {prefetch}: " + json.dumps(out))
    return out


def checkpoint_phase(comm, model, opt, step, dataset):
    """The checkpointer on VGG16's training state (parameters, momentum,
    the trainer's position): a synchronous save (wall ms, GB/s; its copy
    to the host and one sha256 pass over its files timed alone), an
    async save (the stall until ``save()`` returns, then its commit),
    and a resume by a fresh checkpointer (a restart: the digests are
    checked) into perturbed state, which must come back bit-equal."""
    import tempfile

    from chainermn_tpu_torch import create_multi_node_checkpointer
    from chainermn_tpu_torch.extensions.checkpoint import _to_host
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.resilience import elastic
    from chainermn_tpu_torch.training import Trainer, Updater

    trainer = Trainer(Updater(SerialIterator(dataset, VGG_BATCH, seed=1),
                              step, model=model),
                      stop_trigger=(1, "iteration"))
    trainer.run()
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    momentum = [opt.state[p]["momentum_buffer"].clone() for p in opt.params]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = create_multi_node_checkpointer("vgg16", comm, path=tmp)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt(trainer)
        save_ms = (time.perf_counter() - t) * 1e3
        step_dir = os.path.join(tmp, "vgg16", f"step_{trainer.iteration:012d}")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        # the save's parts, timed alone: the copy to the host and one
        # sha256 pass over the committed files (the save takes one)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _to_host(ckpt._trainer_state(trainer))
        host_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        elastic.file_digests(step_dir)
        sha_ms = (time.perf_counter() - t) * 1e3
        lazy = create_multi_node_checkpointer("vgg16_async", comm, path=tmp,
                                              use_async=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lazy(trainer)
        stall_ms = (time.perf_counter() - t) * 1e3
        lazy.wait_until_finished()
        commit_ms = (time.perf_counter() - t) * 1e3
        lazy.finalize()
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
            for p in opt.params:
                opt.state[p]["momentum_buffer"].add_(1.0)
        trainer.iteration = 0
        fresh = create_multi_node_checkpointer("vgg16", comm, path=tmp)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fresh.restore_trainer(trainer)
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t) * 1e3
    check(got == 1 and trainer.iteration == 1, f"resumed at {got}")
    for k, v in model.state_dict().items():
        check(torch.equal(v, saved[k]), f"restored {k} differs from saved")
    for p, m in zip(opt.params, momentum):
        check(torch.equal(opt.state[p]["momentum_buffer"], m),
              "restored momentum differs from saved")
    out = {"bytes": nbytes, "save_ms": save_ms,
           "save_gb_per_s": nbytes / save_ms / 1e6,
           "save_to_host_ms": host_ms, "save_sha256_ms": sha_ms,
           "async_stall_ms": stall_ms, "async_commit_ms": commit_ms,
           "resume_ms": resume_ms}
    log("vgg16 checkpoint: " + json.dumps(out))
    return out


def vgg16_train_phase():
    """VGG16 at full width (batch 64, 224^2, 1000 classes) through
    create_communicator("pure_nccl", allreduce_grad_dtype=bf16) ->
    create_multi_node_optimizer(SGD momentum) -> build_train_step on a
    1-rank NCCL group, dropout on (one generator); K1's count set to 0
    just before the timed steps and read just after; a profiled step;
    then the prefetch A/B and the checkpointer on the same state."""
    import torch.distributed as dist

    from chainermn_tpu_torch import (build_train_step, create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models import VGG16, flax_ordered_parameters
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy
    from chainermn_tpu_torch.utils import SyntheticImageDataset

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = create_communicator("pure_nccl",
                                   allreduce_grad_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        model = VGG16(num_classes=N_CLASSES).to(comm.device)
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(torch.optim.SGD(
            [p for _, p in flax_ordered_parameters(model)], lr=IMAGE_LR,
            momentum=0.9), comm)
        gen = torch.Generator(device=comm.device).manual_seed(SEED)
        step = build_train_step(
            comm, lambda b: softmax_cross_entropy(
                model(b[0], generator=gen), b[1]), opt)
        plan = opt.wire_plan()
        n_params = sum(p.numel() for p in model.parameters())
        batch = image_batch(comm.device, VGG_BATCH)
        log(f"vgg16: {n_params} params; wire {opt.wire.codec}, "
            f"{plan.describe()}; set up in {time.perf_counter() - t0:.1f}s")
        check(np.isfinite(float(step(batch)["loss"])),
              "warm-up loss not finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: every count set to 0 just before, read just after
        fcs.fused_cast_scale.launches = 0
        losses, times = timed_steps(step, batch, VGG_STEPS)
        launches = fcs.fused_cast_scale.launches
        peak = torch.cuda.max_memory_allocated()
        cast_exact_covering("vgg16", [b.size for b in plan.buckets])
        want = 2 * plan.n_buckets * VGG_STEPS
        check(launches == want, f"vgg16 fused_cast_scale launches {launches}"
              f" != 2 x {plan.n_buckets} buckets x {VGG_STEPS} steps")
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        median_ms = float(np.median(times))
        ips = VGG_BATCH / (median_ms / 1e3)
        log(f"vgg16 bf16 wire: {VGG_STEPS} steps of {VGG_BATCH} x {IMAGE}^2"
            f": losses {losses}; step ms {[round(t, 3) for t in times]} "
            f"(median {median_ms:.3f}); {ips:.1f} images/s; peak memory "
            f"{peak / 2**30:.2f} GiB; fused_cast_scale launches {launches} "
            f"= 2 x {plan.n_buckets} buckets x {VGG_STEPS} steps")
        busy, wall, idle, shares = image_step_profile("vgg16", step, batch,
                                                      median_ms)

        # an in-memory dataset, made once: the feed's host cost is the
        # collation and the copies, not numpy's generator
        t0 = time.perf_counter()
        synth = SyntheticImageDataset(FEED_BATCHES * VGG_BATCH,
                                      shape=(IMAGE, IMAGE, 3),
                                      n_classes=min(N_CLASSES, 64), seed=0)
        dataset = [synth[i] for i in range(len(synth))]
        log(f"vgg16 feed dataset: {len(dataset)} images made in "
            f"{time.perf_counter() - t0:.1f}s")
        feeds = [feed_phase(step, model, dataset, d) for d in (0, 2, 2, 0)]
        ckpt = checkpoint_phase(comm, model, opt, step, dataset)
        return {"launches": launches, "steps": VGG_STEPS,
                "buckets": plan.n_buckets, "losses": losses,
                "step_ms": times, "median_step_ms": median_ms,
                "images_per_s": ips, "peak_gib": peak / 2**30,
                "device_busy_ms": busy, "profiled_step_ms": wall,
                "idle_share": idle,
                "device_ms_by_kind": {k: v[0] for k, v in shares.items()},
                "feed": feeds, "checkpoint": ckpt}
    finally:
        dist.destroy_process_group()


class RecordingDataset:
    """A dataset that records the indices it is asked for, in order."""

    def __init__(self, base):
        self.base = base
        self.seen = []

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        self.seen.append(int(i))
        return self.base[i]


def twin(argv, datasets=None):
    """train_imagenet.main(argv) with its output captured and logged:
    (log entries, stdout, K1 launches)."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples import train_imagenet

    buf = io.StringIO()
    fcs.fused_cast_scale.launches = 0
    with contextlib.redirect_stdout(buf):
        entries = train_imagenet.main(argv, datasets=datasets)
    launches = fcs.fused_cast_scale.launches
    out = buf.getvalue()
    for line in out.strip().splitlines():
        log("  | " + line)
    return entries, out, launches


def wire_bucket_sizes(stdout):
    """The bucket sizes of the wire plan the twin prints."""
    line = next(ln for ln in stdout.splitlines() if ln.startswith("wire "))
    return [int(n) for n in re.findall(r"\[\d+\][a-z]+\d*x(\d+)", line)]


def checkpointed_twin_phase():
    """The ImageNet twin with VGG16 (batch 64, bf16 wire, prefetch 2,
    --checkpoint) for one epoch of TWIN_EPOCH_BATCHES batches, then again
    with --epoch 2: it must resume where the first run's snapshot is and
    draw the uninterrupted run's next batches (dataset indices, against
    a third run of 2 epochs from scratch); a snapshot with one flipped
    byte is not elected; then the other archs for a few iterations."""
    import tempfile

    import torch.distributed as dist

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer)
    from chainermn_tpu_torch.utils import SyntheticImageDataset

    n = TWIN_EPOCH_BATCHES * VGG_BATCH
    shape = (IMAGE, IMAGE, 3)
    val = SyntheticImageDataset(VGG_BATCH, shape=shape, n_classes=min(N_CLASSES, 64), seed=1)
    size = ["--image-size", str(IMAGE), "--num-classes", str(N_CLASSES)]
    base = ["--arch", "vgg16", "--batchsize", str(VGG_BATCH),
            "--allreduce-grad-dtype", "bfloat16", "--prefetch", "2",
            "--lr", str(IMAGE_LR)] + size
    here = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            runs = []
            for name, epochs in (("twin", 1), ("twin", 2), ("plain", 2)):
                train = RecordingDataset(SyntheticImageDataset(
                    n, shape=shape, n_classes=min(N_CLASSES, 64), seed=0))
                t = time.perf_counter()
                entries, stdout, launches = twin(
                    base + ["--checkpoint", name, "--epoch", str(epochs)],
                    datasets=(train, val))
                runs.append({"entries": entries, "stdout": stdout,
                             "launches": launches, "seen": train.seen,
                             "wall_s": time.perf_counter() - t})
            first, resumed, plain = runs
            end1 = first["entries"][-1]["iteration"]
            check(end1 == TWIN_EPOCH_BATCHES + 1,
                  f"first run ended at {end1}")
            check(f"resumed from iteration {end1}" in resumed["stdout"],
                  "the second run did not resume from the first's snapshot")
            end2 = resumed["entries"][-1]["iteration"]
            check(end2 == plain["entries"][-1]["iteration"] == 2 * end1 - 1,
                  f"resumed run ended at {end2}")
            k = end2 - end1  # batches the resumed run consumed
            got = resumed["seen"][:k * VGG_BATCH]
            want = plain["seen"][end1 * VGG_BATCH:end2 * VGG_BATCH]
            check(got == want, "the resumed run's batches are not the "
                  "uninterrupted run's")
            sizes = wire_bucket_sizes(first["stdout"])
            cast_exact_covering("vgg16 twin", sizes)
            buckets = len(sizes)
            for r in runs:
                its = (r["entries"][-1]["iteration"]
                       - (end1 if r is resumed else 0))
                check(r["launches"] == 2 * buckets * its,
                      f"twin K1 launches {r['launches']} != 2 x {buckets} x "
                      f"{its}")
                check(all(np.isfinite(e[key]) for e in r["entries"]
                          for key in ("loss", "val/loss")),
                      f"non-finite twin losses: {r['entries']}")
            # a flipped byte drops the newest step from the inventory (the
            # agreement is host work: a gloo group)
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
            try:
                comm = create_communicator("pure_nccl")
                ckpt = create_multi_node_checkpointer("twin", comm)
                newest = ckpt.newest_common_step()
                check(newest == end2, f"newest step {newest} != {end2}")
                path = os.path.join("checkpoints", "twin",
                                    f"step_{newest:012d}", "tensors.pt")
                with open(path, "r+b") as f:
                    f.seek(os.path.getsize(path) // 2)
                    byte = f.read(1)
                    f.seek(-1, os.SEEK_CUR)
                    f.write(bytes([byte[0] ^ 0x10]))
                elected = create_multi_node_checkpointer(
                    "twin", comm).newest_common_step()
                check(elected == end1, f"a corrupt step was elected: {elected}")
            finally:
                dist.destroy_process_group()
            out["vgg16_twin"] = {
                "first_end": end1, "resumed_end": end2,
                "batches_match": True, "corrupt_elected": elected,
                "buckets": buckets,
                "launches": [r["launches"] for r in runs],
                "wall_s": [r["wall_s"] for r in runs],
                "final": [r["entries"][-1] for r in runs]}
            log("vgg16 twin checkpointed: " + json.dumps(out["vgg16_twin"]))

            out["archs"] = {}
            for tag in OTHER_ARCHS:
                entries, stdout, launches = twin(
                    ["--arch"] + tag.split() + size + [
                        "--batchsize", str(VGG_BATCH), "--n-train",
                        str(ARCH_BATCHES_AN_EPOCH * VGG_BATCH), "--n-val",
                        str(VGG_BATCH), "--allreduce-grad-dtype", "bfloat16",
                        "--lr", str(IMAGE_LR)])
                final = entries[-1]
                its = final["iteration"]
                sizes = wire_bucket_sizes(stdout)
                cast_exact_covering(f"twin {tag}", sizes)
                buckets = len(sizes)
                check(its == ARCH_BATCHES_AN_EPOCH + 1, f"{tag}: {its} its")
                check(np.isfinite(final["loss"])
                      and np.isfinite(final["val/loss"]),
                      f"{tag}: non-finite losses {final}")
                check(launches == 2 * buckets * its,
                      f"{tag}: K1 launches {launches} != 2 x {buckets} x {its}")
                out["archs"][tag] = {
                    "iterations": its, "buckets": buckets,
                    "launches": launches, "loss": final["loss"],
                    "val_loss": final["val/loss"],
                    "step_ms": 1e3 * VGG_BATCH / final["samples_per_sec"]}
                log(f"twin {tag}: " + json.dumps(out["archs"][tag]))
        finally:
            os.chdir(here)
    return out


# Phase 12, model parallelism: the JAX bench's seq2seq configuration
# (bench.py:991-994, config_seq2seq_mp) and its seq2seq_mp1 split; the
# pipeline's microbatches (benchmarks/pipeline_seq2seq.py's n_micro)
S2S_VOCAB, S2S_UNITS, S2S_LAYERS, S2S_SEQ, S2S_BATCH = 8192, 512, 2, 40, 64
S2S_LR, S2S_STEPS, S2S_MICRO = 1e-3, 6, 4
# the chain at world 1 runs the monolithic model's modules in the same
# order on the same card: loss and gradients within 1e-6 (relative)
S2S_CHAIN_GAP = 1e-6
# the one-stage pipeline sums its 4 microbatches' token losses where the
# unpipelined step takes one mean (and cuDNN picks per batch size):
# losses within 1e-5 relative, parameters after the steps within 3e-5
# with 99.9 % of entries within 1e-6 (the CPU parity tests' Adam bound)
S2S_PIPE_LOSS_GAP, S2S_PIPE_STEPS = 1e-5, 3
# kinds of kernel in a seq2seq step, by name (first match wins)
S2S_KINDS = (
    ("LSTM (cuDNN)", ("rnn", "lstm")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "sm90_", "sm80_", "xmma")),
    ("softmax and loss", ("softmax", "nll", "cross_entropy")),
    ("embedding", ("embedding",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise and copies", ("",)),
)


def s2s_batch(device, low=1):
    """The bench's resident batch: source and target tokens drawn from
    RandomState(SEED) in [low, vocab)."""
    rng = np.random.RandomState(SEED)
    shape = (S2S_BATCH, S2S_SEQ)
    return tuple(torch.from_numpy(rng.randint(low, S2S_VOCAB, shape)).to(device)
                 for _ in range(2))


def s2s_loss(logits, tgt):
    """bench.py's seq2seq loss: next-token cross entropy, the mean."""
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tgt[:, 1:].reshape(-1))


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def seq2seq_phase():
    """The model-parallel main path on one card (see the module
    docstring, phase 12)."""
    import torch.distributed as dist

    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.examples.train_seq2seq_mp1 import make_chain
    from chainermn_tpu_torch.models import Seq2Seq, translate

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = create_communicator("pure_nccl")
        device = comm.device
        t0 = time.perf_counter()
        chain = make_chain(comm, S2S_VOCAB, S2S_UNITS, S2S_LAYERS)
        enc, dec = chain.stage_modules
        check(chain.stage_rank(0) == chain.stage_rank(1) == 0,
              "both stages belong on rank 0 of a world of one")
        opt = chain.optimizer(torch.optim.Adam, lr=S2S_LR)
        step = chain.value_and_grad(s2s_loss)
        src, tgt = s2s_batch(device)
        x = [src, tgt]
        n_params = sum(p.numel() for p in chain.parameters())
        log(f"seq2seq: {n_params} params in 2 stages on {device}; vocab "
            f"{S2S_VOCAB}, {S2S_UNITS} units, {S2S_LAYERS} layers, "
            f"{S2S_BATCH} x {S2S_SEQ}; set up in "
            f"{time.perf_counter() - t0:.1f}s")

        # the chain against the monolithic model on the same weights
        mono = Seq2Seq(S2S_VOCAB, S2S_VOCAB, S2S_UNITS, S2S_LAYERS).to(device)
        mono.encoder.load_state_dict(enc.encoder.state_dict())
        mono.decoder.load_state_dict(dec.decoder.state_dict())
        opt.zero_grad()
        loss_chain = float(step(x, tgt))
        loss_mono = s2s_loss(mono(src, tgt), tgt)
        loss_mono.backward()
        grads = [p.grad for m in (enc.encoder, dec.decoder)
                 for p in m.parameters()]
        mono_grads = [p.grad for m in (mono.encoder, mono.decoder)
                      for p in m.parameters()]
        loss_gap = abs(loss_chain - loss_mono.item()) / abs(loss_mono.item())
        grad_gap = max(rel_l2(a, b) for a, b in zip(grads, mono_grads))
        log(f"seq2seq chain vs monolithic Seq2Seq (same weights, same "
            f"card): loss {loss_chain:.7f} vs {loss_mono.item():.7f}, "
            f"relative gap {loss_gap:.3e}; largest gradient gap {grad_gap:.3e}"
            f" relative L2 over {len(grads)} arrays (bound {S2S_CHAIN_GAP})")
        check(loss_gap <= S2S_CHAIN_GAP and grad_gap <= S2S_CHAIN_GAP,
              f"chain vs monolithic: loss {loss_gap}, gradients {grad_gap}")
        opt.step()  # the warm-up step

        def train_step(_=None):
            opt.zero_grad()
            loss = step(x, tgt)
            opt.step()
            return {"loss": loss}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = timed_steps(train_step, None, S2S_STEPS)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"non-finite seq2seq loss: {losses}")
        median_ms = float(np.median(times))
        tokens = S2S_BATCH * S2S_SEQ * 2  # enc + dec, the bench's count
        tps = tokens / (median_ms / 1e3)
        log(f"seq2seq chain: {S2S_STEPS} Adam steps: losses {losses}; step "
            f"ms {[round(t, 3) for t in times]} (median {median_ms:.3f}); "
            f"{tps:.1f} tokens/s ({tokens} a step); peak memory "
            f"{peak / 2**30:.3f} GiB")
        busy, wall, n_kernels, kernels = profile_train_step(train_step, None)
        idle = 1 - busy / median_ms
        shares = kernel_categories(kernels, S2S_KINDS)
        log(f"profile seq2seq step: device busy {busy:.3f} ms in {n_kernels}"
            f" kernel launches; the profiled step took {wall:.3f} ms, the "
            f"unprofiled ones {median_ms:.3f} ms (median): idle share "
            f"{idle:.1%} of an unprofiled step")
        for e in kernels[:10]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} "
                f"{e.key[:90]}")
        log("profile seq2seq step by kind: " + ", ".join(
            f"{k} {ms:.3f} ms ({ms / busy:.1%}, {n} launches)"
            for k, (ms, n) in shares.items()))

        # greedy translation of one batch, timed per token
        mono.eval()
        translate(mono, src[:2], max_length=2)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        hyp = translate(mono, src, max_length=S2S_SEQ)  # ends on the host
        tr_ms = (time.perf_counter() - t) * 1e3
        check(hyp.shape == (S2S_BATCH, S2S_SEQ), f"translate {hyp.shape}")
        log(f"seq2seq translate: {S2S_BATCH} sources x {S2S_SEQ} greedy "
            f"steps in {tr_ms:.3f} ms: {tr_ms / S2S_SEQ:.3f} ms a step, "
            f"{S2S_BATCH * S2S_SEQ / (tr_ms / 1e3):.1f} tokens/s")
        pipe = seq2seq_pipeline_check(comm)
        return {"params": n_params, "chain_loss_gap": loss_gap,
                "chain_grad_gap": grad_gap, "losses": losses,
                "step_ms": times, "median_step_ms": median_ms,
                "tokens_per_s": tps, "peak_gib": peak / 2**30,
                "device_busy_ms": busy, "profiled_step_ms": wall,
                "launches": n_kernels, "idle_share": idle,
                "device_ms_by_kind": {k: v[0] for k, v in shares.items()},
                "launches_by_kind": {k: v[1] for k, v in shares.items()},
                "translate_ms_per_step": tr_ms / S2S_SEQ, "pipeline": pipe}
    finally:
        dist.destroy_process_group()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def seq2seq_pipeline_check(comm):
    """A one-stage build_pipeline_train_step (the encoder and the decoder
    in one stage, S2S_MICRO microbatches) against the unpipelined step on
    the same union parameters and batch, S2S_PIPE_STEPS Adam steps each,
    timed; at world 1 that is all a card can show of the schedule."""
    from chainermn_tpu_torch.parallel import (build_pipeline_train_step,
                                              place_stage_params)
    from chainermn_tpu_torch.parallel.seq2seq_pipeline import (
        Seq2SeqStages, carry_width, pack_batch, pipeline_loss, union_params)

    stages = Seq2SeqStages(comm, S2S_VOCAB, S2S_UNITS, S2S_LAYERS, S2S_SEQ)
    stacked = union_params(stages.enc, stages.dec, 1)
    src, ys = s2s_batch(comm.device, low=3)
    packed = pack_batch(src, ys, S2S_MICRO,
                        carry_width(S2S_UNITS, S2S_LAYERS, S2S_SEQ))
    sp = place_stage_params(stacked, comm)
    pstep = build_pipeline_train_step(
        comm, stages, pipeline_loss, torch.optim.Adam(sp.values(), lr=S2S_LR),
        n_micro=S2S_MICRO, remat=False)
    twin = place_stage_params(stacked, comm)
    topt = torch.optim.Adam(twin.values(), lr=S2S_LR)

    def twin_step():
        topt.zero_grad()
        loss = stages.unpipelined_loss(twin, src, ys)
        loss.backward()
        topt.step()
        return loss.detach()

    got, want, got_ms, want_ms = [], [], [], []
    for _ in range(S2S_PIPE_STEPS):
        for fn, out, ms in ((lambda: pstep(sp, (packed, None))["loss"], got,
                             got_ms), (twin_step, want, want_ms)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(float(fn()))
            ms.append((time.perf_counter() - t) * 1e3)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    gap = torch.cat([(sp[k] - twin[k]).detach().abs().flatten()
                     for k in sp])
    share = float((gap < 1e-6).float().mean())
    log(f"seq2seq pipeline, 1 stage x {S2S_MICRO} microbatches vs the "
        f"unpipelined step: losses {got} vs {want} (largest relative gap "
        f"{loss_gap:.3e}); parameters after {S2S_PIPE_STEPS} Adam steps: "
        f"largest gap {float(gap.max()):.3e}, {share:.4%} within 1e-6; step "
        f"ms {[round(t, 3) for t in got_ms]} vs {[round(t, 3) for t in want_ms]}"
        f"")
    check(loss_gap <= S2S_PIPE_LOSS_GAP, f"pipeline loss gap {loss_gap}")
    check(float(gap.max()) < 3e-5 and share >= 0.999,
          f"pipeline parameters: gap {float(gap.max())}, {share} within 1e-6")
    return {"losses": got, "twin_losses": want, "loss_gap": loss_gap,
            "param_gap": float(gap.max()), "share_within_1e-6": share,
            "step_ms": got_ms, "twin_step_ms": want_ms}


def seq2seq_twins_phase():
    """The seq2seq examples' twins on the card at their defaults, two
    epochs each: the data-parallel one through Trainer (its loss falls)
    and seq2seq_mp1 (finite validation metrics)."""
    import contextlib
    import io
    import tempfile

    from chainermn_tpu_torch.examples import train_seq2seq, train_seq2seq_mp1

    here = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name, module in (("train_seq2seq", train_seq2seq),
                                 ("train_seq2seq_mp1", train_seq2seq_mp1)):
                buf = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    res = module.main(["--epoch", "2"])
                wall = time.perf_counter() - t
                for line in buf.getvalue().strip().splitlines():
                    log("  | " + line)
                out[name] = {"result": res, "wall_s": wall}
        finally:
            os.chdir(here)
    log_ = out["train_seq2seq"]["result"]
    check(len(log_) == 2 and log_[1]["loss"] < log_[0]["loss"],
          f"seq2seq twin loss does not fall: {log_}")
    m = out["train_seq2seq_mp1"]["result"]
    check(all(np.isfinite(v) for v in m.values()), f"mp1 twin: {m}")
    log(f"seq2seq twins: data-parallel {out['train_seq2seq']['wall_s']:.1f} s"
        f" (final {json.dumps(log_[-1])}), mp1 "
        f"{out['train_seq2seq_mp1']['wall_s']:.1f} s ({json.dumps(m)})")
    return {k: {"wall_s": v["wall_s"]} for k, v in out.items()} | {
        "dp_final": log_[-1], "mp1_final": m}


# ----------------------------------------------------------------------
# Phase 13, the optimizer's tier 2 on one card (world 1: nothing moves
# on the wire, so double buffering and overlap hide nothing; the phase
# proves the paths and measures their cost)
# ----------------------------------------------------------------------
# BASELINE config 3 as bench.py:212-231 runs it (double_buffering=True),
# at bench.py:565's VGG16 batch; 1 + 6 steps a leg (double buffering:
# 2 + 6, the second step checked against the plain leg's first)
TIER2_VGG_STEPS = 6
# benchmarks/transformer_mfu.py:212 b16_remat (batch 16, remat) with
# ZeRO-1 and accumulation; 1 + 4 steps a leg
TIER2_LM_BATCH, TIER2_LM_STEPS = 16, 4
# the LM's parity bound (tests/test_torch_lm_training.py): every entry
# within 3e-5 and 99.9 % within 1e-6
LM_PARAM_ATOL, LM_PARAM_SHARE = 3e-5, 0.999


def params_of(model):
    return [p.detach().clone() for p in model.parameters()]


def param_gap(a, b):
    """Largest gap and the share of entries within 1e-6."""
    worst, close, n = 0.0, 0, 0
    for x, y in zip(a, b):
        d = (x.float() - y.float()).abs()
        worst = max(worst, float(d.max()))
        close += int((d <= 1e-6).sum())
        n += d.numel()
    return worst, close / n


def tier2_vgg16_legs(comm):
    """VGG16 at full width (batch 64, 224^2, bf16 wire, SGD 0.01 momentum
    0.9, dropout from a seeded generator), each leg from the same
    initial weights: plain, double buffering, overlap="bucket"; cuDNN's
    deterministic algorithms, so that the legs' gradients are
    comparable bit for bit."""
    from chainermn_tpu_torch import build_train_step, create_multi_node_optimizer
    from chainermn_tpu_torch.models import VGG16, flax_ordered_parameters
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

    batch = image_batch(comm.device, VGG_BATCH)
    legs, kept = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for leg, kw in (("plain", {}), ("double_buffering",
                                        dict(double_buffering=True)),
                        ("overlap", dict(overlap="bucket"))):
            model = VGG16(num_classes=N_CLASSES, seed=SEED,
                          image_size=IMAGE).to(comm.device)
            opt = create_multi_node_optimizer(torch.optim.SGD(
                [p for _, p in flax_ordered_parameters(model)], lr=IMAGE_LR,
                momentum=0.9), comm, **kw)
            gen = torch.Generator(device=comm.device).manual_seed(SEED)
            step = build_train_step(
                comm, lambda b: softmax_cross_entropy(
                    model(b[0], generator=gen), b[1]), opt)
            plan = opt.wire_plan()
            p0 = params_of(model)
            check(np.isfinite(float(step(batch)["loss"])),
                  f"vgg16 {leg}: warm-up loss not finite")
            if leg == "plain":
                kept["step1"] = params_of(model)
            elif leg == "double_buffering":
                check(all(torch.equal(a, b) for a, b in
                          zip(params_of(model), p0)),
                      "double buffering: step 1 moved a parameter")
                step(batch)
                check(all(torch.equal(a, b) for a, b in
                          zip(params_of(model), kept["step1"])),
                      "double buffering: step 2 is not the plain step 1, "
                      "bit for bit")
                log("vgg16 double buffering: step 1 left all "
                    f"{len(p0)} parameters unchanged; step 2 equals the "
                    "plain leg's step 1 bit for bit")
            del p0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fcs.fused_cast_scale.launches = 0
            losses, times = timed_steps(step, batch, TIER2_VGG_STEPS)
            launches = fcs.fused_cast_scale.launches
            peak = torch.cuda.max_memory_allocated()
            per = 3 if leg == "double_buffering" else 2
            want = per * plan.n_buckets * TIER2_VGG_STEPS
            check(launches == want, f"vgg16 {leg}: fused_cast_scale launches"
                  f" {launches} != {per} x {plan.n_buckets} x "
                  f"{TIER2_VGG_STEPS}")
            check(all(np.isfinite(losses)), f"vgg16 {leg}: {losses}")
            median = float(np.median(times))
            log(f"vgg16 {leg}: {TIER2_VGG_STEPS} steps: losses {losses}; "
                f"step ms {[round(t, 3) for t in times]} (median "
                f"{median:.3f}); {VGG_BATCH / median * 1e3:.1f} images/s; "
                f"peak {peak / 2**30:.2f} GiB; fused_cast_scale launches "
                f"{launches} = {per} x {plan.n_buckets} buckets x "
                f"{TIER2_VGG_STEPS} steps")
            if leg == "overlap":
                report = opt.issue_report
                log(f"vgg16 overlap issue record (bucket, parameters still "
                    f"without a gradient, from the backward): {report}")
                check([r.bucket for r in report]
                      == list(range(plan.n_buckets))[::-1]
                      and all(r.in_backward for r in report),
                      f"vgg16 overlap issue record {report}")
            busy, wall, idle, shares = image_step_profile(
                f"vgg16 {leg}", step, batch, median)
            if leg == "plain":
                kept["final"] = params_of(model)
            elif leg == "overlap":
                check(all(torch.equal(a, b) for a, b in
                          zip(params_of(model), kept["final"])),
                      "overlap: parameters after the steps differ from the "
                      "synchronous leg's")
                log("vgg16 overlap: parameters after 1 + 6 steps and a "
                    "profiled step equal the synchronous leg's bit for bit")
            legs[leg] = {"launches": launches, "losses": losses,
                         "step_ms": times, "median_step_ms": median,
                         "images_per_s": VGG_BATCH / median * 1e3,
                         "peak_gib": peak / 2**30, "device_busy_ms": busy,
                         "profiled_step_ms": wall, "idle_share": idle,
                         "buckets": plan.n_buckets}
            del model, opt, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return legs


def tier2_lm_legs(comm):
    """The headline TransformerLM at batch 16 x 2048 (AdamW 3e-4, weight
    decay 0.01), each leg from the same weights: plain, remat=True,
    zero_redundancy=True, accum_steps=2, and all three; K2-K4 launches
    counted a step.  Parameters after the steps: ZeRO equal to plain bit
    for bit (world 1, the same elementwise AdamW), remat within the LM
    bound of plain (the same kernels again: expected equal), the three
    together within the LM bound of ``accum_steps=2`` alone; the
    accumulation itself rounds its bf16 weight gradients per microbatch,
    so it is held to plain within 2 lr a step and its losses within
    1e-4."""
    from chainermn_tpu_torch import build_train_step, create_multi_node_optimizer
    from chainermn_tpu_torch.models import flax_ordered_parameters

    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, VOCAB, (TIER2_LM_BATCH, TRAIN_SEQ))).to(comm.device)
    legs, kept = {}, {}
    for leg, opt_kw, step_kw in (
            ("plain", {}, {}), ("remat", {}, dict(remat=True)),
            ("zero", dict(zero_redundancy=True), {}),
            ("accum2", {}, dict(accum_steps=2)),
            ("zero_accum2_remat", dict(zero_redundancy=True),
             dict(accum_steps=2, remat=True))):
        lm = TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, max_len=MAX_LEN,
                           dtype=torch.bfloat16, seed=SEED,
                           attention_fn=fa.flash_attention_fn()
                           ).to(comm.device)
        opt = create_multi_node_optimizer(
            torch.optim.AdamW([p for _, p in flax_ordered_parameters(lm)],
                              lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=0.01), comm, **opt_kw)
        step = build_train_step(comm, lambda t: lm_loss(lm(t), t), opt,
                                **step_kw)
        check(np.isfinite(float(step(tokens)["loss"])),
              f"lm {leg}: warm-up loss not finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        losses, times = timed_steps(step, tokens, TIER2_LM_STEPS)
        launches = flash_counts()
        peak = torch.cuda.max_memory_allocated()
        micro = step_kw.get("accum_steps", 1)
        fwd = 2 if step_kw.get("remat") else 1
        want = {"flash_forward": N_LAYERS * micro * fwd * TIER2_LM_STEPS,
                "flash_backward_dq": N_LAYERS * micro * TIER2_LM_STEPS,
                "flash_backward_dkv": N_LAYERS * micro * TIER2_LM_STEPS}
        check(launches == want, f"lm {leg}: flash launches {launches} != "
              f"{want}")
        check(all(np.isfinite(losses)), f"lm {leg}: {losses}")
        median = float(np.median(times))
        rec = {"launches": launches, "losses": losses, "step_ms": times,
               "median_step_ms": median,
               "tokens_per_s": TIER2_LM_BATCH * TRAIN_SEQ / median * 1e3,
               "peak_gib": peak / 2**30}
        params = params_of(lm)
        kept[leg] = params
        if leg != "plain":
            ref = "accum2" if leg == "zero_accum2_remat" else "plain"
            worst, share = param_gap(params, kept[ref])
            loss_gap = max(abs(a - b) / abs(b) for a, b in
                           zip(losses, legs[ref]["losses"]))
            rec.update(against=ref, max_gap=worst, share_within_1e6=share,
                       loss_gap=loss_gap)
            if leg == "zero":
                check(worst == 0.0, f"lm zero: {worst} from the plain leg")
            elif leg == "accum2":
                # bf16 weight gradients are rounded per microbatch, so a
                # near-zero entry's Adam update may change sign: at most
                # 2 lr a step
                bound = 2 * 3e-4 * (1 + TIER2_LM_STEPS)
                check(worst <= bound and loss_gap <= 1e-4,
                      f"lm accum2: gap {worst} (bound {bound}), loss gap "
                      f"{loss_gap}")
            else:
                check(worst <= LM_PARAM_ATOL and share >= LM_PARAM_SHARE,
                      f"lm {leg}: gap {worst}, {share:.6f} within 1e-6")
        if leg == "zero":
            rec["hbm_bytes"] = opt.hbm_bytes_per_rank()
        log(f"lm {leg}: {TIER2_LM_STEPS} steps of {TIER2_LM_BATCH}x"
            f"{TRAIN_SEQ}: losses {losses}; step ms "
            f"{[round(t, 3) for t in times]} (median {median:.3f}); "
            f"{rec['tokens_per_s']:.1f} tokens/s; peak {peak / 2**30:.2f} "
            f"GiB; flash launches {json.dumps(launches)} = {N_LAYERS} "
            f"layers x {micro} microbatches x {TIER2_LM_STEPS} steps (the "
            f"forward x{fwd}); "
            + (f"against {rec['against']}: largest gap {rec['max_gap']:.3e}"
               f", {rec['share_within_1e6']:.6%} within 1e-6, loss gap "
               f"{rec['loss_gap']:.3e}" if leg != "plain" else "")
            + (f"; bytes a rank holds {rec['hbm_bytes']}"
               if leg == "zero" else ""))
        legs[leg] = rec
        del lm, opt, step, params
        torch.cuda.empty_cache()
    worst, share = param_gap(kept["zero_accum2_remat"], kept["plain"])
    legs["zero_accum2_remat"].update(gap_to_plain=worst,
                                     share_within_1e6_of_plain=share)
    log(f"lm all three against plain: largest gap {worst:.3e}, "
        f"{share:.6%} within 1e-6")
    return legs


def tier2_phase():
    """Phase 13 (see the module docstring): the VGG16 legs and the LM
    legs on a 1-rank NCCL group."""
    import torch.distributed as dist

    from chainermn_tpu_torch import create_communicator

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = create_communicator("pure_nccl",
                                   allreduce_grad_dtype=torch.bfloat16)
        log("tier 2: world 1 (one card): every all-reduce moves nothing, "
            "so double buffering and overlap hide nothing here; the legs "
            "prove the paths and measure their cost")
        vgg = tier2_vgg16_legs(comm)
        lm_comm = create_communicator("pure_nccl")
        lm = tier2_lm_legs(lm_comm)
        return {"vgg16": vgg, "lm": lm}
    finally:
        dist.destroy_process_group()


def build_all():
    """Every kernel source built from the checkout, in parallel (one
    nvcc each); prints build time, registers, shared memory and spills
    per kernel."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("flash_decode", "flash_attention", "flash_attention_sm90",
             "fused_cast_scale")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        texts = dict(zip(names, pool.map(_build.build, names)))
    log(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f}s "
        f"(in parallel)")
    for name, text in texts.items():
        kernel = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"  {name} {kernel}: {line.strip()}")
                k = re.fullmatch(r"(flash_\w+_kernel)<(\w+),(\d+)>",
                                 kernel or "")
                if k and k[1] in FLASH_KERNEL_OF:
                    key = (FLASH_KERNEL_OF[k[1]], k[2], int(k[3]))
                    for field, pat in (("registers", r"Used (\d+) registers"),
                                       ("spill_stores",
                                        r"(\d+) bytes spill stores")):
                        v = re.search(pat, line)
                        if v:
                            PTXAS.setdefault(key, {})[field] = int(v[1])
    log("  flash attention dynamic shared memory a block: " + ", ".join(
        f"{k} {str(dt).split('.')[-1]} d{d} {fa.smem_bytes(k, d, dt)} bytes"
        for k in FLASH_KERNELS for dt in (torch.bfloat16, torch.float32)
        for d in (64, 128)))
    for key, rec in sorted(PTXAS.items()):
        if key[1] == "bf16" and key[0] in FLASH_KERNELS:
            check(rec.get("spill_stores") == 0,
                  f"ptxas spill in {key}: {rec}")


# ptxas registers a thread and spill stores of the flash kernels, by
# (wrapper, "bf16" or "f32", d), from build_all
PTXAS = {}
FLASH_KERNEL_OF = {
    "flash_fwd_kernel": "flash_forward",
    "flash_fwd_sm90_kernel": "flash_forward",
    "flash_bwd_dq_kernel": "flash_backward_dq",
    "flash_bwd_dq_sm90_kernel": "flash_backward_dq",
    "flash_bwd_dkv_kernel": "flash_backward_dkv",
    "flash_bwd_dkv_sm90_kernel": "flash_backward_dkv",
    "flash_decode_kernel": "flash_decode",
}
TYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


# type names in the kernels' mangled names
MANGLED_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
# the type of the flash kernels that are templates on d alone
FLASH_ENTRY_TYPES = {"flash_fwd_kernel": "f32", "flash_bwd_dq_kernel": "f32",
                     "flash_bwd_dkv_kernel": "f32",
                     "flash_fwd_sm90_kernel": "bf16",
                     "flash_bwd_dq_sm90_kernel": "bf16",
                     "flash_bwd_dkv_sm90_kernel": "bf16"}


def kernel_name(mangled):
    """A kernel's template instance from its mangled name, as
    ``name<type,...>``."""
    types = "|".join(MANGLED_TYPES)
    k = re.search(
        rf"(flash_[a-z_]+?(?:_sm90)?_kernel)I(?:({types}))?Li(\d+)E", mangled)
    if k:
        t = MANGLED_TYPES[k[2]] if k[2] else FLASH_ENTRY_TYPES[k[1]]
        return f"{k[1]}<{t},{k[3]}>"
    k = re.search(rf"(fused_cast_scale_kernel)I({types})({types}|S1_)Li(\d+)E",
                  mangled)
    if k:
        a = MANGLED_TYPES[k.group(2)]
        b = a if k.group(3) == "S1_" else MANGLED_TYPES[k.group(3)]
        return f"{k.group(1)}<{a},{b},{k.group(4)}>"
    return mangled[:60]


def kernel_record(name, source, replaces, launches, r, dtype):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": dtype, "share_of_tolerance": r["share_of_tolerance"]}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA card", file=sys.stderr)
        return 1
    # the port and its kernel sources must be this checkout's, not an
    # installed copy elsewhere
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.dirname(os.path.abspath(chainermn_tpu_torch.__file__))
    if os.path.dirname(pkg) != here:
        print(f"chip_smoke: chainermn_tpu_torch was imported from {pkg}, "
              f"not from this checkout ({here})", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    build_all()

    rng = np.random.RandomState(SEED + 1)
    lengths = (rng.randint(PROMPT_MIN, PROMPT_MAX + NEW_TOKENS + 1,
                           CAPACITY)).tolist()
    lengths[3] = 0  # a padded slot
    log(f"flash_decode lengths: {lengths}")
    kern = kernel_phase(lengths)
    serve_path = serve_phase()
    flash = flash_kernel_phase()
    train_path = train_phase()
    plan = resnet50_plan()
    cast = cast_kernel_phase([b.size for b in plan.buckets])
    image_path = resnet_train_phase()
    check(image_path["buckets"] == plan.n_buckets, "ResNet-50 plan drifted")
    mnbn_path = mnbn_train_phase()
    check(mnbn_path["buckets"] == plan.n_buckets, "MNBN ResNet-50 plan drifted")
    trainer_path = trainer_phase(plan.n_buckets)
    vgg_path = vgg16_train_phase()
    archs_path = checkpointed_twin_phase()
    s2s_path = seq2seq_phase()
    s2s_twins = seq2seq_twins_phase()
    tier2 = tier2_phase()

    log("serve summary: " + json.dumps(serve_path))
    log("train summary: " + json.dumps(train_path))
    log("resnet50 summary: " + json.dumps(image_path))
    log("mnbn resnet50 summary: " + json.dumps(mnbn_path))
    log("resnet50 plain BatchNorm vs MNBN (median step ms, images/s, device "
        "busy ms, idle share, peak GiB): "
        + json.dumps({k: [p[k] if k != "step_ms" else float(np.median(p[k]))
                          for p in (image_path, mnbn_path)]
                      for k in ("step_ms", "images_per_s", "device_busy_ms",
                                "idle_share", "peak_gib")}))
    log("trainer summary: " + json.dumps(trainer_path))
    log("vgg16 summary: " + json.dumps(vgg_path))
    log("image archs summary: " + json.dumps(archs_path))
    log("seq2seq summary: " + json.dumps(s2s_path))
    log("seq2seq twins summary: " + json.dumps(s2s_twins))
    log("tier 2 summary: " + json.dumps(tier2))
    log("flash_decode float32: " + json.dumps(kern[torch.float32]))
    log("flash attention float32: " + json.dumps(flash[torch.float32]))
    # the kernels' record: each main path's type (bf16) at its shapes
    records = [kernel_record(
        "flash_decode", "chainermn_tpu_torch/ops/csrc/flash_decode.cu",
        "chainermn_tpu/ops/pallas_attention.py:1271",
        serve_path["launches"], kern[torch.bfloat16], "bfloat16")]
    records[0].update(tolerance=TOLERANCE[torch.bfloat16],
                      design=kern[torch.bfloat16]["design"])
    for name in FLASH_KERNELS:
        r = flash[torch.bfloat16][name]
        records.append(kernel_record(
            name, "chainermn_tpu_torch/ops/" + r["design"]["source"],
            FLASH_REPLACES[name], train_path["launches"][name], r,
            "bfloat16"))
        records[-1].update(tflops=r["tflops"],
                           share_of_bound=r["share_of_bound"],
                           design=r["design"],
                           launches_by_path={
                               "lm_batch8": train_path["launches"][name]} | {
                               f"lm_batch16_{leg}": rec["launches"][name]
                               for leg, rec in tier2["lm"].items()})
    # K1: means per launch over one ResNet-50 step's 2 x buckets launches
    records.append(kernel_record(
        "fused_cast_scale", "chainermn_tpu_torch/ops/csrc/fused_cast_scale.cu",
        "chainermn_tpu/ops/pallas_attention.py:1463", image_path["launches"],
        cast, "float32->bfloat16, bfloat16->float32"))
    records[-1].update(tolerance="bit-exact", per_step_ms=cast["per_step_ms"],
                       per_step_bound_ms=cast["per_step_bound_ms"],
                       bucket_sizes=[b.size for b in plan.buckets],
                       max_abs_err=max(r["max_abs_err"]
                                       for r in CAST_EXACT.values()),
                       exact_by_path=CAST_EXACT,
                       launches_by_path={
                           "resnet50": image_path["launches"],
                           "mnbn_resnet50_bf16": mnbn_path["launches"],
                           "vgg16": vgg_path["launches"]} | {
                           f"vgg16_tier2_{leg}": rec["launches"]
                           for leg, rec in tier2["vgg16"].items()} | {
                           "mnbn_resnet50_bf16_ef":
                               mnbn_path["lossy_wires"]["bf16_ef"]["launches"],
                           "mnbn_resnet50_int8_ef":
                               mnbn_path["lossy_wires"]["int8_ef"]["launches"]})
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
