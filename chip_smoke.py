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
9. the Trainer path: the MNIST example's twin (MLP, bf16 wire) through
   ``Trainer`` + ``Evaluator`` + the reports for a few epochs, then the
   ImageNet example's twin with ResNet-50 for a few iterations, each
   with K1's count set to 0 just before and read just after.

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


def cast_kernel_phase(bucket_sizes):
    """K1 against its plain version, bit for bit (NaN positions as
    positions), for every dtype pair at sizes 1, 7 and 1027, an odd-offset
    view into a larger buffer and every bucket size, at each scale; then
    timed on the main path's launches (each bucket fp32 -> bf16 to the
    wire, bf16 -> fp32 back; scale 1 at world 1) beside its plain
    version, Tensor.to (the one PyTorch call computing the scale-1 leg)
    and its bound.  Returns the record: per-launch means over one step's
    launches."""
    big = max(bucket_sizes)
    n_cases, err = 0, 0.0
    for src in CAST_DTYPES:
        buf = cast_input(big + 8, src, 1)
        xs = [cast_input(n, src, n) for n in (1, 7, 1027)]
        xs.append(buf[3:3 + 70001])  # odd element offset
        xs += [buf[:n] for n in bucket_sizes]
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
    log(f"fused_cast_scale: bit-exact against its plain version in "
        f"{n_cases} cases, max_abs_err={err} over the finite outputs (3 x 3 dtype pairs, sizes 1, 7, 1027, an odd-offset "
        f"view of 70001 and the buckets {list(bucket_sizes)}, scales "
        f"{[round(s, 6) for s in CAST_SCALES]})")

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


def image_batch(device):
    """The resident synthetic batch of bench.py:249-256 (seed 0 images,
    seed 1 labels)."""
    x = np.random.RandomState(0).randn(IMAGE_BATCH, IMAGE, IMAGE, 3)
    y = np.random.RandomState(1).randint(0, N_CLASSES, (IMAGE_BATCH,))
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


def kernel_categories(kernels):
    """{kind: (device ms, launches)} of profiled kernels."""
    out = {k: [0.0, 0] for k, _ in KERNEL_KINDS}
    for e in kernels:
        name = e.key.lower()
        kind = next(k for k, pats in KERNEL_KINDS
                    if any(p in name for p in pats))
        out[kind][0] += e.self_device_time_total / 1e3
        out[kind][1] += e.count
    return {k: tuple(v) for k, v in out.items()}


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

        busy, wall, n_kernels, kernels = profile_train_step(step, batch)
        # the profiler's own cost per launch stretches the profiled step
        # (thousands of launches), not the kernels: idle share against
        # the unprofiled steps
        idle = 1 - busy / median_ms
        log(f"profile resnet50 step: device busy {busy:.3f} ms in "
            f"{n_kernels} kernel launches; the profiled step took {wall:.3f}"
            f" ms on the host clock, the unprofiled ones {median_ms:.3f} ms "
            f"(median): "
            f"idle share {idle:.1%} of an unprofiled step")
        for e in kernels[:10]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} "
                f"{e.key[:90]}")
        shares = kernel_categories(kernels)
        log("profile resnet50 step by kind: " + ", ".join(
            f"{k} {ms:.3f} ms ({ms / busy:.1%}, {n} launches)"
            for k, (ms, n) in shares.items()))
        return {"launches": launches, "steps": IMAGE_STEPS,
                "buckets": plan.n_buckets, "losses": losses,
                "step_ms": times, "images_per_s": ips,
                "peak_gib": peak / 2**30, "device_busy_ms": busy,
                "profiled_step_ms": wall, "idle_share": idle,
                "device_ms_by_kind": {k: v[0] for k, v in shares.items()},
                "none_step_ms": times_none, "bf16_again_step_ms": times_again}
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
    trainer_path = trainer_phase(plan.n_buckets)

    log("serve summary: " + json.dumps(serve_path))
    log("train summary: " + json.dumps(train_path))
    log("resnet50 summary: " + json.dumps(image_path))
    log("trainer summary: " + json.dumps(trainer_path))
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
                           design=r["design"])
    # K1: means per launch over one ResNet-50 step's 2 x buckets launches
    records.append(kernel_record(
        "fused_cast_scale", "chainermn_tpu_torch/ops/csrc/fused_cast_scale.cu",
        "chainermn_tpu/ops/pallas_attention.py:1463", image_path["launches"],
        cast, "float32->bfloat16, bfloat16->float32"))
    records[-1].update(tolerance="bit-exact", per_step_ms=cast["per_step_ms"],
                       per_step_bound_ms=cast["per_step_bound_ms"],
                       bucket_sizes=[b.size for b in plan.buckets])
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
