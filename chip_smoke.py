#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Run from the repository root, with one card.  Phases:

1. the card's name and power limit (``nvidia-smi``), then the main
   path's kernel built from ``chainermn_tpu_torch/ops/csrc`` and the
   build time;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with the tolerance stated, and timed
   beside the plain version, one PyTorch library call computing the same
   function (timed here only, as a yardstick) and the least time the
   card could take (its bound);
3. the main path: the full-width TransformerLM served through
   ``ContinuousBatcher`` -> ``DecodeEngine(attention_impl="flash")``, with
   every kernel's launch count set to 0 just before and read just after;
   then the same stream through the dense attend, and a lockstep check
   of the two engines' logits on identical inputs;
4. a ``torch.profiler`` breakdown of a steady decode step for both
   attends (device time by kernel, launches per step, idle share, host
   ops), and the page allocator's host time per decode step.

Any failed check raises, so the script exits non-zero.  Without CUDA it
exits non-zero before printing any result.  The last two lines are the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chainermn_tpu_torch
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.ops import _build
from chainermn_tpu_torch.ops.flash_decode import (
    TOLERANCE, flash_decode, paged_decode_reference)
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
    """Mean ms per call of fn(layer), cycling through the layers so the
    working set (all layers' live pages) exceeds the 50 MB L2 cache as
    in a decode step; CUDA events around the timed loop."""
    for i in range(2 * n_layers):
        fn(i % n_layers)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
            N_LAYERS, 50 * N_LAYERS)
        plain_ms = cuda_time_ms(
            lambda i: paged_decode_reference(q, k[i], v[i], tables, lens),
            N_LAYERS, 5 * N_LAYERS)
        library_ms = None
        if dtype == torch.bfloat16:
            library_ms = sdpa_time_ms(q, k, v, tables, lens)
        bound_ms, bound_by = flash_decode_bound(lengths, dtype)
        log(f"flash_decode {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms, library {library_ms} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of bound")

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
            f"output bit-identical")
        rec[dtype] = dict(max_abs_err=err, share_of_tolerance=used, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
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

    t0 = time.perf_counter()
    text = _build.build("flash_decode")
    log(f"build: flash_decode in {time.perf_counter() - t0:.2f}s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  flash_decode: {line.strip()}")

    rng = np.random.RandomState(SEED + 1)
    lengths = (rng.randint(PROMPT_MIN, PROMPT_MAX + NEW_TOKENS + 1,
                           CAPACITY)).tolist()
    lengths[3] = 0  # a padded slot
    log(f"flash_decode lengths: {lengths}")
    kern = kernel_phase(lengths)
    main_path = serve_phase()

    log("serve summary: " + json.dumps(main_path))
    log("flash_decode float32: " + json.dumps(kern[torch.float32]))
    # the kernels' record: the main path's type (bf16) at the serving shapes
    bf16 = kern[torch.bfloat16]
    print(json.dumps({"kernels": [{
        "name": "flash_decode",
        "route": "cuda",
        "source": "chainermn_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "chainermn_tpu/ops/pallas_attention.py:1271",
        "launches": main_path["launches"],
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "dtype": "bfloat16",
        "tolerance": TOLERANCE[torch.bfloat16],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
