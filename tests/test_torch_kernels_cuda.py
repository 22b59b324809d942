"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from chainermn_tpu_torch.ops.flash_decode import (
    TOLERANCE,
    decode_splits,
    design,
    flash_decode,
    paged_decode_reference,
)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("d_head", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_decode_matches_plain_version(dtype, d_head):
    """The split-K sm_90a kernel against its plain version at the
    serving geometry (8 slots, 8 heads, 16-token pages, 128 pages a
    slot) for four sets of lengths: ragged with a length-0 slot;
    lengths of 1 and at a split boundary and one position either side
    (a slot of 2 * splits pages gives each split 2 pages); every slot
    at 2048; one long slot among short ones.  Each with NaN-poisoned
    dead pages (never read, so the output does not move), and two
    calls bit-identical (the splits merge in a fixed order).
    Tolerance: ``TOLERANCE``, one bf16 ulp of each element (the two
    fp32 results may straddle a rounding boundary); fp32 by summation
    order over up to 2048 positions."""
    _need_card()
    dt = getattr(torch, dtype)
    b, h, ps, pps = 8, 8, 16, 128
    splits = decode_splits(b, h, pps, torch.cuda.get_device_properties(
        0).multi_processor_count)
    # the chunk tests/test_torch_flash_decode_split.py emulates: 8 KB of
    # K and V rows
    size = torch.finfo(dt).bits // 8
    assert design(dt, d_head, b, h, pps)["chunk_rows"] * 2 * d_head * size \
        == 8192
    edge = 2 * splits * ps
    length_sets = [[1, 17, 64, 300, 0, 1023, 1056, 2048],
                   [edge - 1, edge, edge + 1, 2 * ps - 1, 2 * ps + 1, 1, 0,
                    ps],
                   [pps * ps] * b,
                   [2048, 1, 2, 3, 16, 17, 5, 9]]
    g = torch.Generator().manual_seed(d_head)
    n_pages = b * pps + 1
    for lengths in length_sets:
        q = torch.randn(b, h, d_head, generator=g).to("cuda", dt)
        k = torch.randn(n_pages, ps, h, d_head, generator=g).to("cuda", dt)
        v = torch.randn(n_pages, ps, h, d_head, generator=g).to("cuda", dt)
        tables = (torch.randperm(b * pps, generator=g) + 1).reshape(b, pps)
        tables_d = tables.int().cuda()
        lengths_d = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        ref = paged_decode_reference(q, k, v, tables_d, lengths_d)
        clean = flash_decode(q, k, v, tables_d, lengths_d)
        again = flash_decode(q, k, v, tables_d, lengths_d)
        for s in range(b):
            dead = tables[s, -(-lengths[s] // ps):].cuda()
            k[dead] = float("nan")
            v[dead] = float("nan")
        before = flash_decode.launches
        out = flash_decode(q, k, v, tables_d, lengths_d)
        torch.cuda.synchronize()
        assert flash_decode.launches == before + 1
        assert torch.equal(again, clean), lengths  # reruns agree
        assert torch.equal(out, clean), lengths  # dead pages never read
        for s, n in enumerate(lengths):
            if n == 0:
                assert torch.all(out[s] == 0)
        torch.testing.assert_close(out.float(), ref.float(), **TOLERANCE[dt],
                                   msg=lambda m: f"lengths {lengths}: {m}")


@pytest.mark.cuda
def test_engine_flash_matches_dense_on_card():
    """The decode engine on the card: the kernel's attend against the
    dense attend (fp32 model, the CPU tests' 1e-4 pin), and every decode
    step launches the kernel once per layer."""
    _need_card()
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine

    lm = TransformerLM(256, 128, 4, 2, max_len=128, dtype=torch.float32)
    dense = DecodeEngine(lm, capacity=2, page_size=16)
    flash = DecodeEngine(lm, capacity=2, page_size=16,
                         attention_impl="flash")
    prompt = [7, 1, 42, 9, 3, 100, 200, 17, 5]
    s_d, s_f = dense.admit(len(prompt) + 8), flash.admit(len(prompt) + 8)
    t = int(dense.prefill(s_d, prompt).argmax())
    flash.prefill(s_f, prompt)
    before = flash_decode.launches
    for _ in range(6):
        tk = [0, 0]
        tk[s_d] = t
        a = dense.decode_step(tk)[s_d]
        bb = flash.decode_step(tk)[s_f]
        torch.testing.assert_close(torch.from_numpy(bb),
                                   torch.from_numpy(a), rtol=1e-4, atol=1e-4)
        t = int(a.argmax())
    assert flash_decode.launches == before + 6 * 2


# --- flash attention for training: K2 (forward), K3 (dq), K4 (dk/dv) ---

# (batch, s_q, s_k, heads, d, causal): the training path's shape, a
# ragged causal one, a non-causal cross one, and d = 64 (the same shapes
# as chip_smoke.py's kernel phase, plus the second head dim)
FLASH_SHAPES = [
    (8, 2048, 2048, 8, 128, True),
    (2, 2000, 2000, 8, 128, True),
    (2, 1000, 1500, 8, 128, False),
    (2, 1000, 1000, 4, 64, True),
]


def _flash_inputs(shape, dtype, seed):
    b, s_q, s_k, h, d, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s_q, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s_k, h, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, s_k, h, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, s_q, h, d, generator=g, device="cuda").to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5]))
                         + ("c" if s[5] else "n"))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernels_match_plain_versions(dtype, shape):
    """K2, K3 and K4 against their plain versions on the same inputs
    (the backward kernels get the plain forward's lse and delta), with
    ``flash_attention.tolerance``: 2^-13 of the output's scale for the
    fp32 summation order, plus one bf16 ulp of each element in bf16.
    In bf16, K2, K3 and K4 are the tensor-core kernels, whose P and dS
    are split into bf16 hi + lo."""
    _need_card()
    from chainermn_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype)
    causal = shape[5]
    q, k, v, do = _flash_inputs(shape, dt, seed=shape[1])
    scale = q.shape[-1] ** -0.5
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal, scale)
    n0 = (fa.flash_forward.launches, fa.flash_backward_dq.launches,
          fa.flash_backward_dkv.launches)
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    torch.testing.assert_close(out, ref_out, **fa.tolerance(ref_out))
    torch.testing.assert_close(lse, ref_lse, **fa.tolerance(ref_lse))
    b, s_q, h, _ = q.shape
    delta = ((do.float() * ref_out.float()).sum(-1).transpose(1, 2)
             .reshape(b * h, s_q).contiguous())
    ref_dq = fa.flash_backward_dq_reference(q, k, v, do, ref_lse, delta,
                                            causal, scale)
    ref_dk, ref_dv = fa.flash_backward_dkv_reference(
        q, k, v, do, ref_lse, delta, causal, scale)
    dq = fa.flash_backward_dq(q, k, v, do, ref_lse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, ref_lse, delta, causal,
                                   scale)
    torch.cuda.synchronize()
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dt and got.shape == ref.shape
        torch.testing.assert_close(got, ref, **fa.tolerance(ref))
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == tuple(n + 1 for n in n0)
    _assert_route(fa, dt, shape[4])


def _assert_route(fa, dt, d):
    """bf16 K2, K3 and K4 run on the tensor cores, fp32 on the CUDA
    cores."""
    want = ("csrc/flash_attention_sm90.cu" if dt == torch.bfloat16
            else "csrc/flash_attention.cu")
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        assert fa.design(name, dt, d)["source"] == want, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 70, 2, 64, False),
                                   (1, 63, 65, 2, 128, True),
                                   (2, 130, 70, 2, 64, True),
                                   (1, 100, 300, 2, 128, True),
                                   (1, 65, 129, 3, 128, False)],
                         ids=lambda s: "x".join(map(str, s[:5]))
                         + ("c" if s[5] else "n"))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernels_on_small_shapes(dtype, shape):
    """The edges of the tile loops: one query over two k tiles, a
    single partial tile, causal with s_k < s_q (keys past the last
    query) and s_k > s_q (k tiles no query sees, whose dk and dv are
    zero), odd head counts.  (One query over one causal key is no case:
    there P = 1 and dS = dP - delta = 0, so dk and dq are fp32
    cancellation noise that no tolerance of the output's scale can
    hold.)"""
    _need_card()
    from chainermn_tpu_torch.ops import flash_attention as fa

    causal = shape[5]
    q, k, v, do = _flash_inputs(shape, getattr(torch, dtype), seed=7)
    scale = q.shape[-1] ** -0.5
    b, s_q, h, _ = q.shape
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal, scale)
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    delta = ((do.float() * ref_out.float()).sum(-1).transpose(1, 2)
             .reshape(b * h, s_q).contiguous())
    args = (q, k, v, do, ref_lse, delta, causal, scale)
    ref_dk, ref_dv = fa.flash_backward_dkv_reference(*args)
    dk, dv = fa.flash_backward_dkv(*args)
    dq = fa.flash_backward_dq(*args)
    torch.cuda.synchronize()
    for got, ref in ((out, ref_out), (lse, ref_lse), (dk, ref_dk),
                     (dv, ref_dv),
                     (dq, fa.flash_backward_dq_reference(*args))):
        torch.testing.assert_close(got, ref, **fa.tolerance(ref))
    _assert_route(fa, q.dtype, shape[4])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernels_on_strided_views(dtype, d):
    """K2, K3 and K4 on q, k, v (and dO) that are non-contiguous
    (b, s, h, d) views, slices of one fused (b, s, 3, h, d) tensor as a
    fused QKV projection gives them: the kernels read through the
    strides (no copy) and match their plain versions on contiguous
    copies, under the same ``tolerance``."""
    _need_card()
    from chainermn_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype)
    b, s, h, causal = 2, 1000, 4, True
    g = torch.Generator(device="cuda").manual_seed(d)
    qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)
    do_qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)
    q, k, v = qkv.unbind(2)
    do = do_qkv[:, :, 1]
    assert not q.is_contiguous() and q.stride(1) == 3 * h * d
    assert fa._kernel_operand("q", q, dt, q.device) is q  # read in place
    scale = d ** -0.5
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    ref_out, ref_lse = fa.flash_forward_reference(qc, kc, vc, causal, scale)
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    torch.testing.assert_close(out, ref_out, **fa.tolerance(ref_out))
    torch.testing.assert_close(lse, ref_lse, **fa.tolerance(ref_lse))
    delta = ((doc.float() * ref_out.float()).sum(-1).transpose(1, 2)
             .reshape(b * h, s).contiguous())
    args = (ref_lse, delta, causal, scale)
    ref_dq = fa.flash_backward_dq_reference(qc, kc, vc, doc, *args)
    ref_dk, ref_dv = fa.flash_backward_dkv_reference(qc, kc, vc, doc, *args)
    dq = fa.flash_backward_dq(q, k, v, do, *args)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, *args)
    torch.cuda.synchronize()
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(got, ref, **fa.tolerance(ref))
    _assert_route(fa, dt, d)


@pytest.mark.cuda
def test_flash_tensor_core_kernels_deterministic():
    """The bf16 K2, K3 and K4 own their output tiles (no atomics): two
    runs on the same inputs agree bit for bit."""
    _need_card()
    from chainermn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(FLASH_SHAPES[1], torch.bfloat16, seed=3)
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward(q, k, v, True, scale)
    b, s_q, h, _ = q.shape
    delta = ((do.float() * out.float()).sum(-1).transpose(1, 2)
             .reshape(b * h, s_q).contiguous())
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta, True, scale)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, True, scale)
    out2, lse2 = fa.flash_forward(q, k, v, True, scale)
    dq2 = fa.flash_backward_dq(q, k, v, do, lse, delta, True, scale)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    for a, b2 in ((out, out2), (lse, lse2), (dq, dq2), (dk, dk2),
                  (dv, dv2)):
        assert torch.equal(a, b2)


@pytest.mark.cuda
def test_flash_tolerance_rejects_bf16_probabilities():
    """Negative control: a plain forward that rounds P to bf16 before
    P.V must fail the tolerance the kernel is held to."""
    _need_card()
    from chainermn_tpu_torch.ops import flash_attention as fa

    shape = FLASH_SHAPES[0]
    q, k, v, _ = _flash_inputs(shape, torch.bfloat16, seed=shape[1])
    scale = q.shape[-1] ** -0.5
    ref, _ = fa.flash_forward_reference(q, k, v, True, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~fa._causal_mask(s.shape[-2], s.shape[-1], s.device),
                      -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    rounded = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(),
                           v.float()).bfloat16()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(rounded, ref, **fa.tolerance(ref))


@pytest.mark.cuda
def test_flash_attention_autograd_on_card():
    """The differentiable entry points on the card: every gradient of
    flash_attention (and of flash_attention_with_lse with an lse
    cotangent) against autograd through the plain dense attention,
    each kernel launched once per call."""
    _need_card()
    from chainermn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs((2, 300, 300, 4, 64, True), torch.float32, 1)
    g_lse = torch.randn(2, 300, 4, device="cuda")
    for with_lse in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n0 = fa.flash_backward_dkv.launches
        if with_lse:
            out, lse = fa.flash_attention_with_lse(*leaves, causal=True)
            ref_out, ref_lse = fa.dense_attention_with_lse(*ref_leaves,
                                                           causal=True)
            loss = (out * do).sum() + (lse * g_lse).sum()
            ref_loss = (ref_out * do).sum() + (ref_lse * g_lse).sum()
        else:
            out = fa.flash_attention(*leaves, causal=True)
            ref_out, _ = fa.dense_attention_with_lse(*ref_leaves,
                                                     causal=True)
            loss, ref_loss = (out * do).sum(), (ref_out * do).sum()
        grads = torch.autograd.grad(loss, leaves)
        ref_grads = torch.autograd.grad(ref_loss, ref_leaves)
        for got, ref in zip(grads, ref_grads):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        assert fa.flash_backward_dkv.launches == n0 + 1


@pytest.mark.cuda
def test_dp_train_step_across_cards():
    """The data-parallel step over NCCL on up to 4 cards of one host
    (needs 2): one process per card, bcast_data, scatter_dataset shards,
    the bucketed all-reduce, AdamW.  Every rank ends with bit-identical
    parameters, the same mean losses, all finite, and each step launched
    the flash forward once per layer."""
    _need_card()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs 2 or more cards of one host")
    import numpy as np

    import test_torch_world as torch_world
    from chainermn_tpu_torch.models import TransformerLM

    cfg = dict(vocab=512, d_model=256, n_heads=2, n_layers=2, max_len=256,
               batch=2 * n, seed=3)
    lm = TransformerLM(cfg["vocab"], cfg["d_model"], cfg["n_heads"],
                       cfg["n_layers"], max_len=cfg["max_len"], seed=1)
    state = {k: v.numpy() for k, v in lm.state_dict().items()}
    dataset = np.random.RandomState(0).randint(0, cfg["vocab"],
                                               (cfg["batch"] * 3, 256))
    ranks = torch_world.run_world(torch_world.dp_card_worker, n, cfg, state,
                                  dataset, 3, timeout=300, backend="nccl")
    for r, res in enumerate(ranks):
        assert res["device"] == f"cuda:{r}"
        assert res["launches"] == cfg["n_layers"] * 3
        assert res["losses"] == ranks[0]["losses"]
        assert np.all(np.isfinite(res["losses"]))
        for k, v in res["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k],
                                          err_msg=k)


# --- fused cast and scale: K1, both cast legs of the gradient wire ---

CAST_DTYPES = ["float32", "bfloat16", "float16"]


def _cast_input(n, dtype, seed):
    """n values over many binades, with NaN, +-inf, -0, fp16 overflow
    and fp32 subnormals among them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * torch.exp2(
        torch.randint(-30, 30, (n,), generator=g).float())
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            7e4, -7e4, 1e-40, 3.0e-8])
    x[:min(n, len(special))] = special[:n]
    return x.to(getattr(torch, dtype))


def _resnet50_bucket_size():
    from chainermn_tpu_torch.comm_wire import make_plan
    from chainermn_tpu_torch.models import ResNet50, flax_leaf_specs

    plan = make_plan(flax_leaf_specs(ResNet50(num_classes=1000)))
    return max(b.size for b in plan.buckets)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", CAST_DTYPES)
@pytest.mark.parametrize("in_dtype", CAST_DTYPES)
def test_fused_cast_scale_bit_exact(in_dtype, out_dtype):
    """K1 against its plain version, bit for bit (NaN positions as
    positions), for every dtype pair: ragged sizes, views at odd element
    offsets into a larger buffer (the vector body's head and tail), the
    largest bucket of ResNet-50's wire plan, scales 1, 1/2 and 1/3."""
    _need_card()
    from chainermn_tpu_torch.ops.fused_cast_scale import (
        cast_scale_reference, fused_cast_scale, same_bits)

    out_dt = getattr(torch, out_dtype)
    big = _cast_input(_resnet50_bucket_size() + 16, in_dtype, 1).cuda()
    cases = [_cast_input(n, in_dtype, n).cuda() for n in (1, 7, 1027, 4099)]
    cases += [big[off:off + n] for off, n in ((1, 1027), (3, 4096),
                                              (5, 70001))]
    cases.append(big[:-16])
    for x in cases:
        for scale in (1.0, 0.5, 1.0 / 3.0):
            n0 = fused_cast_scale.launches
            got = fused_cast_scale(x, scale, out_dt)
            want = cast_scale_reference(x, scale, out_dt)
            torch.cuda.synchronize()
            assert fused_cast_scale.launches == n0 + 1
            assert same_bits(got, want), (x.numel(), x.storage_offset(),
                                          scale)


@pytest.mark.cuda
def test_fused_cast_scale_empty_and_refusals():
    _need_card()
    from chainermn_tpu_torch.ops.fused_cast_scale import fused_cast_scale

    n0 = fused_cast_scale.launches
    out = fused_cast_scale(torch.zeros(0, device="cuda"), 0.5, torch.bfloat16)
    assert out.shape == (0,) and out.dtype == torch.bfloat16
    assert fused_cast_scale.launches == n0
    with pytest.raises(TypeError):
        fused_cast_scale(torch.zeros(4, device="cuda", dtype=torch.float64),
                         1.0, torch.float32)
    with pytest.raises(ValueError):
        fused_cast_scale(torch.zeros(4, 4, device="cuda").t(), 1.0,
                         torch.bfloat16)


@pytest.mark.cuda
def test_fused_cast_scale_rejects_truncating_cast():
    """Negative control: a bf16 cast that truncates the mantissa instead
    of rounding to nearest even fails the bit-exact check."""
    _need_card()
    from chainermn_tpu_torch.ops.fused_cast_scale import (
        fused_cast_scale, same_bits)

    x = _cast_input(4099, "float32", 2).cuda()
    x[torch.isnan(x)] = 0.0
    truncated = ((x.view(torch.int32) >> 16).to(torch.int16)
                 .view(torch.bfloat16))
    assert not same_bits(truncated, fused_cast_scale(x, 1.0, torch.bfloat16))


@pytest.mark.cuda
def test_reduce_buckets_launches_fused_cast_scale():
    """On a 1-rank NCCL group: each cast codec launches K1 twice a
    bucket whose dtype differs from the wire's, none when it does not,
    and the means equal the plain casts."""
    _need_card()
    import torch.distributed as dist

    from chainermn_tpu_torch.comm_wire import WireConfig, reduce_buckets
    from chainermn_tpu_torch.ops.fused_cast_scale import (
        cast_scale_reference, fused_cast_scale, same_bits)

    buckets = [_cast_input(n, "float32", n).cuda() for n in (1000, 257, 64)]
    for b in buckets:
        b[torch.isnan(b) | torch.isinf(b)] = 1.0
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for codec, launches in (("none", 0), ("f32", 0), ("bf16", 6),
                                ("f16", 6)):
            n0 = fused_cast_scale.launches
            means, _ = reduce_buckets(buckets, 1, WireConfig(codec=codec))
            torch.cuda.synchronize()
            assert fused_cast_scale.launches - n0 == launches, codec
            for m, b in zip(means, buckets):
                wire = {"bf16": torch.bfloat16, "f16": torch.float16}.get(
                    codec, torch.float32)
                want = cast_scale_reference(
                    cast_scale_reference(b, 1.0, wire), 1.0, torch.float32)
                assert same_bits(m, want), codec
    finally:
        dist.destroy_process_group()


def _mixed_world():
    """A world of one whose default group takes CPU tensors (gloo) and
    card tensors (NCCL), so one call runs on both."""
    import torch.distributed as dist

    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)


@pytest.mark.cuda
def test_reduce_buckets_int8_and_error_feedback_on_card_equal_cpu():
    """The int8 codec (with and without error feedback, with a carried
    residual) and the bf16 codec with error feedback, on card tensors
    over a 1-rank NCCL group, bit-equal to the same call on CPU tensors
    (tolerance 0: the same fp32 divides, round-half-even and integer
    sum; a CUDA divide by a Python number would multiply by its
    reciprocal, and 1/127 is inexact); a zero bucket stays zero; the
    mean divide at world 3 is a divide too."""
    _need_card()
    import torch.distributed as dist

    from chainermn_tpu_torch.comm_wire import WireConfig, reduce_buckets

    g = torch.Generator().manual_seed(7)
    buckets = [torch.randn(n, generator=g) * s
               for n, s in ((1000, 1e-3), (4099, 1.0), (64, 0.0))]
    buckets.append((torch.randn(257, generator=g) * 10).bfloat16())
    carry = [(torch.randn(b.numel(), generator=g) * 1e-4).to(b.dtype)
             for b in buckets]
    _mixed_world()
    try:
        for codec, ef, with_carry in (("int8", False, False),
                                      ("int8", True, False),
                                      ("int8", True, True),
                                      ("bf16", True, True)):
            cfg = WireConfig(codec, error_feedback=ef)
            res_cpu = carry if with_carry else None
            res_card = [r.cuda() for r in carry] if with_carry else None
            m_cpu, r_cpu = reduce_buckets(buckets, 1, cfg, res_cpu)
            m_card, r_card = reduce_buckets([b.cuda() for b in buckets], 1,
                                            cfg, res_card)
            for a, b in zip(m_card + r_card, m_cpu + r_cpu):
                assert a.device.type == "cuda" and a.dtype == b.dtype
                assert torch.equal(a.cpu(), b), (codec, ef, with_carry)
            assert len(r_card) == (len(buckets) if ef else 0)
            assert with_carry or not m_card[2].any()
        from chainermn_tpu_torch.comm_wire.codecs import _div

        x = torch.randn(4099, generator=g)
        assert torch.equal(_div(x.cuda(), 3).cpu(), x / 3)
        assert torch.equal(_div(x.cuda(), 127).cpu(), x / 127.0)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_error_feedback_launch_counts():
    """K1 launches a step: a cast codec twice a bucket whose dtype
    differs from the wire's, three times with error feedback (the
    residual casts the local payload back); int8 never."""
    _need_card()
    import torch.distributed as dist

    from chainermn_tpu_torch.comm_wire import WireConfig, reduce_buckets
    from chainermn_tpu_torch.ops.fused_cast_scale import fused_cast_scale

    buckets = [torch.randn(n, device="cuda") for n in (1000, 257, 64)]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for cfg, launches in ((WireConfig("bf16"), 6),
                              (WireConfig("bf16", error_feedback=True), 9),
                              (WireConfig("f16", error_feedback=True), 9),
                              (WireConfig("int8", error_feedback=True), 0)):
            n0 = fused_cast_scale.launches
            reduce_buckets(buckets, 1, cfg)
            torch.cuda.synchronize()
            assert fused_cast_scale.launches - n0 == launches, cfg
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mnbn_on_card_equals_cpu(dtype):
    """MultiNodeBatchNormalization over a 1-rank hierarchical
    communicator on the card against the same layer on the CPU: the
    output, the running statistics and the input and parameter
    gradients within fp32 rounding (rtol 1e-4, atol 1e-5 of the largest
    entry: the card sums the statistics in another order); bf16 outputs
    within two bf16 steps.  Two all-reduces a training step, none in
    evaluation."""
    _need_card()
    import torch.distributed as dist

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.functions import allreduce_mean
    from chainermn_tpu_torch.links import MultiNodeBatchNormalization

    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 16, 14, 14, generator=g) * 2 + 3
    c = torch.randn(8, 16, 14, 14, generator=g)
    dt = getattr(torch, dtype)
    _mixed_world()
    try:
        comm = cmn.create_communicator("hierarchical")
        out = {}
        for device in ("cpu", "cuda"):
            layer = MultiNodeBatchNormalization(16, comm, dtype=dt).to(device)
            with torch.no_grad():
                layer.weight.copy_(torch.linspace(0.5, 1.5, 16))
                layer.bias.copy_(torch.linspace(-0.2, 0.2, 16))
            xd = x.to(device, dt).clone().requires_grad_()
            n0 = allreduce_mean.calls
            y = layer(xd)
            (y.float() * c.to(device)).sum().backward()
            assert allreduce_mean.calls - n0 == 2
            layer.eval()
            with torch.no_grad():
                layer(xd)
            assert allreduce_mean.calls - n0 == 2
            out[device] = [t.detach().float().cpu() for t in (
                y, layer.running_mean, layer.running_var, xd.grad,
                layer.weight.grad, layer.bias.grad)]
        names = ("y", "running_mean", "running_var", "dx", "dweight",
                 "dbias")
        for name, a, b in zip(names, out["cuda"], out["cpu"]):
            if name == "y" and dtype == "bfloat16":
                step = 2.0 ** -7 * b.abs().clamp_min(2.0 ** -126)
                assert ((a - b).abs() <= 2 * step).all(), name
            elif name in ("y", "running_mean", "running_var"):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                           msg=name)
            else:
                torch.testing.assert_close(
                    a, b, rtol=1e-4 if dtype == "float32" else 2e-2,
                    atol=(1e-4 if dtype == "float32" else 2e-2)
                    * float(b.abs().max()), msg=name)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_prefetch_to_device_copies_on_a_side_stream():
    """``prefetch_to_device`` with ``device_placer("cuda")``: each batch
    equals its host batch bit for bit and lies on the card, the copies
    run on the placer's side stream (with the current stream held by a
    spin of ~0.5 s, a placed batch's copy completes while the current
    stream is still busy), and the consumer's stream waits for the copy
    before it reads the batch."""
    _need_card()
    import numpy as np

    from chainermn_tpu_torch.iterators import (CudaPlacer, SerialIterator,
                                               device_placer,
                                               prefetch_to_device)

    rng = np.random.RandomState(0)
    data = [(rng.randn(64, 32).astype(np.float32), np.int32(i))
            for i in range(24)]
    placer = device_placer("cuda")
    assert isinstance(placer, CudaPlacer)
    it = prefetch_to_device(SerialIterator(data, 4, shuffle=False),
                            placer, depth=2)
    host = SerialIterator(data, 4, shuffle=False)
    for _ in range(8):
        x, y = next(it)
        hx, hy = next(host)
        assert x.is_cuda and y.is_cuda
        assert torch.equal(x.cpu(), torch.from_numpy(hx))
        assert torch.equal(y.cpu(), torch.from_numpy(hy))
    assert placer.copies == 8 + 2
    assert placer.stream != torch.cuda.current_stream()

    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)  # the current stream busy for a while
    pending = placer((np.ones((256, 256), np.float32),))
    pending.event.synchronize()  # the copy is done ...
    assert not torch.cuda.current_stream().query()  # ... the spin is not
    (x,) = pending.wait()
    assert float(x.sum()) == 256 * 256
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_checkpointer_round_trips_card_tensors(tmp_path):
    """The checkpointer's save and resume of card tensors (fp32, bf16,
    int64, a 0-dim step) in a tree with numpy and Python leaves: bit for
    bit, the structure kept, back on the card with ``like`` and on the
    CPU without; the async tier the same."""
    _need_card()
    import numpy as np
    import torch.distributed as dist

    import chainermn_tpu_torch as cmn

    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(64, 32, generator=g).cuda(),
                        "b": torch.randn(32, generator=g).bfloat16().cuda()},
             "opt_state": [torch.arange(7).cuda(), torch.tensor(3.5).cuda()],
             "trainer": {"iteration": 9, "order": np.arange(5)}}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = cmn.create_communicator("pure_nccl")
        for use_async in (False, True):
            ckpt = cmn.create_multi_node_checkpointer(
                f"card{use_async}", comm, path=str(tmp_path),
                use_async=use_async)
            ckpt.save(9, state)
            step, back = ckpt.resume(like=state)
            _, host = ckpt.resume()
            ckpt.finalize()
            assert step == 9
            for got, on in ((back, "cuda"), (host, "cpu")):
                for k in ("w", "b"):
                    t = got["params"][k]
                    assert t.device.type == on
                    assert t.dtype == state["params"][k].dtype
                    assert torch.equal(t.cpu(), state["params"][k].cpu())
                for a, b in zip(got["opt_state"], state["opt_state"]):
                    assert a.device.type == on
                    assert torch.equal(a.cpu(), b.cpu())
                assert got["trainer"]["iteration"] == 9
                np.testing.assert_array_equal(got["trainer"]["order"],
                                              np.arange(5))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,train", [
    ("vgg16", False), ("alex", False), ("nin", False), ("googlenet", False),
    ("googlenetbn", False), ("googlenetbn", True)])
def test_image_archs_on_card_equal_cpu(monkeypatch, arch, train):
    """Each of the ImageNet example's other archs (fp32, 96 x 96, 10
    classes, batch 2, dropout off, TF32 off) on the card against the same
    model on the CPU.

    Evaluation mode (GoogLeNetBN on its running statistics): logits
    within rtol 1e-4 / atol 1e-4 of the largest, every parameter's
    gradient within 2e-3 of its largest entry.  cuDNN and the CPU sum in
    other orders, and a gradient that sums over every position of the
    batch moves most: GoogLeNet's 7 x 7 stem by 2.5e-4 of its largest
    entry (a first bound of 1e-4 failed on it and, by one element, on
    VGG16's stem).

    GoogLeNetBN in training mode (its BatchNorms on the batch's
    statistics, which are updated) is held as the CPU test holds it
    against flax: logits within 3e-4 of the largest, running statistics
    within 1e-4, gradients within 0.1 by their relative L2 norm over
    every parameter (the train-mode gradient is ill-conditioned in fp32
    at this batch: the two frameworks part by 0.013-0.028 on the CPU)."""
    _need_card()
    from chainermn_tpu_torch.examples.train_imagenet import ARCHS, SIZED_ARCHS
    from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 96, 96, 3, generator=g)
    y = torch.tensor([3, 7])
    out = {}
    for device in ("cpu", "cuda"):
        kw = {"image_size": 96} if arch in SIZED_ARCHS else {}
        model = ARCHS[arch](num_classes=10, dtype=torch.float32, **kw)
        model.to(device).train(train)
        logits = model(x.to(device), deterministic=True) if train \
            else model(x.to(device))
        softmax_cross_entropy(logits, y.to(device)).backward()
        out[device] = ([logits.detach().cpu()]
                       + [p.grad.cpu() for p in model.parameters()],
                       [b.cpu() for b in model.buffers()])
    ((a, *grads_a), bufs_a), ((b, *grads_b), bufs_b) = (out["cuda"],
                                                        out["cpu"])
    if not train:
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
        for ga, gb in zip(grads_a, grads_b):
            assert float((ga - gb).abs().max()) <= 2e-3 * float(
                gb.abs().max())
        return
    assert float((a - b).abs().max()) <= 3e-4 * float(b.abs().max())
    assert len(bufs_a) > 0
    for ba, bb in zip(bufs_a, bufs_b):
        torch.testing.assert_close(ba, bb, rtol=0, atol=1e-4)
    num = sum(float(((ga - gb) ** 2).sum()) for ga, gb in zip(grads_a,
                                                               grads_b))
    den = sum(float((gb ** 2).sum()) for gb in grads_b)
    assert (num / den) ** 0.5 <= 0.1


S2S_CARD = dict(vocab=64, units=32, layers=2)


def _s2s_card_batch(seed, batch=4, seqlen=8):
    """Source and target tokens with PAD tails."""
    from chainermn_tpu_torch.models.seq2seq import PAD

    g = torch.Generator().manual_seed(seed)
    src, tgt = (torch.randint(3, S2S_CARD["vocab"], (batch, seqlen),
                              generator=g) for _ in range(2))
    src[:, -2:] = PAD
    tgt[1:, -3:] = PAD
    return src, tgt


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_seq2seq_chain_and_model_on_card_equal_cpu(monkeypatch):
    """The ``seq2seq_mp1`` chain (both stages on the one rank; cuDNN's
    LSTM) and the monolithic ``Seq2Seq`` on the card against the same
    seeded models on the CPU, TF32 off: logits within 1e-5 of the
    largest, the first loss within 1e-6 relative and the second within
    1e-5, every gradient within 1e-5 relative L2, the parameters after 2
    Adam steps within 3e-5 with 99.9 % of entries within 1e-6 (the CPU
    parity tests' bounds against JAX)."""
    _need_card()
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.train_seq2seq_mp1 import make_chain
    from chainermn_tpu_torch.models import (Seq2Seq, seq2seq_loss,
                                            teacher_forcing)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    src, tgt = _s2s_card_batch(0)
    ys_in, ys_out = teacher_forcing(tgt)
    cfg = (S2S_CARD["vocab"], S2S_CARD["units"], S2S_CARD["layers"])
    out = {}
    _mixed_world()
    try:
        comm = create_communicator("pure_nccl")
        for device in ("cpu", "cuda"):
            chain = make_chain(comm, *cfg, device=device)
            opt = chain.optimizer(torch.optim.Adam, lr=1e-3)
            step = chain.value_and_grad(seq2seq_loss)
            x = [src.to(device), ys_in.to(device)]
            with torch.no_grad():
                logits = chain(x).cpu()
            losses, grads = [], None
            for _ in range(2):
                opt.zero_grad()
                losses.append(float(step(x, ys_out.to(device))))
                grads = grads or [p.grad.cpu() for p in chain.parameters()]
                opt.step()
            model = Seq2Seq(cfg[0], cfg[0], cfg[1], cfg[2]).to(device)
            m_logits = model(src.to(device), ys_in.to(device))
            seq2seq_loss(m_logits, ys_out.to(device)).backward()
            out[device] = (logits, losses, grads,
                           [p.detach().cpu() for p in chain.parameters()],
                           m_logits.detach().cpu(),
                           [p.grad.cpu() for p in model.parameters()])
    finally:
        dist.destroy_process_group()
    card, cpu = out["cuda"], out["cpu"]
    for a, b in ((card[0], cpu[0]), (card[4], cpu[4])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert abs(card[1][0] - cpu[1][0]) <= 1e-6 * abs(cpu[1][0])
    assert abs(card[1][1] - cpu[1][1]) <= 1e-5 * abs(cpu[1][1])
    for ga, gb in zip(card[2] + card[5], cpu[2] + cpu[5]):
        assert _rel_l2(ga, gb) <= 1e-5
    gap = torch.cat([(a - b).abs().flatten() for a, b in zip(card[3],
                                                               cpu[3])])
    assert float(gap.max()) < 3e-5
    assert float((gap < 1e-6).float().mean()) >= 0.999


@pytest.mark.cuda
def test_translate_on_card_equals_cpu(monkeypatch):
    """Greedy ``translate`` of one seeded ``Seq2Seq`` on the card and on
    the CPU, TF32 off: the logits along the CPU's greedy path within
    1e-5 of the largest, the tokens equal in every row whose greedy path
    keeps its top two logits more than 1e-4 apart."""
    _need_card()
    from chainermn_tpu_torch.models import Seq2Seq, translate
    from chainermn_tpu_torch.models.seq2seq import BOS

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    xs = _s2s_card_batch(1, batch=16)[0]
    steps = 9
    cfg = (S2S_CARD["vocab"], S2S_CARD["vocab"], S2S_CARD["units"],
           S2S_CARD["layers"])
    cpu, card = Seq2Seq(*cfg).eval(), Seq2Seq(*cfg).cuda().eval()
    with torch.no_grad():
        state = cpu.encode(xs)
        tok = torch.full((len(xs), 1), BOS, dtype=torch.long)
        path = []
        for _ in range(steps):
            state, logits = cpu.decode(state, tok)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            path.append(tok)
        feed = torch.cat([torch.full((len(xs), 1), BOS, dtype=torch.long)]
                         + path[:-1], dim=1)
        want = cpu(xs, feed)
        got = card(xs.cuda(), feed.cuda()).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > 1e-4).all(dim=1).numpy()
    assert clear.sum() >= len(xs) // 2
    a = translate(card, xs.cuda(), max_length=steps)
    b = translate(cpu, xs, max_length=steps)
    assert (a[clear] == b[clear]).all()


def _quad_case(seed=0, steps=3, rows=4):
    """Dyadic parameters and batches: every gradient ``w - mean(x)`` and
    every SGD step is exact, so the card and the CPU agree bit for
    bit wherever the wire does."""
    g = torch.Generator().manual_seed(seed)

    def dyadic(*shape):
        return torch.randint(-8, 9, shape, generator=g).float() / 8.0

    shapes = [(4099,), (64, 33), (7,)]
    return ([dyadic(*s) for s in shapes],
            [[dyadic(rows, *s) for s in shapes] for _ in range(steps)])


def _quad_train(comm, w0, batches, device, **opt_kw):
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig

    params = [torch.nn.Parameter(w.clone().to(device)) for w in w0]
    opt = cmn.create_multi_node_optimizer(
        torch.optim.SGD(params, lr=0.5, momentum=0.5), comm,
        wire=WireConfig("bf16", bucket_bytes=1024, max_buckets=0), **opt_kw)

    def loss(b):
        return sum(0.5 * ((w - x.mean(0)) ** 2).sum()
                   for w, x in zip(params, b))

    step = cmn.build_train_step(comm, loss, opt)
    for b in batches:
        step([x.to(device) for x in b])
    return [p.detach().cpu() for p in params], opt


@pytest.mark.cuda
def test_double_buffering_and_overlap_on_card_equal_cpu():
    """Double buffering and ``overlap="bucket"`` (bf16 wire, three
    buckets, SGD with momentum, 3 steps of an elementwise loss) on card
    tensors over a 1-rank NCCL group, bit-equal to the same steps on CPU
    tensors (tolerance 0: K1 is exact, the gradients and steps are
    exact); K1 launches 3 times a bucket a step under double buffering
    (the store, the encode, the decode) and twice under overlap."""
    _need_card()
    import torch.distributed as dist

    from chainermn_tpu_torch.ops.fused_cast_scale import fused_cast_scale

    w0, batches = _quad_case()
    _mixed_world()
    try:
        import chainermn_tpu_torch as cmn

        comm = cmn.create_communicator("pure_nccl")
        for kw, per_step in ((dict(double_buffering=True), 3),
                             (dict(overlap="bucket"), 2)):
            cpu, _ = _quad_train(comm, w0, batches, "cpu", **kw)
            card, opt = _quad_train(comm, w0, batches[:1], "cuda", **kw)
            n0 = fused_cast_scale.launches
            card, _ = _quad_train(comm, w0, batches, "cuda", **kw)
            torch.cuda.synchronize()
            nb = opt.wire_plan().n_buckets
            assert nb == 3
            launches = fused_cast_scale.launches - n0
            # double buffering's first step also puts the zero buffer on
            # the wire (an encode and a decode a bucket)
            extra = 2 * nb if "double_buffering" in kw else 0
            assert launches == per_step * nb * len(batches) + extra, kw
            for a, b in zip(card, cpu):
                assert torch.equal(a, b), kw
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_remat_with_flash_kernels_equals_plain():
    """A 2-layer bf16 TransformerLM through the flash kernels (K2-K4),
    3 AdamW steps with ``remat=True`` and with ``accum_steps=2`` plus
    remat, against the same steps without remat: parameters bit-equal
    (the recompute runs the same kernels on the same inputs); K2 runs
    twice a microbatch (the forward and the recompute), K3 and K4
    once."""
    _need_card()
    import torch.distributed as dist

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.ops import flash_attention as fa

    tokens = torch.randint(0, 512, (4, 256),
                           generator=torch.Generator().manual_seed(1)).cuda()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = cmn.create_communicator("pure_nccl")
        out = {}
        for remat, accum in ((False, 1), (True, 1), (False, 2), (True, 2)):
            lm = TransformerLM(512, 128, 2, 2, max_len=256,
                               dtype=torch.bfloat16, seed=0,
                               attention_fn=fa.flash_attention_fn()).cuda()
            opt = cmn.create_multi_node_optimizer(
                torch.optim.AdamW(lm.parameters(), lr=1e-3), comm)
            step = cmn.build_train_step(comm, lambda t: lm_loss(lm(t), t),
                                        opt, remat=remat, accum_steps=accum)
            counts = [getattr(fa, k).launches for k in
                      ("flash_forward", "flash_backward_dq",
                       "flash_backward_dkv")]
            for _ in range(3):
                step(tokens)
            torch.cuda.synchronize()
            got = [getattr(fa, k).launches - c for k, c in zip(
                ("flash_forward", "flash_backward_dq",
                 "flash_backward_dkv"), counts)]
            assert got == [2 * 3 * accum * (2 if remat else 1),
                           2 * 3 * accum, 2 * 3 * accum], (remat, accum)
            out[remat, accum] = [p.detach().clone() for p in lm.parameters()]
        for accum in (1, 2):
            for a, b in zip(out[True, accum], out[False, accum]):
                assert torch.equal(a, b), accum
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_tier2_paths_across_cards():
    """The optimizer's tier 2 over NCCL on up to 4 cards of one host
    (needs 2), one process per card, an elementwise loss on dyadic data
    (every sum exact, so the schedules agree bit for bit):
    ``overlap="bucket"`` equals the synchronous bf16 wire, with every
    bucket issued from the backward in reverse plan order; double
    buffering's first step moves nothing and its second equals the plain
    wrapper's first; ZeRO (on 4 cards as 2 x 2 nodes, ``hier_rs_ag``)
    equals the plain wrapper; every rank ends equal to rank 0."""
    _need_card()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs 2 or more cards of one host")
    import numpy as np

    import test_torch_world as torch_world
    import torch_mp_workers as W
    from chainermn_tpu_torch.communicators import FAKE_NODE_SIZE_ENV

    rng = np.random.RandomState(0)
    shapes = [(33,), (8, 9), (5,)]
    w0 = [(rng.randint(-8, 9, s) / 8.0).astype(np.float32) for s in shapes]
    xs = [(rng.randint(-8, 9, (3, 2 * n) + s) / 8.0).astype(np.float32)
          for s in shapes]
    env = {FAKE_NODE_SIZE_ENV: "2"} if n == 4 else {}
    ranks = torch_world.run_world(W.tier2_card_worker, n, w0, xs, env,
                                  timeout=300, backend="nccl", env=env)
    for r, res in enumerate(ranks):
        assert res["device"] == f"cuda:{r}"
        assert res["mesh_shape"] == ({"mn_inter": 2, "mn_intra": 2} if env
                                     else {"mn": n})
        for name in ("overlap_bf16", "db_bf16", "zero_none"):
            for a, b in zip(res[name]["params"][-1],
                            ranks[0][name]["params"][-1]):
                np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in zip(res["overlap_bf16"]["params"][-1],
                        res["plain_bf16"]["params"][-1]):
            np.testing.assert_array_equal(a, b)
        nb = len(res["overlap_bf16"]["schedules"])
        assert nb >= 3
        assert res["overlap_bf16"]["report"] == [
            (b, res["overlap_bf16"]["report"][i][1], True)
            for i, b in enumerate(reversed(range(nb)))]
        for a, b in zip(res["db_bf16"]["params"][0], w0):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(res["db_bf16"]["params"][1],
                        res["plain_bf16"]["params"][0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(res["zero_none"]["params"][-1],
                        res["plain_none"]["params"][-1]):
            np.testing.assert_array_equal(a, b)
        assert set(res["zero_none"]["schedules"]) == (
            {"hier_rs_ag"} if n == 4 else {"flat"})
