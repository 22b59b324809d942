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
    """The sm_90a kernel against its plain version at the serving
    geometry (8 slots, 8 heads, 16-token pages, 128 pages a slot):
    ragged lengths, a length-0 slot, NaN-poisoned dead pages.
    Tolerance: ``TOLERANCE``, one bf16 ulp of each element (the two
    fp32 results may straddle a rounding boundary); fp32 by summation
    order over up to 2048 positions."""
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(d_head)
    b, h, ps, pps = 8, 8, 16, 128
    n_pages = b * pps + 1
    q = torch.randn(b, h, d_head, generator=g).to("cuda", dt)
    k = torch.randn(n_pages, ps, h, d_head, generator=g).to("cuda", dt)
    v = torch.randn(n_pages, ps, h, d_head, generator=g).to("cuda", dt)
    tables = (torch.randperm(b * pps, generator=g) + 1).reshape(b, pps)
    lengths = torch.tensor([1, 17, 64, 300, 0, 1023, 1056, 2048])
    tables_d = tables.int().cuda()
    lengths_d = lengths.int().cuda()
    ref = paged_decode_reference(q, k, v, tables_d, lengths_d)
    clean = flash_decode(q, k, v, tables_d, lengths_d)
    for s in range(b):
        dead = tables[s, -(-int(lengths[s]) // ps):].cuda()
        k[dead] = float("nan")
        v[dead] = float("nan")
    before = flash_decode.launches
    out = flash_decode(q, k, v, tables_d, lengths_d)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert torch.equal(out, clean)  # dead pages are never read
    assert torch.all(out[4] == 0)
    torch.testing.assert_close(out.float(), ref.float(), **TOLERANCE[dt])


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
    In bf16, K2 and K4 are the tensor-core kernels, whose P and dS are
    split into bf16 hi + lo."""
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


@pytest.mark.cuda
def test_flash_tensor_core_kernels_deterministic():
    """The bf16 K2 and K4 own their output tiles (no atomics): two runs
    on the same inputs agree bit for bit."""
    _need_card()
    from chainermn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(FLASH_SHAPES[1], torch.bfloat16, seed=3)
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward(q, k, v, True, scale)
    b, s_q, h, _ = q.shape
    delta = ((do.float() * out.float()).sum(-1).transpose(1, 2)
             .reshape(b * h, s_q).contiguous())
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, True, scale)
    out2, lse2 = fa.flash_forward(q, k, v, True, scale)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    for a, b2 in ((out, out2), (lse, lse2), (dk, dk2), (dv, dv2)):
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
            means = reduce_buckets(buckets, 1, WireConfig(codec=codec))
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
