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
