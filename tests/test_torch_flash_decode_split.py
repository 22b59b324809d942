"""The split-K decode kernel's arithmetic, on the CPU.

``chainermn_tpu_torch/ops/csrc/flash_decode.cu`` deals each slot's live
pages out to ``splits`` blocks per (slot, head), ``ceil(pages / splits)``
whole pages each.  Inside a block, position ``i`` of a chunk of
``chunk`` rows belongs to row group ``i % groups``; each group keeps an
fp32 online softmax (m, l, acc) in log2 units, the groups merge at the
end of the block, and the last block of a (slot, head) merges the
splits in split order.  Here plain torch replays that partition and
those three levels of merging at the serving geometry (8 slots, 8 heads,
16-token pages, d 128, 128 pages a slot) on numpy-seeded inputs, and
holds the result to ``flash_decode.TOLERANCE`` against
``paged_decode_reference`` (one exact softmax over the gathered cache),
the same bound the kernel is held to on the card.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainermn_tpu.ops.pallas_attention import (
    paged_decode_reference as jax_paged_decode_reference,
)
from chainermn_tpu_torch.ops.flash_decode import (
    BLOCKS_PER_SM,
    TOLERANCE,
    decode_splits,
    paged_decode_reference,
)

SLOTS, HEADS, PAGE, D, PPS = 8, 8, 16, 128, 128
H100_SMS = 132
LOG2E = 1.4426950408889634
SPLITS = decode_splits(SLOTS, HEADS, PPS, H100_SMS)


def _boundary_lengths():
    """Lengths at a split boundary and one position either side: a slot
    of ``SPLITS * m`` pages gives each split m pages."""
    edge = SPLITS * 2 * PAGE
    return [edge - 1, edge, edge + 1, 2 * PAGE - 1, 2 * PAGE + 1, 1, 0,
            PAGE]


LENGTHS = {
    "ragged": [1, 17, 64, 300, 0, 1023, 1056, 2048],
    "split_boundary": _boundary_lengths(),
    "all_full": [PPS * PAGE] * SLOTS,
    "one_long": [2048, 1, 2, 3, 16, 17, 5, 9],
}


def _geometry(dtype, d):
    """(groups, chunk) of the kernel's ``Geometry<T, D>``: a thread holds
    16 bytes of a row (or d / 32 elements), 128 threads a block, 8 KB of
    K and V rows a chunk (the card test holds the kernel's chunk to
    this)."""
    size = torch.finfo(dtype).bits // 8
    elems = max(16 // size, d // 32)
    groups = 128 // (d // elems)
    rows = 8192 // (2 * 128 * elems * size)
    return groups, groups * rows


def split_ranges(length, page_size, pages_per_slot, splits):
    """[start, end) of each split that gets positions, as the kernel
    deals a slot's live pages out."""
    length = min(length, pages_per_slot * page_size)
    pages = -(-length // page_size) if length > 0 else 0
    if pages == 0:
        return []
    per = -(-pages // splits)
    live = -(-pages // per)
    return [(s * per * page_size, min((s + 1) * per * page_size, length))
            for s in range(live)]


def _merge(m, l, acc):
    """Online-softmax states (m, l in log2 units; acc (..., d)) merged
    over their first dim in order, as the kernel merges row groups and
    splits."""
    m_all = m.max(0).values
    w = torch.exp2(m - m_all)
    return m_all, (w * l).sum(0), (w[..., None] * acc).sum(0)


def emulated_split_decode(q, k_pages, v_pages, tables, lengths, splits,
                          scale=None):
    """The split-K kernel's arithmetic in fp32, cast to q's dtype."""
    b, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    page_size = k_pages.shape[1]
    groups, chunk = _geometry(q.dtype, d)
    kf = k_pages.reshape(-1, h, d)
    vf = v_pages.reshape(-1, h, d)
    out = torch.zeros(b, h, d)
    for slot in range(b):
        parts = []
        for start, end in split_ranges(int(lengths[slot]), page_size,
                                       tables.shape[1], splits):
            pos = torch.arange(start, end)
            rows = tables[slot, pos // page_size].long() * page_size \
                + pos % page_size
            qs = q[slot].float() * (scale * LOG2E)
            s = torch.einsum("hd,nhd->hn", qs, kf[rows].float())
            group = ((pos - start) % chunk) % groups
            ms, ls, accs = [], [], []
            for g in range(groups):
                sel = group == g
                if not bool(sel.any()):  # no live position: weight 0
                    ms.append(torch.full((h,), -1e30))
                    ls.append(torch.zeros(h))
                    accs.append(torch.zeros(h, d))
                    continue
                sg = s[:, sel]
                m = sg.max(-1).values
                p = torch.exp2(sg - m[:, None])
                ms.append(m)
                ls.append(p.sum(-1))
                accs.append(torch.einsum("hn,nhd->hd", p,
                                         vf[rows[sel]].float()))
            parts.append(_merge(torch.stack(ms), torch.stack(ls),
                                torch.stack(accs)))
        if parts:
            _, l, acc = _merge(*(torch.stack(x) for x in zip(*parts)))
            out[slot] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


@functools.lru_cache(maxsize=1)
def _serving_arrays(seed):
    rng = np.random.RandomState(seed)
    n_pages = SLOTS * PPS + 1
    q = rng.randn(SLOTS, HEADS, D).astype(np.float32)
    k = rng.randn(n_pages, PAGE, HEADS, D).astype(np.float32)
    v = rng.randn(n_pages, PAGE, HEADS, D).astype(np.float32)
    tables = (rng.permutation(SLOTS * PPS) + 1).reshape(SLOTS, PPS)
    return q, k, v, tables


def _serving_inputs(dtype, lengths, seed=0):
    q, k, v, tables = _serving_arrays(seed)
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype),
            torch.tensor(tables, dtype=torch.int32),
            torch.tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("case", sorted(LENGTHS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_merge_within_tolerance(dtype, case):
    dt = getattr(torch, dtype)
    q, k, v, tables, lens = _serving_inputs(dt, LENGTHS[case])
    got = emulated_split_decode(q, k, v, tables, lens, SPLITS)
    ref = paged_decode_reference(q, k, v, tables, lens)
    assert got.dtype == ref.dtype == dt
    torch.testing.assert_close(got.float(), ref.float(), **TOLERANCE[dt])
    for s, n in enumerate(LENGTHS[case]):
        if n == 0:
            assert torch.all(got[s] == 0)


@pytest.mark.parametrize("splits", [1, 2, 5, PPS])
def test_any_split_count_within_tolerance(splits):
    """One split (no merge), a few, and one page a split."""
    q, k, v, tables, lens = _serving_inputs(torch.float32, LENGTHS["ragged"],
                                            seed=1)
    got = emulated_split_decode(q, k, v, tables, lens, splits)
    ref = paged_decode_reference(q, k, v, tables, lens)
    torch.testing.assert_close(got, ref, **TOLERANCE[torch.float32])


def test_split_merge_matches_jax_reference():
    """The emulation against the JAX package's plain version on the same
    numpy inputs (fp32)."""
    q, k, v, tables, lens = _serving_inputs(torch.float32,
                                            LENGTHS["one_long"], seed=2)
    got = emulated_split_decode(q, k, v, tables, lens, SPLITS)
    want = np.asarray(jax_paged_decode_reference(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, tables, lens))))
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCE[torch.float32])


def test_dead_pages_never_read():
    """Pages past each slot's length poisoned with NaN leave the output
    bit for bit unchanged: no split reads them."""
    lengths = LENGTHS["ragged"]
    q, k, v, tables, lens = _serving_inputs(torch.bfloat16, lengths, seed=3)
    clean = emulated_split_decode(q, k, v, tables, lens, SPLITS)
    for s, n in enumerate(lengths):
        dead = tables[s, -(-n // PAGE):].long()
        k[dead] = float("nan")
        v[dead] = float("nan")
    assert torch.equal(emulated_split_decode(q, k, v, tables, lens, SPLITS),
                       clean)


@pytest.mark.parametrize("splits", [1, 2, 3, SPLITS, 64, PPS])
def test_partition_covers_live_pages_once(splits):
    """Every live position lies in exactly one split, every split but a
    slot's last ends on a page boundary, no split reaches a dead page,
    and at most ``splits`` splits get positions."""
    for length in list(range(0, 70)) + [255, 256, 257, 1000, 2047, 2048,
                                        2049, 5000]:
        ranges = split_ranges(length, PAGE, PPS, splits)
        live = min(length, PPS * PAGE)
        assert len(ranges) <= splits
        covered = [p for a, b in ranges for p in range(a, b)]
        assert covered == list(range(live))
        for a, b in ranges[:-1]:
            assert a % PAGE == 0 and b % PAGE == 0 and b > a
        if ranges:
            assert ranges[-1][0] % PAGE == 0
            assert max(b for _, b in ranges) == live


def test_decode_splits_fill_the_card():
    """At the serving geometry on an H100 (132 SMs): at least two blocks
    an SM, BLOCKS_PER_SM of them; never more splits than pages, never
    fewer than one."""
    assert BLOCKS_PER_SM >= 2
    assert SPLITS == math.ceil(BLOCKS_PER_SM * H100_SMS / (SLOTS * HEADS))
    assert SLOTS * HEADS * SPLITS >= 2 * H100_SMS
    assert decode_splits(SLOTS, HEADS, 4, H100_SMS) == 4
    assert decode_splits(512, 64, PPS, H100_SMS) == 1
    assert decode_splits(1, 1, PPS, H100_SMS) == PPS
