"""Port parity: the port's ``PagedKVCache`` allocator against the JAX
package's.

The allocator is host numpy in both packages, so for the same op stream
(admit, release, evict, prefix lookup/register, copy-on-write, advance)
block tables, lengths, refcounts, free lists, CoW reserves and prefix
index must be EQUAL after every op, and both must pass their own
``check_invariants``.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu.serving.kv_cache import PagedKVCache as JaxCache
from chainermn_tpu_torch.serving.kv_cache import (
    CacheAdmissionError,
    PagedKVCache,
    pages_needed,
)

GEOMETRY = dict(n_layers=2, n_heads=2, d_head=4, capacity=3, page_size=4,
                pages_per_slot=4, num_pages=11)


def _pair():
    return (JaxCache(**GEOMETRY),
            PagedKVCache(**GEOMETRY, dtype=torch.float32, device="cpu"))


def _state(c):
    return {
        "block_tables": c.block_tables.tolist(),
        "lengths": c.lengths.tolist(),
        "active": c.active.tolist(),
        "refcounts": c._refcounts.tolist(),
        "free": list(c._free_pages),
        "slot_pages": {s: list(p) for s, p in c._slot_pages.items()},
        "admit_order": list(c._admit_order),
        "cow_reserve": dict(c._cow_reserve),
        "prefix_index": {h: (tuple(p), n)
                         for h, (p, n) in c._prefix_index.items()},
        "victim": c.choose_victim(),
        "used": c.used_pages,
    }


def _apply(c, op):
    """One op of the stream; returns what the op returned, in a form
    comparable across the packages."""
    kind, args = op[0], op[1:]
    if kind == "admit":
        total, tokens = args
        m = c.lookup_prefix(tokens) if tokens else None
        if not c.can_admit(total, prefix=m):
            return ("refused", None if m is None else tuple(m))
        return ("slot", c.admit(total, prefix=m),
                None if m is None else tuple(m))
    if kind == "register":
        slot, tokens = args
        return c.register_prefix(slot, tokens)
    if kind == "write":
        slot, n = args
        copied = c.cow_for_write(slot, n)
        c.advance(slot, n)
        return copied
    if kind == "release":
        c.release(args[0])
        return None
    if kind == "evict":
        victim = c.choose_victim()
        if victim is not None:
            c.evict(victim)
        return victim
    raise ValueError(kind)


SYS = list(range(1, 9))  # a two-page shared system prompt

SCRIPT = [
    ("admit", 14, None),              # slot 0: 4 fresh pages
    ("write", 0, 8),
    ("register", 0, SYS),             # two prefix chains
    ("admit", 12, SYS + [20, 21]),    # slot 1 aliases both pages
    ("write", 1, 2),
    ("admit", 12, SYS),               # slot 2: capped match -> CoW reserve
    ("write", 2, 1),                  # copy-on-write of the shared page
    ("write", 2, 2),
    ("admit", 4, None),               # no free slot: refused
    ("evict",),                       # every slot holds a shared page
    ("release", 0),
    ("admit", 16, [9, 9, 9, 9, 9]),   # fresh pages after the release
    ("write", 0, 5),
    ("register", 0, [9, 9, 9, 9, 9]),
    ("evict",),                       # slot 0: the only unshared slot
    ("release", 1),
    ("admit", 8, [9, 9, 9, 9, 7]),    # the evicted chain is gone: fresh
    ("write", 0, 5),
    ("release", 0),
    ("release", 2),
]


def test_scripted_op_stream_gives_equal_allocator_state():
    jc, tc = _pair()
    for i, op in enumerate(SCRIPT):
        got_j, got_t = _apply(jc, op), _apply(tc, op)
        assert got_t == got_j, f"op {i} {op}"
        assert _state(tc) == _state(jc), f"after op {i} {op}"
        jc.check_invariants()
        tc.check_invariants()
    assert tc.used_pages == 0


def _random_stream(seed, n_ops=60):
    rng = np.random.RandomState(seed)
    heads = [rng.randint(0, 5, 8).tolist() for _ in range(2)]
    ops, live = [], 0
    for _ in range(n_ops):
        r = rng.rand()
        if r < 0.45:
            head = heads[rng.randint(2)]
            prompt = head[: rng.randint(3, 9)] + rng.randint(
                0, 5, rng.randint(0, 3)).tolist()
            ops.append(("admit", len(prompt) + rng.randint(1, 5), prompt))
        elif r < 0.65:
            ops.append(("write", int(rng.randint(3)), 1))
        elif r < 0.8:
            ops.append(("release", int(rng.randint(3))))
        else:
            ops.append(("evict",))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_stream_gives_equal_allocator_state(seed):
    """Admissions with prefix lookups, registration after each prefill
    (as the batcher does), single-position writes, releases and
    evictions; ops that the allocator rejects must be rejected alike."""
    jc, tc = _pair()
    prompts = {}
    for i, op in enumerate(_random_stream(seed)):
        kind = op[0]
        if kind in ("write", "release") and not jc.active[op[1]]:
            assert not tc.active[op[1]]
            continue
        if kind == "write":
            slot = op[1]
            room = len(jc._slot_pages[slot]) * jc.page_size
            if int(jc.lengths[slot]) + 1 > room:
                continue
        got_j, got_t = _apply(jc, op), _apply(tc, op)
        assert got_t == got_j, f"op {i} {op}"
        if kind == "admit" and got_j[0] == "slot":
            slot, prompt = got_j[1], op[2]
            prompts[slot] = prompt
            fill = len(prompt) - int(jc.lengths[slot])
            for c in (jc, tc):  # prefill writes the prompt's tail
                c.cow_for_write(slot, fill)
                c.advance(slot, fill)
                c.register_prefix(slot, prompt)
        assert _state(tc) == _state(jc), f"after op {i} {op}"
        jc.check_invariants()
        tc.check_invariants()


def test_copy_on_write_copies_page_contents():
    """The CoW copy moves the shared page's K/V into the reserve."""
    c = PagedKVCache(**GEOMETRY, dtype=torch.float32, device="cpu")
    a = c.admit(12)
    c.advance(a, 8)
    c.k_pages[:, c.block_tables[a, 1]] = 3.0
    c.register_prefix(a, SYS)
    b = c.admit(12, prefix=c.lookup_prefix(SYS))
    shared = int(c.block_tables[b, 1])
    assert c.cow_for_write(b, 1)
    copy = int(c.block_tables[b, 1])
    assert copy != shared
    assert torch.equal(c.k_pages[:, copy], c.k_pages[:, shared])


def test_admission_failures_are_loud():
    c = PagedKVCache(**GEOMETRY, dtype=torch.float32, device="cpu")
    with pytest.raises(CacheAdmissionError):
        c.admit(4 * 4 + 1)  # more than pages_per_slot pages
    assert pages_needed(17, 4) == 5 and pages_needed(0, 4) == 1
