"""Decode steps over the paged KV cache (port of
``chainermn_tpu/serving/decode.py``).

:class:`PagedLM` runs a :class:`~chainermn_tpu_torch.models.transformer.
TransformerLM`'s forward against an external KV cache, reusing the
model's own parameters.  Two cache layouts, one math:

* ``layout="paged"``: pages gathered through the block table; the
  attend is the dtype flow of the JAX package's ``_attend_cached``
  (QK in the compute dtype, fp32 softmax, PV in the compute dtype);
* ``layout="dense"``: the test oracle, a contiguous per-slot cache
  written by position, no block table anywhere.  Same contraction
  length and masking, so the paged step equals it bit for bit.

``attention_impl="flash"`` sends single-token decode steps through
:func:`~chainermn_tpu_torch.ops.flash_decode.flash_decode` (the
hand-written CUDA kernel on the card); prefill keeps the dense attend.

Unlike the JAX engine, whose compiled step returns fresh page arrays,
the port writes the page pool in place.  Not ported yet: tensor
parallelism, ``verify_step`` (speculative decode), KV export/import and
the analysis hooks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..models.transformer import TransformerLM, dense
from ..observability import timeline as _obs
from ..ops.flash_decode import flash_decode
from ..resilience import fault_injection as _fi
from .kv_cache import NULL_PAGE, PagedKVCache, pages_needed

_LAYOUTS = ("paged", "dense")
_ATTENTION_IMPLS = ("dense", "flash")


def _write_paged(kl, vl, k, v, tables, lengths, page_size):
    """Scatter this call's k/v rows into one layer's page pool, in
    place.  Cache position for (row b, step j) is ``lengths[b] + j``;
    its page comes from the row's block table.  Positions past the
    table width land on the null page, as do inactive slots (length 0,
    table all null)."""
    b, s = k.shape[:2]
    pos = lengths[:, None].long() + torch.arange(s, device=k.device)[None]
    idx = pos // page_size
    width = tables.shape[1]
    page = torch.gather(tables.long(), 1, idx.clamp(0, width - 1))
    page = page.masked_fill(idx >= width, NULL_PAGE)
    off = pos % page_size
    page, off = page.reshape(-1), off.reshape(-1)
    kl[page, off] = k.reshape(b * s, *k.shape[2:])
    vl[page, off] = v.reshape(b * s, *v.shape[2:])


def _write_dense(kl, vl, k, v, lengths):
    """The oracle's write: by position into a contiguous per-slot cache,
    in place."""
    b, s = k.shape[:2]
    rows = torch.arange(b, device=k.device)[:, None].expand(b, s)
    pos = lengths[:, None].long() + torch.arange(s, device=k.device)[None]
    kl[rows, pos] = k
    vl[rows, pos] = v


def _attend_cached(q, kg, vg, lengths, scale):
    """The decode attend on a gathered/contiguous cache view ``(b, K,
    heads, dh)``: QK in the compute dtype, fp32 softmax masked with
    ``finfo(float32).min``, PV in the compute dtype.  Shared by both
    layouts, so their bit-identity is a property of the plumbing."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kg).float() * scale
    kpos = torch.arange(kg.shape[1], device=q.device)[None, :]
    # query row j sits at cache position lengths[b] + j and sees every
    # position up to its own, including the k/v this call just wrote
    qpos = lengths[:, None].long() + torch.arange(s, device=q.device)[None]
    mask = kpos[None] <= qpos[:, :, None]                      # (b, s, K)
    scores = scores.masked_fill(~mask[:, None],
                                torch.finfo(torch.float32).min)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vg)


class PagedLM(nn.Module):
    """``lm``'s forward against an external cache, in either layout.

    ``forward(tokens, k_pages, v_pages, tables, lengths)`` takes tokens
    ``(b, s)`` int64, the cache ``(n_layers, ...)`` (written in place),
    block tables ``(b, pages_per_slot)`` int32 (slot ids for the dense
    layout) and each row's cached length ``(b,)`` int32; returns fp32
    logits ``(b, s, vocab)``."""

    def __init__(self, lm: TransformerLM, *, layout: str = "paged",
                 attention_impl: str = "dense", page_size: int = 16):
        super().__init__()
        self.lm = lm
        self.layout = layout
        self.attention_impl = attention_impl
        self.page_size = int(page_size)

    def _attend(self, attn, x, kl, vl, tables, lengths):
        b, s, d = x.shape
        q, k, v = attn.project_qkv(x)
        scale = (d // attn.n_heads) ** -0.5
        if self.layout == "paged":
            _write_paged(kl, vl, k, v, tables, lengths, self.page_size)
            if self.attention_impl == "flash" and s == 1:
                out = flash_decode(
                    q[:, 0].contiguous(), kl, vl, tables, lengths + 1,
                    scale=scale,
                )[:, None]
            else:
                kg = kl[tables.long()].reshape(b, -1, *k.shape[2:])
                vg = vl[tables.long()].reshape(b, -1, *v.shape[2:])
                out = _attend_cached(q, kg, vg, lengths, scale)
        else:
            _write_dense(kl, vl, k, v, lengths)
            out = _attend_cached(q, kl, vl, lengths, scale)
        return dense(out.reshape(b, s, d), attn.proj, attn.dtype)

    def forward(self, tokens, k_pages, v_pages, tables, lengths):
        lm = self.lm
        s = tokens.shape[1]
        positions = (lengths[:, None].long()
                     + torch.arange(s, device=tokens.device)[None])
        pos = lm.pos_embed[positions.clamp(0, lm.max_len - 1)]
        x = (lm.embed(tokens) + pos).to(lm.dtype)
        for i, blk in enumerate(lm.blocks):
            h = blk.ln1(x.float()).to(lm.dtype)
            x = x + self._attend(blk.attn, h, k_pages[i], v_pages[i],
                                 tables, lengths)
            x = x + blk.mlp(blk.ln2(x.float()).to(lm.dtype))
        return lm.head(x)


class DecodeEngine:
    """The decode/prefill steps and the page pool for one replica.

    ``model``: the :class:`TransformerLM` to serve; the engine moves it
    to ``device`` (default ``"cuda"``, which raises without a card; pass
    ``device="cpu"`` to run on the CPU).  ``capacity`` fixed decode
    slots (the padded slot model: every decode step runs every slot;
    prompts pad to ``page_size`` buckets).
    """

    def __init__(self, model: TransformerLM, *,
                 capacity: int = 4, page_size: int = 16,
                 pages_per_slot: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 layout: str = "paged",
                 attention_impl: str = "dense",
                 device="cuda"):
        if layout not in _LAYOUTS:
            raise ValueError(f"layout must be one of {_LAYOUTS}")
        if attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {_ATTENTION_IMPLS}"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        if pages_per_slot is None:
            pages_per_slot = pages_needed(model.max_len, page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.layout = layout
        self.attention_impl = attention_impl
        self.module = PagedLM(model, layout=layout,
                              attention_impl=attention_impl,
                              page_size=self.page_size)
        d_head = model.d_model // model.n_heads
        self.cache = PagedKVCache(
            n_layers=model.n_layers, n_heads=model.n_heads, d_head=d_head,
            capacity=self.capacity, page_size=self.page_size,
            num_pages=num_pages, pages_per_slot=self.pages_per_slot,
            dtype=model.dtype, device=self.device,
        )
        # an explicit (small) num_pages also bounds the admissible
        # request: one needing more pages than the whole pool could
        # never be admitted, so submit() must reject it up front
        self.max_total = min(
            self.pages_per_slot * self.page_size, model.max_len,
            (self.cache.num_pages - 1) * self.page_size,
        )
        if layout == "dense":
            # the oracle's contiguous per-slot cache, sized to the SAME
            # contraction length as the paged pool
            shape = (model.n_layers, self.capacity, self.max_pages_tokens,
                     model.n_heads, d_head)
            self.cache.k_pages = torch.zeros(shape, dtype=model.dtype,
                                             device=self.device)
            self.cache.v_pages = torch.zeros(shape, dtype=model.dtype,
                                             device=self.device)
        self.steps = 0

    @property
    def max_pages_tokens(self) -> int:
        return self.pages_per_slot * self.page_size

    def _ints(self, a, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor(a, dtype=dtype, device=self.device)

    def _run(self, tokens: np.ndarray, k_pages, v_pages, tables,
             lengths) -> torch.Tensor:
        with torch.no_grad():
            return self.module(self._ints(tokens, torch.int64), k_pages,
                               v_pages, tables, lengths)

    # -- serving ops ----------------------------------------------------
    def prompt_bucket(self, prompt_len: int) -> int:
        """Prompts pad to page_size multiples."""
        return max(pages_needed(prompt_len, self.page_size)
                   * self.page_size, self.page_size)

    def admit(self, total_tokens: int, prefix=None,
              slot: Optional[int] = None) -> int:
        if total_tokens > self.max_total:
            raise ValueError(
                f"request needs {total_tokens} cache positions > "
                f"max_total={self.max_total} (pages_per_slot * "
                "page_size, capped by model.max_len)"
            )
        return self.cache.admit(total_tokens, prefix=prefix, slot=slot)

    def release(self, slot: int) -> None:
        self.cache.release(slot)

    def _tables_for(self, rows) -> torch.Tensor:
        if self.layout == "dense":
            # the oracle has no tables; pass the slot ids (unused by the
            # dense write/attend, but keeps one call signature)
            return self._ints(np.asarray(rows, np.int32).reshape(-1, 1),
                              torch.int32)
        return self._ints(self.cache.block_tables[rows], torch.int32)

    def prefill(self, slot: int, prompt: Sequence[int]) -> np.ndarray:
        """Run the prompt through the model, writing its k/v into the
        slot's pages; returns the next-token logits row (vocab,).  The
        prompt is padded to its page bucket; padded positions hold
        garbage k/v that the masked attend never reads.  A slot admitted
        over a shared prefix runs only the tail ``prompt[start:]``."""
        prompt = np.asarray(prompt, np.int64)
        n = int(prompt.shape[0])
        if n < 1:
            raise ValueError("empty prompt")
        start = int(self.cache.lengths[slot])
        if start >= n:
            raise ValueError(
                f"slot {slot} already holds {start} positions >= "
                f"prompt length {n} (a shared prefix is capped at "
                "len(prompt)-1 so the tail is never empty)"
            )
        nt = n - start
        _fi.fire("serving.prefill")
        with _obs.span("serving.prefill", slot=slot, prompt=n,
                       shared=start):
            bucket = self.prompt_bucket(nt)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :nt] = prompt[start:]
            if self.layout == "paged":
                # copy-on-write BEFORE the write: a capped shared prefix
                # puts the first written position inside a shared page
                self.cache.cow_for_write(slot, bucket)
                k_in, v_in = self.cache.k_pages, self.cache.v_pages
            else:
                k_in = self.cache.k_pages[:, slot: slot + 1]
                v_in = self.cache.v_pages[:, slot: slot + 1]
            logits = self._run(toks, k_in, v_in, self._tables_for([slot]),
                               self._ints([start], torch.int32))
            self.cache.advance(slot, nt)
            return logits[0, nt - 1].cpu().numpy()

    def decode_step(self, tokens: np.ndarray) -> np.ndarray:
        """One token for every slot (inactive slots run too, on the null
        page, and their logits are garbage the batcher ignores).
        ``tokens``: (capacity,) each active slot's pending token.
        Returns (capacity, vocab) logits; active slots' cache lengths
        advance by one."""
        _fi.fire("serving.decode_step")
        active = [s for s in range(self.capacity) if self.cache.active[s]]
        with _obs.span("serving.decode", active=len(active)):
            toks = np.asarray(tokens, np.int64).reshape(self.capacity, 1)
            if self.layout == "paged":
                for s in active:
                    self.cache.cow_for_write(s, 1)
            if self.layout == "dense":
                tables = self._tables_for(list(range(self.capacity)))
            else:
                tables = self.cache.tables_array()
            logits = self._run(toks, self.cache.k_pages,
                               self.cache.v_pages, tables,
                               self.cache.lengths_array())
            for s in active:
                self.cache.advance(s, 1)
            self.steps += 1
            return logits[:, 0].cpu().numpy()

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_id: Optional[int] = None) -> list:
        """Single-request greedy decode (admit -> prefill -> decode loop
        -> release).  Returns prompt + generated tokens."""
        prompt = [int(t) for t in prompt]
        slot = self.admit(len(prompt) + max_new_tokens)
        try:
            logits = self.prefill(slot, prompt)
            out = list(prompt)
            tok = int(np.argmax(logits))
            out.append(tok)
            for _ in range(max_new_tokens - 1):
                if eos_id is not None and tok == eos_id:
                    break
                toks = np.zeros((self.capacity,), np.int64)
                toks[slot] = tok
                step_logits = self.decode_step(toks)
                tok = int(np.argmax(step_logits[slot]))
                out.append(tok)
        finally:
            self.release(slot)
        return out
