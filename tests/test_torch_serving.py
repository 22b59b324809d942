"""Port parity: the port's ``DecodeEngine`` and ``ContinuousBatcher``
against the JAX package's, plus the port's own pins (paged == dense
oracle bit for bit, the flash attend against the dense attend, retry on
a recoverable fault, the card as the default device).

Weights are the JAX model's, carried over by ``lm_params_from_flax``;
the JAX side runs on the CPU as ``tests/test_serving.py`` runs it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from chainermn_tpu.serving.batcher import Request as JaxRequest
from chainermn_tpu.serving.decode import DecodeEngine as JaxEngine
from chainermn_tpu_torch.models import TransformerLM, lm_params_from_flax
from chainermn_tpu_torch.observability import observe
from chainermn_tpu_torch.ops.flash_decode import flash_decode
from chainermn_tpu_torch.resilience import (
    FaultSpec,
    PreemptionError,
    inject_faults,
)
from chainermn_tpu_torch.serving import ContinuousBatcher, DecodeEngine, Request

VOCAB, D, HEADS, LAYERS, MAXLEN = 64, 32, 4, 2, 64

# fp32 models on both sides: logits agree to float roundoff (the
# frameworks' matmuls and LayerNorms round differently by a few ulps)
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_lm():
    model = JaxLM(vocab_size=VOCAB, d_model=D, n_heads=HEADS,
                  n_layers=LAYERS, max_len=MAXLEN, dtype=jnp.float32)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16), jnp.int32),
    )
    return model, params


def _jax_engine(model, params, **kw):
    """The JAX engine with its step made synchronous.  Its decode step
    reads ``cache.lengths`` through a zero-copy ``jnp.asarray`` view and
    runs asynchronously while ``advance()`` mutates that array in place,
    so on the CPU the step can read the advanced lengths (seen as flaky
    1e-2..1e-1 logits errors).  Waiting for the step before the host
    goes on gives the values the engine means to compute."""
    eng = JaxEngine(model, params, **kw)
    step = eng._fn
    eng._fn = lambda *args: jax.block_until_ready(step(*args))
    return eng


def _port_lm(jax_lm, dtype=torch.float32):
    lm = TransformerLM(VOCAB, D, HEADS, LAYERS, max_len=MAXLEN, dtype=dtype)
    params = jax.tree_util.tree_map(np.asarray, jax_lm[1])
    lm.load_state_dict(lm_params_from_flax(params))
    return lm


def _script(eng):
    """Joins, a leave mid-stream and slot reuse with ragged lengths (the
    interleave of tests/test_serving.py's bit-exactness pin); returns
    every logits row produced, in order."""
    rng = np.random.RandomState(1)
    p0 = rng.randint(0, VOCAB, 5).tolist()
    p1 = rng.randint(0, VOCAB, 11).tolist()   # ragged vs page 8
    p2 = rng.randint(0, VOCAB, 3).tolist()
    logs = []
    s0 = eng.admit(5 + 12)
    lg = eng.prefill(s0, p0); logs.append(lg); t0 = int(np.argmax(lg))
    for _ in range(2):
        tk = np.zeros(3, np.int32); tk[s0] = t0
        lg = eng.decode_step(tk)
        logs.append(lg[s0].copy()); t0 = int(np.argmax(lg[s0]))
    s1 = eng.admit(11 + 6)
    lg = eng.prefill(s1, p1); logs.append(lg); t1 = int(np.argmax(lg))
    for _ in range(3):
        tk = np.zeros(3, np.int32); tk[s0] = t0; tk[s1] = t1
        lg = eng.decode_step(tk)
        logs.append(lg[[s0, s1]].copy())
        t0, t1 = int(np.argmax(lg[s0])), int(np.argmax(lg[s1]))
    eng.release(s0)  # leave mid-stream; s2 joins into freed pages
    s2 = eng.admit(3 + 4)
    lg = eng.prefill(s2, p2); logs.append(lg); t2 = int(np.argmax(lg))
    for _ in range(2):
        tk = np.zeros(3, np.int32); tk[s1] = t1; tk[s2] = t2
        lg = eng.decode_step(tk)
        logs.append(lg[[s1, s2]].copy())
        t1, t2 = int(np.argmax(lg[s1])), int(np.argmax(lg[s2]))
    return logs


@pytest.mark.parametrize("attention_impl", ["dense", "flash"])
def test_engine_interleave_matches_jax(jax_lm, attention_impl):
    """Every logits row of the scripted interleave within 1e-5 of the
    JAX engine's (fp32 models)."""
    model, params = jax_lm
    ref = _script(_jax_engine(model, params, capacity=3, page_size=8,
                              attention_impl=attention_impl))
    got = _script(DecodeEngine(_port_lm(jax_lm), capacity=3, page_size=8,
                               attention_impl=attention_impl,
                               device="cpu"))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=f"row {i}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_equals_dense_oracle_bit_identical(dtype):
    """The port's own acceptance pin: the paged layout equals the dense
    contiguous-cache oracle at 0 tolerance through joins, leaves, slot
    reuse and ragged final pages."""
    lm = TransformerLM(VOCAB, D, HEADS, LAYERS, max_len=MAXLEN,
                       dtype=getattr(torch, dtype), seed=3)
    paged = _script(DecodeEngine(lm, capacity=3, page_size=8,
                                 layout="paged", device="cpu"))
    dense = _script(DecodeEngine(lm, capacity=3, page_size=8,
                                 layout="dense", device="cpu"))
    assert len(paged) == len(dense)
    for i, (a, b) in enumerate(zip(paged, dense)):
        np.testing.assert_array_equal(a, b, err_msg=f"row {i}")


def test_flash_impl_matches_dense_impl(jax_lm):
    """The flash attend (here its plain version, on CPU tensors) agrees
    with the dense attend: fp32 model, so the only difference is the
    fp32-vs-compute-dtype flow and the softmax association (the JAX
    package's 1e-4 pin)."""
    lm = _port_lm(jax_lm)
    prompt = [7, 1, 42, 9, 3]
    dense = DecodeEngine(lm, capacity=2, page_size=8, device="cpu")
    flash = DecodeEngine(lm, capacity=2, page_size=8,
                         attention_impl="flash", device="cpu")
    s_d, s_f = dense.admit(5 + 6), flash.admit(5 + 6)
    ld, lf = dense.prefill(s_d, prompt), flash.prefill(s_f, prompt)
    np.testing.assert_array_equal(ld, lf)  # prefill is dense in both
    t = int(np.argmax(ld))
    launches = flash_decode.launches
    for _ in range(4):
        tk = np.zeros(2, np.int32); tk[0] = t
        a = dense.decode_step(tk)[0]
        b = flash.decode_step(tk)[0]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        t = int(np.argmax(a))
    assert flash_decode.launches == launches  # CPU tensors: no kernel


def _shared_prompts(n, seed=17, page=8):
    """Prompts over one page-aligned shared system prefix + unique
    tails (the mix of tests/test_serving.py's prefix-sharing pin)."""
    rng = np.random.RandomState(seed)
    head = rng.randint(0, VOCAB, page).tolist()
    return [head + rng.randint(0, VOCAB, 2 + rng.randint(3)).tolist()
            for _ in range(n)]


def _record_rows(eng, rows):
    """Wrap an engine's prefill/decode_step to record the logits rows
    the batcher reads (active slots only)."""
    prefill, decode_step = eng.prefill, eng.decode_step

    def rec_prefill(slot, prompt):
        out = prefill(slot, prompt)
        rows.append(np.asarray(out))
        return out

    def rec_decode(tokens):
        active = [s for s in range(eng.capacity) if eng.cache.active[s]]
        out = decode_step(tokens)
        rows.extend(np.asarray(out)[s] for s in active)
        return out

    eng.prefill, eng.decode_step = rec_prefill, rec_decode


def test_batcher_serve_matches_jax(jax_lm):
    """A 6-request stream over one shared prefix: same greedy tokens,
    prefix hits and token count as the JAX batcher, every logits row
    within 1e-5.  The reference's top-2 logit gap exceeds 10x that
    tolerance at every step, so no near-tie decides a token."""
    model, params = jax_lm
    prompts = _shared_prompts(6, seed=4)
    ref_rows, got_rows = [], []
    jeng = _jax_engine(model, params, capacity=3, page_size=8)
    _record_rows(jeng, ref_rows)
    jb = JaxBatcher(jeng)
    ref = jb.serve([JaxRequest(p, 3 + i % 3, id=f"r{i}")
                    for i, p in enumerate(prompts)])
    eng = DecodeEngine(_port_lm(jax_lm), capacity=3, page_size=8,
                       device="cpu")
    _record_rows(eng, got_rows)
    tb = ContinuousBatcher(eng)
    got = tb.serve([Request(p, 3 + i % 3, id=f"r{i}")
                    for i, p in enumerate(prompts)])
    top2 = np.sort(np.stack(ref_rows), axis=-1)[:, -2:]
    assert np.min(top2[:, 1] - top2[:, 0]) > 10 * TOL
    assert [r.output for r in got] == [r.output for r in ref]
    assert [r.state for r in got] == ["done"] * 6
    assert tb.prefix_hits == jb.prefix_hits >= 1
    assert tb.prefix_tokens_shared == jb.prefix_tokens_shared
    assert tb.tokens_generated == jb.tokens_generated
    assert len(got_rows) == len(ref_rows)
    np.testing.assert_allclose(np.stack(got_rows), np.stack(ref_rows),
                               rtol=TOL, atol=TOL)


def test_generate_matches_jax(jax_lm):
    """Single-request greedy decode: the JAX engine's tokens, also when an
    eos stops it early, and every page back in the pool after.  As in
    the batcher test, no near-tie in the reference decides a token."""
    model, params = jax_lm
    prompt = [5, 9, 2, 33, 7, 1, 60, 12, 3]
    ref_rows = []
    jeng = _jax_engine(model, params, capacity=2, page_size=8)
    _record_rows(jeng, ref_rows)
    ref = jeng.generate(prompt, 6)
    top2 = np.sort(np.stack(ref_rows), axis=-1)[:, -2:]
    assert np.min(top2[:, 1] - top2[:, 0]) > 10 * TOL
    eng = DecodeEngine(_port_lm(jax_lm), capacity=2, page_size=8,
                       device="cpu")
    assert eng.generate(prompt, 6) == ref
    eos = ref[len(prompt) + 2]
    stop = ref.index(eos, len(prompt)) + 1
    assert eng.generate(prompt, 6, eos_id=eos) == ref[:stop]
    assert eng.cache.used_pages == 0


def test_recoverable_fault_requeues_and_outputs_match(jax_lm):
    """An injected transient at the second decode step evicts and
    re-queues the in-flight requests; greedy decode replays them to the
    same tokens as the fault-free serve."""
    lm = _port_lm(jax_lm)
    prompts = _shared_prompts(4, seed=5)

    def serve(faults):
        eng = DecodeEngine(lm, capacity=2, page_size=8, device="cpu")
        b = ContinuousBatcher(eng, max_retries=1)
        with inject_faults(faults):
            out = b.serve([Request(p, 4, id=f"r{i}")
                           for i, p in enumerate(prompts)])
        return out, b

    clean, _ = serve([])
    faulty, b = serve([FaultSpec("serving.decode_step", "timeout", at=[2])])
    assert [r.output for r in faulty] == [r.output for r in clean]
    assert sum(r.retries for r in faulty) == 2  # both in-flight slots
    assert b.engine.cache.used_pages == 0


def test_retry_budget_exhaustion_fails_request_not_batch(jax_lm):
    eng = DecodeEngine(_port_lm(jax_lm), capacity=2, page_size=8,
                       device="cpu")
    b = ContinuousBatcher(eng, max_retries=0)
    with inject_faults([FaultSpec("serving.prefill", "timeout", at=[1])]):
        out = b.serve([Request([1, 2, 3], 3, id="a"),
                       Request([4, 5, 6], 3, id="b")])
    assert [r.state for r in out] == ["failed", "done"]
    assert "retries exhausted" in out[0].error


@pytest.mark.parametrize("kind,exc", [("preempt", PreemptionError),
                                      ("error", RuntimeError)])
def test_unrecoverable_faults_propagate(jax_lm, kind, exc):
    """A preemption notice (the drain signal) and a fault outside the
    resilience taxonomy escape the batcher unretried, with the in-flight
    slot still allocated."""
    eng = DecodeEngine(_port_lm(jax_lm), capacity=2, page_size=8,
                       device="cpu")
    b = ContinuousBatcher(eng, max_retries=3)
    req = Request([1, 2, 3], 4, id="a")
    with inject_faults([FaultSpec("serving.decode_step", kind, at=[1])]):
        with pytest.raises(exc, match="injected"):
            b.serve([req])
    assert req.retries == 0 and req.state == "running"
    assert list(b.active) == [req.slot] and eng.cache.used_pages > 0
    assert not b.finished


def test_latency_report_and_spans(jax_lm):
    eng = DecodeEngine(_port_lm(jax_lm), capacity=2, page_size=8,
                       device="cpu")
    b = ContinuousBatcher(eng)
    with observe() as tel:
        b.serve([Request([1, 2, 3], 4), Request([5, 6], 3)])
    rep = b.latency_report()
    assert rep["done"] == 2 and rep["tokens_generated"] == 7
    for name in ("serving.token_latency", "serving.ttft",
                 "serving.prefill_latency"):
        assert rep[name]["n"] > 0 and rep[name]["p99_ms"] >= 0
    names = {e["name"] for e in tel.timeline.spans()}
    assert {"serving.step", "serving.prefill", "serving.decode"} <= names


def test_request_over_capacity_rejected(jax_lm):
    eng = DecodeEngine(_port_lm(jax_lm), capacity=1, page_size=8,
                       pages_per_slot=2, device="cpu")
    with pytest.raises(ValueError, match="max_total"):
        eng.admit(17)
    with pytest.raises(ValueError, match="max_total"):
        ContinuousBatcher(eng).submit(Request([1] * 10, 8))


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """No silent CPU fallback: without a card the default device raises;
    only an explicit device='cpu' runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = TransformerLM(VOCAB, D, HEADS, LAYERS, max_len=MAXLEN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(lm, capacity=2, page_size=8)
    assert DecodeEngine(lm, capacity=2, page_size=8,
                        device="cpu").device.type == "cpu"
