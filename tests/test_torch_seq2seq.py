"""Port parity of the seq2seq family: ``links.LSTMStack`` (and
``MultiNodeNStepRNN``), ``models.seq2seq`` (``Encoder``, ``Decoder``,
``Seq2Seq``, the loss and metrics, ``teacher_forcing``, ``translate``),
``utils.SyntheticTranslationDataset``, and the data-parallel twin's
step (``examples/train_seq2seq.py``) against the JAX example's
(``examples/seq2seq/seq2seq.py``) at worlds 1 and 2.

Shared numpy inputs and the JAX modules' initial weights (carried over
by ``models.seq2seq_params_from_flax``) go through both packages.
Tolerances (fp32 everywhere): forward values within 1e-5 of the largest
absolute value; gradients within 1e-5 relative L2 per array; the loss
and metrics 1e-6 relative; dataset items and teacher forcing exact;
``translate``'s tokens exact in every row whose greedy path never comes
within 1e-4 of a tie between its top two logits (XLA:CPU's rounding may
flip a near tie; ROADMAP Queue 3), its teacher-forced logits as the
forward everywhere; the twin's losses 1e-5 relative and its parameters
after 3 Adam steps within 3e-5 with 99.9 % of entries within 1e-6 (as
the LM's parity test holds Adam).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chainermn_tpu as jcmn
from chainermn_tpu.links.n_step_rnn import LSTMStack as JaxLSTMStack
from chainermn_tpu.links.n_step_rnn import MultiNodeNStepRNN as JaxNStepRNN
from chainermn_tpu.models import seq2seq as jax_s2s
from chainermn_tpu.utils import SyntheticTranslationDataset as JaxDataset
from chainermn_tpu_torch.links import LSTMStack, MultiNodeNStepRNN
from chainermn_tpu_torch.models import seq2seq as s2s
from chainermn_tpu_torch.models import seq2seq_params_from_flax
from chainermn_tpu_torch.utils import SyntheticTranslationDataset

import test_torch_world as torch_world
import torch_mp_workers as W

CFG = dict(vocab=32, units=16, layers=2)
MAX_LEN, BATCH, LR, STEPS = 8, 8, 1e-3, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's in-process torch work: the
    suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return np.asarray(t.detach().numpy() if torch.is_tensor(t) else t)


def _close(got, ref, tol=1e-5):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= tol * scale


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _batches(n_steps=STEPS, batch=BATCH, seed=0):
    ds = JaxDataset(n_steps * batch, vocab=CFG["vocab"], max_len=MAX_LEN,
                    seed=seed)
    return [tuple(np.stack([ds[i][k] for i in range(s * batch,
                                                    (s + 1) * batch)])
                  for k in (0, 1)) for s in range(n_steps)]


@pytest.fixture(scope="module")
def jax_model():
    model = jax_s2s.Seq2Seq(CFG["vocab"], CFG["vocab"], CFG["units"],
                            CFG["layers"])
    xs, ys = _batches()[0]
    ys_in, _ = jax_s2s.teacher_forcing(jnp.asarray(ys))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(xs),
                                    ys_in)
    return model, _tree(variables)


def _port_model(variables):
    model = s2s.Seq2Seq(CFG["vocab"], CFG["vocab"], CFG["units"],
                        CFG["layers"])
    model.load_state_dict(seq2seq_params_from_flax(variables))
    return model


# ----------------------------------------------------------------------
# LSTMStack
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_stack_values_and_gradients_match_jax(with_state):
    """Values and the gradients of every parameter, the inputs and the
    initial state, of ``sum(ys * w) + sum(h * wh) + sum(c * wc)``."""
    rng = np.random.RandomState(1)
    b, t, f, hidden, layers = 3, 7, 5, 8, 2
    xs = rng.randn(b, t, f).astype(np.float32)
    state = tuple(rng.randn(layers, b, hidden).astype(np.float32)
                  for _ in range(2)) if with_state else None
    w, wh, wc = (rng.randn(*s).astype(np.float32)
                 for s in ((b, t, hidden), (layers, b, hidden),
                           (layers, b, hidden)))
    jm = JaxLSTMStack(hidden, layers)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), xs, state)

    def jloss(p, xs, state):
        (h, c), ys = jm.apply(p, xs, state)
        return jnp.sum(ys * w) + jnp.sum(h * wh) + jnp.sum(c * wc)

    (jh, jc), jys = jax.jit(jm.apply)(params, xs, state)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(params, xs, state)

    m = LSTMStack(f, hidden, layers)
    m.load_state_dict(seq2seq_params_from_flax(_tree(params)))
    xt = torch.tensor(xs, requires_grad=True)
    st = (tuple(torch.tensor(s, requires_grad=True) for s in state)
          if with_state else None)
    (h, c), ys = m(xt, st)
    for got, ref in ((h, jh), (c, jc), (ys, jys)):
        _close(got, ref)
    (ys * torch.from_numpy(w)).sum().add((h * torch.from_numpy(wh)).sum()) \
        .add((c * torch.from_numpy(wc)).sum()).backward()
    ref = seq2seq_params_from_flax(_tree(jg[0]))
    for k, p in m.named_parameters():
        assert _rel_l2(_np(p.grad), ref[k].numpy()) < 1e-5, k
    assert _rel_l2(_np(xt.grad), jg[1]) < 1e-5
    if with_state:
        for got, g in zip(st, jg[2]):
            assert _rel_l2(_np(got.grad), g) < 1e-5
    # MultiNodeNStepRNN: the same stack under the flax name LSTMStack_0
    jn = JaxNStepRNN(hidden, layers)
    nparams = jax.jit(jn.init)(jax.random.PRNGKey(3), xs, state)
    n = MultiNodeNStepRNN(f, hidden, layers)
    n.load_state_dict(seq2seq_params_from_flax(_tree(nparams)))
    (_, _), nys = n(torch.from_numpy(xs), None if st is None else
                    tuple(s.detach() for s in st))
    _close(nys, jax.jit(jn.apply)(nparams, xs, state)[1])


# ----------------------------------------------------------------------
# Encoder, Decoder, Seq2Seq, the loss, translate
# ----------------------------------------------------------------------
def test_encoder_decoder_seq2seq_logits_and_gradients_match_jax(jax_model):
    """``Encoder`` (PAD embeddings masked), ``Decoder`` (fp32 projection)
    and ``Seq2Seq`` on PAD-padded batches; the gradients of the masked
    loss."""
    model, variables = jax_model
    xs, ys = _batches()[1]
    ys_in, ys_out = jax_s2s.teacher_forcing(jnp.asarray(ys))
    port = _port_model(variables)
    pxs, pys = torch.from_numpy(xs), torch.from_numpy(ys)
    p_in, p_out = s2s.teacher_forcing(pys)
    np.testing.assert_array_equal(_np(p_in), np.asarray(ys_in))
    np.testing.assert_array_equal(_np(p_out), np.asarray(ys_out))

    (jh, jc), jouts = jax.jit(lambda v, x: model.apply(
        v, x, method=lambda m, x: m.encoder(x)))(variables, xs)
    (h, c), outs = port.encoder(pxs)
    for got, ref in ((h, jh), (c, jc), (outs, jouts)):
        _close(got, ref)
    jstate, jdec = jax.jit(lambda v, s, y: model.apply(
        v, s, y, method=jax_s2s.Seq2Seq.decode))(variables, (jh, jc), ys_in)
    state, dec = port.decode((h, c), p_in)
    _close(dec, jdec)
    _close(state[0], jstate[0])
    _close(port(pxs, p_in), jax.jit(model.apply)(variables, xs, ys_in))

    def jloss(v):
        return jax_s2s.seq2seq_loss(model.apply(v, xs, ys_in), ys_out)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables)
    loss = s2s.seq2seq_loss(port(pxs, p_in), p_out)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    ref = seq2seq_params_from_flax(_tree(jg))
    for k, p in port.named_parameters():
        assert _rel_l2(_np(p.grad), ref[k].numpy()) < 1e-5, k


@pytest.mark.parametrize("pad_share", [0.0, 0.7, 1.0])
def test_loss_and_metrics_on_pad_heavy_targets_match_jax(pad_share):
    rng = np.random.RandomState(4)
    logits = (rng.randn(4, 6, CFG["vocab"]) * 3).astype(np.float32)
    ys = rng.randint(3, CFG["vocab"], (4, 6)).astype(np.int32)
    ys[rng.rand(4, 6) < pad_share] = s2s.PAD
    # argmax hits for the accuracy
    ys[0, 0] = logits[0, 0].argmax() if pad_share < 1 else s2s.PAD
    ref = jax_s2s.seq2seq_metrics(jnp.asarray(logits), jnp.asarray(ys))
    got = s2s.seq2seq_metrics(torch.from_numpy(logits), torch.from_numpy(ys))
    for k in ("loss", "perp", "accuracy"):
        assert abs(float(got[k]) - float(ref[k])) <= 1e-6 * max(
            abs(float(ref[k])), 1.0), k
    assert (s2s.PAD, s2s.EOS, s2s.BOS, s2s.N_SPECIAL) == (
        jax_s2s.PAD, jax_s2s.EOS, jax_s2s.BOS, jax_s2s.N_SPECIAL)


def test_translate_matches_jax(jax_model):
    """Greedy decoding: tokens (after the first EOS set to PAD) equal in
    every row whose greedy path has a clear top-2 margin at each step,
    and the logits along JAX's greedy path equal everywhere."""
    model, variables = jax_model
    xs = np.concatenate([b[0] for b in _batches(2, 16, seed=5)])
    max_length = MAX_LEN + 1
    port = _port_model(variables).eval()
    got = s2s.translate(port, torch.from_numpy(xs), max_length=max_length)
    ref = jax_s2s.translate(model, variables, jnp.asarray(xs),
                            max_length=max_length)
    # JAX's raw greedy path, and both models' logits along it
    raw = np.asarray(jax_s2s._greedy_decode(model, variables,
                                            jnp.asarray(xs), max_length))
    feed = np.concatenate([np.full((len(xs), 1), s2s.BOS, np.int32),
                           raw[:, :-1]], axis=1)
    jlogits = np.asarray(jax.jit(model.apply)(variables, xs, feed))
    with torch.no_grad():
        logits = port(torch.from_numpy(xs), torch.from_numpy(feed))
    _close(logits, jlogits)
    np.testing.assert_array_equal(jlogits.argmax(-1), raw)
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 1e-4).all(axis=1)
    assert clear.sum() >= len(xs) // 2
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert got.dtype == np.int32 and got.shape == (len(xs), max_length)


def test_synthetic_translation_dataset_item_for_item():
    for args in ((40, 32, 8, 0), (25, 37, 5, 3)):
        ref, got = JaxDataset(*args), SyntheticTranslationDataset(*args)
        assert len(got) == len(ref)
        for i in list(range(len(ref))) + [-1, -len(ref)]:
            for a, b in zip(got[i], ref[i]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for a, b in zip(got[3:9:2], ref[3:9:2]):
            np.testing.assert_array_equal(a[1], b[1])
        with pytest.raises(IndexError):
            got[len(ref)]


# ----------------------------------------------------------------------
# The data-parallel twin's step
# ----------------------------------------------------------------------
def _jax_example_step(variables, n_devices):
    """The JAX example's step (``examples/seq2seq/seq2seq.py``: its
    loss_fn, ``create_multi_node_optimizer(optax.adam)``,
    ``build_train_step``) on ``n_devices`` CPU devices for 3 steps."""
    model = jax_s2s.Seq2Seq(CFG["vocab"], CFG["vocab"], CFG["units"],
                            CFG["layers"])
    comm = jcmn.create_communicator("tpu",
                                    devices=jax.devices("cpu")[:n_devices])
    opt = jcmn.create_multi_node_optimizer(optax.adam(LR), comm)

    def loss_fn(params, batch):
        xs, ys = batch
        ys_in, ys_out = jax_s2s.teacher_forcing(ys)
        return jax_s2s.seq2seq_loss(model.apply(params, xs, ys_in), ys_out)

    step = jcmn.build_train_step(comm, loss_fn, opt, donate=False)
    params, state = step.place(variables, opt.init(variables))
    losses = []
    for xs, ys in _batches():
        params, state, m = step(params, state, (jnp.asarray(xs),
                                                jnp.asarray(ys)))
        losses.append(float(m["loss"]))
    return losses, seq2seq_params_from_flax(_tree(params))


def _check_twin(got, ref):
    np.testing.assert_allclose(got["losses"], ref[0], rtol=1e-5)
    gap = np.concatenate([np.abs(v - ref[1][k].numpy()).ravel()
                          for k, v in got["params"].items()])
    assert gap.max() < 3e-5 and np.mean(gap < 1e-6) >= 0.999, (
        gap.max(), np.mean(gap < 1e-6))


def test_data_parallel_twin_step_matches_jax_example(jax_model):
    """3 Adam steps on the same global batches: world 2 (gloo, half the
    batch a rank) against the JAX step on 2 devices, world 1 against it
    on 1."""
    from chainermn_tpu_torch.communicators import create_communicator

    variables = jax_model[1]
    batches = _batches()
    with ThreadPoolExecutor(1) as pool:
        port2 = pool.submit(torch_world.run_world, W.seq2seq_dp_worker, 2,
                            CFG, variables, batches, LR, timeout=180)
        ref2 = _jax_example_step(variables, 2)
        ref1 = _jax_example_step(variables, 1)
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            got1 = W.seq2seq_dp_run(create_communicator("pure_nccl"), CFG,
                                    variables, batches, LR)
        finally:
            dist.destroy_process_group()
        ranks = port2.result()
    _check_twin(got1, ref1)
    for got in ranks:
        _check_twin(got, ref2)


def test_examples_train_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Both twins end to end on the CPU at a tiny size: the data-parallel
    one through Trainer (its loss falls, the evaluator reports
    perplexity, translate prints), the model-parallel one (its
    validation loss below the uniform guess's, log(vocab))."""
    from chainermn_tpu_torch.examples import train_seq2seq, train_seq2seq_mp1

    monkeypatch.chdir(tmp_path)
    size = ["--device", "cpu", "--epoch", "2", "--n-train", "256",
            "--n-test", "64", "--batchsize", "64", "--unit", "16"]
    log = train_seq2seq.main(size)
    assert len(log) == 2 and log[1]["loss"] < log[0]["loss"]
    assert np.isfinite(log[1]["val/perp"])
    assert "-> hyp:" in capsys.readouterr().out
    m = train_seq2seq_mp1.main(size)
    assert m["loss"] < np.log(32)
