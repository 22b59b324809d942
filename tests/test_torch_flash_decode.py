"""Port parity: ``chainermn_tpu_torch.ops.flash_decode`` against the JAX
package's ``flash_decode``.

On the CPU the port's wrapper runs its plain version
(``paged_decode_reference``), which is held here against the JAX
kernel run in interpret mode and against the JAX plain version, on the
same numpy inputs.  The CUDA kernel itself runs only on a card:
``tests/test_torch_kernels_cuda.py`` holds it against the plain version
there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainermn_tpu.ops.pallas_attention import flash_decode as jax_flash_decode
from chainermn_tpu.ops.pallas_attention import (
    paged_decode_reference as jax_paged_decode_reference,
)
from chainermn_tpu_torch.ops import _build
from chainermn_tpu_torch.ops.flash_decode import _check_args, flash_decode

# fp32 throughout: the two sides differ only in the summation order of
# their einsums (and, against the interpret-mode kernel, in its online
# softmax over pages), a few ulps of O(1) outputs
TOL = 2e-6

BT_DEFAULT = [[1, 2, 3], [4, 5, 0], [6, 0, 0]]
CASES = {
    "ragged": (BT_DEFAULT, [20, 9, 3]),
    "single_page": ([[1], [4], [6]], [5, 8, 3]),
    "zero_length": (BT_DEFAULT, [20, 0, 3]),
    "full_pages": (BT_DEFAULT, [24, 16, 8]),
}


def _pages(seed=0, B=3, H=4, Dh=32, bs=8, P=12):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Dh).astype(np.float32)
    k = rng.randn(P, bs, H, Dh).astype(np.float32)
    v = rng.randn(P, bs, H, Dh).astype(np.float32)
    return q, k, v


def _port(q, k, v, bt, lengths):
    return flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(bt, dtype=torch.int32),
        torch.tensor(lengths, dtype=torch.int32),
    ).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax(case):
    bt, lengths = CASES[case]
    q, k, v = _pages()
    ours = _port(q, k, v, bt, lengths)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bt, jnp.int32), jnp.asarray(lengths, jnp.int32))
    kernel = np.asarray(jax_flash_decode(*args, interpret=True))
    plain = np.asarray(jax_paged_decode_reference(*args))
    np.testing.assert_allclose(ours, kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, plain, rtol=TOL, atol=TOL)


def test_zero_length_slot_returns_exact_zeros():
    q, k, v = _pages()
    ours = _port(q, k, v, BT_DEFAULT, [20, 0, 3])
    assert np.all(ours[1] == 0)
    assert np.all(np.isfinite(ours))


def test_dead_pages_do_not_contribute():
    """Pages past the length are dead: poisoning them (huge finite
    values) leaves the output bit for bit unchanged."""
    q, k, v = _pages()
    lengths = [9, 9, 3]  # slot 0's third page (page 3) is dead
    clean = _port(q, k, v, BT_DEFAULT, lengths)
    k2, v2 = k.copy(), v.copy()
    k2[3], v2[3] = 1e9, 1e9
    np.testing.assert_array_equal(_port(q, k2, v2, BT_DEFAULT, lengths),
                                  clean)


def test_cpu_path_runs_no_kernel():
    before = flash_decode.launches
    q, k, v = _pages()
    _port(q, k, v, BT_DEFAULT, [20, 9, 3])
    assert flash_decode.launches == before


def _good_args():
    q, k, v = _pages(Dh=64)
    return dict(q=torch.from_numpy(q), k_pages=torch.from_numpy(k),
                v_pages=torch.from_numpy(v),
                block_tables=torch.tensor(BT_DEFAULT, dtype=torch.int32),
                lengths=torch.tensor([20, 9, 3], dtype=torch.int32))


BAD_ARGS = {
    "fp16": (lambda a: a.update(q=a["q"].half(), k_pages=a["k_pages"].half(),
                                v_pages=a["v_pages"].half()), TypeError),
    "mixed_dtype": (lambda a: a.update(k_pages=a["k_pages"].double()),
                    TypeError),
    "int64_tables": (lambda a: a.update(
        block_tables=a["block_tables"].long()), TypeError),
    "non_contiguous_q": (lambda a: a.update(
        q=a["q"].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
    "head_dim_48": (lambda a: a.update(
        q=a["q"][..., :48].contiguous(),
        k_pages=a["k_pages"][..., :48].contiguous(),
        v_pages=a["v_pages"][..., :48].contiguous()), ValueError),
    "pages_heads_mismatch": (lambda a: a.update(
        k_pages=a["k_pages"][:, :, :2].contiguous()), ValueError),
    "lengths_shape": (lambda a: a.update(lengths=a["lengths"][:2]),
                      ValueError),
}


def test_argument_checks_accept_the_serving_layout():
    _check_args(**_good_args())


@pytest.mark.parametrize("bad", sorted(BAD_ARGS))
def test_argument_checks_raise(bad):
    """What the CUDA kernel does not take raises before any launch (the
    checks run here on CPU tensors; the wrapper applies them to every
    CUDA call)."""
    mutate, exc = BAD_ARGS[bad]
    args = _good_args()
    mutate(args)
    with pytest.raises(exc):
        _check_args(**args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_name_tracks_source_and_flags(monkeypatch):
    path = _build.library_path("flash_decode")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert _build.library_path("flash_decode") == path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("flash_decode") != path
