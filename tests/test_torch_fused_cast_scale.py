"""Port parity of K1, ``fused_cast_scale``: the plain version the CPU
path runs against the JAX package's Pallas kernel (interpret mode), bit
for bit, over ``TestFusedCastScale``'s shapes, every dtype pair and the
empty input; and the helper the card compares with."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.pallas_attention import fused_cast_scale as jax_fcs
from chainermn_tpu_torch.ops.fused_cast_scale import (
    cast_scale_reference, fused_cast_scale, same_bits)

DTYPES = ["float32", "bfloat16", "float16"]
# tests/test_pallas_kernels.py::TestFusedCastScale's shapes
SHAPES = [(7,), (128,), (3, 5, 11), (256, 128)]


def _input(shape, seed):
    """Values over many binades, with NaN, +-inf, -0, fp16 overflow and
    an fp16 subnormal among them (no fp32 subnormal: see
    test_fp32_subnormals_kept_where_xla_flushes)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * np.exp2(rng.randint(-20, 20, shape))
    flat = x.reshape(-1)
    special = [np.nan, np.inf, -np.inf, -0.0, 7e4, 3e-8]
    flat[:len(special)] = special[:flat.size]
    return x.astype(np.float32)


def _jax_bits(x, scale, src, dst):
    out = jax_fcs(jnp.asarray(x).astype(getattr(jnp, src)), scale,
                  getattr(jnp, dst), interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dst", DTYPES)
@pytest.mark.parametrize("src", DTYPES)
def test_plain_version_bit_equal_to_pallas_kernel(src, dst, shape):
    """Tolerance 0: both widen to fp32, multiply by the fp32-rounded
    scale and round once to the output type (NaN compared by position:
    the payload of a converted NaN is the framework's own).  Scales 1/8
    (TestFusedCastScale's) and 1/3 (inexact)."""
    x = _input(shape, len(shape))
    t = torch.from_numpy(x).to(getattr(torch, src))
    for scale in (0.125, 1.0 / 3.0):
        got = fused_cast_scale(t, scale, getattr(torch, dst))
        assert got.dtype == getattr(torch, dst) and got.shape == t.shape
        want = _jax_bits(x, scale, src, dst).to(getattr(torch, dst))
        assert same_bits(got, want), (src, dst, shape, scale)


def test_fp32_subnormals_kept_where_xla_flushes():
    """The one difference from the JAX package: XLA on the CPU (as a
    TPU) flushes fp32 subnormals to zero; the port keeps them, as
    ``Tensor.to`` and the CUDA kernel (built without fast math) do."""
    x = torch.tensor([1e-40, -3e-39, 1e-30], dtype=torch.float32)
    got = fused_cast_scale(x, 0.5, torch.float32)
    assert same_bits(got, x.to(torch.float64).mul(0.5).float())
    assert float(got[0]) != 0.0
    ref = np.asarray(jax_fcs(jnp.asarray(x.numpy()), 0.5, jnp.float32,
                             interpret=True))
    assert ref[0] == 0.0 and ref[1] == 0.0
    assert ref[2] == float(got[2])


def test_empty_input():
    x = torch.zeros(0)
    got = fused_cast_scale(x, 0.5, torch.bfloat16)
    ref = jax_fcs(jnp.zeros((0,), jnp.float32), 0.5, jnp.bfloat16,
                  interpret=True)
    assert got.shape == tuple(ref.shape) == (0,)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    x = torch.from_numpy(_input((1000,), 3))
    n0 = fused_cast_scale.launches
    assert same_bits(fused_cast_scale(x, 0.25, torch.float16),
                     cast_scale_reference(x, 0.25, torch.float16))
    assert fused_cast_scale.launches == n0
    with pytest.raises(ValueError, match="CUDA .kernel. or CPU"):
        fused_cast_scale(x.to("meta"), 1.0, torch.bfloat16)


def test_scale_rounds_to_fp32_once():
    """1/3 as a Python double and as fp32 give one result: the scale is
    rounded to fp32 before the multiply, as JAX rounds a weak float."""
    x = torch.from_numpy(_input((4096,), 5))
    third = float(np.float32(1.0 / 3.0))
    assert same_bits(cast_scale_reference(x, 1.0 / 3.0, torch.float32),
                     x * torch.tensor(third))


def test_same_bits():
    a = torch.tensor([1.0, float("nan"), -0.0, 2.0])
    assert same_bits(a, a.clone())
    assert not same_bits(a, torch.tensor([1.0, float("nan"), 0.0, 2.0]))
    assert not same_bits(a, torch.tensor([1.0, 3.0, -0.0, 2.0]))
    assert not same_bits(a, a.bfloat16())
    assert not same_bits(a, a[:3])
    b = a.bfloat16()
    assert same_bits(b, b.clone())
    assert not same_bits(b, (a + 2 ** -12).bfloat16() + 2 ** -7)
