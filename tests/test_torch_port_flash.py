"""Port parity: ``vit_torch_tpu_torch.ops.flash_attention`` (plain version,
which the wrapper runs for CPU tensors) against the JAX package's Pallas
flash kernel in interpret mode, and the port's attention dispatcher against
the JAX ``_xla_attention``.  Inputs are made with numpy from a seed; fp32
on both sides, so the tolerance only covers summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.ops.attention import _xla_attention
from vit_torch_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_bhnd as jax_flash_attention_bhnd)
from vit_torch_tpu_torch.ops.attention import dot_product_attention
from vit_torch_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bhnd, flash_attention_bhnd_reference)

ATOL = 1e-5


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [1, 17, 65, 130])
def test_flash_bhnd_matches_pallas(N, D):
    q, k, v = _qkv((2, 2, N, D), seed=N * 100 + D)
    ref = np.asarray(jax_flash_attention_bhnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    launches = flash_attention_bhnd.launches
    got = flash_attention_bhnd(*(torch.from_numpy(x) for x in (q, k, v)))
    assert flash_attention_bhnd.launches == launches   # no kernel on CPU
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_flash_bnhd_wrapper_matches_pallas(scale):
    q, k, v = _qkv((2, 37, 3, 32), seed=7)
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale))
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          scale=scale)
    assert got.shape == (2, 37, 3, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_dot_product_attention_cpu_matches_xla_path():
    """The CPU path, with an additive bias and a boolean mask, is the JAX
    package's plain attention."""
    q, k, v = _qkv((2, 19, 2, 16), seed=3)
    rng = np.random.default_rng(4)
    bias = rng.standard_normal((1, 2, 19, 19)).astype(np.float32)
    mask = rng.random((2, 1, 19, 19)) > 0.2
    mask[..., 0] = True                       # keep every row non-empty
    ref = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.25,
        bias=jnp.asarray(bias), mask=jnp.asarray(mask)))
    got = dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), scale=0.25,
        bias=torch.from_numpy(bias), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_reference_rounds_p_like_the_kernel():
    """In bf16 the plain version rounds unnormalised P to bf16 for PV and
    divides after it, so it agrees with fp32 attention to bf16 precision
    and keeps the bf16 dtype."""
    q, k, v = _qkv((1, 2, 40, 32), seed=11)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = flash_attention_bhnd_reference(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    exact = flash_attention_bhnd_reference(tq.float(), tk.float(), tv.float())
    np.testing.assert_allclose(got.float().numpy(), exact.numpy(), atol=2e-2)
