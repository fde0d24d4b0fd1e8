"""Port parity: Swin's window kernels against the JAX package, on the CPU.

Rows 5, 8 and 9 of the kernel table: ``window_attention`` (B5),
``window_block_spatial`` (B8) and ``window_block_full_spatial`` (B9).  On
CPU tensors each port wrapper runs its plain version; the JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_fused_block.py`` run them.  Inputs come from numpy with a
seed; weights go to the JAX side in Dense layout ``(in, out)`` and to the
port in ``nn.Linear`` layout ``(out, in)``.

fp32 unless stated: the two sides then differ by summation order (and the
Pallas B9's polynomial erf, |err| <= 1.5e-7), so the tolerances are a few
fp32 ulps of values of order 1-10.  The bf16 cases hold the rounding
points: both sides round at the same places, so they differ only where an
fp32 sum in another order moves a rounded value by one bf16 ulp (2^-8
relative), which the next product carries; the limit is 2% of max |out|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.models import swin as jax_swin
from vit_torch_tpu.ops.window_attention import (
    window_attention as jax_window_attention)
from vit_torch_tpu.ops.window_block import (
    window_block_full_spatial as jax_window_block_full_spatial,
    window_block_spatial as jax_window_block_spatial)
from vit_torch_tpu_torch.models import swin
from vit_torch_tpu_torch.ops import window_attention as wa
from vit_torch_tpu_torch.ops import window_block as wb

BF16_RTOL = 2e-2


def _rel_err(got, want):
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return np.abs(got - want).max() / np.abs(want).max()


def _mask(rng, nW, N):
    return np.where(rng.random((nW, N, N)) > 0.7, -100.0,
                    0.0).astype(np.float32)


# --------------------------------------------------------------------------
# row 5: window attention

@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("N", [16, 49, 144])
def test_window_attention_matches_pallas(N, masked):
    rng = np.random.default_rng(N)
    nW, B, H, D = 2, 2, 2, 32
    q, k, v = (rng.standard_normal((nW * B, N, H, D)).astype(np.float32)
               for _ in range(3))
    bias = (0.5 * rng.standard_normal((H, N, N))).astype(np.float32)
    mask = _mask(rng, nW, N) if masked else None
    want = jax_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask))
    before = wa.window_attention.launches
    got = wa.window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask))
    assert wa.window_attention.launches == before    # the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_window_attention_bf16_rounding_matches_pallas():
    """bf16 q, k, v: P rounded to bf16 for PV, the row sum divided out
    after it, as the Pallas kernel does."""
    rng = np.random.default_rng(7)
    N, H = 49, 3
    q, k, v = (rng.standard_normal((8, N, H, 32)).astype(np.float32)
               for _ in range(3))
    bias = (0.5 * rng.standard_normal((H, N, N))).astype(np.float32)
    mask = _mask(rng, 4, N)
    want = jax_window_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(bias), jnp.asarray(mask))
    got = wa.window_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want) <= BF16_RTOL


# --------------------------------------------------------------------------
# rows 8 and 9: the window blocks on the spatial map

def _block_params(rng, C, heads, w, hidden=None):
    """Dense-layout (in, out) weights, fp32, and the (H, N, N) bias."""
    N = w * w
    hidden = hidden or 4 * C
    dense = lambda i, o: (rng.normal(0, i ** -0.5, (i, o)).astype(np.float32),
                          rng.normal(0, 0.1, (o,)).astype(np.float32))
    ln = lambda: (1 + 0.1 * rng.standard_normal(C).astype(np.float32),
                  0.1 * rng.standard_normal(C).astype(np.float32))
    return dict(qkv=dense(C, 3 * C), proj=dense(C, C), fc1=dense(C, hidden),
                fc2=dense(hidden, C), ln1=ln(), ln2=ln(),
                bias=(0.5 * rng.standard_normal((heads, N, N))).astype(
                    np.float32))


def _linear(pair, dtype):
    """A Dense (in, out) pair as the port's (out, in) pair."""
    w, b = pair
    return (torch.from_numpy(np.ascontiguousarray(w.T)).to(dtype),
            torch.from_numpy(b).to(dtype))


def _rolled_jax(fn, x, shift):
    """The JAX model's order around the block kernels: roll by -s, the
    kernel, roll by +s."""
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    y = fn(x)
    return jnp.roll(y, (shift, shift), axis=(1, 2)) if shift else y


# (B, Hp, Wp, C, window, shift, valid): a map whose rows and columns past
# `valid` are zero is the model's zero-padded map (window 4 on 10 x 10)
B8_CASES = [(2, 8, 8, 64, 4, 0, 8), (1, 8, 8, 96, 4, 2, 8),
            (1, 14, 14, 128, 7, 3, 14), (1, 12, 12, 64, 4, 2, 10)]


def _b8_pair(case, dtype_np, dtype_t, seed=0):
    B, Hp, Wp, C, w, shift, valid = case
    heads = C // 32
    rng = np.random.default_rng(seed)
    p = _block_params(rng, C, heads, w)
    y = np.zeros((B, Hp, Wp, C), np.float32)
    y[:, :valid, :valid] = rng.standard_normal((B, valid, valid, C))
    mask = (jax_swin.shifted_window_mask(Hp, Wp, w, shift) if shift
            else None)
    want = _rolled_jax(lambda t: jax_window_block_spatial(
        t, jnp.asarray(p["qkv"][0], dtype_np), jnp.asarray(p["qkv"][1],
                                                           dtype_np),
        jnp.asarray(p["bias"]), None if mask is None else jnp.asarray(mask),
        jnp.asarray(p["proj"][0], dtype_np), jnp.asarray(p["proj"][1],
                                                         dtype_np),
        num_heads=heads, window=w), jnp.asarray(y, dtype_np), shift)
    got = wb.window_block_spatial(
        torch.from_numpy(y).to(dtype_t), *_linear(p["qkv"], dtype_t),
        torch.from_numpy(p["bias"]),
        None if mask is None else torch.from_numpy(mask),
        *_linear(p["proj"], dtype_t), num_heads=heads, window=w,
        shift=shift)
    return got, want


@pytest.mark.parametrize("case", B8_CASES, ids=str)
def test_window_block_spatial_matches_pallas(case):
    got, want = _b8_pair(case, jnp.float32, torch.float32)
    assert got.shape == tuple(case[:4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


def test_window_block_spatial_bf16_rounding_matches_pallas():
    got, want = _b8_pair((1, 14, 14, 96, 7, 3, 14), jnp.bfloat16,
                         torch.bfloat16, seed=3)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want) <= BF16_RTOL


# (B, H, W, C, window, shift): windows 4 and 7, C 64 / 96 / 128 with head
# dim 32, shifted and unshifted
B9_CASES = [(2, 8, 8, 64, 4, 0), (1, 8, 8, 96, 4, 2), (1, 14, 14, 128, 7, 3),
            (1, 14, 14, 64, 7, 0)]


def _b9_pair(case, dtype_np, dtype_t, seed=0):
    B, H, W, C, w, shift = case
    heads = C // 32
    rng = np.random.default_rng(seed)
    p = _block_params(rng, C, heads, w)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    mask = jax_swin.shifted_window_mask(H, W, w, shift) if shift else None
    j = lambda a: jnp.asarray(a, dtype_np)              # noqa: E731
    f32 = jnp.asarray
    want = _rolled_jax(lambda t: jax_window_block_full_spatial(
        t, f32(p["ln1"][0]), f32(p["ln1"][1]), j(p["qkv"][0]),
        j(p["qkv"][1]), f32(p["bias"]),
        None if mask is None else f32(mask), j(p["proj"][0]),
        j(p["proj"][1]), f32(p["ln2"][0]), f32(p["ln2"][1]), j(p["fc1"][0]),
        f32(p["fc1"][1]), j(p["fc2"][0]), f32(p["fc2"][1]),
        num_heads=heads, window=w), j(x), shift)
    ln = lambda pair: tuple(torch.from_numpy(a) for a in pair)  # noqa: E731
    got = wb.window_block_full_spatial(
        torch.from_numpy(x).to(dtype_t), ln(p["ln1"]),
        _linear(p["qkv"], dtype_t), torch.from_numpy(p["bias"]),
        None if mask is None else torch.from_numpy(mask),
        _linear(p["proj"], dtype_t), ln(p["ln2"]),
        _linear(p["fc1"], dtype_t), _linear(p["fc2"], dtype_t),
        num_heads=heads, window=w, shift=shift)
    return got, want


@pytest.mark.parametrize("case", B9_CASES, ids=str)
def test_window_block_full_spatial_matches_pallas(case):
    got, want = _b9_pair(case, jnp.float32, torch.float32)
    assert got.shape == tuple(case[:4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_window_block_full_spatial_bf16_rounding_matches_pallas():
    got, want = _b9_pair((1, 8, 8, 64, 4, 2), jnp.bfloat16, torch.bfloat16,
                         seed=5)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want) <= BF16_RTOL


def test_window_layout_helpers_match_jax():
    """Partition, reverse, the relative-position index and the shifted
    mask: the window order every kernel and mask row assumes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 8, 3)).astype(np.float32)
    wins = wb.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jax_swin.window_partition(jnp.asarray(x),
                                                           4)))
    np.testing.assert_array_equal(
        wb.window_reverse(wins, 4, 12, 8).numpy(), x)
    for w in (2, 4, 7, 12):
        np.testing.assert_array_equal(swin.relative_position_index(w),
                                      jax_swin.relative_position_index(w))
    for Hp, Wp, w, s in ((8, 8, 4, 2), (14, 21, 7, 3), (24, 24, 12, 6)):
        np.testing.assert_array_equal(
            swin.shifted_window_mask(Hp, Wp, w, s),
            jax_swin.shifted_window_mask(Hp, Wp, w, s))
