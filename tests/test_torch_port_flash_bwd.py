"""Port parity: the flash-attention backward.  The port's plain backward
(``flash_attention_bwd_reference``) and its autograd path on CPU tensors
against ``jax.vjp`` of the JAX package's ``flash_attention_bhnd``, which
on the CPU runs the Pallas backward kernels in interpret mode.  The cases
reach all four: H=2 takes the head-blocked ``_bwd_fused_kernel_hb``, H=3
(heads not divisible by the head block of 2) the one-pass
``_bwd_fused_kernel``, and ``block_q=64`` with N > 64 the split
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``.  Also the forward's log-sum-exp
and the packed-qkv entry the model calls.

Inputs are made with numpy from a seed.  Everything is fp32 on both sides,
so the tolerance covers summation order only: gradients of order 1–10 for
standard-normal inputs agree to ~1e-6 relative.

Also the backward kernel's launch plan at the shapes the card checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_bhnd as jax_flash_attention_bhnd)
from vit_torch_tpu_torch.ops import flash_attention as fa
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

ATOL, RTOL = 1e-5, 1e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, do, block_q=None):
    f = lambda q, k, v: jax_flash_attention_bhnd(q, k, v, block_q=block_q)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


# heads per case: 2 reaches _bwd_fused_kernel_hb, 3 _bwd_fused_kernel
VARIANTS = {"fused_hb": 2, "fused": 3}


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [1, 17, 65, 130])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bwd_matches_pallas(variant, N, D):
    H = VARIANTS[variant]
    q, k, v, do = _inputs((2, H, N, D), seed=N * 100 + D + H)
    _, want = _jax_grads(q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got = fa.flash_attention_bwd_reference(tq, tk, tv, tdo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)
    # the autograd path on CPU tensors
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    launches = fa.flash_attention_bwd.launches
    out = fa.flash_attention_bhnd(*leaves)
    grads = torch.autograd.grad(out, leaves, tdo)
    assert fa.flash_attention_bwd.launches == launches   # no kernel on CPU
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [65, 130])
def test_bwd_matches_pallas_split_dq_dkv(N, D):
    """block_q=64 below the padded length: the split dq and dk/dv kernels,
    the latter carrying its sums over the sequential q-block axis."""
    q, k, v, do = _inputs((2, 2, N, D), seed=N + D)
    _, want = _jax_grads(q, k, v, do, block_q=64)
    got = fa.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, do)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N", [1, 17, 130])
def test_forward_lse_matches_logsumexp(N):
    """The forward's LSE (natural log, fp32) is logsumexp of the scaled
    scores; its output is the Pallas forward's."""
    q, k, v, _ = _inputs((2, 3, N, 32), seed=N)
    scale = 32 ** -0.5
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k)) * scale
    want_lse = np.asarray(jax.nn.logsumexp(s, axis=-1))
    want_o = np.asarray(jax_flash_attention_bhnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    o, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), return_lse=True)
    assert lse.shape == (2, 3, N) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), want_o, atol=ATOL, rtol=0)


def test_qkv_entry_grad_matches_pallas():
    """The model's call: attention over the packed (B, N, 3, H, D) qkv,
    one gradient of that shape, against the JAX (B, N, H, D) entry."""
    rng = np.random.default_rng(9)
    qkv = rng.standard_normal((2, 37, 3, 2, 32)).astype(np.float32)
    do = rng.standard_normal((2, 37, 2, 32)).astype(np.float32)
    f = lambda qkv: jax_flash_attention(qkv[:, :, 0], qkv[:, :, 1],
                                        qkv[:, :, 2], scale=0.3)
    out, vjp = jax.vjp(f, jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(do))
    t = torch.from_numpy(qkv).requires_grad_(True)
    got_out = fa.flash_attention_qkv(t, scale=0.3)
    (got,) = torch.autograd.grad(got_out, t, torch.from_numpy(do))
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_bwd_reference_rounds_like_the_kernel():
    """In bf16 the plain backward keeps the TPU kernels' rounding points
    (P to bf16 for dV, dS to bf16) and returns bf16 gradients that agree
    with the fp32 backward to bf16 precision."""
    q, k, v, do = _inputs((1, 2, 40, 32), seed=5)
    t32 = [torch.from_numpy(x) for x in (q, k, v, do)]
    exact = fa.flash_attention_bwd_reference(*t32)
    got = fa.flash_attention_bwd_reference(*(x.bfloat16() for x in t32))
    for g, e in zip(got, exact):
        assert g.dtype == torch.bfloat16
        scale = e.abs().max().item()
        assert (g.float() - e).abs().max().item() <= 3e-2 * scale


# (B, H, N, D): chip_smoke's BWD_SHAPES (dino_vitb8 @224 bs32 and @32
# bs128, DeiT-base and dino_vits16 @224, small ragged ones) and the
# headline at D = 32
PLAN_SHAPES = [(32, 12, 785, 64), (128, 12, 17, 64), (8, 12, 197, 64),
               (2, 2, 65, 32), (1, 1, 1, 64), (32, 12, 197, 64),
               (64, 6, 197, 64), (32, 12, 785, 32)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_backward_launch_plan(shape):
    """128 keys a block, 64-query tiles, as many ring stages as query
    tiles up to 4, one block per (key block, b * h), a dQ accumulator of
    ceil(N / 64) * 64 rows, shared memory inside the SM's 227 KB."""
    B, H, N, D = shape
    plan = fa.launch_plan(B, H, N, D, backward=True)
    assert (plan.block_q, plan.block_k) == (64, 128)
    assert plan.grid == (-(-N // 128), B * H)
    assert plan.dq_rows == -(-N // 64) * 64 and plan.dq_rows - N < 64
    assert plan.stages == min(4, -(-N // 64))
    tile = 64 * D * 2
    stage = -(-(2 * tile + 512) // 1024) * 1024
    assert plan.smem_bytes == (1024 + 4 * tile + 2 * 128 * 64 * 2
                               + plan.stages * stage + 72)
    assert plan.smem_bytes <= 232448


def test_backward_launch_plan_at_the_headline():
    assert fa.launch_plan(32, 12, 785, 64, backward=True) == fa.Plan(
        64, 128, 4, (7, 384), 136264, 832)
