"""Port parity: the Swin window kernels' backward against the JAX package,
on the CPU.

Row 6 of the kernel table, the window-attention backward (B6): the port's
plain backward ``window_attention_bwd_reference`` against the VJP of the
JAX ``window_attention``, which runs the Pallas ``_bwd_kernel`` in
interpret mode; the port's autograd Functions around it (both layouts);
and the gradients of the window blocks B8 (``window_block_spatial``) and
B9 (``window_block_full_spatial``) through the port's autograd Functions,
against ``jax.vjp`` of the JAX blocks (their custom VJPs recompute through
XLA dots around the Pallas window attention).  On CPU tensors every port
Function runs the plain forward and the plain B6 backward.

Inputs come from numpy with a seed; weights go to the JAX side in Dense
layout ``(in, out)`` and to the port in ``nn.Linear`` layout ``(out, in)``.
Everything is fp32 unless stated, so the two sides differ by summation
order only (and the Pallas B9's polynomial erf, |err| <= 1.5e-7).  fp32
rather than bf16 for the blocks: the JAX backward recomputes qkv with the
bias added in bf16 after the product is rounded, where the forward
kernels add it in fp32, so at bf16 the two differ by design.
"""

import jax
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
from vit_torch_tpu_torch.ops import window_attention as wa
from vit_torch_tpu_torch.ops import window_block as wb
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

# the attention backward in fp32: gradients of order 1-10 that differ by
# summation order (test_kernels.py holds the Pallas kernel to its own
# reference at the same limits)
ATOL, RTOL = 5e-5, 1e-3
# block gradients: max |port - JAX| relative to max |JAX| of the same
# gradient.  Weight gradients sum a few hundred token products of order
# 1-10, so fp32 sums in another order differ by ~1e-6 of their scale
BLOCK_GRAD_RTOL = 2e-5
# bf16: both sides round P and dS at the same points; an fp32 sum in
# another order moves a rounded value by one bf16 ulp (2^-8), which the
# next product carries
BF16_RTOL = 2e-2


def _mask(rng, nW, N):
    return np.where(rng.random((nW, N, N)) > 0.7, -100.0,
                    0.0).astype(np.float32)


def _attention_inputs(N, masked, seed, nW=2, B=2, H=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((nW * B, N, H, 32)).astype(np.float32)
                   for _ in range(4))
    bias = (0.5 * rng.standard_normal((H, N, N))).astype(np.float32)
    return q, k, v, do, bias, _mask(rng, nW, N) if masked else None


def _jax_attention_grads(q, k, v, bias, mask, do, dtype=jnp.float32):
    j = lambda a: jnp.asarray(a, dtype)                   # noqa: E731
    m = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v, b: jax_window_attention(q, k, v, b, m),
                     j(q), j(k), j(v), jnp.asarray(bias))
    return [np.asarray(g, np.float32) for g in vjp(j(do))]


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("N", [16, 49, 144])
def test_window_attention_bwd_matches_pallas(N, masked):
    q, k, v, do, bias, mask = _attention_inputs(N, masked, seed=N)
    want = _jax_attention_grads(q, k, v, bias, mask, do)
    before = wa.window_attention_bwd.launches
    got = wa.window_attention_bwd(*(_t(a) for a in (q, k, v, bias, mask,
                                                    do)))
    assert wa.window_attention_bwd.launches == before   # the plain version
    assert got[3].shape == bias.shape and got[3].dtype == torch.float32
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_window_attention_bwd_bf16_rounding_matches_pallas():
    """bf16 q, k, v and dO: P rounded to bf16 for dV and dS for dQ and dK,
    the scale applied after the product, dbias from the unrounded fp32 dS,
    as the Pallas kernel does."""
    q, k, v, do, bias, mask = _attention_inputs(49, True, seed=7, nW=4, H=3)
    want = _jax_attention_grads(q, k, v, bias, mask, do, jnp.bfloat16)
    got = wa.window_attention_bwd_reference(
        *(_t(a, torch.bfloat16) for a in (q, k, v)), _t(bias), _t(mask),
        _t(do, torch.bfloat16))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.dtype == (torch.float32 if name == "dbias"
                           else torch.bfloat16), name
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= BF16_RTOL, (name, err)


def test_window_attention_functions_run_the_plain_backward():
    """On CPU tensors both autograd Functions return exactly the plain
    backward's values; the qkv entry returns one gradient of qkv's shape,
    and the mask gets none."""
    q, k, v, do, bias, mask = _attention_inputs(25, True, seed=3)
    want = wa.window_attention_bwd_reference(*(_t(a) for a in (q, k, v,
                                                               bias, mask,
                                                               do)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v, bias)]
    tmask = _t(mask)
    out = wa.window_attention(*leaves[:3], leaves[3], tmask)
    got = torch.autograd.grad(out, leaves, _t(do))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_(True)
    tbias = _t(bias).requires_grad_(True)
    out = wa.window_attention_qkv(qkv, tbias, tmask)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        wa.window_attention_reference(*(_t(a) for a in (q, k, v, bias,
                                                        mask))).numpy())
    dqkv, dbias = torch.autograd.grad(out, (qkv, tbias), _t(do))
    assert dqkv.shape == qkv.shape
    for g, w in zip((*dqkv.unbind(2), dbias), want):
        assert torch.equal(g, w)
    assert not tmask.requires_grad


# --------------------------------------------------------------------------
# rows 8 and 9: the window blocks' gradients

def _dense(rng, i, o):
    return (rng.normal(0, i ** -0.5, (i, o)).astype(np.float32),
            rng.normal(0, 0.1, (o,)).astype(np.float32))


def _rolled_jax(fn, x, shift):
    """The JAX model's order around the block kernels: roll by -s, the
    kernel, roll by +s."""
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    y = fn(x)
    return jnp.roll(y, (shift, shift), axis=(1, 2)) if shift else y


def _port_grad(name, g):
    """A port gradient in the JAX parameter's layout: Linear weights
    ``(out, in)`` back to Dense ``(in, out)``."""
    g = g.numpy()
    return g.T if name.startswith("w") else g


def _assert_grads_close(got, want):
    for name in want:
        w = np.asarray(want[name])
        err = np.abs(_port_grad(name, got[name]) - w).max() / np.abs(w).max()
        assert err <= BLOCK_GRAD_RTOL, (name, err)


# (B, Hp, Wp, C, window, shift, valid): a map whose rows and columns past
# `valid` are zero is the model's zero-padded map (window 4 on 10 x 10)
B8_CASES = [(2, 8, 8, 64, 4, 0, 8), (1, 8, 8, 96, 4, 2, 8),
            (1, 14, 14, 64, 7, 3, 14), (1, 12, 12, 64, 4, 2, 10)]


@pytest.mark.parametrize("case", B8_CASES, ids=str)
def test_window_block_spatial_grads_match_jax(case):
    """Every input's gradient: the map, both weights and biases, and the
    gathered bias."""
    B, Hp, Wp, C, w, shift, valid = case
    heads = C // 32
    rng = np.random.default_rng(sum(case))
    y = np.zeros((B, Hp, Wp, C), np.float32)
    y[:, :valid, :valid] = rng.standard_normal((B, valid, valid, C))
    (wq, bq), (wp, bp) = _dense(rng, C, 3 * C), _dense(rng, C, C)
    bias = (0.5 * rng.standard_normal((heads, w * w, w * w))).astype(
        np.float32)
    dout = rng.standard_normal(y.shape).astype(np.float32)
    mask = jax_swin.shifted_window_mask(Hp, Wp, w, shift) if shift else None
    jm = None if mask is None else jnp.asarray(mask)
    names = ("y", "w_qkv", "b_qkv", "bias", "w_proj", "b_proj")
    arrays = (y, wq, bq, bias, wp, bp)

    def f(y, wq, bq, bias, wp, bp):
        return _rolled_jax(lambda t: jax_window_block_spatial(
            t, wq, bq, bias, jm, wp, bp, num_heads=heads, window=w), y, shift)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    want = dict(zip(names, vjp(jnp.asarray(dout))))

    leaves = {n: _t(a.T if n.startswith("w") else a).requires_grad_(True)
              for n, a in zip(names, arrays)}
    before = wa.window_attention_bwd_reference.calls
    out = wb.window_block_spatial(
        leaves["y"], leaves["w_qkv"], leaves["b_qkv"], leaves["bias"],
        _t(mask), leaves["w_proj"], leaves["b_proj"], num_heads=heads,
        window=w, shift=shift)
    got = dict(zip(names, torch.autograd.grad(out, list(leaves.values()),
                                              _t(dout))))
    assert wa.window_attention_bwd_reference.calls == before + 1
    _assert_grads_close(got, want)


# (B, H, W, C, window, shift): windows 4 and 7, shifted and unshifted
B9_CASES = [(2, 8, 8, 64, 4, 0), (1, 8, 8, 96, 4, 2), (1, 14, 14, 64, 7, 3)]


@pytest.mark.parametrize("case", B9_CASES, ids=str)
def test_window_block_full_spatial_grads_match_jax(case):
    """Every input's gradient: the map, both LayerNorms' weight and bias,
    the four linear layers and the gathered bias."""
    B, H, W, C, w, shift = case
    heads = C // 32
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ln = lambda: (1 + 0.1 * rng.standard_normal(C).astype(np.float32),  # noqa
                  0.1 * rng.standard_normal(C).astype(np.float32))
    (l1w, l1b), (wq, bq), (wp, bp) = ln(), _dense(rng, C, 3 * C), \
        _dense(rng, C, C)
    (l2w, l2b), (w1, b1), (w2, b2) = ln(), _dense(rng, C, 4 * C), \
        _dense(rng, 4 * C, C)
    bias = (0.5 * rng.standard_normal((heads, w * w, w * w))).astype(
        np.float32)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    mask = jax_swin.shifted_window_mask(H, W, w, shift) if shift else None
    jm = None if mask is None else jnp.asarray(mask)
    names = ("x", "ln1_w", "ln1_b", "w_qkv", "b_qkv", "bias", "w_proj",
             "b_proj", "ln2_w", "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2")
    arrays = (x, l1w, l1b, wq, bq, bias, wp, bp, l2w, l2b, w1, b1, w2, b2)

    def f(x, l1w, l1b, wq, bq, bias, wp, bp, l2w, l2b, w1, b1, w2, b2):
        return _rolled_jax(lambda t: jax_window_block_full_spatial(
            t, l1w, l1b, wq, bq, bias, jm, wp, bp, l2w, l2b, w1, b1, w2, b2,
            num_heads=heads, window=w), x, shift)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    want = dict(zip(names, vjp(jnp.asarray(dout))))

    t = {n: _t(a.T if n.startswith("w") else a).requires_grad_(True)
         for n, a in zip(names, arrays)}
    before = wa.window_attention_bwd_reference.calls
    out = wb.window_block_full_spatial(
        t["x"], (t["ln1_w"], t["ln1_b"]), (t["w_qkv"], t["b_qkv"]),
        t["bias"], _t(mask), (t["w_proj"], t["b_proj"]),
        (t["ln2_w"], t["ln2_b"]), (t["w_fc1"], t["b_fc1"]),
        (t["w_fc2"], t["b_fc2"]), num_heads=heads, window=w, shift=shift)
    got = dict(zip(names, torch.autograd.grad(out, list(t.values()),
                                              _t(dout))))
    assert wa.window_attention_bwd_reference.calls == before + 1
    _assert_grads_close(got, want)
