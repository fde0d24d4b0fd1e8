"""Port parity: the W8A8 int8 serving path against the JAX package, on the
CPU (where the two kernels run their plain versions).

Compared:
- ``quantize_rowwise`` / ``quantize_weight`` against the JAX functions in
  fp32 and bf16, with exact ties (a row whose scale is exactly 1), an
  all-zero row (scale = eps) and rows of magnitudes 10^-3 to 10^3: codes
  and scales equal to the JAX functions run op by op, which divide by 127
  as ``quant.py`` writes it.  Under ``jax.jit`` XLA's CPU compiler folds
  ``absmax / 127 + 1e-8`` into one fused multiply-add with the reciprocal
  of 127, so about a quarter of the jitted scales are one ulp off the
  division's; against the jitted functions scales are held within one ulp
  and codes within one step on at most 0.1% of the elements;
- ``w8a8_linear`` against JAX ``w8a8_dot`` op by op (the
  ``tests/test_quant.py`` cases: an int8-representable grid, the relative
  error, 3-D inputs): fp32 outputs within 1e-6 relative;
- the training path never quantises (bitwise the fp forward, finite
  non-zero gradients) and the dispatch order: W8A8 before B3, B4 and
  B12, B9 off under W8A8 in eval only;
- ``Attention``, ``Mlp`` and XCA under ``VITX_W8A8=1`` against the JAX
  modules, and vit_tiny_test, deit_test_distilled, cait_test, xcit_test
  and swin_test logits under W8A8 against the JAX package's, plus the
  port's W8A8 logits against its own fp forward with ``test_quant.py``'s
  bounds (cosine > 0.99, top-1 agreement);
- bundles: ``cli.export --w8a8``'s int8 weights against the JAX package's
  ``prequant_capture`` collection, prequantised and ``--no_prequant``
  bundles, the manifest (not ``VITX_W8A8``) choosing the path, ResNet's
  ``w8a8_prequant: false``, and ``cli.main --export_bundle`` under the
  flag.

Weights are seeded in the JAX model's tree (shapes from ``jax.eval_shape``,
nothing compiled for an init) and carried over by ``state_dict_from_jax``;
each JAX model is traced once (one ``jax.jit`` giving its fp and its
W8A8 logits).

Tolerance of the module and model comparisons: both packages quantise the
same values with the same arithmetic, but an activation that reaches a
quantiser after fp32 work in another summation order (an attention
output, a GELU, a LayerNorm; or a jitted JAX scale one ulp off) can sit
on the other side of a rounding tie and move one code by one step, which
moves that token's product by one quantisation step of one weight, and
everything downstream of it in that image.  Such a move is rare (about
one in 10^5 to 10^6 codes), so at least three quarters of the rows
(tokens of a module, images of a model) agree within 1e-5 of max |JAX|,
and no output is further from the JAX W8A8 output than half the JAX W8A8
output's own distance from the JAX fp output.  Measured here: every row
of vit_tiny_test, xcit_test and swin_test within 5e-7; one image in 8 of
deit_test_distilled (6.4e-3 against a W8A8 error of 2.8e-2) and of
cait_test (1.5e-3 against 3.0e-2) moved.
"""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint.torch_import import import_vit
from vit_torch_tpu.models import VisionModelZoo as JaxZoo
from vit_torch_tpu.models import layers as jax_layers
from vit_torch_tpu.models import xcit as jax_xcit
from vit_torch_tpu.ops import quant as jax_quant
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import export as cli_export
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.models import layers, xcit
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from vit_torch_tpu_torch.ops import attn_block, fused_mlp, quant
from vit_torch_tpu_torch.ops import window_block as wb
from vit_torch_tpu_torch.serving import load_bundle
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

# fp32 outputs of one product: the same codes, scales and s32 sums; the
# rescale's roundings may differ only where XLA contracts into an FMA
LINEAR_RTOL = 1e-6
# modules and models (module docstring): rows within EXACT_RTOL of max
# |JAX| (at least EXACT_SHARE of them), every output within FLIP_SHARE of
# the W8A8 error itself
EXACT_RTOL, EXACT_SHARE, FLIP_SHARE = 1e-5, 0.75, 0.5
ARCHS = ["vit_tiny_test", "deit_test_distilled", "cait_test", "xcit_test",
         "swin_test"]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_close_int8(got, want, want_fp) -> None:
    """The port's W8A8 output against the JAX W8A8 and fp outputs (rows
    along the last axis; the module docstring gives the bounds)."""
    got, want, want_fp = (np.asarray(a, np.float64)
                          for a in (got, want, want_fp))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want) / scale
    quant_err = np.abs(want - want_fp).max() / scale
    assert err.max() <= FLIP_SHARE * quant_err, (err.max(), quant_err)
    rows = err.reshape(-1, err.shape[-1]).max(-1)
    assert (rows <= EXACT_RTOL).mean() >= EXACT_SHARE, rows


def _w8a8_env(on: bool):
    return mock.patch.dict(os.environ, {"VITX_W8A8": "1" if on else ""})


# ---- the quantisers and the product -----------------------------------


def _quant_input(dtype):
    """Rows of magnitudes 10^-3 .. 10^3, a row of exact ties (absmax 127,
    so scale = 127 / 127 + 1e-8 = 1 in fp32, and codes of x.5 round half
    to even) and an all-zero row."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 96)) * 10.0 ** rng.uniform(-3, 3, (64, 1))
    x[0] = np.resize([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5], 96)
    x[1] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _assert_near_jitted(q, s, want_q, want_s) -> None:
    """Codes and scales against the jitted JAX quantiser (the module
    docstring): scales within one ulp, codes within one step on at most
    0.1% of the elements."""
    ulps = np.abs(s.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(want_s).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(want_q))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rowwise_matches_jax(dtype):
    x = _quant_input(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want_q, want_s = jax_quant.quantize_rowwise(jx)
    q, s = quant.quantize_rowwise(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (64, 1)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    assert s[1].item() == np.float32(1e-8) and not q[1].any()
    if dtype == torch.float32:   # the ties, round half to even
        assert s[0].item() == 1.0
        assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]
    _assert_near_jitted(q, s, *jax.jit(jax_quant.quantize_rowwise)(jx))


def test_quantize_weight_matches_jax():
    """The port's ``(N, K)`` rows are the JAX ``(K, N)`` kernel's output
    channels."""
    w = _quant_input(torch.float32)[:, :48]              # (N, K)
    want_q, want_s = jax_quant.quantize_weight(jnp.asarray(w.T))
    q, s = quant.quantize_weight(w)
    assert q.shape == (64, 48) and s.shape == (64,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    want_q, want_s = jax.jit(jax_quant.quantize_weight)(jnp.asarray(w.T))
    _assert_near_jitted(q, s, np.asarray(want_q).T, want_s)


def _jax_dots(xi, wi, x, w, b, x3):
    return (jax_quant.w8a8_dot(xi, wi, out_dtype=jnp.float32),
            jax_quant.w8a8_dot(x, w, b, out_dtype=jnp.float32),
            jax_quant.w8a8_dot(x3, w, b, out_dtype=jnp.float32))


def test_w8a8_linear_matches_jax():
    """``tests/test_quant.py``'s cases: an int8 grid (scale exactly 1, the
    product exact), the relative error against the fp product, and (4, 32,
    96) activations, against ``w8a8_dot`` within 1e-6 relative."""
    rng = np.random.default_rng(2)
    xi = rng.integers(-127, 128, (11, 32)).astype(np.float32)
    wi = rng.integers(-127, 128, (32, 24)).astype(np.float32)
    xi[:, 0], wi[0, :] = 127.0, 127.0
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (128, 96)).astype(np.float32)
    w = rng.normal(0, 0.05, (96, 160)).astype(np.float32)
    b = rng.normal(0, 0.1, (160,)).astype(np.float32)
    x3 = x.reshape(4, 32, 96)
    want_i, want, want3 = _jax_dots(xi, wi, x, w, b, x3)

    t = torch.from_numpy
    got_i = quant.w8a8_linear(t(xi), t(wi.T.copy()), None)
    np.testing.assert_array_equal(got_i.numpy(), xi @ wi)
    assert _rel(got_i, want_i) <= LINEAR_RTOL
    got = quant.w8a8_linear(t(x), t(w.T.copy()), t(b))
    assert _rel(got, want) <= LINEAR_RTOL
    ref = x @ w + b
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 0.02
    got3 = quant.w8a8_linear(t(x3), t(w.T.copy()), t(b))
    assert got3.shape == (4, 32, 160)
    assert _rel(got3, want3) <= LINEAR_RTOL
    np.testing.assert_array_equal(got3.reshape(128, 160).numpy(),
                                  got.numpy())
    # prequantised weights give the same product; a bf16 input, bf16 out
    pre = quant.quantize_weight(t(w.T.copy()))
    np.testing.assert_array_equal(
        quant.w8a8_linear(t(x), None, t(b), pre=pre).numpy(), got.numpy())
    y16 = quant.w8a8_linear(t(x).bfloat16(), t(w.T.copy()), t(b))
    assert y16.dtype == torch.bfloat16


def test_int8_plan_and_refusals():
    """Q2's plan at dino_vitb8 @224 bs32's shapes (T = 25,120) and a
    ragged one; widths the kernels do not take raise before any launch."""
    for K, N in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        plan = quant.int8_plan(25120, K, N)
        assert plan.block_n in quant.BLOCK_NS and plan.grid <= 132
        assert plan.block_m in quant.BLOCK_MS
        assert plan.smem_bytes <= 232448 and 2 <= plan.stages <= 8
        assert plan.tiles_m == -(-25120 // plan.block_m)
        # 192 x 192 tiles: 131 x 12, 4, 16 and 4 tiles, whole waves of 132
        assert (plan.block_m, plan.block_n, plan.tiles_m) == (192, 192, 131)
    ragged = quant.int8_plan(203, 784, 200)
    assert ragged.tiles_m == -(-203 // ragged.block_m) == 2
    assert ragged.tiles_n * ragged.block_n >= 200
    assert quant.int8_plan(1, 128, 8).grid == 1
    for K, N in ((24, 64), (128, 12), (8, 64)):
        with pytest.raises(ValueError):
            quant.int8_plan(64, K, N)
    meta = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        quant.quantize_rowwise(meta)
    with pytest.raises(ValueError, match="several devices"):
        quant.int8_gemm(torch.zeros((4, 64), dtype=torch.int8),
                        torch.ones(4), meta.to(torch.int8), torch.ones(4),
                        None, torch.float32)


# dino_vitb8 @224 bs32's products; the Swin MLPs W8A8 runs at bs8; Faster
# R-CNN's box head at bs8 x 256 RoIs (chip_smoke.py's FRCNN_W8A8_SHAPES);
# a ragged shape and the smallest the kernel takes
INT8_PLAN_SHAPES = [(25120, 768, 2304), (25120, 768, 768),
                    (25120, 768, 3072), (25120, 3072, 768),
                    (73728, 128, 512), (73728, 512, 128), (1152, 1024, 4096),
                    (2048, 12544, 1024), (2048, 1024, 1024), (203, 784, 200),
                    (1, 16, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("shape", INT8_PLAN_SHAPES, ids=str)
def test_int8_plan_fits_shared_memory(shape, dtype):
    """The plan's shared memory: 1 KB of alignment and the barriers, two
    8 KB output slices and the tile's column scales and bias per consumer
    warpgroup, and at least two ring stages, within the 232,448 bytes a
    block may use in either output dtype; a stage more would not fit (or
    the ring holds its eight)."""
    T, K, N = shape
    plan = quant.int8_plan(T, K, N)
    bm, bn = plan.block_m, plan.block_n
    assert bm in quant.BLOCK_MS and bn in quant.BLOCK_NS
    # a slice: 64 rows of 64 bf16 or 32 fp32 columns, 128 bytes a row
    slice_cols = 128 // dtype.itemsize
    assert slice_cols in (64, 32)
    assert 64 * slice_cols * dtype.itemsize == quant.SLICE_BYTES
    ring = plan.stages * (bm + bn) * 128
    fixed = 1024 + 2 * 8 * 8 + 2 * (bm // 64) * quant.SLICE_BYTES + (
        bm // 64) * 2 * bn * 4
    assert plan.smem_bytes == fixed + ring == quant.int8_smem_bytes(
        bm, bn, plan.stages)
    assert 2 <= plan.stages <= 8 and plan.smem_bytes <= 232448
    assert plan.stages == 8 or plan.smem_bytes + (bm + bn) * 128 > 232448
    assert plan.tiles_m * bm >= T > (plan.tiles_m - 1) * bm
    assert plan.tiles_n * bn >= N > (plan.tiles_n - 1) * bn
    assert plan.grid == min(plan.tiles_m * plan.tiles_n, 132)
    # the plan is the tile whose busiest SM reads the fewest operand rows
    # a k-step (the larger tile on a tie)
    def load(m, n):
        return -(-(-(-T // m) * -(-N // n)) // 132) * (m + n)
    assert min(load(m, n) for m in quant.BLOCK_MS
               for n in quant.BLOCK_NS) == load(bm, bn)


# Q1's plan for 132 SMs, (R, K, bytes a value) -> (team, units, passes,
# threads, grid): dino_vitb8 @224 bs32 and bs8's inputs at K = 768 and
# 3072, the box head's at bs8 x 256 RoIs (box_fc2's spread over twice the
# threads: 128 blocks would leave SMs without one), Swin bs8's stage-1
# MLP inputs, and the card tests' branches: rows fewer than the SMs (a
# block a row), K = 16, a K that is no multiple of a team's values, an
# fp32 weight, rows wider than a block holds (two passes)
Q1_PLANS = [((25120, 768, 2), (16, 3, 1, 256, 1570)),
            ((25120, 3072, 2), (64, 3, 1, 256, 6280)),
            ((6280, 768, 2), (16, 3, 1, 256, 393)),
            ((6280, 3072, 2), (64, 3, 1, 256, 1570)),
            ((2048, 12544, 2), (256, 4, 1, 256, 2048)),
            ((2048, 1024, 2), (32, 2, 1, 256, 256)),
            ((73728, 128, 2), (2, 4, 1, 256, 576)),
            ((73728, 512, 2), (8, 4, 1, 256, 2304)),
            ((7, 12544, 2), (512, 2, 1, 512, 7)),
            ((300, 16, 2), (1, 1, 1, 256, 2)),
            ((1000, 1040, 2), (64, 2, 1, 256, 250)),
            ((4096, 1024, 4), (32, 2, 1, 256, 512)),
            ((5, 32784, 2), (512, 4, 2, 512, 5)),
            ((5, 16400, 4), (512, 2, 2, 512, 5))]


@pytest.mark.parametrize("shape,want", Q1_PLANS, ids=str)
def test_quant_plan_choices(shape, want):
    """Q1's plan at the port's shapes: the fewest threads a row (a power
    of two) that hold it at 128 bytes a thread, spread over more where
    the blocks would not give every SM one; several passes only past a
    block's 512 threads."""
    R, K, nbytes = shape
    plan = quant.quant_plan(R, K, nbytes, sms=132)
    assert (plan.team, plan.units, plan.passes, plan.threads,
            plan.grid) == want
    assert plan.rows == plan.threads // plan.team
    assert plan.units * 16 * nbytes <= quant.Q_UNIT_BYTES
    assert plan.threads == max(plan.team, quant.Q_BLOCK) <= quant.Q_THREADS


@pytest.mark.parametrize("shape", [c[0] for c in Q1_PLANS], ids=str)
def test_quant_plan_covers_every_row_once(shape):
    """The kernel's indexing under the plan: thread t of block b holds row
    b * rows + t // team and, in each pass, units (t % team) + team j;
    every unit of every row is held by exactly one thread, and nothing
    past R rows or K / 16 units is."""
    R, K, nbytes = shape
    plan = quant.quant_plan(R, K, nbytes, sms=132)
    units = K // 16
    t = np.arange(plan.threads)
    rows = (np.arange(plan.grid)[:, None] * plan.rows
            + t // plan.team)[:, :, None]
    held = ((t % plan.team)[:, None]
            + plan.team * np.arange(plan.units * plan.passes))[None]
    rows, held = np.broadcast_arrays(rows, held)
    keep = (rows < R) & (held < units)
    count = np.bincount((rows[keep] * units + held[keep]).ravel(),
                        minlength=R * units)
    assert count.shape == (R * units,) and (count == 1).all()
    assert plan.grid * plan.rows >= R > (plan.grid - 1) * plan.rows


def test_quant_plan_spreads_rows_by_the_sm_count():
    """Fewer rows than the SMs can take in blocks spread each row over
    more threads (the box head's box_fc2 input), and a card with fewer
    SMs keeps the narrower team."""
    assert quant.quant_plan(2048, 1024, 2, sms=132).team == 32
    assert quant.quant_plan(2048, 1024, 2, sms=114).team == 16
    assert quant.quant_plan(7, 12544, 2, sms=132).team == quant.Q_THREADS


def test_quant_plan_refusals():
    """Widths and value sizes the kernel does not take raise before any
    launch."""
    for R, K, nbytes in ((0, 64, 2), (-3, 64, 2), (8, 24, 2), (8, 8, 2),
                         (8, 0, 2), (8, 64, 3), (8, 64, 1)):
        with pytest.raises(ValueError):
            quant.quant_plan(R, K, nbytes)


# ---- dispatch ---------------------------------------------------------


def _block(seed=0, dim=128, heads=4):
    torch.manual_seed(seed)
    blk = layers.Block(dim, heads, drop_path_rate=0.0)
    layers.init_weights(blk, torch.Generator().manual_seed(seed))
    return blk


def test_training_bypasses_w8a8():
    """Under ``VITX_W8A8=1`` a training-mode block is bitwise the fp block,
    never calls the int8 path, and its gradients are finite and non-zero."""
    blk = _block().train()
    x = torch.randn(2, 17, 128, generator=torch.Generator().manual_seed(1))
    with _w8a8_env(False):
        ref = blk(x)
    with _w8a8_env(True), mock.patch.object(
            quant, "w8a8_linear", side_effect=AssertionError("quantised")):
        got = blk(x)
        got.square().sum().backward()
    assert torch.equal(got, ref)
    norms = [p.grad.norm().item() for p in blk.parameters()]
    assert all(np.isfinite(norms)) and min(norms) > 0
    blk.eval()
    with _w8a8_env(True), torch.no_grad():
        assert not torch.equal(blk(x), ref.detach())


def _calls(module, name):
    return mock.patch.object(module, name, wraps=getattr(module, name))


@pytest.mark.parametrize("tokens", [17, 40])
def test_w8a8_takes_precedence(tokens):
    """With B3, B4 and B12 forced on and W8A8 on, an eval block runs its
    four products through int8 and none of the fused kernels; in training
    mode the fused kernels run (B4 at N <= 32, else B3) and int8 does not."""
    blk = _block()
    x = torch.randn(2, tokens, 128,
                    generator=torch.Generator().manual_seed(2))
    env = {"VITX_W8A8": "1", "VITX_FUSED_ATTN": "1",
           "VITX_PACKED_ATTN": "1", "VITX_FUSED_MLP": "1"}
    kernel = ("attention_block_packed" if tokens <= 32
              else "attention_block")
    with mock.patch.dict(os.environ, env), _calls(quant, "w8a8_linear") as q, \
            _calls(attn_block, kernel) as ab, \
            _calls(fused_mlp, "fused_mlp") as fm, torch.no_grad():
        blk.eval()(x)
        assert (q.call_count, ab.call_count, fm.call_count) == (4, 0, 0)
        blk.train()(x)
        assert (q.call_count, ab.call_count, fm.call_count) == (4, 1, 1)


def test_swin_full_block_off_under_w8a8_in_eval_only():
    """swin_test: B9 takes every eval block without the flag; with it the
    eval blocks run B8 and their MLPs through int8; a training-mode block
    (drop-path 0) keeps B9 under the flag."""
    zm = VisionModelZoo.get_model("swin_test", classifier=[10],
                                  image_size=32, dtype=torch.float32,
                                  device="cpu")
    for mod in zm.model.modules():
        if isinstance(mod, layers.DropPath):
            mod.rate = 0.0
    blocks = sum(len(layer.blocks) for layer in zm.model.backbone.layers)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    for on, train, want in ((False, False, (blocks, 0, 0)),
                            (True, False, (0, blocks, 2 * blocks)),
                            (True, True, (blocks, 0, 0))):
        zm.model.train(train)
        with _w8a8_env(on), _calls(wb, "window_block_full_spatial") as b9, \
                _calls(wb, "window_block_spatial") as b8, \
                _calls(quant, "w8a8_linear") as q, torch.no_grad():
            zm.model(x)
        assert (b9.call_count, b8.call_count, q.call_count) == want, (on,
                                                                     train)


def test_flag_is_read_per_call_and_forced_by_set_w8a8():
    blk = _block().eval()
    assert not layers._use_w8a8(False)
    with _w8a8_env(True):
        assert layers._use_w8a8(False) and not layers._use_w8a8(True)
        assert blk.mlp.fc1.quantized()
        layers.set_w8a8(blk, False)
        assert not blk.mlp.fc1.quantized()
        assert not layers._use_w8a8(False, False)
    layers.set_w8a8(blk, True)
    assert blk.attn.qkv.quantized() and not blk.train().attn.qkv.quantized()
    layers.set_w8a8(blk, None)
    assert not blk.eval().attn.proj.quantized()


# ---- modules and models against the JAX package -------------------------


def _seeded(tree, rng):
    """Seeded weights for a JAX variable tree of shapes: kernels of std
    1/sqrt(fan in), biases of std 0.1, LayerNorm/BN scales and XCA
    temperatures in [0.5, 1.5], LayerScale gates 0.5, BN running means of
    std 0.1 and variances in [0.5, 1.5], the other leaves of std 0.02."""
    def leaf(path, a):
        name = str(path[-1].key)
        if name == "kernel" or name.endswith("_kernel"):
            v = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "bias" or name.endswith("_bias") or name == "mean":
            v = 0.1 * rng.standard_normal(a.shape)
        elif name in ("scale", "temperature", "var"):
            v = rng.uniform(0.5, 1.5, a.shape)
        elif name.startswith("gamma"):
            v = np.full(a.shape, 0.5)
        else:
            v = 0.02 * rng.standard_normal(a.shape)
        return jnp.asarray(v, a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _module_pair(jmod, tmod, x):
    """The JAX module's fp and W8A8 outputs (one trace) and the port
    module's, from the same seeded weights."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
    params = _seeded(shapes["params"], np.random.default_rng(1))

    @jax.jit
    def run(p, a):
        with _w8a8_env(False):
            ref = jmod.apply({"params": p}, a)
        with _w8a8_env(True):
            got = jmod.apply({"params": p}, a)
        return ref, got

    want_fp, want = run(params, jnp.asarray(x))
    tmod.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    tmod.eval()
    with torch.no_grad(), _w8a8_env(True):
        got = tmod(torch.from_numpy(x))
    return np.asarray(want_fp), np.asarray(want), got.numpy()


@pytest.mark.parametrize("module", ["attention", "mlp", "xca"])
def test_module_matches_jax_under_w8a8(module):
    rng = np.random.default_rng(5)
    if module == "attention":
        x = rng.standard_normal((2, 37, 128)).astype(np.float32)
        pair = (jax_layers.Attention(num_heads=4, dtype=jnp.float32),
                layers.Attention(128, 4))
    elif module == "mlp":
        x = rng.standard_normal((2, 19, 64)).astype(np.float32)
        pair = (jax_layers.Mlp(hidden_dim=256, dtype=jnp.float32),
                layers.Mlp(64, 256))
    else:
        x = rng.standard_normal((2, 16, 64)).astype(np.float32)
        pair = (jax_xcit.XCA(num_heads=4, dtype=jnp.float32),
                xcit.XCA(64, 4))
    want_fp, want, got = _module_pair(*pair, x)
    _assert_close_int8(got, want, want_fp)
    assert 0 < np.linalg.norm(got - want_fp) / np.linalg.norm(want_fp) < 0.05


def _model_case(arch):
    """JAX fp and W8A8 logits of ``arch`` (one trace), the port model with
    the same weights, and the images."""
    x = np.random.default_rng(8).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    jzm = JaxZoo.get_model(arch, classifier=[10], image_size=32,
                           dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jzm.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), True))
    variables = _seeded(shapes, np.random.default_rng(10 + ARCHS.index(arch)))

    @jax.jit
    def run(v, a):
        with _w8a8_env(False):
            ref = jzm.model.apply(v, a, True)
        with _w8a8_env(True):
            got = jzm.model.apply(v, a, True)
        return ref, got

    want_fp, want = run(variables, jnp.asarray(x))
    np_vars = jax.tree.map(np.asarray, variables)
    zm = VisionModelZoo.get_model(arch, classifier=[10], image_size=32,
                                  dtype=torch.float32, device="cpu")
    zm.model.load_state_dict(state_dict_from_jax(
        np_vars["params"], batch_stats=np_vars.get("batch_stats")))
    return (np.asarray(want_fp), np.asarray(want), zm.model.eval(),
            torch.from_numpy(x))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax_under_w8a8(arch):
    """Every transformer family's logits under W8A8 against the JAX
    package's; then against the port's own fp forward with the bounds of
    ``tests/test_quant.py:test_vit_logits_agreement``."""
    want_fp, want, model, x = _model_case(arch)
    with torch.no_grad():
        with _w8a8_env(True), _calls(quant, "int8_gemm") as q:
            got = model(x).numpy()
        with _w8a8_env(False):
            fp = model(x).numpy()
    assert q.call_count > 0
    _assert_close_int8(got, want, want_fp)
    assert _rel(fp, want_fp) <= EXACT_RTOL
    cos = np.sum(fp * got) / (np.linalg.norm(fp) * np.linalg.norm(got))
    assert cos > 0.99, cos
    assert (fp.argmax(-1) == got.argmax(-1)).all()


# ---- bundles ----------------------------------------------------------


@pytest.fixture(scope="module")
def cli_bundles(tmp_path_factory):
    """vit_tiny_test bundles of one seeded set of weights through
    ``cli.export``: W8A8 prequantised, W8A8 with ``--no_prequant``, fp."""
    root = tmp_path_factory.mktemp("w8a8_bundles")
    out = {}
    for name, flags in (("pre", ["--w8a8"]),
                        ("no_pre", ["--w8a8", "--no_prequant"]),
                        ("fp", [])):
        out[name] = str(root / name)
        with _w8a8_env(False):
            cli_export.main(["--arch", "vit_tiny_test", "--classifier",
                             "12,10", "--image_size", "32", "--bs", "2,4",
                             "--device", "cpu",
                             "--out", out[name], *flags])
    return out


def _weights(bundle):
    return torch.load(os.path.join(bundle, "weights.pt"), weights_only=True)


def test_cli_w8a8_bundle_codes_equal_jax_capture(cli_bundles):
    """The prequantised bundle's ``weight_q`` (N, K) and ``weight_scale``
    equal the JAX package's ``prequant_capture`` int8 collection of the
    same fp32 weights (the ``--no_prequant`` bundle's), transposed; its
    other entries equal that bundle's."""
    pre, fp32 = _weights(cli_bundles["pre"]), _weights(cli_bundles["no_pre"])
    manifests = [json.load(open(os.path.join(cli_bundles[k],
                                             "manifest.json")))
                 for k in ("pre", "no_pre", "fp")]
    assert [(m["w8a8"], m["w8a8_prequant"]) for m in manifests] == [
        (True, True), (True, False), (False, False)]
    sd = {k[len("backbone."):]: v.numpy() for k, v in fp32.items()
          if k.startswith("backbone.")}
    jzm = JaxZoo.get_model("vit_tiny_test", classifier=[12, 10],
                           image_size=32, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jzm.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), True))
    params = {"backbone": import_vit(sd, shapes["params"]["backbone"]),
              "head": {f"fc{i}": {k: fp32[f"head.fc{i}.{t}"].numpy().T
                                  if k == "kernel" else
                                  fp32[f"head.fc{i}.{t}"].numpy()
                                  for k, t in (("kernel", "weight"),
                                               ("bias", "bias"))
                                  if f"head.fc{i}.{t}" in fp32}
                       for i in range(2)}}

    # eager, as the JAX export_classifier captures (serving/export.py)
    with _w8a8_env(True), jax_quant.prequant_capture():
        _, aux = jzm.model.apply({"params": params},
                                 jnp.zeros((1, 32, 32, 3)), True,
                                 mutable=["int8"])
    int8 = aux["int8"]["backbone"]
    sites = 0
    for blk, tree in int8.items():
        i = int(blk.split("_")[1])
        for sub, names in (("attn", ("qkv", "proj")),
                           ("mlp", ("fc1", "fc2"))):
            for name in names:
                w_q, w_scale = tree[sub][f"{name}_q8"]
                key = f"backbone.blocks.{i}.{sub}.{name}"
                np.testing.assert_array_equal(
                    pre[f"{key}.weight_q"].numpy(), np.asarray(w_q).T)
                np.testing.assert_array_equal(
                    pre[f"{key}.weight_scale"].numpy(), np.asarray(w_scale))
                assert f"{key}.weight" not in pre
                sites += 1
    assert sites == 4 * len(int8) and sites == sum(
        k.endswith(".weight_q") for k in pre)
    for k, v in fp32.items():
        if k in pre:
            assert torch.equal(pre[k], v), k


def test_bundles_serve_by_their_manifest(cli_bundles):
    """With ``VITX_W8A8`` unset, the prequantised and ``--no_prequant``
    bundles serve the same logits through int8; with it set, the fp bundle
    serves in fp (the same logits as with it unset, no int8 product)."""
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    served = {}
    for name in ("pre", "no_pre", "fp"):
        with _w8a8_env(name == "fp"), _calls(quant, "int8_gemm") as q:
            served[name] = load_bundle(cli_bundles[name],
                                       device="cpu").predict(images)
        assert (q.call_count > 0) == (name != "fp"), name
    np.testing.assert_array_equal(served["pre"], served["no_pre"])
    with _w8a8_env(False):
        fp = load_bundle(cli_bundles["fp"], device="cpu").predict(images)
    np.testing.assert_array_equal(served["fp"], fp)
    assert 0 < _rel(served["pre"], fp) < 0.05
    size = {k: os.path.getsize(os.path.join(v, "weights.pt"))
            for k, v in cli_bundles.items()}
    assert size["pre"] < 0.6 * size["fp"], size


def test_resnet_w8a8_bundle_keeps_fp32(tmp_path):
    """ResNet has no quantised product: its ``--w8a8`` bundle says
    ``w8a8_prequant: false`` and keeps every weight, as the JAX export
    does for a conv-only backbone."""
    out = str(tmp_path / "resnet")
    cli_export.main(["--arch", "resnet_test", "--image_size", "32",
                     "--bs", "2", "--device", "cpu", "--w8a8", "--out", out])
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert manifest["w8a8"] and not manifest["w8a8_prequant"]
    assert not any(k.endswith("weight_q") for k in _weights(out))
    logits = load_bundle(out, device="cpu").predict(
        np.zeros((2, 32, 32, 3), np.uint8))
    assert logits.shape == (2, 10) and np.isfinite(logits).all()


def test_cli_main_export_bundle_bakes_w8a8(tmp_path):
    """``cli.main --export_bundle`` under ``VITX_W8A8=1`` writes a W8A8
    bundle with prequantised weights, which serves with the flag unset."""
    bundle = str(tmp_path / "b")
    with _w8a8_env(True):
        cli_main.main(["--dataset", "synthetic", "--arch", "vit_tiny_test",
                       "--image_size", "32", "--epoch", "1", "--bs", "16",
                       "--limit_train", "16", "--limit_test", "16",
                       "--device", "cpu", "--export_bundle", bundle,
                       "--export_bs", "2"])
    manifest = json.load(open(os.path.join(bundle, "manifest.json")))
    assert manifest["w8a8"] and manifest["w8a8_prequant"]
    with _w8a8_env(False), _calls(quant, "int8_gemm") as q:
        logits = load_bundle(bundle, device="cpu").predict(
            np.zeros((2, 32, 32, 3), np.uint8))
    assert q.call_count == 8 and np.isfinite(logits).all()
