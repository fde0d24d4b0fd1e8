"""The port's CUDA kernels on the card: the flash-attention forward and
backward against their plain versions, their input checks and launch
counts, the classifier on CUDA against the same weights on the CPU, and a
bf16 train step that runs the backward kernel once per layer; the Swin
window-attention kernels (forward and backward) and window-block kernels
against their plain versions, with gradients, their refusals, a small Swin
on the card against the CPU, and a Swin fine-tune step that runs the
window-attention backward once per block, and the backward at every
chip_smoke Swin shape, masked and not, bitwise the same across two calls;
the CaiT talking-heads kernel against its plain version through its three
entry points and at every chip_smoke CaiT shape, its refusals,
a small CaiT on the card against the CPU, and a CaiT fine-tune step that
launches the kernel once per talking-heads block; the fused attention
blocks (B3 and B4) against their plain versions, with gradients, their
refusals, and a dino-shaped ViT step with B3 forced on against the CPU;
the fused MLP (B12) against its plain version, with gradients, its
refusals, and a DeiT-shaped step with it on against the CPU; the flat
window block (B7) against its plain version, with gradients; the window
GEMM's four launches of B9 and the window-attention core's plans (one
and 64 mask rows, 25- and 49-token windows) against their plain
versions; the conv families at full width (xcit_small_24_p16 with B12 off
and on, resnext50_32x4d with the conv+BN fold on and off) against their
fp32 CPU forwards, and their BN running statistics after one card step.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They
import neither JAX nor the JAX package, so they run on a machine without
JAX (the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from vit_torch_tpu_torch.ops import attn_block as ab
from vit_torch_tpu_torch.ops import flash_attention as fa
from vit_torch_tpu_torch.ops import talking_heads as th
from vit_torch_tpu_torch.ops import window_attention as wa
from vit_torch_tpu_torch.ops import window_block as wb

pytestmark = pytest.mark.cuda

# bf16 outputs of order 1 that differ by summation order and the final
# rounding (see chip_smoke.py)
ATOL = 2e-2
# gradients: max |kernel - plain| relative to max |plain|, floored (see
# chip_smoke.py BWD_RTOL)
BWD_RTOL, BWD_FLOOR = 2e-2, 1e-3
# window blocks: max |kernel - plain| relative to max |plain|.  Both round
# at the same points, but fp32 sums in another order can move a rounded
# qkv, head output or hidden value by one bf16 ulp (2^-8), which the next
# product carries; outputs hold the residual stream (see chip_smoke.py)
BLOCK_RTOL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _qkv(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(3)]


# small ragged shapes; DeiT-base bs32 and dino_vits16 @224 bs64 (N = 197);
# a ragged D = 32 shape whose last 128-row block has one live warpgroup
FLASH_SHAPES = [(2, 3, 1, 64), (2, 3, 65, 64), (1, 2, 130, 32),
                (3, 2, 257, 64), (32, 12, 197, 64), (64, 6, 197, 64),
                (3, 5, 211, 32)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_kernel_matches_plain(cuda, shape):
    q, k, v = _qkv(shape, seed=shape[2], device=cuda)
    ref = fa.flash_attention_bhnd_reference(q, k, v).float()
    got = fa.flash_attention_bhnd(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() <= ATOL
    # the (B, N, H, D) entry, reading strided views of one qkv tensor
    B, H, N, D = shape
    qkv = torch.stack([x.transpose(1, 2) for x in (q, k, v)], dim=2)
    out = fa.flash_attention(*qkv.unbind(2))
    assert out.is_contiguous() and out.shape == (B, N, H, D)
    assert (out.transpose(1, 2).float() - ref).abs().max().item() <= ATOL


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 16, 64), seed=0, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_bhnd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bhnd(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bhnd(q[..., 1:33], k[..., 1:33], v[..., 1:33])
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[..., :8], o)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, k, v, o, lse, o.float())


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_bwd_kernel_matches_plain(cuda, shape):
    """Gradients through the packed-qkv entry, as the model calls it,
    against the plain backward; one backward launch per call."""
    B, H, N, D = shape
    gen = torch.Generator(device=cuda).manual_seed(N)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device=cuda,
                      dtype=torch.bfloat16, requires_grad=True)
    dout = torch.randn((B, N, H, D), generator=gen, device=cuda,
                       dtype=torch.bfloat16)
    before = fa.flash_attention_bwd.launches
    (dqkv,) = torch.autograd.grad(fa.flash_attention_qkv(qkv), qkv, dout)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    q, k, v = (x.detach().transpose(1, 2) for x in qkv.unbind(2))
    ref = fa.flash_attention_bwd_reference(q, k, v, dout.transpose(1, 2))
    for got, want in zip(dqkv.unbind(2), ref):
        err = (got.transpose(1, 2).float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL * max(want.float().abs().max().item(),
                                     BWD_FLOOR)


def test_bwd_kernel_writes_one_dqkv_through_strides(cuda):
    """dq, dk and dv as views into one (B, N, 3, H, D) gradient (the qkv
    Function's layout), filled with NaN first: every element is written,
    each against the plain backward, and dq, which sums by atomics, agrees
    with itself between two runs to one bf16 rounding."""
    B, H, N, D = 4, 6, 197, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv, dout = (torch.randn(shape, generator=gen, device=cuda,
                             dtype=torch.bfloat16)
                 for shape in ((B, N, 3, H, D), (B, N, H, D)))
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    do = dout.transpose(1, 2)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    grads = []
    for _ in range(2):
        dqkv = torch.full((B, N, 3, H, D), float("nan"), device=cuda,
                          dtype=torch.bfloat16)
        views = [x.transpose(1, 2) for x in dqkv.unbind(2)]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, dq=views[0],
                                     dk=views[1], dv=views[2])
        assert all(g.data_ptr() == w.data_ptr() for g, w in zip(got, views))
        grads.append(dqkv)
    torch.cuda.synchronize()
    assert torch.isfinite(grads[0]).all()
    ref = fa.flash_attention_bwd_reference(q, k, v, do)
    for got, want in zip(grads[0].unbind(2), ref):
        err = (got.transpose(1, 2).float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL * max(want.float().abs().max().item(),
                                     BWD_FLOOR)
    assert torch.equal(grads[0][:, :, 1:], grads[1][:, :, 1:])
    dq0, dq1 = (g[:, :, 0].float() for g in grads)
    assert ((dq0 - dq1).abs() <= 2 ** -7 * dq0.abs().clamp_min(1e-3)).all()


def test_launch_count(cuda):
    q, k, v = _qkv((1, 1, 8, 32), seed=1, device=cuda)
    before = fa.flash_attention_bhnd.launches
    fa.flash_attention_bhnd(q, k, v)
    fa.flash_attention(q, k, v)
    assert fa.flash_attention_bhnd.launches == before + 2


def test_classifier_on_cuda_matches_cpu(cuda):
    """bf16 logits of one seeded model on the card (flash kernel) and on
    the CPU (plain attention)."""
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    models = [VisionModelZoo.get_model("vit_tiny_test", classifier=[10],
                                       image_size=32, device=dev)
              for dev in (cuda, "cpu")]
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    before = fa.flash_attention_bhnd.launches
    with torch.inference_mode():
        got, ref = (zm.model(torch.from_numpy(x).to(dev)).float().cpu()
                    for zm, dev in zip(models, (cuda, "cpu")))
    assert fa.flash_attention_bhnd.launches == before + 2   # depth 2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-2, rtol=0)


def test_train_step_launches_bwd_kernel_per_layer(cuda):
    """One bf16 finetune step of a depth-2 model on the card: two forward
    and two backward kernel launches, finite loss and gradients."""
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.train.optimizers import get_optimizer
    from vit_torch_tpu_torch.train.steps import make_train_step
    zm = VisionModelZoo.get_model("vit_tiny_test", classifier=[10],
                                  image_size=32, device=cuda)
    model = zm.model.train()
    opt = get_optimizer("adamw", model.parameters(), 1e-3)
    step = make_train_step(model, opt)
    x = torch.randn((4, 32, 32, 3), device=cuda)
    labels = torch.arange(4, device=cuda)
    mask = torch.ones(4, device=cuda)
    fwd, bwd = fa.flash_attention_bhnd.launches, fa.flash_attention_bwd.launches
    m = step(x, labels, mask)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhnd.launches == fwd + 2
    assert fa.flash_attention_bwd.launches == bwd + 2
    assert torch.isfinite(m["loss_sum"]).item()
    assert all(torch.isfinite(p).all() for p in model.parameters())


# (B, H, W, C, window, shift): window 12 shifted and unshifted, window 7
# (N = 49, padded to 64 rows), a ragged window 5 on a 10 x 15 map
BLOCK_CASES = [(2, 24, 24, 64, 12, 6), (1, 12, 12, 128, 12, 0),
               (2, 14, 14, 96, 7, 3), (1, 10, 15, 64, 5, 2)]


def _block_inputs(case, device, seed=0):
    """A bf16 map, bf16 weights in nn.Linear layout, fp32 LN weights, the
    fp32 bias and, for a shifted block, a -100/0 mask."""
    B, H, W, C, w, shift = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    heads, N, hid = C // 32, w * w, 4 * C
    nW = (H // w) * (W // w)
    x = rnd(B, H, W, C)
    mask = None
    if shift:
        mask = torch.where(torch.rand((nW, N, N), generator=gen,
                                      device=device) > 0.7, -100.0, 0.0)
    lin = lambda o, i: (rnd(o, i, scale=i ** -0.5), rnd(o, scale=0.1))
    ln = lambda: (1 + rnd(C, scale=0.1, dtype=torch.float32),
                  rnd(C, scale=0.1, dtype=torch.float32))
    return dict(x=x, bias=rnd(heads, N, N, scale=0.5, dtype=torch.float32),
                mask=mask, qkv=lin(3 * C, C), proj=lin(C, C), fc1=lin(hid, C),
                fc2=lin(C, hid), ln1=ln(), ln2=ln(), heads=heads, w=w,
                shift=shift)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("N", [144, 49, 16, 1])
def test_window_attention_kernel_matches_plain(cuda, N, masked):
    """The core over views of one (Bn, N, 3, H, D) qkv tensor, as the
    block kernels feed it, and over contiguous tensors."""
    Bn, H, nW = 8, 3, 4
    gen = torch.Generator(device=cuda).manual_seed(N)
    qkv = torch.randn((Bn, N, 3, H, 32), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    bias = torch.randn((H, N, N), generator=gen, device=cuda)
    mask = (torch.where(torch.rand((nW, N, N), generator=gen, device=cuda)
                        > 0.7, -100.0, 0.0) if masked else None)
    q, k, v = qkv.unbind(2)
    before = wa.window_attention.launches
    got = wa.window_attention(q, k, v, bias, mask)
    got_c = wa.window_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), bias, mask)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 2
    ref = wa.window_attention_reference(q, k, v, bias, mask).float()
    assert got.shape == (Bn, N, H, 32) and got.is_contiguous()
    for out in (got, got_c):
        assert (out.float() - ref).abs().max().item() <= ATOL


@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_window_block_kernels_match_plain(cuda, case):
    """B8 and B9 with the shift folded in, against their plain versions
    (which roll); one launch of each chain and one core launch each."""
    d = _block_inputs(case, cuda)
    kw = dict(num_heads=d["heads"], window=d["w"], shift=d["shift"])
    b8 = (d["x"], *d["qkv"], d["bias"], d["mask"], *d["proj"])
    b9 = (d["x"], d["ln1"], d["qkv"], d["bias"], d["mask"], d["proj"],
          d["ln2"], d["fc1"], d["fc2"])
    counts = (wb.window_block_spatial.launches,
              wb.window_block_full_spatial.launches,
              wa.window_attention.launches)
    got8 = wb.window_block_spatial(*b8, **kw)
    got9 = wb.window_block_full_spatial(*b9, **kw)
    torch.cuda.synchronize()
    assert (wb.window_block_spatial.launches,
            wb.window_block_full_spatial.launches,
            wa.window_attention.launches) == (counts[0] + 1, counts[1] + 1,
                                              counts[2] + 2)
    ref8 = wb.window_block_spatial_reference(*b8, **kw)
    ref9 = wb.window_block_full_spatial_reference(*b9, **kw)
    assert got8.shape == got9.shape == d["x"].shape
    assert _rel_err(got8, ref8) <= BLOCK_RTOL
    assert _rel_err(got9, ref9) <= BLOCK_RTOL


# (Bn, N, H, nW): the core's plans at one mask row and at 64 (the swin
# stage-1 masks), windows of 25 and 49 tokens, a single window
CORE_CASES = [(6, 144, 2, 1), (128, 144, 2, 64), (12, 25, 2, 6),
              (128, 49, 3, 64), (1, 49, 1, 1)]


@pytest.mark.parametrize("case", CORE_CASES, ids=str)
def test_window_attention_core_plans_match_plain(cuda, case):
    """The core over strided q/k/v views of one (Bn, N, 3, H, D) qkv
    tensor and a -100/0 mask (or none, at nW = 1), against the plain
    version; the plan's runs of windows and the group tables."""
    Bn, N, H, nW = case
    gen = torch.Generator(device=cuda).manual_seed(7 * N + nW)
    qkv = torch.randn((Bn, N, 3, H, 32), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    bias = torch.randn((H, N, N), generator=gen, device=cuda)
    mask = (torch.where(torch.rand((nW, N, N), generator=gen, device=cuda)
                        > 0.7, -100.0, 0.0) if nW > 1 else None)
    q, k, v = qkv.unbind(2)
    got = wa.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    ref = wa.window_attention_reference(q, k, v, bias, mask).float()
    assert (got.float() - ref).abs().max().item() <= ATOL


# (B, H, W, C, window, shift): K = 96 (swin_tiny, N = 96, 288, 384), K = 64
# with a ragged T = 300 (not a multiple of the 128-row tile), the stage-4
# width of swin_base
GEMM_CASES = [(2, 14, 14, 96, 7, 3), (2, 10, 15, 64, 5, 2),
              (1, 12, 12, 1024, 12, 0)]


@pytest.mark.parametrize("launch", ["qkv", "proj", "fc1", "fc2"])
@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_window_gemm_kernel_matches_plain(cuda, case, launch):
    """One window-GEMM launch as B9 makes it (the gathered qkv, the
    scattered proj with its residual, fc1 with GELU, fc2 with its
    residual) against dense_f32 with the epilogue's roundings, the rows
    permuted as the kernel addresses them; one launch counted."""
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import gemm as gm
    B, H, W, C, w, shift = case
    T = B * H * W
    K, N, epi = {"qkv": (C, 3 * C, gm.EPI_BIAS),
                 "proj": (C, C, gm.EPI_BIAS_RES),
                 "fc1": (C, 4 * C, gm.EPI_GELU),
                 "fc2": (4 * C, C, gm.EPI_BIAS16_RES)}[launch]
    gen = torch.Generator(device=cuda).manual_seed(K + N)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda)
                * scale).to(torch.bfloat16)

    a, wt, bt = rnd(T, K), rnd(N, K, scale=K ** -0.5), rnd(N, scale=0.1)
    res = rnd(T, N) if epi in (gm.EPI_BIAS_RES, gm.EPI_BIAS16_RES) else None
    out = torch.empty((T, N), dtype=torch.bfloat16, device=cuda)
    before = gm.gemm.launches
    gm.gemm(a, wt, bt, out, epilogue=epi, geom=(H, W, w, shift),
            gather=launch == "qkv", scatter=launch == "proj", res=res)
    torch.cuda.synchronize()
    assert gm.gemm.launches == before + 1
    order = ((torch.arange(B, device=cuda) * H * W)[:, None]
             + gm.window_rows(H, W, w, shift, cuda)[None].long()).view(-1)

    def r16(x):
        return x.to(torch.bfloat16).float()

    acc = gm.dense_f32(a[order] if launch == "qkv" else a, wt, None)
    if epi == gm.EPI_BIAS:
        ref = r16(acc + bt.float())
    elif epi == gm.EPI_BIAS_RES:
        ref = r16(r16(acc + bt.float()) + res[order].float())
        ref = ref[torch.argsort(order)]
    elif epi == gm.EPI_GELU:
        ref = r16(F.gelu(r16(r16(acc) + bt.float())))
    else:
        ref = r16(res.float() + r16(r16(acc) + bt.float()))
    assert _rel_err(out, ref) <= BLOCK_RTOL


def test_window_kernels_refuse_what_they_do_not_take(cuda):
    d = _block_inputs((1, 12, 12, 64, 12, 0), cuda)
    q = torch.randn((2, 144, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        wa.window_attention(q.float(), q.float(), q.float(), d["bias"])
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention(q[..., :16], q[..., :16], q[..., :16], d["bias"])
    with pytest.raises(ValueError, match="bias"):
        wa.window_attention(q, q, q, d["bias"].bfloat16())
    with pytest.raises(TypeError):
        wa.window_attention_bwd(q, q, q, d["bias"], None, q.float())
    odd = torch.empty((2, 144, 2, 40), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        wa.window_attention_bwd(q, q, q, d["bias"], None, q,
                                dq=odd[..., 1:33])
    kw = dict(num_heads=2, window=12)
    with pytest.raises(ValueError, match="tiled by window"):
        wb.window_block_spatial(d["x"][:, :10], *d["qkv"], d["bias"], None,
                                *d["proj"], **kw)
    with pytest.raises(ValueError, match="ln1"):
        wb.window_block_full_spatial(
            d["x"], (d["ln1"][0].bfloat16(), d["ln1"][1]), d["qkv"],
            d["bias"], None, d["proj"], d["ln2"], d["fc1"], d["fc2"], **kw)


def test_swin_on_cuda_matches_cpu(cuda):
    """bf16 features of one seeded small Swin (head dim 32) on the card,
    every block through B9 in eval, against the same weights on the CPU
    (plain versions)."""
    from vit_torch_tpu_torch.models.layers import init_weights
    from vit_torch_tpu_torch.models.swin import SwinConfig, SwinTransformer
    cfg = SwinConfig(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                     window_size=4, drop_path_rate=0.0)
    model = SwinTransformer(cfg, image_size=32).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    before = wb.window_block_full_spatial.launches
    with torch.inference_mode():
        ref = model(torch.from_numpy(x)).float()
        got = model.to(cuda)(torch.from_numpy(x).to(cuda)).float().cpu()
    assert wb.window_block_full_spatial.launches == before + 4   # depth 4
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-2, rtol=0)


def _bwd_counts():
    return (wa.window_attention.launches, wa.window_attention_bwd.launches,
            wa.window_attention_reference.calls,
            wa.window_attention_bwd_reference.calls)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("N", [144, 49, 16, 1])
def test_window_attention_bwd_kernel_matches_plain(cuda, N, masked):
    """B6 through the qkv entry's autograd Function, as the model calls
    it, against the plain backward: dq, dk and dv within BWD_RTOL of
    max |plain| (floored), dbias within 1e-2 of max |plain dbias|; one
    launch of each kernel and no plain version on the way."""
    Bn, H, nW = 8, 3, 4
    gen = torch.Generator(device=cuda).manual_seed(100 + N)
    qkv = torch.randn((Bn, N, 3, H, 32), generator=gen, device=cuda,
                      dtype=torch.bfloat16, requires_grad=True)
    bias = torch.randn((H, N, N), generator=gen, device=cuda,
                       requires_grad=True)
    mask = (torch.where(torch.rand((nW, N, N), generator=gen, device=cuda)
                        > 0.7, -100.0, 0.0) if masked else None)
    dout = torch.randn((Bn, N, H, 32), generator=gen, device=cuda,
                       dtype=torch.bfloat16)
    before = _bwd_counts()
    out = wa.window_attention_qkv(qkv, bias, mask)
    dqkv, dbias = torch.autograd.grad(out, (qkv, bias), dout)
    torch.cuda.synchronize()
    assert _bwd_counts() == (before[0] + 1, before[1] + 1, *before[2:])
    ref = wa.window_attention_bwd_reference(
        *qkv.detach().unbind(2), bias.detach(), mask, dout)
    for got, want in zip(dqkv.unbind(2), ref):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL * max(want.float().abs().max().item(),
                                     BWD_FLOOR)
    assert dbias.shape == (H, N, N) and dbias.dtype == torch.float32
    err = (dbias - ref[3]).abs().max().item()
    assert err <= 1e-2 * max(ref[3].abs().max().item(), BWD_FLOOR)


@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_window_block_grads_match_plain(cuda, case):
    """The gradients of B8 and B9 through their autograd Functions (the
    chains forward, B6 backward) against autograd through their plain
    versions, every input but the mask."""
    d = _block_inputs(case, cuda)
    kw = dict(num_heads=d["heads"], window=d["w"], shift=d["shift"])
    for fn, ref_fn, full in (
            (wb.window_block_spatial, wb.window_block_spatial_reference,
             False),
            (wb.window_block_full_spatial,
             wb.window_block_full_spatial_reference, True)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            d["x"], *d["ln1"], *d["qkv"], d["bias"], *d["proj"], *d["ln2"],
            *d["fc1"], *d["fc2"])]
        x, l1w, l1b, wq, bq, bias, wp, bp, l2w, l2b, w1, b1, w2, b2 = leaves
        if full:
            args = (x, (l1w, l1b), (wq, bq), bias, d["mask"], (wp, bp),
                    (l2w, l2b), (w1, b1), (w2, b2))
            wrt = leaves
        else:
            args = (x, wq, bq, bias, d["mask"], wp, bp)
            wrt = [x, wq, bq, bias, wp, bp]
        dout = torch.randn_like(d["x"])
        before = wa.window_attention_bwd.launches
        got = torch.autograd.grad(fn(*args, **kw), wrt, dout)
        torch.cuda.synchronize()
        assert wa.window_attention_bwd.launches == before + 1
        want = torch.autograd.grad(ref_fn(*args, **kw), wrt, dout)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert _rel_err(g, w) <= BLOCK_RTOL


def test_swin_finetune_step_on_cuda_runs_b6_per_block(cuda):
    """One bf16 AdamW fine-tune step of a small Swin (head dim 32) on the
    card: block 0 (drop-path rate 0) through B9, the others through B8,
    and the attention backward of every block through B6; finite loss and
    gradients, no plain version launched."""
    from vit_torch_tpu_torch.models.layers import set_generator
    from vit_torch_tpu_torch.models.swin import SwinConfig, SwinTransformer
    from vit_torch_tpu_torch.models.zoo import Classifier
    from vit_torch_tpu_torch.models.layers import ClassifierHead, init_weights
    from vit_torch_tpu_torch.train.optimizers import get_optimizer
    from vit_torch_tpu_torch.train.steps import make_train_step
    cfg = SwinConfig(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                     window_size=4, drop_path_rate=0.1)
    model = Classifier(SwinTransformer(cfg, image_size=32),
                       ClassifierHead(cfg.feature_dim, [10]))
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    set_generator(model, torch.Generator(device=cuda).manual_seed(0))
    step = make_train_step(model, get_optimizer("adamw", model.parameters(),
                                                1e-3))
    x = torch.randn((4, 32, 32, 3), device=cuda)
    labels = torch.arange(4, device=cuda)
    mask = torch.ones(4, device=cuda)
    blocks = (wb.window_block_spatial.launches,
              wb.window_block_full_spatial.launches)
    before = _bwd_counts()
    m = step(x, labels, mask)
    torch.cuda.synchronize()
    assert (wb.window_block_spatial.launches,
            wb.window_block_full_spatial.launches) == (blocks[0] + 3,
                                                        blocks[1] + 1)
    # the core: 4 forwards and B9's recompute; B6: one per block
    assert _bwd_counts() == (before[0] + 5, before[1] + 4, *before[2:])
    assert torch.isfinite(m["loss_sum"]).item()
    assert all(torch.isfinite(p).all() for p in model.parameters())


# the backward at chip_smoke's SWIN_BLOCKS shapes, (Bn, N, H, nW):
# swin_base_384 bs32 stages 1-4, swin_tiny's window 7 stage 1, a ragged
# window 5; each masked (a -100/0 mask of nW rows, one row at stage 4) and
# not
SWIN_BWD_SHAPES = [(2048, 144, 4, 64), (512, 144, 8, 16), (128, 144, 16, 4),
                   (32, 144, 32, 1), (2048, 49, 3, 64), (12, 25, 2, 6)]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", SWIN_BWD_SHAPES, ids=str)
def test_window_attention_bwd_at_swin_shapes(cuda, shape, masked):
    """B6 over strided views of one (Bn, N, 3, H, D) qkv tensor, its
    gradients written into one such tensor, against the plain backward
    (dq, dk, dv within BWD_RTOL of max |plain|, dbias within 1e-2 of
    max |plain dbias|); a second call gives bitwise the same dq, dk, dv
    and dbias (the partials are summed in a fixed order)."""
    Bn, N, H, nW = shape
    gen = torch.Generator(device=cuda).manual_seed(Bn + N + H)
    qkv = torch.randn((Bn, N, 3, H, 32), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    bias = 0.5 * torch.randn((H, N, N), generator=gen, device=cuda)
    mask = (torch.where(torch.rand((nW, N, N), generator=gen, device=cuda)
                        > 0.7, -100.0, 0.0) if masked else None)
    dout = torch.randn((Bn, N, H, 32), generator=gen, device=cuda,
                       dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    runs = []
    for _ in range(2):
        dqkv = torch.empty_like(qkv)
        *_, dbias = wa.window_attention_bwd(
            q, k, v, bias, mask, dout,
            **dict(zip(("dq", "dk", "dv"), dqkv.unbind(2))))
        runs.append((dqkv, dbias))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dqkv, dbias = runs[0]
    ref = wa.window_attention_bwd_reference(q, k, v, bias, mask, dout)
    for got, want in zip(dqkv.unbind(2), ref):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL * max(want.float().abs().max().item(),
                                     BWD_FLOOR)
    err = (dbias - ref[3]).abs().max().item()
    assert err <= 1e-2 * max(ref[3].abs().max().item(), BWD_FLOOR)


# talking heads: max |kernel - plain| relative to max |plain|.  Both round
# the mixed weights A to bf16 at the same point, but fp32 sums in another
# order can move one A element by one bf16 ulp (2^-8), which PV carries
# (see chip_smoke.py TH_RTOL)
TH_RTOL = 2e-2


def _th_inputs(shape, device, seed=0):
    """A (B, N, 3, H, D) bf16 qkv tensor and fp32 tables: mixes of std 0.3
    around the identity, biases of std 0.1."""
    B, H, N, D = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device=device,
                      dtype=torch.bfloat16)
    eye = torch.eye(H, device=device)
    tables = (eye + 0.3 * torch.randn((H, H), generator=gen, device=device),
              0.1 * torch.randn((H,), generator=gen, device=device),
              eye + 0.3 * torch.randn((H, H), generator=gen, device=device),
              0.1 * torch.randn((H,), generator=gen, device=device))
    return qkv, tables


# cait_s24 at 224 px (shrunk batch), xxs, m48's 16 heads of dim 64, a
# ragged N, H = 6 (xs), head dims 16 and 32, a single token
TH_SHAPES = [(2, 8, 196, 48), (2, 4, 37, 48), (1, 16, 100, 64),
             (3, 2, 17, 16), (1, 6, 50, 32), (2, 1, 1, 48)]


@pytest.mark.parametrize("shape", TH_SHAPES, ids=str)
def test_talking_heads_kernel_matches_plain(cuda, shape):
    """The kernel through the model's qkv entry (strided views), the
    (B, H, N, D) entry on contiguous tensors and the (B, N, C) entry,
    against the plain version; one launch each, no plain forward."""
    B, H, N, D = shape
    qkv, tables = _th_inputs(shape, cuda, seed=N)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    before = (th.talking_heads_attention.launches,
              th.talking_heads_reference.calls)
    got_qkv = th.talking_heads_attention_qkv(qkv, *tables).transpose(1, 2)
    got_bhnd = th.talking_heads_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), *tables)
    bnc = [x.reshape(B, N, H * D) for x in qkv.unbind(2)]
    got_bnc = th.talking_heads_attention_bnc(*bnc, *tables, num_heads=H)
    torch.cuda.synchronize()
    assert (th.talking_heads_attention.launches,
            th.talking_heads_reference.calls) == (before[0] + 3, before[1])
    ref = th.talking_heads_reference(q, k, v, *tables)
    assert got_bnc.shape == (B, N, H * D) and got_bnc.is_contiguous()
    got_bnc = got_bnc.view(B, N, H, D).transpose(1, 2)
    for got in (got_qkv, got_bhnd, got_bnc):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel_err(got, ref) <= TH_RTOL


# chip_smoke's TH_SHAPES (cait_s24_224 bs32, xxs24_224 bs32, s24_384 and
# m36_384 bs8, m48_448 bs4, a ragged shape), head dims 16, 32 and 64 on a
# small shape, a single head
TH_CHIP_SHAPES = [(32, 8, 196, 48), (32, 4, 196, 48), (8, 8, 576, 48),
                  (8, 16, 576, 48), (4, 16, 784, 48), (2, 4, 37, 48),
                  (2, 8, 70, 16), (2, 8, 70, 32), (2, 8, 70, 64),
                  (2, 1, 50, 48)]


@pytest.mark.parametrize("entry", ["qkv", "bnc"])
@pytest.mark.parametrize("shape", TH_CHIP_SHAPES, ids=str)
def test_talking_heads_kernel_at_cait_shapes(cuda, shape, entry):
    """The kernel through the model's qkv entry (strided views of one
    (B, N, 3, H, D) tensor) or the (B, N, C) entry, against the plain
    version; one launch, no plain forward."""
    B, H, N, D = shape
    qkv, tables = _th_inputs(shape, cuda, seed=N + H)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    before = (th.talking_heads_attention.launches,
              th.talking_heads_reference.calls)
    if entry == "qkv":
        got = th.talking_heads_attention_qkv(qkv, *tables).transpose(1, 2)
    else:
        bnc = [x.reshape(B, N, H * D) for x in qkv.unbind(2)]
        got = th.talking_heads_attention_bnc(
            *bnc, *tables, num_heads=H).view(B, N, H, D).transpose(1, 2)
    torch.cuda.synchronize()
    assert (th.talking_heads_attention.launches,
            th.talking_heads_reference.calls) == (before[0] + 1, before[1])
    ref = th.talking_heads_reference(q, k, v, *tables)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TH_RTOL


def test_talking_heads_kernel_refuses_what_it_does_not_take(cuda):
    qkv, tables = _th_inputs((1, 4, 16, 48), cuda)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    wl, bl, ww, bw = tables
    with pytest.raises(TypeError):
        th.talking_heads_attention(q.float(), k.float(), v.float(), *tables)
    with pytest.raises(ValueError, match="head dim"):
        th.talking_heads_attention(q[..., :40], k[..., :40], v[..., :40],
                                   *tables)
    big = torch.zeros((1, 17, 8, 16), device=cuda, dtype=torch.bfloat16)
    eye = torch.eye(17, device=cuda)
    zero = torch.zeros(17, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        th.talking_heads_attention(big, big, big, eye, zero, eye, zero)
    long = torch.zeros((1, 1, th.MAX_TOKENS + 1, 16), device=cuda,
                       dtype=torch.bfloat16)
    one, bias = torch.ones((1, 1), device=cuda), torch.zeros(1, device=cuda)
    with pytest.raises(ValueError, match="tokens"):
        th.talking_heads_attention(long, long, long, one, bias, one, bias)
    odd = torch.zeros((1, 4, 16, 49), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        th.talking_heads_attention(odd[..., 1:], odd[..., 1:], odd[..., 1:],
                                   *tables)
    with pytest.raises(ValueError, match="wl"):
        th.talking_heads_attention(q, k, v, wl.double(), bl, ww, bw)


def test_cait_on_cuda_matches_cpu(cuda):
    """bf16 features of the seeded cait_test backbone on the card (every
    talking-heads block through the kernel) against the same weights on
    the CPU (plain version); the LayerScale gates are raised from their
    1e-5 init to 0.1 so that every block shows in the bf16 features."""
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    models = [VisionModelZoo.get_model("cait_test", image_size=32,
                                       device=dev)
              for dev in (cuda, "cpu")]
    with torch.no_grad():
        for zm in models:
            for name, p in zm.model.named_parameters():
                if ".gamma_" in name:
                    p.fill_(0.1)
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    before = th.talking_heads_attention.launches
    with torch.inference_mode():
        got, ref = (zm.model(torch.from_numpy(x).to(dev)).float().cpu()
                    for zm, dev in zip(models, (cuda, "cpu")))
    assert th.talking_heads_attention.launches == before + 2   # depth 2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-2, rtol=0)


def test_cait_finetune_step_launches_the_kernel_per_block(cuda):
    """One bf16 AdamW fine-tune step of cait_test on the card: one kernel
    launch and one backward recompute per talking-heads block, no plain
    forward, no flash or window kernel; finite loss and parameters."""
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.train.optimizers import get_optimizer
    from vit_torch_tpu_torch.train.steps import make_train_step
    zm = VisionModelZoo.get_model("cait_test", classifier=[10],
                                  image_size=32, device=cuda)
    model = zm.model.train()
    step = make_train_step(model, get_optimizer("adamw", model.parameters(),
                                                1e-3))
    x = torch.randn((4, 32, 32, 3), device=cuda)
    labels = torch.arange(4, device=cuda)
    mask = torch.ones(4, device=cuda)

    def counts():
        return (th.talking_heads_attention.launches,
                th.talking_heads_bwd.calls, th.talking_heads_reference.calls,
                fa.flash_attention_bhnd.launches, wa.window_attention.launches)

    before = counts()
    m = step(x, labels, mask)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 2, *before[2:])
    assert torch.isfinite(m["loss_sum"]).item()
    assert all(torch.isfinite(p).all() for p in model.parameters())


# fused attention blocks: max |kernel - plain| relative to max |plain|.
# Both round qkv, P and each head's output to bf16 at the same points, but
# fp32 sums in another order (and the kernel's online softmax past 64 keys)
# can move one of them by one bf16 ulp (2^-8), which the projection carries
# (see chip_smoke.py ATTN_BLOCK_RTOL)
AB_RTOL = 3e-2


def _ab_inputs(B, N, C, device, seed=0, bias=True):
    """A bf16 (B, N, C) block of std 1 and bf16 weights in nn.Linear
    layout of std 1/sqrt(C), biases of std 0.1 (or None)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    return (rnd(B, N, C), rnd(3 * C, C, scale=C ** -0.5),
            rnd(3 * C, scale=0.1) if bias else None,
            rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1) if bias else None)


# (B, N, C, heads): dino_vits16 @224 (shrunk batch), a ragged N over two
# query tiles, head dim 32, one token, no biases
AB_SHAPES = [(2, 197, 384, 6), (3, 37, 128, 2), (2, 130, 256, 8),
             (2, 1, 128, 2)]


@pytest.mark.parametrize("shape", AB_SHAPES, ids=str)
def test_attention_block_kernel_matches_plain(cuda, shape):
    B, N, C, H = shape
    args = _ab_inputs(B, N, C, cuda, seed=N, bias=N != 1)
    before = (ab.attention_block.launches, ab.attention_block_reference.calls)
    got = ab.attention_block(*args, num_heads=H)
    torch.cuda.synchronize()
    assert (ab.attention_block.launches,
            ab.attention_block_reference.calls) == (before[0] + 1, before[1])
    ref = ab.attention_block_reference(*args, num_heads=H)
    assert got.shape == (B, N, C) and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= AB_RTOL


# (B, N, C, heads): dino_vitb8 @32 (shrunk batch), a ragged pack of 12
# images per tile, the largest N, head dim 32
AB_PACKED_SHAPES = [(9, 17, 768, 12), (7, 5, 128, 4), (3, 48, 128, 2),
                    (13, 9, 256, 8)]


@pytest.mark.parametrize("shape", AB_PACKED_SHAPES, ids=str)
def test_attention_block_packed_kernel_matches_plain(cuda, shape):
    """The packed kernel's output and its qkv projection (the backward's
    residual) against the plain version's."""
    B, N, C, H = shape
    args = _ab_inputs(B, N, C, cuda, seed=B)
    before = (ab.attention_block_packed.launches,
              ab.attention_block_packed_reference.calls)
    out, qkv = ab.attention_block_packed_fwd(*args, num_heads=H)
    torch.cuda.synchronize()
    assert (ab.attention_block_packed.launches,
            ab.attention_block_packed_reference.calls) == (before[0] + 1,
                                                           before[1])
    ref_out, ref_qkv = ab.attention_block_packed_reference(*args,
                                                           num_heads=H)
    assert out.shape == (B, N, C) and qkv.shape == (B, N, 3 * C)
    assert torch.isfinite(out).all()
    assert _rel_err(out, ref_out) <= AB_RTOL
    assert _rel_err(qkv, ref_qkv) <= AB_RTOL


@pytest.mark.parametrize("packed", [False, True], ids=["b3", "b4"])
def test_attention_block_grads_match_plain(cuda, packed):
    """Gradients of all five inputs through the Functions (B3: the flash
    recompute, one flash backward launch; B4: the analytic backward over
    the saved qkv) against autograd through the plain versions."""
    B, N, C, H = (6, 17, 384, 6) if packed else (2, 197, 384, 6)
    leaves = [t.requires_grad_(True)
              for t in _ab_inputs(B, N, C, cuda, seed=3)]
    dout = torch.randn((B, N, C), device=cuda, dtype=torch.bfloat16)
    fn = ab.attention_block_packed if packed else ab.attention_block

    def ref_fn(*a, num_heads):
        if packed:
            return ab.attention_block_packed_reference(
                *a, num_heads=num_heads)[0]
        return ab.attention_block_reference(*a, num_heads=num_heads)

    bwd = fa.flash_attention_bwd.launches
    got = torch.autograd.grad(fn(*leaves, num_heads=H), leaves, dout)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == bwd + (0 if packed else 1)
    want = torch.autograd.grad(ref_fn(*leaves, num_heads=H), leaves, dout)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _rel_err(g, w) <= 5e-2


@pytest.mark.parametrize("shape", [(2, 100, 768, 12), (2, 65, 1024, 16),
                                   (2, 65, 64, 1),
                                   (2, 70, 448, 7), (2, 40, 768, 24)],
                         ids=str)
def test_attention_block_wide_plans_match_plain(cuda, shape):
    """The projection's wider plans: one pass of 384 columns a warpgroup
    (C = 768), two of 256 (C = 1024); one head (the second warpgroup
    idles through the attention and projects no column), an odd head
    count (it idles on the last head), head dim 32."""
    B, N, C, H = shape
    args = _ab_inputs(B, N, C, cuda, seed=C)
    got = ab.attention_block(*args, num_heads=H)
    torch.cuda.synchronize()
    ref = ab.attention_block_reference(*args, num_heads=H)
    assert got.shape == (B, N, C) and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= AB_RTOL


def test_attention_block_refuses_what_it_does_not_take(cuda):
    x, wq, bq, wp, bp = _ab_inputs(2, 17, 384, cuda)
    with pytest.raises(TypeError):
        ab.attention_block(x.float(), wq, bq, wp, bp, num_heads=6)
    with pytest.raises(TypeError):
        ab.attention_block(x.transpose(0, 1), wq, bq, wp, bp, num_heads=6)
    with pytest.raises(ValueError, match="fits"):
        ab.attention_block(x, wq, bq, wp, bp, num_heads=8)      # head dim 48
    with pytest.raises(ValueError, match="w_qkv"):
        ab.attention_block(x, wq.float(), bq, wp, bp, num_heads=6)
    with pytest.raises(ValueError, match="b_proj"):
        ab.attention_block(x, wq, bq, wp, bp[:64], num_heads=6)
    odd = torch.empty(2 * 17 * 384 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ab.attention_block(odd[1:].view(2, 17, 384), wq, bq, wp, bp,
                           num_heads=6)
    long = torch.zeros((1, 49, 384), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fits_packed"):
        ab.attention_block_packed(long, wq, bq, wp, bp, num_heads=6)


def test_dino_shaped_vit_step_with_b3_on_cuda_matches_cpu(cuda, monkeypatch):
    """One bf16 fine-tune step (loss and gradients, no optimizer step) of a
    depth-2 ViT with dino_vits16's widths (C 384, 6 heads of 64) at 64 px
    and B3 forced on: every block through the kernel on the card, through
    the plain version on the CPU."""
    from vit_torch_tpu_torch.models.layers import ClassifierHead, init_weights
    from vit_torch_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from vit_torch_tpu_torch.models.zoo import Classifier
    from vit_torch_tpu_torch.train.steps import cross_entropy_loss
    monkeypatch.setenv("VITX_FUSED_ATTN", "1")
    cfg = ViTConfig(patch_size=16, embed_dim=384, depth=2, num_heads=6)
    model = Classifier(VisionTransformer(cfg, image_size=64),
                       ClassifierHead(384, [10]))
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    labels, mask = torch.arange(4), torch.ones(4)
    results = []
    for dev in ("cpu", cuda):
        m = model.to(dev).train()
        m.zero_grad(set_to_none=True)
        before = (ab.attention_block.launches,
                  ab.attention_block_reference.calls)
        loss = cross_entropy_loss(m(x.to(dev)), labels.to(dev),
                                  mask.to(dev))
        loss.backward()
        launched = (ab.attention_block.launches - before[0],
                    ab.attention_block_reference.calls - before[1])
        assert launched == ((0, 2) if dev == "cpu" else (2, 0))
        # copies: moving the model to the card moves its gradients too
        results.append((loss.item(), {n: p.grad.float().cpu().clone()
                                      for n, p in m.named_parameters()}))
    (loss_c, grads_c), (loss_g, grads_g) = results
    assert abs(loss_c - loss_g) <= 2e-2
    for n, g in grads_c.items():
        err = ((grads_g[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
        assert err <= 5e-2, (n, err)


# --------------------------------------------------------------------------
# the fused MLP (B12) and the flat window block (B7)

# (T, C, hidden, out): DeiT-base (shrunk T; 64-row blocks, 384 columns a
# warpgroup), CaiT's C = 384, Swin stage 1 (C = 128, the smallest C), a
# ragged T with out != C (a masked slab), a ragged T at C = 192 (three
# k-steps), Swin stage 4 bs32 (C = 1024: two slabs, the one shape that
# recomputes fc1) and T < 64 (one partly empty row tile)
MLP_SHAPES = [(198, 768, 3072, 768), (131, 384, 1536, 384),
              (300, 128, 512, 128), (77, 256, 1024, 520),
              (5, 192, 768, 192), (4608, 1024, 4096, 1024),
              (40, 384, 1536, 384)]


def _mlp_inputs(T, C, Hd, Co, device, seed=0, bias=True):
    """bf16 tokens of std 1, weights in nn.Linear layout of std
    1/sqrt(fan in), biases of std 0.1 (or None)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    return (rnd(T, C), rnd(Hd, C, scale=C ** -0.5),
            rnd(Hd, scale=0.1) if bias else None,
            rnd(Co, Hd, scale=Hd ** -0.5),
            rnd(Co, scale=0.1) if bias else None)


@pytest.mark.parametrize("shape", MLP_SHAPES, ids=str)
def test_fused_mlp_kernel_matches_plain(cuda, shape):
    """One launch against the plain version (the rounding points of the
    Pallas kernel): max |kernel - plain| within BLOCK_RTOL of max |plain|
    (a one-ulp hidden value carried through fc2)."""
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    T, C, Hd, Co = shape
    args = _mlp_inputs(T, C, Hd, Co, cuda, seed=T, bias=Co != 520)
    before = (fm.fused_mlp.launches, fm.fused_mlp_reference.calls)
    got = fm.fused_mlp(*args)
    torch.cuda.synchronize()
    assert (fm.fused_mlp.launches, fm.fused_mlp_reference.calls) == (
        before[0] + 1, before[1])
    ref = fm.fused_mlp_reference(*args)
    assert got.shape == (T, Co) and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= BLOCK_RTOL


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("shape", [(300, 128, 512, 128), (5, 192, 768, 192),
                                   (77, 256, 1024, 256)], ids=str)
def test_fused_mlp_row_layouts_match_plain(cuda, shape, rows):
    """Each row layout of the kernel, forced through ``launch``, at the
    narrow widths where launch_plan chooses between them (ragged T),
    against the plain version within BLOCK_RTOL."""
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    T, C, Hd, Co = shape
    args = _mlp_inputs(T, C, Hd, Co, cuda, seed=T)
    got = fm.launch(*args, fm.launch_plan(T, C, Hd, Co, block_rows=rows))
    torch.cuda.synchronize()
    ref = fm.fused_mlp_reference(*args)
    assert got.shape == (T, Co) and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= BLOCK_RTOL


def test_fused_mlp_grads_match_plain(cuda):
    """All five gradients through the Function (the recompute of the XLA
    composition, cuBLAS) against autograd through the plain version; the
    forward is one kernel launch and the backward none."""
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    leaves = [t.requires_grad_(True)
              for t in _mlp_inputs(2 * 198, 768, 3072, 768, cuda, seed=3)]
    dout = torch.randn((2 * 198, 768), device=cuda, dtype=torch.bfloat16)
    before = fm.fused_mlp.launches
    got = torch.autograd.grad(fm.fused_mlp(*leaves), leaves, dout)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    want = torch.autograd.grad(fm.fused_mlp_reference(*leaves), leaves, dout)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _rel_err(g, w) <= 5e-2


def test_fused_mlp_refuses_what_it_does_not_take(cuda):
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    x, w1, b1, w2, b2 = _mlp_inputs(8, 128, 512, 128, cuda)
    with pytest.raises(TypeError):
        fm.fused_mlp(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w1"):
        fm.fused_mlp(x, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError, match="b2"):
        fm.fused_mlp(x, w1, b1, w2, b2[:64])
    with pytest.raises(ValueError, match="hidden"):
        fm.fused_mlp(x, w1[:96], b1[:96], w2[:, :96].contiguous(), b2)


@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_window_block_flat_matches_plain_with_grads(cuda, case):
    """B7 over the block case's windows, partitioned (and rolled) on the
    card: one chain launch (one core launch) against the plain version,
    and its gradients through the Function (one B6 launch) against
    autograd through the plain version."""
    d = _block_inputs(case, cuda)
    rolled = torch.roll(d["x"], (-d["shift"],) * 2, dims=(1, 2))
    wins = wb.window_partition(rolled, d["w"])
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (wins, *d["qkv"], d["bias"], *d["proj"])]
    x, wq, bq, bias, wp, bp = leaves
    args = (x, wq, bq, bias, d["mask"], wp, bp)
    counts = (wb.window_block.launches, wa.window_attention.launches,
              wa.window_attention_bwd.launches)
    with torch.no_grad():
        got = wb.window_block(*args, num_heads=d["heads"])
    dout = torch.randn_like(wins)
    grads = torch.autograd.grad(wb.window_block(*args, num_heads=d["heads"]),
                                leaves, dout)
    torch.cuda.synchronize()
    assert (wb.window_block.launches, wa.window_attention.launches,
            wa.window_attention_bwd.launches) == (
        counts[0] + 2, counts[1] + 2, counts[2] + 1)
    ref = wb.window_block_reference(*args, num_heads=d["heads"])
    assert got.shape == wins.shape and _rel_err(got, ref) <= BLOCK_RTOL
    want = torch.autograd.grad(
        wb.window_block_reference(*args, num_heads=d["heads"]), leaves, dout)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _rel_err(g, w) <= BLOCK_RTOL


def test_deit_step_with_b12_on_cuda_matches_cpu(cuda, monkeypatch):
    """One bf16 fine-tune step (loss and gradients, no optimizer step) of a
    depth-2 distilled DeiT with DeiT-base's widths (C 768, 12 heads,
    hidden 3072) at 64 px with ``VITX_FUSED_MLP=1``: every MLP through the
    kernel on the card, through the plain version on the CPU."""
    from vit_torch_tpu_torch.models.deit import DistilledVisionTransformer
    from vit_torch_tpu_torch.models.layers import ClassifierHead, init_weights
    from vit_torch_tpu_torch.models.vit import ViTConfig
    from vit_torch_tpu_torch.models.zoo import Classifier
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    from vit_torch_tpu_torch.train.steps import cross_entropy_loss
    monkeypatch.setenv("VITX_FUSED_MLP", "1")
    cfg = ViTConfig(patch_size=16, embed_dim=768, depth=2, num_heads=12)
    model = Classifier(DistilledVisionTransformer(cfg, image_size=64),
                       ClassifierHead(768, [10]))
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    labels, mask = torch.arange(4), torch.ones(4)
    results = []
    for dev in ("cpu", cuda):
        m = model.to(dev).train()
        m.zero_grad(set_to_none=True)
        before = (fm.fused_mlp.launches, fm.fused_mlp_reference.calls)
        loss = cross_entropy_loss(m(x.to(dev)), labels.to(dev),
                                  mask.to(dev))
        loss.backward()
        launched = (fm.fused_mlp.launches - before[0],
                    fm.fused_mlp_reference.calls - before[1])
        assert launched == ((0, 2) if dev == "cpu" else (2, 0))
        results.append((loss.item(), {n: p.grad.float().cpu().clone()
                                      for n, p in m.named_parameters()}))
    (loss_c, grads_c), (loss_g, grads_g) = results
    assert abs(loss_c - loss_g) <= 2e-2
    for n, g in grads_c.items():
        err = ((grads_g[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
        assert err <= 5e-2, (n, err)


# the conv families at full width: xcit_small_24_p16 (its MLPs through the
# cuBLAS chain, or B12 under VITX_FUSED_MLP=1) and resnext50_32x4d (eval
# with the conv+BN fold on and off), bf16 on the card against fp32 on the
# CPU; relative to max |CPU logit| (as chip_smoke's served logits)
CONV_CASES = [("xcit_small_24_p16", {"VITX_FUSED_MLP": "0"}),
              ("xcit_small_24_p16", {"VITX_FUSED_MLP": "1"}),
              ("resnext50_32x4d", {"VITX_FOLD_BN": "1"}),
              ("resnext50_32x4d", {"VITX_FOLD_BN": "0"})]
CONV_LOGITS_RTOL = 5e-2
# BN running statistics after one bf16 step on the card against one fp32
# step on the CPU: the batch statistics of bf16 activations, relative to
# max |CPU| of each tensor
CONV_STATS_RTOL = 5e-2


def _conv_model(arch):
    """A seeded fp32 classifier on the CPU with its BN statistics and
    scales drawn away from their init and XCiT's LayerScale gates raised
    from 1e-5 to 0.1, so that eval and train mode and every block count."""
    from vit_torch_tpu_torch.models.layers import BatchNorm
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    zm = VisionModelZoo.get_model(arch, classifier=[10], device="cpu",
                                  dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, mod in zm.model.named_modules():
            if isinstance(mod, BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                mod.weight.copy_(0.5 + torch.rand(n, generator=gen))
        for name, p in zm.model.named_parameters():
            if ".gamma" in name:
                p.fill_(0.1)
    return zm


@pytest.mark.parametrize("arch,env", CONV_CASES, ids=str)
def test_conv_family_on_cuda_matches_cpu_fp32(cuda, arch, env, monkeypatch):
    """Eval logits of one seeded full-width model in bf16 on the card and
    in fp32 on the CPU; under ``VITX_FUSED_MLP=1`` every XCiT MLP (24 XCA
    and 2 class-attention blocks) launches B12 on the card."""
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ref = _conv_model(arch)
    zm = VisionModelZoo.get_model(arch, classifier=[10], device=cuda)
    zm.model.load_state_dict(ref.model.state_dict())
    x = torch.randn((2, 224, 224, 3), generator=torch.Generator()
                    .manual_seed(2))
    before = fm.fused_mlp.launches
    with torch.inference_mode():
        got = zm.model.eval()(x.to(cuda)).float().cpu()
        want = ref.model.eval()(x)
    fused = env.get("VITX_FUSED_MLP") == "1"
    assert fm.fused_mlp.launches - before == (26 if fused else 0)
    assert torch.isfinite(got).all()
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= CONV_LOGITS_RTOL, err


@pytest.mark.parametrize("arch", ["xcit_small_24_p16", "resnext50_32x4d"])
def test_bn_running_stats_after_one_card_step(cuda, arch):
    """One bf16 fine-tune step on the card and one fp32 step on the CPU
    from the same weights and batch: every BN's running mean and variance
    (momentum 0.1, the unbiased variance) within CONV_STATS_RTOL of the
    CPU's, one batch tracked, a finite loss."""
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.train.optimizers import get_optimizer
    from vit_torch_tpu_torch.train.steps import make_train_step, split_params
    ref = _conv_model(arch)
    zm = VisionModelZoo.get_model(arch, classifier=[10], device=cuda)
    zm.model.load_state_dict(ref.model.state_dict())
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 224, 224, 3), generator=gen)
    labels, mask = torch.arange(4), torch.ones(4)
    stats = []
    for model, dev in ((ref.model, "cpu"), (zm.model, cuda)):
        model.train()
        step = make_train_step(model, get_optimizer(
            "adamw", split_params(model, False), 1e-4))
        m = step(x.to(dev), labels.to(dev), mask.to(dev))
        assert torch.isfinite(m["loss_sum"]).item()
        stats.append({k: v.float().cpu() for k, v in
                      model.state_dict().items()
                      if "running" in k or "num_batches" in k})
    want, got = stats
    assert len(want) == (3 * 53 if arch.startswith("resnext") else
                         3 * (4 + 24))
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert got[k].item() == w.item() == 1, k
            continue
        err = ((got[k] - w).abs().max() / w.abs().max()).item()
        assert err <= CONV_STATS_RTOL, (k, err)
