"""The port's CUDA kernels on the card: the flash-attention forward and
backward against their plain versions, their input checks and launch
counts, the classifier on CUDA against the same weights on the CPU, and a
bf16 train step that runs the backward kernel once per layer; the Swin
window-attention kernels (forward and backward) and window-block kernels
against their plain versions, with gradients, their refusals, a small Swin
on the card against the CPU, and a Swin fine-tune step that runs the
window-attention backward once per block; the CaiT talking-heads kernel
against its plain version through its three entry points, its refusals,
a small CaiT on the card against the CPU, and a CaiT fine-tune step that
launches the kernel once per talking-heads block.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They
import neither JAX nor the JAX package, so they run on a machine without
JAX (the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("shape", [(2, 3, 1, 64), (2, 3, 65, 64),
                                   (1, 2, 130, 32), (3, 2, 257, 64)])
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


@pytest.mark.parametrize("shape", [(2, 3, 1, 64), (2, 3, 65, 64),
                                   (1, 2, 130, 32), (3, 2, 257, 64)])
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
