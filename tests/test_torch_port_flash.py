"""Port parity: ``vit_torch_tpu_torch.ops.flash_attention`` (plain version,
which the wrapper runs for CPU tensors) against the JAX package's Pallas
flash kernel in interpret mode, and the port's attention dispatcher against
the JAX ``_xla_attention``.  Inputs are made with numpy from a seed; fp32
on both sides, so the tolerance only covers summation order.  Also the
forward kernel's launch plan at the shapes the card checks, the shapes
both plans refuse, and the dispatch of a tensor on the card to the
forward's and the backward's launchers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from vit_torch_tpu.ops.attention import _xla_attention
from vit_torch_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_bhnd as jax_flash_attention_bhnd)
from vit_torch_tpu_torch.ops import flash_attention as fa
from vit_torch_tpu_torch.ops.attention import dot_product_attention
from vit_torch_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bhnd, flash_attention_bhnd_reference)
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

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


# (B, H, N, D): chip_smoke's ATTN_SHAPES (dino_vitb8 @224 bs32, DeiT-base
# and dino_vits16 @224, small ragged ones) and the headline at D = 32
PLAN_SHAPES = [(32, 12, 785, 64), (8, 12, 197, 64), (2, 2, 65, 32),
               (1, 1, 1, 64), (32, 12, 197, 64), (64, 6, 197, 64),
               (32, 12, 785, 32), (128, 12, 17, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_forward_launch_plan(shape):
    """Items of 128 query rows, one persistent block per SM or per item
    where there are fewer, 64-key tiles, as many ring stages as key tiles
    up to 8, shared memory inside the SM's 227 KB; the products cover
    ceil(N / 64) * 64 keys."""
    B, H, N, D = shape
    plan = fa.launch_plan(B, H, N, D)
    assert (plan.block_q, plan.block_k, plan.dq_rows) == (128, 64, 0)
    assert plan.grid == (min(132, -(-N // 128) * B * H), 1)
    assert plan.stages == min(8, -(-N // 64))
    tile = 64 * D * 2
    assert plan.smem_bytes == 1024 + (4 + 2 * plan.stages) * tile + 160
    assert plan.smem_bytes <= 232448
    assert fa.launch_plan(B, H, N, D, sms=1).grid == (1, 1)


def test_forward_launch_plan_at_the_headline():
    assert fa.launch_plan(32, 12, 785, 64) == fa.Plan(
        128, 64, 8, (132, 1), 165024, 0)


@pytest.mark.parametrize("shape,backward,match", [
    ((2, 2, 65, 48), False, "head dim"), ((2, 2, 65, 128), True, "head dim"),
    ((2, 2, 0, 64), False, "no flash"), ((0, 2, 16, 64), True, "no flash"),
    ((65536, 1, 16, 64), True, "exceeds 65535"),
    ((2 ** 24, 128, 16, 64), False, "items")])
def test_launch_plan_refuses_what_the_kernels_do_not_take(shape, backward,
                                                          match):
    """The backward's grid holds B * H in y; the forward's persistent
    blocks number their items in an int, and take B * H = 65536."""
    with pytest.raises(ValueError, match=match):
        fa.launch_plan(*shape, backward=backward)
    assert fa.launch_plan(65536, 1, 16, 64).grid == (132, 1)


class _OnCard(torch.Tensor):
    """A meta tensor that says it lies on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _CardOnMeta(TorchFunctionMode):
    """Allocations asked for on the card become meta tensors that say they
    lie on the card, so that the wrappers' CUDA branch runs without a
    card."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cuda":
            kwargs["device"] = "meta"
        out = func(*args, **kwargs)
        if (isinstance(out, torch.Tensor) and out.is_meta
                and not isinstance(out, _OnCard)):
            out = out.as_subclass(_OnCard)
        return out


def _refuse(*args, **kwargs):
    raise AssertionError("a tensor on the card took the plain version")


def test_forward_on_the_card_calls_the_launcher(monkeypatch):
    """Both forward entries send a tensor on the card to the kernel's
    launcher, never to the plain version."""
    calls = []
    monkeypatch.setattr(fa, "_launch_fwd",
                        lambda *args: calls.append([a is None or a.device.type
                                                    for a in args[:5]]))
    monkeypatch.setattr(fa, "flash_attention_bhnd_reference", _refuse)
    with _CardOnMeta():
        q, k, v = (torch.empty((2, 3, 40, 64), dtype=torch.bfloat16,
                               device="cuda") for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
        fa.flash_attention_fwd(q, k, v)
        bnhd = fa.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)))
    assert calls == [["cuda"] * 5, ["cuda"] * 4 + [True],
                     ["cuda"] * 4 + [True]]
    assert out.device.type == "cuda" and out.shape == (2, 3, 40, 64)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 40)
    assert bnhd.shape == (2, 40, 3, 64) and bnhd.is_contiguous()


def test_backward_on_the_card_calls_the_launcher(monkeypatch):
    """The backward entry sends tensors on the card to the kernel's
    launcher with the gradients it allocated, or with the caller's views,
    never to the plain version."""
    calls = []
    monkeypatch.setattr(fa, "_launch_bwd",
                        lambda *args: calls.append(args))
    monkeypatch.setattr(fa, "flash_attention_bwd_reference", _refuse)
    with _CardOnMeta():
        q, k, v, o, do = (torch.empty((2, 3, 40, 32), dtype=torch.bfloat16,
                                      device="cuda") for _ in range(5))
        lse = torch.empty((2, 3, 40), dtype=torch.float32, device="cuda")
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=0.5)
        dqkv = torch.empty((2, 40, 3, 3, 32), dtype=torch.bfloat16,
                           device="cuda")
        views = [x.transpose(1, 2) for x in dqkv.unbind(2)]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, dq=views[0],
                                     dk=views[1], dv=views[2])
    assert len(calls) == 2
    first, second = calls
    assert all(x.device.type == "cuda" for x in first[:9])
    assert first[6:9] == (dq, dk, dv) and first[9] == 0.5
    assert dq.shape == dk.shape == dv.shape == (2, 3, 40, 32)
    assert second[6:9] == tuple(views) == got
    assert second[9] == 32 ** -0.5


# (B, H, Nq, Nk, D): DETR's cross-attention (100 queries over a 16 x 16
# memory), a ragged memory, Nq > Nk, one query
CROSS_SHAPES = [(2, 2, 100, 256, 32), (1, 2, 100, 391, 32),
                (2, 1, 300, 256, 32), (2, 3, 1, 70, 64)]


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=str)
def test_cross_attention_plain_versions_match_xla(shape):
    """q of Nq rows over k, v of Nk: the plain forward and backward (which
    the wrappers run on the CPU, and the card checks its kernels against)
    against the JAX package's ``_xla_attention`` and its ``jax.vjp``, the
    path the JAX DETR takes for its attentions."""
    import jax
    B, H, Nq, Nk, D = shape
    rng = np.random.default_rng(Nq + Nk)
    q, do = (rng.standard_normal((B, Nq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Nk, H, D)).astype(np.float32)
            for _ in range(2))
    want, vjp = jax.vjp(lambda q, k, v: _xla_attention(q, k, v,
                                                       scale=D ** -0.5),
                        *(jnp.asarray(x) for x in (q, k, v)))
    dwant = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    got = flash_attention_bhnd_reference(tq, tk, tv)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v))).numpy(),
        np.asarray(want), atol=ATOL, rtol=0)
    grads = fa.flash_attention_bwd(tq, tk, tv, got, None, tdo)
    for g, w, name in zip(grads, dwant, "qkv"):
        assert g.shape == tuple(w.shape[i] for i in (0, 2, 1, 3)), name
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape", CROSS_SHAPES + [(8, 8, 100, 100, 32),
                                                  (8, 8, 256, 256, 32)],
                         ids=str)
def test_launch_plans_with_a_key_length_of_their_own(shape):
    """The forward's items and grid count query rows, its stages key tiles;
    the backward's grid counts 128-key blocks and its stages and dQ rows
    64-query tiles; ``Nk`` None is self-attention."""
    B, H, Nq, Nk, D = shape
    fwd = fa.launch_plan(B, H, Nq, D, Nk=Nk)
    assert fwd.grid == (min(132, -(-Nq // 128) * B * H), 1)
    assert fwd.stages == min(8, -(-Nk // 64))
    assert fwd.smem_bytes == 1024 + (4 + 2 * fwd.stages) * 64 * D * 2 + 160
    bwd = fa.launch_plan(B, H, Nq, D, Nk=Nk, backward=True)
    assert bwd.grid == (-(-Nk // 128), B * H)
    assert bwd.stages == min(4, -(-Nq // 64))
    assert bwd.dq_rows == -(-Nq // 64) * 64
    assert fa.launch_plan(B, H, Nq, D) == fa.launch_plan(B, H, Nq, D, Nk=Nq)
    with pytest.raises(ValueError, match="no flash"):
        fa.launch_plan(B, H, Nq, D, Nk=0)


def test_cross_attention_on_the_card_calls_the_launchers(monkeypatch):
    """A tensor on the card with Nq != Nk reaches both launchers, the
    output and dq of q's shape, dk and dv of k's, the LSE over Nq."""
    calls = []
    monkeypatch.setattr(fa, "_launch_fwd",
                        lambda *args: calls.append(("fwd", args)))
    monkeypatch.setattr(fa, "_launch_bwd",
                        lambda *args: calls.append(("bwd", args)))
    monkeypatch.setattr(fa, "flash_attention_bhnd_reference", _refuse)
    monkeypatch.setattr(fa, "flash_attention_bwd_reference", _refuse)
    with _CardOnMeta():
        q = torch.empty((2, 3, 40, 32), dtype=torch.bfloat16, device="cuda")
        k, v = (torch.empty((2, 3, 70, 32), dtype=torch.bfloat16,
                            device="cuda") for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, out)
    assert [c[0] for c in calls] == ["fwd", "bwd"]
    assert out.shape == dq.shape == (2, 3, 40, 32)
    assert dk.shape == dv.shape == (2, 3, 70, 32)
    assert lse.shape == (2, 3, 40)
    assert calls[1][1][6:9] == (dq, dk, dv)
