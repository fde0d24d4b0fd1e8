"""Swin window blocks: hand-written CUDA kernels for Hopper and their
plain PyTorch versions, with gradients.

Counterpart of ``vit_torch_tpu/ops/window_block.py``:

- :func:`window_block` replaces the Pallas ``_fwd_kernel`` (ROADMAP B7):
  ``proj(attn(qkv(x)))`` over ``(Bn, N, C)`` windows already
  partitioned;
- :func:`window_block_spatial` replaces the Pallas ``_fwd_kernel_spatial``
  (ROADMAP B8): ``window_reverse(proj(attn(qkv(window_partition(y)))))``
  on the padded, already-rolled ``(B, Hp, Wp, C)`` map;
- :func:`window_block_full_spatial` replaces ``_fwd_kernel_spatial_full``
  (B9): a whole Swin block, LN1 → window attention → residual → LN2 →
  fc1 → exact GELU → fc2 → residual, on the unpadded, already-rolled map.

On CUDA each forward is a short chain of launches of two hand-written
sources: ``csrc/window_gemm.cu`` (the products, with the window
partition/reverse folded into their row addressing and the fused
epilogues, and the LayerNorm) and ``csrc/window_attention_fwd.cu`` (the
attention core, the kernel of :mod:`.window_attention`).  B7 and B8 are
qkv → core → proj (B7's products over plain rows); B9 is LN1 → qkv →
core → proj+residual → LN2 → fc1+GELU → fc2+residual.  The source notes
give the design and the bounds.  The TPU's window-chunk pickers,
head-split groups and VMEM budgets are tilings of the same functions and
have no counterpart here.

Rounding points follow the TPU kernels (``_block_compute`` and
``_fwd_kernel_spatial_full``): products accumulate in fp32; qkv and
B7's and B8's projections add their bias in fp32 and round once; each
head's attention output is rounded; B9's projection rounds, then adds
the residual in bf16; fc1 and fc2 round, then add their bias in bf16;
GELU runs in fp32; LayerNorm takes flax's fast-variance fp32 statistics,
eps 1e-5.

Weights come in ``nn.Linear`` layout ``(out, in)``, as the port's modules
hold them, in the activation dtype; LayerNorm weights stay fp32.

``shift`` (keyword, default 0): with ``shift = s > 0`` the map is taken
un-rolled and the function is ``roll(+s) ∘ f ∘ roll(-s)``, the shifted
Swin block's order; the kernels fold the roll into their addressing, the
plain versions roll.

Gradients, as the JAX package's custom VJPs (``_wb_bwd``, ``_wbs_bwd``,
``_wbsf_bwd``) take them: when an input requires grad, each entry point
goes through a ``torch.autograd.Function`` whose forward is the chain
above (the plain version on CPU tensors) and whose attention backward is
the window attention backward (B6, ``csrc/window_attention_bwd.cu``).
B7's and B8's keep the window-major qkv projection and attention output
of their forward and compute the products' gradients with
``torch.matmul`` (the JAX backward leaves them to XLA dots too).  B9's
recomputes the composition of ``_wbsf_bwd`` (LN1 → qkv → core → proj →
residual → LN2 → fc1 → GELU → fc2 → residual) under autograd, its core
through :func:`.window_attention_qkv` (B5 once more, then B6).  The mask
gets no gradient.

Dispatch is by the tensors' device, as in :mod:`.window_attention`: CPU
tensors run the plain versions (differentiable through autograd, their
attention through :func:`.window_attention_qkv`, so the plain B6 backward
runs there too); CUDA tensors launch the kernels or raise.
``window_block.launches``, ``window_block_spatial.launches`` and
``window_block_full_spatial.launches`` count kernel chains launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.gemm import (
    EPI_BIAS, EPI_BIAS16_RES, EPI_BIAS_RES, EPI_GELU, FLAT, check, dense_f32,
    gemm, linear, needs_grad, recompute_grads)
from vit_torch_tpu_torch.ops.window_attention import (
    HEAD_DIM, MAX_TOKENS, launch_window_attention, window_attention_bwd,
    window_attention_qkv, window_attention_reference)

LN_EPS = 1e-5

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]


# --------------------------------------------------------------------------
# the window layout (the order the mask rows and the kernels assume)
# --------------------------------------------------------------------------

def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, w·w, C), windows row-major per image."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int,
                   W: int) -> torch.Tensor:
    """(B·nW, w·w, C) → (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // w // w)
    x = windows.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _layer_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """flax's LayerNorm arithmetic on fp32 rows (``_ln_rows_f32``):
    fast-variance statistics, ``(x - mu) * (rsqrt(var + eps) * w) + b``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return (x32 - mu) * mul + bias.float()


def _plain_core(qkv: torch.Tensor, bias, mask, scale) -> torch.Tensor:
    """The plain versions' attention over a (Bn, N, 3, H, D) qkv: on the
    CPU the differentiable entry (the plain forward, and the plain B6
    backward under autograd); on the card the plain forward itself, which
    autograd differentiates, so that no kernel runs inside a plain
    version."""
    if qkv.device.type == "cpu":
        return window_attention_qkv(qkv, bias, mask, scale=scale)
    return window_attention_reference(*qkv.unbind(2), bias, mask,
                                      scale=scale)


def _attention_core_reference(t, w_qkv, b_qkv, bias, mask, w_proj, b_proj,
                              num_heads, scale):
    """``_block_compute`` over (Bn, N, C) windows: the fp32 (Bn, N, C) out,
    the (Bn, N, 3, H, D) qkv projection and the (Bn, N, C) attention
    output."""
    Bn, N, C = t.shape
    dt = t.dtype
    qkv = dense_f32(t, w_qkv, b_qkv).to(dt).view(Bn, N, 3, num_heads, -1)
    o = _plain_core(qkv, bias, mask, scale).reshape(Bn, N, C)
    return dense_f32(o, w_proj, b_proj), qkv, o


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` rolled by ``shift`` along both map axes."""
    return torch.roll(x, (shift, shift), dims=(1, 2)) if shift else x


def _rolled(fn, y: torch.Tensor, shift: int) -> torch.Tensor:
    return _roll(fn(_roll(y, -shift)), shift)


def _spatial_reference_parts(y, w_qkv, b_qkv, bias, mask, w_proj, b_proj,
                             num_heads, window, scale, shift):
    """The plain B8: (out map, window-major qkv, attention output)."""
    _, Hp, Wp, _ = y.shape
    out, qkv, o = _attention_core_reference(
        window_partition(_roll(y, -shift), window), w_qkv, b_qkv, bias, mask,
        w_proj, b_proj, num_heads, scale)
    return _roll(window_reverse(out.to(y.dtype), window, Hp, Wp), shift), \
        qkv, o


def window_block_spatial_reference(
        y: torch.Tensor, w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor],
        bias: torch.Tensor, mask: Optional[torch.Tensor],
        w_proj: torch.Tensor, b_proj: Optional[torch.Tensor], *,
        num_heads: int, window: int, scale: Optional[float] = None,
        shift: int = 0) -> torch.Tensor:
    """Plain version of :func:`window_block_spatial` (B8)."""
    if scale is None:
        scale = (y.shape[-1] // num_heads) ** -0.5
    return _spatial_reference_parts(y, w_qkv, b_qkv, bias, mask, w_proj,
                                    b_proj, num_heads, window, scale,
                                    shift)[0]


def window_block_full_spatial_reference(
        x: torch.Tensor, ln1: Pair, qkv: Pair, bias: torch.Tensor,
        mask: Optional[torch.Tensor], proj: Pair, ln2: Pair, fc1: Pair,
        fc2: Pair, *, num_heads: int, window: int,
        scale: Optional[float] = None, shift: int = 0) -> torch.Tensor:
    """Plain version of :func:`window_block_full_spatial` (B9)."""
    C = x.shape[-1]
    if scale is None:
        scale = (C // num_heads) ** -0.5

    def f(x):
        _, H, W, _ = x.shape
        dt = x.dtype
        t = _layer_norm_f32(x, *ln1).to(dt)
        a, _, _ = _attention_core_reference(window_partition(t, window),
                                            *qkv, bias, mask, *proj,
                                            num_heads, scale)
        h = x + window_reverse(a.to(dt), window, H, W)
        u = _layer_norm_f32(h, *ln2).to(dt)
        hid = dense_f32(u, fc1[0], None).to(dt)
        if fc1[1] is not None:
            hid = hid + fc1[1].to(dt)
        g = F.gelu(hid.float()).to(dt)
        m = dense_f32(g, fc2[0], None).to(dt)
        if fc2[1] is not None:
            m = m + fc2[1].to(dt)
        return h + m

    return _rolled(f, x, shift)


# --------------------------------------------------------------------------
# the CUDA chains
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer_norm_fn():
    """window_gemm.cu's LayerNorm entry point."""
    fn = _build.load("window_gemm").window_layer_norm_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _layer_norm(x: torch.Tensor, ln: Pair) -> torch.Tensor:
    """window_gemm.cu's LayerNorm over the rows of a contiguous map."""
    out = torch.empty_like(x)
    C = x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(_layer_norm_fn()(x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
                           out.data_ptr(), x.numel() // C, C, LN_EPS,
                           stream), "window_layer_norm")
    return out


def _check_inputs(x: torch.Tensor, window: Optional[int], num_heads: int,
                  weights: Sequence[Tuple[str, Optional[torch.Tensor],
                                          Tuple[int, ...]]],
                  lns: Sequence[Tuple[str, Pair]] = ()) -> None:
    """What the CUDA chains take: a contiguous bf16 (B, H, W, C) map with
    H and W multiples of the window (or, for ``window=None``, (Bn, N, C)
    windows), head dim 32, N = w^2 <= 144, bf16 contiguous weights and
    biases of the named shapes (16-byte aligned: the kernels read them 16
    and 4 bytes at a time), fp32 LN weights."""
    if (x.dim() != (3 if window is None else 4)
            or x.dtype != torch.bfloat16 or not x.is_contiguous()):
        raise TypeError(f"the CUDA kernels take a contiguous bfloat16 "
                        f"(B, H, W, C) map or (Bn, N, C) windows, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("the map must be 16-byte aligned")
    C = x.shape[-1]
    if window is None:
        if x.shape[1] > MAX_TOKENS:
            raise ValueError(f"windows of {x.shape[1]} tokens exceed "
                             f"{MAX_TOKENS}")
    elif (window < 1 or x.shape[1] % window or x.shape[2] % window
          or window * window > MAX_TOKENS):
        raise ValueError(f"map {x.shape[1]}x{x.shape[2]} is not tiled by "
                         f"window {window} (or the window exceeds "
                         f"{MAX_TOKENS} tokens)")
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise ValueError(f"C = {C} with {num_heads} heads: the kernels take "
                         f"head dim {HEAD_DIM}")
    for name, t, shape in weights:
        if t is None:
            continue
        if (t.shape != shape or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bfloat16 {shape} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, (wt, bt) in lns:
        for t in (wt, bt):
            if (t.shape != (C,) or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != x.device):
                raise ValueError(f"{name} must be contiguous float32 ({C},) "
                                 f"tensors on {x.device}")


def _attention_chain(src: torch.Tensor, w_qkv, b_qkv, bias, mask, geom,
                     num_heads: int, scale: float):
    """qkv product → attention core over the windows of ``src``: a map whose
    rows the product gathers window-major (``geom`` its geometry), or
    (Bn, N, C) windows already partitioned (``geom=None``).  Returns the
    (Bn, N, 3, H, D) window-major qkv projection and the (Bn, N, C)
    attention output."""
    C = src.shape[-1]
    if geom is None:
        Bn, N = src.shape[:2]
    else:
        B, H, W, _ = src.shape
        window = geom[2]
        N = window * window
        Bn = B * (H // window) * (W // window)
    qkv = torch.empty((Bn, N, 3, num_heads, HEAD_DIM), dtype=src.dtype,
                      device=src.device)
    gemm(src, w_qkv, b_qkv, qkv, epilogue=EPI_BIAS, geom=geom or FLAT,
         gather=geom is not None)
    attn = torch.empty((Bn, N, C), dtype=src.dtype, device=src.device)
    launch_window_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], bias,
                            mask, attn.view(Bn, N, num_heads, HEAD_DIM),
                            scale)
    return qkv, attn


def _spatial_parts(y, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads,
                   window, scale, shift):
    """B8 without autograd: (out map, window-major qkv, attention output),
    from the plain version on CPU tensors and the kernel chain on CUDA
    tensors."""
    if y.device.type == "cpu":
        return _spatial_reference_parts(y, w_qkv, b_qkv, bias, mask, w_proj,
                                        b_proj, num_heads, window, scale,
                                        shift)
    if y.device.type != "cuda":
        raise ValueError(f"no window block for device {y.device}")
    C = y.shape[-1]
    _check_inputs(y, window, num_heads, [
        ("w_qkv", w_qkv, (3 * C, C)), ("b_qkv", b_qkv, (3 * C,)),
        ("w_proj", w_proj, (C, C)), ("b_proj", b_proj, (C,))])
    B, Hp, Wp, _ = y.shape
    geom = (Hp, Wp, window, shift)
    qkv, attn = _attention_chain(y, w_qkv, b_qkv, bias, mask, geom,
                                 num_heads, scale)
    out = torch.empty_like(y)
    gemm(attn, w_proj, b_proj, out, epilogue=EPI_BIAS, geom=geom,
         scatter=True)
    window_block_spatial.launches += 1
    return out, qkv, attn


@functools.lru_cache(maxsize=64)
def _window_order(Hp: int, Wp: int, window: int, shift: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, inverse): the map position (within an image) of each
    window-major row of the rolled map, the order the kernels' gathered and
    scattered rows take, and its inverse permutation."""
    pos = torch.arange(Hp * Wp).view(1, Hp, Wp, 1)
    order = window_partition(_roll(pos, -shift), window).reshape(-1)
    return order.to(device), torch.argsort(order).to(device)


def _block_grads(x_rows, do, qkv, attn, w_qkv, w_proj, bias, mask, scale,
                 need):
    """The gradients of qkv product → core → proj product over window-major
    rows, as ``_wb_bwd`` and ``_wbs_bwd`` take them: ``x_rows`` (T, C) the
    block's input rows (None when w_qkv needs no gradient), ``do`` (T, C)
    the output gradient in the same order, ``qkv`` and ``attn`` the
    forward's.  The proj product's gradients, the attention backward (B6)
    into one dqkv, the qkv product's gradients; ``need`` is the Function's
    ``needs_input_grad`` over (x, w_qkv, b_qkv, bias, mask, w_proj,
    b_proj).  Returns those seven gradients, x's as (T, C) rows."""
    C = do.shape[-1]
    dw_proj = do.t() @ attn.reshape(-1, C) if need[5] else None
    db_proj = do.sum(dim=0) if need[6] else None
    dqkv = torch.empty_like(qkv)
    _, _, _, dbias = window_attention_bwd(
        *qkv.unbind(2), bias, mask,
        (do @ w_proj).view(attn.shape[0], -1, *qkv.shape[3:]), scale=scale,
        **dict(zip(("dq", "dk", "dv"), dqkv.unbind(2))))
    dqkv = dqkv.view(-1, 3 * C)
    return (dqkv @ w_qkv if need[0] else None,
            dqkv.t() @ x_rows if need[1] else None,
            dqkv.sum(dim=0) if need[2] else None,
            dbias if need[3] else None, None, dw_proj, db_proj)


class _WindowBlockSpatial(torch.autograd.Function):
    """B8 with gradients (``_wbs_fwd`` / ``_wbs_bwd``).  The forward keeps
    the window-major qkv projection and attention output; the backward
    gathers the output gradient into window-major rows (one gather: the
    roll and the partition), runs :func:`_block_grads` and gathers dy back
    into map order."""

    @staticmethod
    def forward(ctx, y, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads,
                window, scale, shift):
        out, qkv, attn = _spatial_parts(y, w_qkv, b_qkv, bias, mask, w_proj,
                                        b_proj, num_heads, window, scale,
                                        shift)
        ctx.save_for_backward(y, w_qkv, bias, mask, w_proj, qkv, attn)
        ctx.geom = (window, scale, shift)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, w_qkv, bias, mask, w_proj, qkv, attn = ctx.saved_tensors
        window, scale, shift = ctx.geom
        need = ctx.needs_input_grad
        B, Hp, Wp, C = y.shape
        order, inverse = _window_order(Hp, Wp, window, shift, y.device)

        def rows(m):                          # map → (T, C) window-major
            return m.reshape(B, Hp * Wp, C)[:, order].view(-1, C)

        dx, *grads = _block_grads(rows(y) if need[1] else None, rows(dout),
                                  qkv, attn, w_qkv, w_proj, bias, mask,
                                  scale, need)
        dy = None if dx is None else \
            dx.view(B, Hp * Wp, C)[:, inverse].view(B, Hp, Wp, C)
        return (dy, *grads, None, None, None, None)


def window_block_spatial(y: torch.Tensor, w_qkv: torch.Tensor,
                         b_qkv: Optional[torch.Tensor], bias: torch.Tensor,
                         mask: Optional[torch.Tensor], w_proj: torch.Tensor,
                         b_proj: Optional[torch.Tensor], *, num_heads: int,
                         window: int, scale: Optional[float] = None,
                         shift: int = 0) -> torch.Tensor:
    """Window attention block (qkv → attention → proj) over the padded
    spatial map ``(B, Hp, Wp, C)`` (B8); ``(B, Hp, Wp, C)`` out.
    Differentiable in every input but the mask.

    ``bias`` (H, N, N) and ``mask`` (nW, N, N) as :func:`.window_attention`
    takes them; ``w_qkv`` (3C, C), ``w_proj`` (C, C)."""
    if scale is None:
        scale = (y.shape[-1] // num_heads) ** -0.5
    args = (y, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads, window,
            float(scale), shift)
    if needs_grad(y, w_qkv, b_qkv, bias, w_proj, b_proj):
        return _WindowBlockSpatial.apply(*args)
    return _spatial_parts(*args)[0]


window_block_spatial.launches = 0


# --------------------------------------------------------------------------
# B7: the block over windows already partitioned
# --------------------------------------------------------------------------

def window_block_reference(x: torch.Tensor, w_qkv: torch.Tensor,
                           b_qkv: Optional[torch.Tensor], bias: torch.Tensor,
                           mask: Optional[torch.Tensor], w_proj: torch.Tensor,
                           b_proj: Optional[torch.Tensor], *, num_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`window_block` (B7)."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    return _attention_core_reference(x, w_qkv, b_qkv, bias, mask, w_proj,
                                     b_proj, num_heads, scale)[0].to(x.dtype)


def _flat_parts(x, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads,
                scale):
    """B7 without autograd: (out, qkv projection, attention output), from
    the plain version on CPU tensors and the kernel chain on CUDA
    tensors: the qkv product over plain rows, the core, the proj
    product."""
    if x.device.type == "cpu":
        out, qkv, attn = _attention_core_reference(
            x, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads, scale)
        return out.to(x.dtype), qkv, attn
    if x.device.type != "cuda":
        raise ValueError(f"no window block for device {x.device}")
    C = x.shape[-1]
    _check_inputs(x, None, num_heads, [
        ("w_qkv", w_qkv, (3 * C, C)), ("b_qkv", b_qkv, (3 * C,)),
        ("w_proj", w_proj, (C, C)), ("b_proj", b_proj, (C,))])
    qkv, attn = _attention_chain(x, w_qkv, b_qkv, bias, mask, None,
                                 num_heads, scale)
    out = torch.empty_like(x)
    gemm(attn, w_proj, b_proj, out, epilogue=EPI_BIAS, geom=FLAT)
    window_block.launches += 1
    return out, qkv, attn


class _WindowBlock(torch.autograd.Function):
    """B7 with gradients (``_wb_fwd`` / ``_wb_bwd``): the forward keeps the
    qkv projection and the attention output; the backward is
    :func:`_block_grads` over the windows' rows."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads,
                scale):
        out, qkv, attn = _flat_parts(x, w_qkv, b_qkv, bias, mask, w_proj,
                                     b_proj, num_heads, scale)
        ctx.save_for_backward(x, w_qkv, bias, mask, w_proj, qkv, attn)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w_qkv, bias, mask, w_proj, qkv, attn = ctx.saved_tensors
        need = ctx.needs_input_grad
        C = x.shape[-1]
        dx, *grads = _block_grads(x.reshape(-1, C) if need[1] else None,
                                  dout.reshape(-1, C), qkv, attn, w_qkv,
                                  w_proj, bias, mask, ctx.scale, need)
        return (None if dx is None else dx.view(x.shape), *grads, None,
                None)


def window_block(x: torch.Tensor, w_qkv: torch.Tensor,
                 b_qkv: Optional[torch.Tensor], bias: torch.Tensor,
                 mask: Optional[torch.Tensor], w_proj: torch.Tensor,
                 b_proj: Optional[torch.Tensor], *, num_heads: int,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Window attention block (qkv → attention → proj) over ``(Bn, N, C)``
    windows already partitioned (B7); ``(Bn, N, C)`` out.  Differentiable
    in every input but the mask.

    ``bias`` (H, N, N) and ``mask`` (nW, N, N), window ``i`` taking mask
    row ``i mod nW``, as :func:`.window_attention` takes them; ``w_qkv``
    (3C, C), ``w_proj`` (C, C).  Any N up to 144 runs as it is (the JAX
    wrapper pads N = 49 to 64 for the TPU's layout, with the padded keys
    masked: the same function)."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    args = (x, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads,
            float(scale))
    if needs_grad(x, w_qkv, b_qkv, bias, w_proj, b_proj):
        return _WindowBlock.apply(*args)
    return _flat_parts(*args)[0]


window_block.launches = 0


def _full_spatial_graph(x, ln1w, ln1b, w_qkv, b_qkv, bias, mask, w_proj,
                        b_proj, ln2w, ln2b, w1, b1, w2, b2, num_heads,
                        window, scale, shift):
    """The composition ``_wbsf_bwd`` differentiates: LN1 → partition → qkv
    → core → proj → reverse → residual → LN2 → fc1 → +b1 → GELU in fp32 →
    fc2 → +b2 → residual, its core through :func:`.window_attention_qkv`."""

    def f(x):
        B, H, W, C = x.shape
        dt = x.dtype
        t = window_partition(_layer_norm_f32(x, ln1w, ln1b).to(dt), window)
        Bn, N, _ = t.shape
        qkv = linear(t, w_qkv, b_qkv).view(Bn, N, 3, num_heads, -1)
        o = window_attention_qkv(qkv, bias, mask, scale=scale)
        a = linear(o.reshape(Bn, N, C), w_proj, b_proj)
        h = x + window_reverse(a, window, H, W)
        u = _layer_norm_f32(h, ln2w, ln2b).to(dt)
        g = F.gelu(linear(u, w1, b1).float()).to(dt)
        return h + linear(g, w2, b2)

    return _rolled(f, x, shift)


def _full_spatial_forward(x, ln1w, ln1b, w_qkv, b_qkv, bias, mask, w_proj,
                          b_proj, ln2w, ln2b, w1, b1, w2, b2, num_heads,
                          window, scale, shift):
    """B9 without autograd: the plain version on CPU tensors, the kernel
    chain on CUDA tensors."""
    ln1, qkv, proj = (ln1w, ln1b), (w_qkv, b_qkv), (w_proj, b_proj)
    ln2, fc1, fc2 = (ln2w, ln2b), (w1, b1), (w2, b2)
    if x.device.type == "cpu":
        return window_block_full_spatial_reference(
            x, ln1, qkv, bias, mask, proj, ln2, fc1, fc2,
            num_heads=num_heads, window=window, scale=scale, shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"no window block for device {x.device}")
    C = x.shape[-1]
    hidden = w1.shape[0]
    _check_inputs(x, window, num_heads, [
        ("qkv weight", w_qkv, (3 * C, C)), ("qkv bias", b_qkv, (3 * C,)),
        ("proj weight", w_proj, (C, C)), ("proj bias", b_proj, (C,)),
        ("fc1 weight", w1, (hidden, C)), ("fc1 bias", b1, (hidden,)),
        ("fc2 weight", w2, (C, hidden)), ("fc2 bias", b2, (C,))],
        lns=[("ln1", ln1), ("ln2", ln2)])
    if hidden % 32:
        raise ValueError(f"MLP width {hidden} is not a multiple of 32")
    B, H, W, _ = x.shape
    geom = (H, W, window, shift)
    _, attn = _attention_chain(_layer_norm(x, ln1), *qkv, bias, mask, geom,
                               num_heads, scale)
    h = torch.empty_like(x)
    gemm(attn, *proj, h, epilogue=EPI_BIAS_RES, geom=geom, scatter=True,
         res=x)
    hid = torch.empty((B, H, W, hidden), dtype=x.dtype, device=x.device)
    gemm(_layer_norm(h, ln2), *fc1, hid, epilogue=EPI_GELU, geom=geom)
    out = torch.empty_like(x)
    gemm(hid, *fc2, out, epilogue=EPI_BIAS16_RES, geom=geom, res=h)
    window_block_full_spatial.launches += 1
    return out


_FULL_TENSORS = 15        # x, ln1 (2), qkv (2), bias, mask, proj (2), ...


class _WindowBlockFullSpatial(torch.autograd.Function):
    """B9 with gradients (``_wbsf_fwd`` / ``_wbsf_bwd``): the forward is
    the chain; the backward recomputes :func:`_full_spatial_graph` under
    autograd and differentiates it."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args[:_FULL_TENSORS])
        ctx.meta = args[_FULL_TENSORS:]
        return _full_spatial_forward(*args)

    @staticmethod
    def backward(ctx, dout):
        return recompute_grads(ctx, _full_spatial_graph, dout, *ctx.meta)


def window_block_full_spatial(x: torch.Tensor, ln1: Pair, qkv: Pair,
                              bias: torch.Tensor,
                              mask: Optional[torch.Tensor], proj: Pair,
                              ln2: Pair, fc1: Pair, fc2: Pair, *,
                              num_heads: int, window: int,
                              scale: Optional[float] = None,
                              shift: int = 0) -> torch.Tensor:
    """A whole Swin block (LN1 → W-MSA → +residual → LN2 → MLP →
    +residual) over the unpadded spatial map ``(B, H, W, C)`` (B9).
    Differentiable in every input but the mask.

    ``ln1``/``ln2`` are (weight, bias) pairs, fp32; ``qkv``, ``proj``,
    ``fc1``, ``fc2`` are (weight, bias) pairs in ``nn.Linear`` layout.
    DropPath and dropout are the caller's business: the residuals are
    inside."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    tensors = (x, *ln1, *qkv, bias, mask, *proj, *ln2, *fc1, *fc2)
    meta = (num_heads, window, float(scale), shift)
    if needs_grad(*tensors):
        return _WindowBlockFullSpatial.apply(*tensors, *meta)
    return _full_spatial_forward(*tensors, *meta)


window_block_full_spatial.launches = 0


def block_flops(tokens: int, C: int, N: int, full: bool,
                mlp_ratio: float = 4.0) -> int:
    """Operations of one block over ``tokens`` tokens: the qkv and proj
    products, QK^T and PV over N-token windows, and (``full``) the MLP."""
    flops = 2 * tokens * 4 * C * C + 4 * tokens * N * C
    if full:
        flops += 2 * tokens * 2 * C * int(C * mlp_ratio)
    return flops
