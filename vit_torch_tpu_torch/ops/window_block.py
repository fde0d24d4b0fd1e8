"""Swin window blocks on the spatial map: hand-written CUDA kernels for
Hopper and their plain PyTorch versions.

Counterpart of ``vit_torch_tpu/ops/window_block.py``:

- :func:`window_block_spatial` replaces the Pallas ``_fwd_kernel_spatial``
  (ROADMAP B8): ``window_reverse(proj(attn(qkv(window_partition(y)))))``
  on the padded, already-rolled ``(B, Hp, Wp, C)`` map;
- :func:`window_block_full_spatial` replaces ``_fwd_kernel_spatial_full``
  (B9): a whole Swin block, LN1 → window attention → residual → LN2 →
  fc1 → exact GELU → fc2 → residual, on the unpadded, already-rolled map.

On CUDA each is a short chain of launches of two hand-written sources:
``csrc/window_gemm.cu`` (the products, with the window partition/reverse
folded into their row addressing and the fused epilogues, and the
LayerNorm) and ``csrc/window_attention_fwd.cu`` (the attention core, the
kernel of :mod:`.window_attention`).  B8 is qkv → core → proj; B9 is LN1
→ qkv → core → proj+residual → LN2 → fc1+GELU → fc2+residual.  The source notes give the
design and the bounds.  The TPU's window-chunk pickers, head-split groups
and VMEM budgets are tilings of the same functions and have no
counterpart here.

Rounding points follow the TPU kernels (``_block_compute`` and
``_fwd_kernel_spatial_full``): products accumulate in fp32; qkv and B8's
projection add their bias in fp32 and round once; each head's attention
output is rounded; B9's projection rounds, then adds the residual in
bf16; fc1 and fc2 round, then add their bias in bf16; GELU runs in fp32;
LayerNorm takes flax's fast-variance fp32 statistics, eps 1e-5.

Weights come in ``nn.Linear`` layout ``(out, in)``, as the port's modules
hold them, in the activation dtype; LayerNorm weights stay fp32.

``shift`` (keyword, default 0): with ``shift = s > 0`` the map is taken
un-rolled and the function is ``roll(+s) ∘ f ∘ roll(-s)``, the shifted
Swin block's order; the kernels fold the roll into their addressing, the
plain versions roll.

Dispatch is by the tensors' device, as in :mod:`.window_attention`: CPU
tensors run the plain versions (differentiable through autograd); CUDA
tensors launch the kernels or raise; a CUDA input that requires grad
raises (the backward is ROADMAP B6).  ``window_block_spatial.launches``
and ``window_block_full_spatial.launches`` count kernel chains launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.window_attention import (
    HEAD_DIM, MAX_TOKENS, launch_window_attention, refuse_grad,
    requires_grad_on_cuda, window_attention_reference)

LN_EPS = 1e-5
# window_gemm.cu epilogues
_EPI_BIAS, _EPI_BIAS_RES, _EPI_GELU, _EPI_BIAS16_RES = 0, 1, 2, 3

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

def _dense_f32(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32-accumulated ``x @ w.T (+ b)`` of values in their own dtypes."""
    y = torch.matmul(x.float(), w.float().t())
    return y if b is None else y + b.float()


def _layer_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """flax's LayerNorm arithmetic on fp32 rows (``_ln_rows_f32``):
    fast-variance statistics, ``(x - mu) * (rsqrt(var + eps) * w) + b``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return (x32 - mu) * mul + bias.float()


def _attention_core_reference(t, w_qkv, b_qkv, bias, mask, w_proj, b_proj,
                              num_heads, scale):
    """``_block_compute`` over (Bn, N, C) windows; fp32 (Bn, N, C) out."""
    Bn, N, C = t.shape
    dt = t.dtype
    qkv = _dense_f32(t, w_qkv, b_qkv).to(dt).view(Bn, N, 3, num_heads, -1)
    o = window_attention_reference(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   bias, mask, scale=scale)
    return _dense_f32(o.reshape(Bn, N, C), w_proj, b_proj)


def _rolled(fn, y: torch.Tensor, shift: int) -> torch.Tensor:
    if not shift:
        return fn(y)
    out = fn(torch.roll(y, (-shift, -shift), dims=(1, 2)))
    return torch.roll(out, (shift, shift), dims=(1, 2))


def window_block_spatial_reference(
        y: torch.Tensor, w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor],
        bias: torch.Tensor, mask: Optional[torch.Tensor],
        w_proj: torch.Tensor, b_proj: Optional[torch.Tensor], *,
        num_heads: int, window: int, scale: Optional[float] = None,
        shift: int = 0) -> torch.Tensor:
    """Plain version of :func:`window_block_spatial` (B8)."""
    C = y.shape[-1]
    if scale is None:
        scale = (C // num_heads) ** -0.5

    def f(y):
        _, Hp, Wp, _ = y.shape
        out = _attention_core_reference(
            window_partition(y, window), w_qkv, b_qkv, bias, mask, w_proj,
            b_proj, num_heads, scale).to(y.dtype)
        return window_reverse(out, window, Hp, Wp)

    return _rolled(f, y, shift)


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
        a = _attention_core_reference(window_partition(t, window), *qkv,
                                      bias, mask, *proj, num_heads, scale)
        h = x + window_reverse(a.to(dt), window, H, W)
        u = _layer_norm_f32(h, *ln2).to(dt)
        hid = _dense_f32(u, fc1[0], None).to(dt)
        if fc1[1] is not None:
            hid = hid + fc1[1].to(dt)
        g = F.gelu(hid.float()).to(dt)
        m = _dense_f32(g, fc2[0], None).to(dt)
        if fc2[1] is not None:
            m = m + fc2[1].to(dt)
        return h + m

    return _rolled(f, x, shift)


# --------------------------------------------------------------------------
# the CUDA chains
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gemm_fn():
    """window_gemm.cu's product entry point, built and loaded on first
    use."""
    fn = _build.load("window_gemm").window_gemm_bf16
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _layer_norm_fn():
    """window_gemm.cu's LayerNorm entry point."""
    fn = _build.load("window_gemm").window_layer_norm_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _gemm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          out: torch.Tensor, *, epilogue: int, geom, gather: bool = False,
          scatter: bool = False, res: Optional[torch.Tensor] = None) -> None:
    """One launch of window_gemm.cu's product over all T = out.numel() /
    Nout rows; ``x``, ``out`` and ``res`` are contiguous with rows along
    the last axis; ``geom`` = (Hm, Wm, window, shift) of the map."""
    K, Nout = x.shape[-1], w.shape[0]
    T = out.numel() // Nout
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(_gemm_fn()(x.data_ptr(), w.data_ptr(), _ptr(b), _ptr(res),
                      out.data_ptr(), T, K, Nout, K, Nout, int(gather),
                      int(scatter), *geom, epilogue, stream), "window_gemm")


def _layer_norm(x: torch.Tensor, ln: Pair) -> torch.Tensor:
    """window_gemm.cu's LayerNorm over the rows of a contiguous map."""
    out = torch.empty_like(x)
    C = x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(_layer_norm_fn()(x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
                            out.data_ptr(), x.numel() // C, C, LN_EPS,
                            stream), "window_layer_norm")
    return out


def _check_inputs(x: torch.Tensor, window: int, num_heads: int,
                  weights: Sequence[Tuple[str, Optional[torch.Tensor],
                                          Tuple[int, ...]]],
                  lns: Sequence[Tuple[str, Pair]] = ()) -> None:
    """What the CUDA chains take: a contiguous bf16 (B, H, W, C) map with
    H and W multiples of the window, head dim 32, N = w^2 <= 144, bf16
    contiguous weights and biases of the named shapes (16-byte aligned:
    the kernels read them 16 and 4 bytes at a time), fp32 LN weights."""
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the CUDA kernels take a contiguous bfloat16 "
                        f"(B, H, W, C) map, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("the map must be 16-byte aligned")
    B, H, W, C = x.shape
    if window < 1 or H % window or W % window or window * window > MAX_TOKENS:
        raise ValueError(f"map {H}x{W} is not tiled by window {window} (or "
                         f"the window exceeds {MAX_TOKENS} tokens)")
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
                     num_heads: int, scale: float) -> torch.Tensor:
    """qkv product (rows gathered window-major from the map) → attention
    core; returns the (T, C) window-major attention output."""
    B, H, W, C = src.shape
    window = geom[2]
    N = window * window
    Bn = B * (H // window) * (W // window)
    qkv = torch.empty((Bn, N, 3, num_heads, HEAD_DIM), dtype=src.dtype,
                      device=src.device)
    _gemm(src, w_qkv, b_qkv, qkv, epilogue=_EPI_BIAS, geom=geom,
          gather=True)
    attn = torch.empty((Bn, N, C), dtype=src.dtype, device=src.device)
    launch_window_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], bias,
                            mask, attn.view(Bn, N, num_heads, HEAD_DIM),
                            scale)
    return attn


def window_block_spatial(y: torch.Tensor, w_qkv: torch.Tensor,
                         b_qkv: Optional[torch.Tensor], bias: torch.Tensor,
                         mask: Optional[torch.Tensor], w_proj: torch.Tensor,
                         b_proj: Optional[torch.Tensor], *, num_heads: int,
                         window: int, scale: Optional[float] = None,
                         shift: int = 0) -> torch.Tensor:
    """Window attention block (qkv → attention → proj) over the padded
    spatial map ``(B, Hp, Wp, C)`` (B8); ``(B, Hp, Wp, C)`` out.

    ``bias`` (H, N, N) and ``mask`` (nW, N, N) as :func:`.window_attention`
    takes them; ``w_qkv`` (3C, C), ``w_proj`` (C, C)."""
    C = y.shape[-1]
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if y.device.type == "cpu":
        return window_block_spatial_reference(
            y, w_qkv, b_qkv, bias, mask, w_proj, b_proj, num_heads=num_heads,
            window=window, scale=scale, shift=shift)
    if y.device.type != "cuda":
        raise ValueError(f"no window block for device {y.device}")
    if requires_grad_on_cuda(y, w_qkv, b_qkv, bias, w_proj, b_proj):
        refuse_grad("window_block_spatial")
    _check_inputs(y, window, num_heads, [
        ("w_qkv", w_qkv, (3 * C, C)), ("b_qkv", b_qkv, (3 * C,)),
        ("w_proj", w_proj, (C, C)), ("b_proj", b_proj, (C,))])
    B, Hp, Wp, _ = y.shape
    geom = (Hp, Wp, window, shift)
    attn = _attention_chain(y, w_qkv, b_qkv, bias, mask, geom, num_heads,
                            scale)
    out = torch.empty_like(y)
    _gemm(attn, w_proj, b_proj, out, epilogue=_EPI_BIAS, geom=geom,
          scatter=True)
    window_block_spatial.launches += 1
    return out


window_block_spatial.launches = 0


def window_block_full_spatial(x: torch.Tensor, ln1: Pair, qkv: Pair,
                              bias: torch.Tensor,
                              mask: Optional[torch.Tensor], proj: Pair,
                              ln2: Pair, fc1: Pair, fc2: Pair, *,
                              num_heads: int, window: int,
                              scale: Optional[float] = None,
                              shift: int = 0) -> torch.Tensor:
    """A whole Swin block (LN1 → W-MSA → +residual → LN2 → MLP →
    +residual) over the unpadded spatial map ``(B, H, W, C)`` (B9).

    ``ln1``/``ln2`` are (weight, bias) pairs, fp32; ``qkv``, ``proj``,
    ``fc1``, ``fc2`` are (weight, bias) pairs in ``nn.Linear`` layout.
    DropPath and dropout are the caller's business: the residuals are
    inside."""
    C = x.shape[-1]
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu":
        return window_block_full_spatial_reference(
            x, ln1, qkv, bias, mask, proj, ln2, fc1, fc2,
            num_heads=num_heads, window=window, scale=scale, shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"no window block for device {x.device}")
    if requires_grad_on_cuda(x, bias, *ln1, *qkv, *proj, *ln2, *fc1, *fc2):
        refuse_grad("window_block_full_spatial")
    hidden = fc1[0].shape[0]
    _check_inputs(x, window, num_heads, [
        ("qkv weight", qkv[0], (3 * C, C)), ("qkv bias", qkv[1], (3 * C,)),
        ("proj weight", proj[0], (C, C)), ("proj bias", proj[1], (C,)),
        ("fc1 weight", fc1[0], (hidden, C)), ("fc1 bias", fc1[1], (hidden,)),
        ("fc2 weight", fc2[0], (C, hidden)), ("fc2 bias", fc2[1], (C,))],
        lns=[("ln1", ln1), ("ln2", ln2)])
    if hidden % 32:
        raise ValueError(f"MLP width {hidden} is not a multiple of 32")
    B, H, W, _ = x.shape
    geom = (H, W, window, shift)
    attn = _attention_chain(_layer_norm(x, ln1), *qkv, bias, mask, geom,
                            num_heads, scale)
    h = torch.empty_like(x)
    _gemm(attn, *proj, h, epilogue=_EPI_BIAS_RES, geom=geom, scatter=True,
          res=x)
    hid = torch.empty((B, H, W, hidden), dtype=x.dtype, device=x.device)
    _gemm(_layer_norm(h, ln2), *fc1, hid, epilogue=_EPI_GELU, geom=geom)
    out = torch.empty_like(x)
    _gemm(hid, *fc2, out, epilogue=_EPI_BIAS16_RES, geom=geom, res=h)
    window_block_full_spatial.launches += 1
    return out


window_block_full_spatial.launches = 0


def block_flops(tokens: int, C: int, N: int, full: bool,
                mlp_ratio: float = 4.0) -> int:
    """Operations of one block over ``tokens`` tokens: the qkv and proj
    products, QK^T and PV over N-token windows, and (``full``) the MLP."""
    flops = 2 * tokens * 4 * C * C + 4 * tokens * N * C
    if full:
        flops += 2 * tokens * 2 * C * int(C * mlp_ratio)
    return flops
