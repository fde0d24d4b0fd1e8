"""Swin window attention: a hand-written CUDA forward kernel for Hopper and
its plain PyTorch version.

Counterpart of ``vit_torch_tpu/ops/window_attention.py``: the kernel
``csrc/window_attention_fwd.cu`` replaces the Pallas ``_fwd_kernel``.  It
computes ``softmax(scale * Q K^T + bias[h] + mask[i mod nW]) V`` for every
window ``i`` and head ``h`` of ``(Bn, N, H, D)`` tensors (the flax layout,
``Bn = B * nW`` windows flattened window-major per image), with exact
softmax rows: fp32 scores, the row max subtracted, P rounded to V's dtype
for the PV product and the row sum divided out after it.

Layout contracts (the JAX module's):

- ``bias``: ``(H, N, N)`` fp32, the relative-position bias gathered from
  its table outside the kernel (so the table's gradient stays an autograd
  gather);
- ``mask``: ``(nW, N, N)`` additive fp32 (the shifted-window mask), or
  None; window ``i`` takes row ``i mod nW``.

Dispatch is by the tensors' device: a CPU tensor runs the plain version
(:func:`window_attention_reference`), which autograd differentiates; a CUDA
tensor launches the kernel, or raises if the kernel does not take the
input.  The kernel has no backward yet (ROADMAP.md B6), so a CUDA input
that requires grad raises.  There is no fallback.

The Swin block kernels of :mod:`.window_block` launch this kernel as their
attention core, through :func:`launch_window_attention`, so
``window_attention.launches`` counts every launch of the core.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vit_torch_tpu_torch.ops import _build

HEAD_DIM = 32          # every Swin config has head dim 32
MAX_TOKENS = 144       # N = w^2 up to window 12
BACKWARD_ITEM = "ROADMAP.md B6, the window-attention backward"


def window_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain version over ``(Bn, N, H, D)``: the Pallas ``_fwd_kernel``'s
    arithmetic.  Differentiable through autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    Bn, N, H, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.view(Bn // nW, nW, H, N, N)
             + mask.float()[None, :, None]).view(Bn, H, N, N)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                      # (Bn, H, N)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def requires_grad_on_cuda(*xs) -> bool:
    """True when a CUDA input would need a gradient from a kernel that has
    no backward yet."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def refuse_grad(name: str) -> None:
    raise NotImplementedError(
        f"{name} has no backward kernel on CUDA yet ({BACKWARD_ITEM}): run "
        f"it under torch.no_grad(), or train on the CPU")


def _takes_rows(x: torch.Tensor) -> bool:
    """The kernel reads and writes 16-byte rows: unit stride along D,
    (window, row, head) strides that are multiples of 8, 16-byte aligned."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_bias_mask(bias, mask, H, N, Bn, dev) -> int:
    """The tables as the kernel reads them (column pairs, 8 bytes at a
    time): contiguous fp32, 8-byte aligned; the number of mask rows."""
    if (bias.dtype != torch.float32 or bias.shape != (H, N, N)
            or not bias.is_contiguous() or bias.device != dev
            or bias.data_ptr() % 8):
        raise ValueError(f"bias must be a contiguous, 8-byte aligned float32 "
                         f"({H}, {N}, {N}) tensor on {dev}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if mask is None:
        return 1
    if (mask.dtype != torch.float32 or mask.dim() != 3
            or mask.shape[1:] != (N, N) or not mask.is_contiguous()
            or mask.device != dev or mask.data_ptr() % 8):
        raise ValueError(f"mask must be a contiguous, 8-byte aligned float32 "
                         f"(nW, {N}, {N}) tensor on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    if Bn % mask.shape[0]:
        raise ValueError(f"{Bn} windows are not a multiple of the mask's "
                         f"{mask.shape[0]} windows per image")
    return mask.shape[0]


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    """The kernel's C entry point, built and loaded on first use."""
    fn = _build.load("window_attention_fwd").window_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_window_attention(q, k, v, bias, mask, out, scale: float) -> None:
    """Launch the kernel on the current stream: ``q``, ``k``, ``v`` and
    ``out`` are ``(Bn, N, H, D)`` bf16 CUDA views with unit stride along D
    (e.g. into the ``(Bn, N, 3, H, D)`` qkv projection and a ``(Bn, N, C)``
    buffer); ``bias`` and ``mask`` as :func:`window_attention` takes them."""
    shape, dev = q.shape, q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.dim() != 4 or x.shape != shape:
            raise ValueError(f"{name} must have q's (Bn, N, H, D) shape "
                             f"{tuple(shape)}, got {tuple(x.shape)}")
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernel takes "
                             f"CUDA tensors on one device")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16, {name} is "
                            f"{x.dtype}")
        if not _takes_rows(x):
            raise ValueError(
                f"the kernel reads 16-byte rows: {name} needs unit stride "
                f"along D, strides that are multiples of 8 and a 16-byte "
                f"aligned pointer, got strides {x.stride()}")
    Bn, N, H, D = shape
    if D != HEAD_DIM:
        raise ValueError(f"head dim {D} is not {HEAD_DIM}")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"{N} tokens per window: the kernel takes 1 to "
                         f"{MAX_TOKENS}")
    if H > 65535:
        raise ValueError(f"{H} heads exceed the grid's 65535")
    nW = _check_bias_mask(bias, mask, H, N, Bn, dev)
    if not Bn:
        return
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    strides = (ctypes.c_longlong * 12)(*strides)
    fn = _fwd_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bias.data_ptr(), None if mask is None else mask.data_ptr(),
                 Bn, H, N, D, nW, ctypes.cast(strides, ctypes.c_void_p),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"window_attention_fwd launch failed: CUDA error "
                           f"{err}")
    window_attention.launches += 1


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     *, scale: Optional[float] = None) -> torch.Tensor:
    """Window attention over ``(Bn, N, H, D)`` tensors (the flax layout);
    ``(Bn, N, H, D)`` out, contiguous on CUDA.

    ``window_attention.launches`` counts kernel launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no window attention for device {q.device}")
    if requires_grad_on_cuda(q, k, v, bias):
        refuse_grad("window_attention")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_window_attention(q, k, v, bias, mask, out, scale)
    return out


window_attention.launches = 0
