"""Flash-attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of ``vit_torch_tpu/ops/flash_attention.py`` (Pallas
``_fwd_kernel`` / ``_fwd_kernel_hb``).  The kernel is
``csrc/flash_attention_fwd.cu``; its source note gives the design and the
bound.  The TPU's ``block_q`` and head-blocking knobs are tilings of the
same function and have no counterpart here.

Dispatch is by the tensors' device: a CPU tensor runs
:func:`flash_attention_bhnd_reference`; a CUDA tensor launches the kernel,
or raises if the kernel does not take the input.  There is no fallback.
The backward kernels come with the training slice, so inputs that require
grad are refused on CUDA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vit_torch_tpu_torch.ops import _build

# (B * H) rides in gridDim.y
_MAX_BH = 65535
_HEAD_DIMS = (32, 64)


def flash_attention_bhnd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """Plain version over ``(B, H, N, D)``: fp32 scores, max-subtracted
    softmax, P rounded to V's dtype for the PV product, normalised after it
    (the TPU kernel's arithmetic)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16, {name} is "
                            f"{x.dtype}")
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "flash attention has no backward kernel yet (training "
                "slice); call it under torch.inference_mode()")
    B, H, N, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if B * H > _MAX_BH:
        raise ValueError(f"B*H = {B * H} exceeds {_MAX_BH}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built and loaded on first use."""
    fn = _build.load("flash_attention_fwd").flash_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, o, scale: float) -> None:
    """Launch the kernel on the current stream; ``o`` may be any view
    with unit stride along D (e.g. into a (B, N, H, D) buffer)."""
    strides = []
    for x in (q, k, v, o):
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"the kernel reads 16-byte rows: need unit stride along D, "
                f"strides that are multiples of 8 and a 16-byte aligned "
                f"pointer, got strides {x.stride()}")
        strides.extend(x.stride()[:3])
    B, H, N, D = q.shape
    fn = _kernel_fn()
    stride_arr = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, N, D, ctypes.cast(stride_arr, ctypes.c_void_p),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bhnd.launches += 1


def _run(q, k, v, o, scale) -> torch.Tensor:
    _check(q, k, v)
    if q.shape[0] * q.shape[1] * q.shape[2]:
        _launch(q, k, v, o, scale)
    return o


def flash_attention_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``(B, H, N, D)`` tensors, the kernel's native layout.

    ``flash_attention_bhnd.launches`` counts kernel launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bhnd_reference(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _run(q, k, v, out, scale)


flash_attention_bhnd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``(B, N, H, D)`` tensors (the JAX package's layout).

    On CUDA the kernel reads the inputs through their strides and writes a
    contiguous ``(B, N, H, D)`` result, so no transposed copies are made."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.device.type == "cpu":
        return flash_attention_bhnd_reference(
            qt, kt, vt, scale=scale).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _run(qt, kt, vt, out.transpose(1, 2), scale)
    return out
