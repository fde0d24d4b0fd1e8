"""The hand-written product the fused blocks share, and the helpers their
plain versions and autograd Functions share.

:func:`gemm` launches ``csrc/window_gemm.cu``'s product: ``out = x @ w.T``
over bf16 rows with fp32 accumulation and one of the fused epilogues
below.  Its row addressing can gather the rows of a Swin map window-major
and scatter them back (the Swin blocks, :mod:`.window_block`); with the
identity map ``geom = (1, 1, 1, 0)`` it is a plain row-major product
(the ViT attention block's qkv projection, :mod:`.attn_block`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vit_torch_tpu_torch.ops import _build

# window_gemm.cu's epilogues (the source note gives their rounding)
EPI_BIAS, EPI_BIAS_RES, EPI_GELU, EPI_BIAS16_RES = 0, 1, 2, 3
# the identity row map: a plain row-major product
FLAT = (1, 1, 1, 0)


def needs_grad(*xs) -> bool:
    """True when autograd records and an input requires grad."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def recompute_grads(ctx, fn, dout, *meta):
    """The backward of a Function that saved its tensor inputs (None where
    an input was None) and recomputes: ``fn(*inputs, *meta)`` runs again
    under autograd and is differentiated with respect to every input that
    needs a gradient; the others get None."""
    need = ctx.needs_input_grad
    leaves = [t if t is None else t.detach().requires_grad_(need[i])
              for i, t in enumerate(ctx.saved_tensors)]
    wrt = [i for i, t in enumerate(leaves) if t is not None and need[i]]
    with torch.enable_grad():
        out = fn(*leaves, *meta)
    grads = torch.autograd.grad(out, [leaves[i] for i in wrt], dout)
    res = [None] * len(need)
    for i, g in zip(wrt, grads):
        res[i] = g
    return tuple(res)


def dense_f32(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32-accumulated ``x @ w.T (+ b)`` of values in their own dtypes."""
    y = torch.matmul(x.float(), w.float().t())
    return y if b is None else y + b.float()


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w.T`` rounded to x's dtype, then ``+ b`` in that dtype: the
    rounding of the JAX backward's recomputed XLA dots."""
    y = torch.matmul(x, w.t())
    return y if b is None else y + b.to(x.dtype)


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


def ptr(x: Optional[torch.Tensor]):
    """A tensor's device address, or NULL for None."""
    return None if x is None else x.data_ptr()


def check(err: int, what: str) -> None:
    """Raise on the CUDA error a launcher returned."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def gemm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
         out: torch.Tensor, *, epilogue: int, geom, gather: bool = False,
         scatter: bool = False, res: Optional[torch.Tensor] = None) -> None:
    """One launch of window_gemm.cu's product over all T = out.numel() /
    Nout rows; ``x``, ``out`` and ``res`` are contiguous with rows along
    the last axis; ``geom`` = (Hm, Wm, window, shift) of the map that
    ``gather`` (rows of x) and ``scatter`` (rows of out and res) address."""
    K, Nout = x.shape[-1], w.shape[0]
    T = out.numel() // Nout
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(_gemm_fn()(x.data_ptr(), w.data_ptr(), ptr(b), ptr(res),
                     out.data_ptr(), T, K, Nout, K, Nout, int(gather),
                     int(scatter), *geom, epilogue, stream), "window_gemm")
