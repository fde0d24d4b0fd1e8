"""The hand-written product of the Swin window blocks, and the helpers the
fused blocks' plain versions and autograd Functions share.

:func:`gemm` launches ``csrc/window_gemm.cu``'s product: ``out = x @ w.T``
over bf16 rows with fp32 accumulation and one of the fused epilogues
below.  Its row addressing can gather the rows of a Swin map window-major
and scatter them back (the Swin blocks, :mod:`.window_block`), through the
per-image row table of :func:`window_rows`; with the identity map
``geom = (1, 1, 1, 0)`` it is a plain row-major product (the flat window
block's projections, fc1 and fc2).  :func:`gemm_plan` is the launch plan
the wrapper passes to the kernel: tile width, ring stages and grid.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from vit_torch_tpu_torch.ops import _build

# window_gemm.cu's epilogues (the source note gives their rounding)
EPI_BIAS, EPI_BIAS_RES, EPI_GELU, EPI_BIAS16_RES = 0, 1, 2, 3
# the identity row map: a plain row-major product
FLAT = (1, 1, 1, 0)

# csrc/window_gemm.cu: 128-row tiles, column widths of its instances (the
# widest first), its ring's bounds and the shared memory a block may use
BLOCK_M = 128
BLOCK_NS = (192, 128)
_MAX_STAGES = 8
_SMEM_MAX = 232448
# 1 KB of alignment, two 64 x 64 bf16 output slices a consumer
# warpgroup, the ring's barriers
_SMEM_FIXED = 1024 + 4 * 64 * 128 + 2 * _MAX_STAGES * 8
# the H100 SXM's SMs, gemm_plan's default
_H100_SMS = 132


class GemmPlan(NamedTuple):
    """How ``csrc/window_gemm.cu`` is launched for one product: output
    columns a tile (rows: :data:`BLOCK_M`), row and column tiles, ring
    stages of (128 + block_n) x 64 bf16, persistent blocks and their
    dynamic shared bytes."""
    block_n: int
    tiles_m: int
    tiles_n: int
    stages: int
    grid: int
    smem_bytes: int


def gemm_plan(T: int, K: int, N: int, sms: int = _H100_SMS) -> GemmPlan:
    """The product's launch plan for ``T`` rows of ``K`` in, ``N`` out:
    the tile width of :data:`BLOCK_NS` whose busiest SM (``ceil(tiles /
    sms)`` tiles) computes the fewest columns, the wider one on a tie
    (fewer re-reads of A); as many ring stages as shared memory holds, up
    to 8; one persistent block per SM, or per tile where there are fewer.
    Widths the kernel does not take raise ``ValueError``: K a multiple of
    32, N of 8 (16-byte rows for TMA and the copy-out)."""
    if T < 1 or K < 32 or K % 32 or N < 8 or N % 8:
        raise ValueError(f"window_gemm takes T >= 1 rows, K a multiple of "
                         f"32 and N a multiple of 8, got T, K, N = {T}, "
                         f"{K}, {N}")
    tiles_m = -(-T // BLOCK_M)

    def load(bn):   # columns the busiest SM computes
        return -(-(tiles_m * -(-N // bn)) // sms) * bn

    bn = min(BLOCK_NS, key=lambda b: (load(b), -b))
    tiles_n = -(-N // bn)
    stage = (BLOCK_M + bn) * 128
    stages = min(_MAX_STAGES, (_SMEM_MAX - _SMEM_FIXED) // stage)
    if tiles_m * tiles_n > 2 ** 31 - 1:
        raise ValueError(f"{tiles_m * tiles_n} tiles exceed 2^31 - 1")
    return GemmPlan(bn, tiles_m, tiles_n, stages,
                    min(tiles_m * tiles_n, sms),
                    _SMEM_FIXED + stages * stage)


@functools.lru_cache(maxsize=64)
def window_rows(H: int, W: int, window: int, shift: int,
                device: torch.device) -> torch.Tensor:
    """The int32 ``(H * W,)`` table, on ``device`` and built once per
    geometry, of the map rows (within an image) of the window-major rows
    that window_gemm.cu gathers and scatters: window ``(wy, wx)``, token
    ``j`` at position ``((wy w + j // w + s) mod H, (wx w + j mod w + s)
    mod W)``, the cyclic shift ``s`` of a shifted block folded in (image
    ``b``'s rows are ``b * H * W`` on)."""
    if window < 1 or H % window or W % window or not 0 <= shift < window:
        raise ValueError(f"map {H}x{W} is not tiled by window {window}, or "
                         f"the shift {shift} is not in [0, {window})")
    j = torch.arange(H * W)
    n = window * window
    wi, tok = j // n, j % n
    wy, wx = wi // (W // window), wi % (W // window)
    yy = (wy * window + tok // window + shift) % H
    xx = (wx * window + tok % window + shift) % W
    return (yy * W + xx).to(device=device, dtype=torch.int32)


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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (the kernels' grid sizes)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    ``gather`` (rows of x) and ``scatter`` (rows of out and res) address.
    The plan is :func:`gemm_plan`'s; widths it does not take raise before
    the launch.  ``gemm.launches`` counts the launches."""
    K, Nout = x.shape[-1], w.shape[0]
    T = out.numel() // Nout
    plan = gemm_plan(T, K, Nout, sm_count(x.device))
    rows, hw = None, 1
    if gather or scatter:
        Hm, Wm = geom[:2]
        hw = Hm * Wm
        if T % hw:
            raise ValueError(f"{T} rows are not whole {Hm}x{Wm} maps")
        rows = window_rows(*geom, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(_gemm_fn()(x.data_ptr(), w.data_ptr(), ptr(b), ptr(res),
                     out.data_ptr(), ptr(rows), T, K, Nout, hw, int(gather),
                     int(scatter), epilogue, plan.block_n, plan.stages,
                     plan.grid, stream), "window_gemm")
    gemm.launches += 1


gemm.launches = 0
