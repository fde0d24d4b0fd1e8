"""The fused ViT attention block: a hand-written CUDA kernel for Hopper,
its plain PyTorch versions, and gradients.

Counterpart of ``vit_torch_tpu/ops/attn_block.py``:

- :func:`attention_block` replaces the Pallas ``_kernel`` (ROADMAP B3):
  qkv projection → exact softmax attention per head → output projection,
  over ``(B, N, C)`` token blocks;
- :func:`attention_block_packed` replaces ``_kernel_packed`` (B4): the
  same function for short sequences, several whole images in one tile
  under a block-diagonal mask; its forward also keeps qkv for the
  analytic backward.

On CUDA each is a chain of two launches of ``csrc/attn_block.cu``'s
warp-specialised ``wgmma`` kernels fed by TMA: the qkv product
(``bf16(x W_qkvᵀ + b)``, columns in the ``(3, H, D)`` order) and the
attention-and-projection kernel, which loads a block's q rows once into
a head-output tile in shared memory, runs the exact online softmax of
every head against its image's keys, writes each head's output over its
q columns there and projects the tile with the output weight streamed
through shared memory, writing each output row once.  A block takes 64
query rows; its two consumer warpgroups take alternate heads and then
split the projection's columns, whose passes :func:`launch_plan` gives;
the source note gives the design, the budgets and the bound.  The TPU's
128-row chunks, pack width and VMEM budgets are tilings of the same
function and have no counterpart here; :func:`fits` and
:func:`fits_packed` state what the CUDA kernels take.

Rounding points follow ``_kernel``: q, k and v take their bias in fp32
and round once; scores and softmax statistics are fp32; the unnormalised
``exp(s - m)`` is rounded for PV and the fp32 PV divided by the fp32 row
sum; each head's output is rounded; the projection adds its bias in fp32
and rounds once.  The kernel's softmax is online over 64-key tiles, so at
N > 64 its P is rounded against the running, not the final, row max (as
the flash kernel's).  Weights come in ``nn.Linear`` layout ``(out, in)``
in the activation dtype.

Gradients, as the JAX custom VJPs take them (the inputs that require grad
go through a ``torch.autograd.Function``):

- B3 (``_ab_bwd``) recomputes ``_ref_forward`` under autograd: the qkv
  product with its bias added in the activation dtype, the flash
  attention (:func:`.flash_attention_qkv`: kernels 1 and 2 on CUDA, their
  plain versions on the CPU) and the output product;
- B4 (``_abp_bwd``) is analytic over the saved qkv: only the attention
  core is recomputed (fp32 scores, softmax, P in the activation dtype, PV)
  and differentiated; the products' gradients are one matmul each.

Dispatch is by the tensors' device: CPU tensors run the plain versions;
CUDA tensors launch the kernel chain or raise, with no fallback.
``attention_block.launches`` and ``attention_block_packed.launches`` count
chains launched; ``attention_block_reference.calls`` and
``attention_block_packed_reference.calls`` count plain forwards.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.flash_attention import (
    flash_attention_bhnd_reference, flash_attention_qkv)
from vit_torch_tpu_torch.ops.gemm import (
    check, dense_f32, linear, needs_grad, ptr, recompute_grads, sm_count)

HEAD_DIMS = (32, 64)
# the products run over 64-column k-tiles; the query rows and the heads'
# outputs, rows x C bf16, sit in shared memory beside the ring
MAX_CHANNELS = 1024
# the packed form takes whole images into one 64-row tile
MAX_PACKED_TOKENS = 48
_TILE_ROWS = 64
_MAX_GRID_Y = 65535
# csrc/attn_block.cu's projection instances: columns a consumer warpgroup
# projects in one pass (at most 384: 192 fp32 accumulators a thread)
_PASS_COLS = (128, 192, 256, 384)


def fits(N: int, C: int, num_heads: int) -> bool:
    """True when the CUDA kernel takes these shapes: C a multiple of 64 up
    to :data:`MAX_CHANNELS`, head dim 32 or 64, at least one token."""
    return (N >= 1 and num_heads >= 1 and C % num_heads == 0
            and C % 64 == 0 and C <= MAX_CHANNELS
            and C // num_heads in HEAD_DIMS)


def fits_packed(N: int, C: int, num_heads: int) -> bool:
    """:func:`fits`, for sequences of at most :data:`MAX_PACKED_TOKENS`."""
    return N <= MAX_PACKED_TOKENS and fits(N, C, num_heads)


class Plan(NamedTuple):
    """How ``csrc/attn_block.cu``'s attention-and-projection kernel is
    launched for one shape: the output columns a consumer warpgroup
    projects in one pass (the two warpgroups take half the columns each),
    the passes, and the 64-row blocks in the grid."""
    pass_cols: int
    passes: int
    blocks: int


def _round_up(n: int, widths) -> int:
    return next(w for w in widths if n <= w)


def launch_plan(B: int, N: int, C: int, num_heads: int, *,
                packed: bool = False) -> Plan:
    """The kernel's launch plan for these shapes (the one the wrapper
    passes to the C entry point): each consumer warpgroup projects half
    the C columns in the fewest passes of at most 384.  B3 blocks take 64
    rows of one image; B4 (``packed``) blocks take whole images, 64 // N
    of them.  Shapes the kernel does not take raise."""
    if not (fits_packed if packed else fits)(N, C, num_heads):
        raise ValueError(f"no attention block kernel for N = {N}, C = {C}, "
                         f"{num_heads} heads")
    half = -(-C // 2)
    passes = -(-half // _PASS_COLS[-1])
    cols = _round_up(-(-half // passes), _PASS_COLS)
    if packed:
        blocks = -(-B // (_TILE_ROWS // N))
    else:
        blocks = -(-N // _TILE_ROWS) * B
    return Plan(cols, passes, blocks)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _reference_parts(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale):
    """``_kernel``'s arithmetic: the ``(B, N, C)`` output and the
    ``(B, N, 3C)`` qkv projection, both in x's dtype.  Attention within
    each image is what the packed kernel's block-diagonal mask computes
    (masked scores give exactly 0 after the exp)."""
    B, N, C = x.shape
    dt = x.dtype
    qkv = dense_f32(x, w_qkv, b_qkv).to(dt)
    q, k, v = (t.transpose(1, 2)
               for t in qkv.view(B, N, 3, num_heads, -1).unbind(2))
    o = flash_attention_bhnd_reference(q, k, v, scale=scale)
    o = o.transpose(1, 2).reshape(B, N, C)
    return dense_f32(o, w_proj, b_proj).to(dt), qkv


def _default_scale(x: torch.Tensor, num_heads: int) -> float:
    return (x.shape[-1] // num_heads) ** -0.5


def attention_block_reference(x: torch.Tensor, w_qkv: torch.Tensor,
                              b_qkv: Optional[torch.Tensor],
                              w_proj: torch.Tensor,
                              b_proj: Optional[torch.Tensor], *,
                              num_heads: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`attention_block` (B3), differentiable
    through autograd."""
    attention_block_reference.calls += 1
    if scale is None:
        scale = _default_scale(x, num_heads)
    return _reference_parts(x, w_qkv, b_qkv, w_proj, b_proj, num_heads,
                            scale)[0]


attention_block_reference.calls = 0


def attention_block_packed_reference(
        x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor],
        w_proj: torch.Tensor, b_proj: Optional[torch.Tensor], *,
        num_heads: int, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed forward (B4): ``(out, qkv)``."""
    attention_block_packed_reference.calls += 1
    if scale is None:
        scale = _default_scale(x, num_heads)
    return _reference_parts(x, w_qkv, b_qkv, w_proj, b_proj, num_heads,
                            scale)


attention_block_packed_reference.calls = 0


# --------------------------------------------------------------------------
# the CUDA chain
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fns():
    """attn_block.cu's two entry points, built and loaded on first use:
    ``(qkv product, attention and projection)``."""
    lib = _build.load("attn_block")
    qkv = lib.attn_block_qkv_bf16
    qkv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    qkv.restype = ctypes.c_int
    attn = lib.attn_block_bf16
    attn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    attn.restype = ctypes.c_int
    return qkv, attn


def _check_inputs(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
                  packed: bool) -> None:
    """What the chain takes: a contiguous, 16-byte aligned bf16
    ``(B, N, C)`` block whose shapes :func:`fits` (:func:`fits_packed`),
    and contiguous, aligned bf16 weights and biases of the block's
    shapes on its device."""
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the CUDA kernel takes a contiguous bfloat16 "
                        f"(B, N, C) block, got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("the token block must be 16-byte aligned")
    B, N, C = x.shape
    if not (fits_packed if packed else fits)(N, C, num_heads):
        raise ValueError(
            f"N = {N}, C = {C}, {num_heads} heads: the kernel takes C a "
            f"multiple of 64 up to {MAX_CHANNELS} and head dim in "
            f"{HEAD_DIMS}" + (f", N up to {MAX_PACKED_TOKENS}" if packed
                              else ""))
    if not packed and B > _MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds {_MAX_GRID_Y}")
    for name, t, shape in (("w_qkv", w_qkv, (3 * C, C)),
                           ("b_qkv", b_qkv, (3 * C,)),
                           ("w_proj", w_proj, (C, C)),
                           ("b_proj", b_proj, (C,))):
        if t is None:
            continue
        if (t.shape != shape or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bfloat16 {shape} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int, scale: float,
            packed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two launches on CUDA tensors: the qkv product, then the
    attention and projection kernel with :func:`launch_plan`'s plan.
    Returns ``(out, qkv)``; raises on inputs the kernels do not take."""
    _check_inputs(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, packed)
    B, N, C = x.shape
    plan = launch_plan(B, N, C, num_heads, packed=packed)
    qkv_fn, attn_fn = _fns()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    qkv = torch.empty((B, N, 3 * C), dtype=x.dtype, device=x.device)
    check(qkv_fn(x.data_ptr(), w_qkv.data_ptr(), ptr(b_qkv), qkv.data_ptr(),
                 B * N, C, sm_count(x.device), stream), "attn_block qkv")
    out = torch.empty_like(x)
    group = _TILE_ROWS // N if packed else 0
    check(attn_fn(qkv.data_ptr(), w_proj.data_ptr(), ptr(b_proj),
                  out.data_ptr(), B, N, C, num_heads, group,
                  plan.pass_cols, plan.passes, float(scale), stream),
          "attn_block")
    return out, qkv


def _forward(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale):
    """B3 without autograd: the plain version on CPU tensors, the chain on
    CUDA tensors."""
    if x.device.type == "cpu":
        return attention_block_reference(x, w_qkv, b_qkv, w_proj, b_proj,
                                         num_heads=num_heads, scale=scale)
    if x.device.type != "cuda":
        raise ValueError(f"no attention block for device {x.device}")
    out = _launch(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale,
                  packed=False)[0]
    attention_block.launches += 1
    return out


def attention_block_packed_fwd(
        x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor],
        w_proj: torch.Tensor, b_proj: Optional[torch.Tensor], *,
        num_heads: int, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4's forward without autograd, ``(out, qkv)``: the plain version on
    CPU tensors, the chain on CUDA tensors."""
    if scale is None:
        scale = _default_scale(x, num_heads)
    if x.device.type == "cpu":
        return attention_block_packed_reference(
            x, w_qkv, b_qkv, w_proj, b_proj, num_heads=num_heads,
            scale=scale)
    if x.device.type != "cuda":
        raise ValueError(f"no attention block for device {x.device}")
    res = _launch(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale,
                  packed=True)
    attention_block_packed.launches += 1
    return res


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

def _recompute(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale):
    """``_ref_forward``, the composition ``_ab_bwd`` differentiates: the
    products rounded to x's dtype, then their biases added in it."""
    B, N, C = x.shape
    qkv = linear(x, w_qkv, b_qkv).view(B, N, 3, num_heads, C // num_heads)
    o = flash_attention_qkv(qkv, scale=scale).reshape(B, N, C)
    return linear(o, w_proj, b_proj)


class _AttentionBlock(torch.autograd.Function):
    """B3 with gradients (``_ab_fwd`` / ``_ab_bwd``): the forward is the
    chain; the backward recomputes :func:`_recompute` under autograd."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale):
        ctx.save_for_backward(x, w_qkv, b_qkv, w_proj, b_proj)
        ctx.meta = (num_heads, scale)
        return _forward(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        return recompute_grads(ctx, _recompute, dout, *ctx.meta)


def _core(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """``_abp_bwd``'s attention core over a ``(B, N, 3C)`` qkv: fp32 scores
    and softmax, P in qkv's dtype, PV in it; ``(B, N, C)`` out."""
    B, N, C3 = qkv.shape
    q, k, v = qkv.view(B, N, 3, num_heads, -1).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, C3 // 3)


class _AttentionBlockPacked(torch.autograd.Function):
    """B4 with gradients (``_abp_fwd`` / ``_abp_bwd``): the forward keeps
    the qkv projection; the backward differentiates the attention core
    over it and runs the products' gradients once each."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale):
        out, qkv = attention_block_packed_fwd(
            x, w_qkv, b_qkv, w_proj, b_proj, num_heads=num_heads,
            scale=scale)
        ctx.save_for_backward(x, qkv, w_qkv, w_proj)
        ctx.meta = (num_heads, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, qkv, w_qkv, w_proj = ctx.saved_tensors
        need = ctx.needs_input_grad
        C = x.shape[-1]
        do = dout.to(x.dtype).reshape(-1, C)
        with torch.enable_grad():
            leaf = qkv.detach().requires_grad_(True)
            attn = _core(leaf, *ctx.meta)
        (dqkv,) = torch.autograd.grad(attn, leaf,
                                      (do @ w_proj).view(attn.shape))
        dqkv = dqkv.reshape(-1, 3 * C)
        return (
            (dqkv @ w_qkv).view(x.shape) if need[0] else None,
            dqkv.t() @ x.reshape(-1, C) if need[1] else None,
            dqkv.sum(dim=0) if need[2] else None,
            do.t() @ attn.detach().reshape(-1, C) if need[3] else None,
            do.sum(dim=0) if need[4] else None,
            None, None)


# --------------------------------------------------------------------------
# entries
# --------------------------------------------------------------------------

def attention_block(x: torch.Tensor, w_qkv: torch.Tensor,
                    b_qkv: Optional[torch.Tensor], w_proj: torch.Tensor,
                    b_proj: Optional[torch.Tensor], *, num_heads: int,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused qkv → attention → proj over ``(B, N, C)`` token blocks (B3);
    ``(B, N, C)`` out.  ``w_qkv`` ``(3C, C)`` with outputs in ``(3, H, D)``
    order, ``w_proj`` ``(C, C)``; biases may be None.  Differentiable in
    every tensor input.  Call :func:`fits` first."""
    B, N, C = x.shape
    if not fits(N, C, num_heads):
        raise ValueError(f"attention_block does not take N = {N}, C = {C}, "
                         f"{num_heads} heads; check fits() first")
    if scale is None:
        scale = _default_scale(x, num_heads)
    args = (x, w_qkv, b_qkv, w_proj, b_proj, num_heads, float(scale))
    if needs_grad(x, w_qkv, b_qkv, w_proj, b_proj):
        return _AttentionBlock.apply(*args)
    return _forward(*args)


attention_block.launches = 0


def attention_block_packed(x: torch.Tensor, w_qkv: torch.Tensor,
                           b_qkv: Optional[torch.Tensor],
                           w_proj: torch.Tensor,
                           b_proj: Optional[torch.Tensor], *, num_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """:func:`attention_block` for short sequences (B4): whole images packed
    into 64-row tiles under a block-diagonal mask.  Differentiable in every
    tensor input.  Call :func:`fits_packed` first."""
    B, N, C = x.shape
    if not fits_packed(N, C, num_heads):
        raise ValueError(f"attention_block_packed does not take N = {N}, "
                         f"C = {C}, {num_heads} heads; check fits_packed() "
                         f"first")
    if scale is None:
        scale = _default_scale(x, num_heads)
    args = (x, w_qkv, b_qkv, w_proj, b_proj, num_heads, float(scale))
    if needs_grad(x, w_qkv, b_qkv, w_proj, b_proj):
        return _AttentionBlockPacked.apply(*args)
    return attention_block_packed_fwd(*args[:5], num_heads=num_heads,
                                      scale=float(scale))[0]


attention_block_packed.launches = 0


def attention_block_flops(B: int, N: int, C: int) -> int:
    """Operations of one block: the qkv and output products (8·B·N·C²) and
    QKᵀ and PV (4·B·N²·C)."""
    return 8 * B * N * C * C + 4 * B * N * N * C
