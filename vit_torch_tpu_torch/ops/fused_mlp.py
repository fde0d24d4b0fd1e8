"""The fused transformer MLP: a hand-written CUDA kernel for Hopper, its
plain PyTorch version, and gradients.

Counterpart of ``vit_torch_tpu/ops/fused_mlp.py``: :func:`fused_mlp`
replaces the Pallas ``_kernel`` (ROADMAP B12), fc1 → exact GELU → fc2 over
``(..., C)`` tokens with the ``(T, Hd)`` hidden activation kept on chip.
On CUDA it is one launch of ``csrc/fused_mlp.cu``: a warp-specialised
``wgmma`` kernel fed by TMA, each block holding a tile of token rows and a
whole output row (up to 768 columns) in registers, so fc1 runs once per
row; :func:`launch_plan` chooses the row tile (128 rows where the slab
is narrow and the grid fills the card, else 64), the columns of each
consumer warpgroup and the slabs (more than one only above 768 output
columns), and the source note gives the register, shared-memory and wave
arithmetic and the bound.  The TPU's token blocks, lane-of-128 rule and
VMEM budget are tilings of the same function and have no counterpart
here: :func:`fits` states what the CUDA kernel takes.

Rounding points follow ``_kernel`` (``:92-99``): x·w1 accumulates in fp32,
b1 is added in fp32, GELU runs in fp32 (the exact erf form), the hidden
activation is rounded once to x's dtype; h·w2 accumulates in fp32, b2 is
added in fp32, one rounding.  The JAX package's XLA path (``_ref_forward``
``:124``, what the backward differentiates) rounds each product before
adding its bias in x's dtype instead; :func:`_recompute` keeps that form.

Gradients, as ``_mlp_bwd`` (``:141``) takes them: when an input requires
grad the call goes through a ``torch.autograd.Function`` whose forward is
the kernel (the plain version on CPU tensors) and whose backward
recomputes ``_ref_forward`` with ``torch.matmul`` (the JAX backward leaves
these products to XLA too) and differentiates it: dx, dw1, db1, dw2, db2.

Weights come in ``nn.Linear`` layout, ``w1`` ``(Hd, C)`` and ``w2``
``(Co, Hd)``, in the activation dtype; biases may be None.  Dispatch is by
the tensors' device: CPU tensors run the plain version; CUDA tensors
launch the kernel or raise, with no fallback.  ``fused_mlp.launches``
counts kernel launches and ``fused_mlp_reference.calls`` plain forwards.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.gemm import (check, dense_f32, linear,
                                          needs_grad, ptr, recompute_grads,
                                          sm_count)

# csrc/fused_mlp.cu's shapes: fc1 runs over k-steps of 64, the hidden
# dimension in TMA tiles of 64, the output in 16-byte rows.  fits() keeps
# C >= 128, the JAX dispatch's smallest lane-aligned width
_K_STEP, _HIDDEN_CHUNK, _OUT_ALIGN = 64, 64, 8
# the widest output row one block holds in registers (two warpgroups of
# 384 fp32 columns); wider rows are cut into slabs
_ROW_COLS = 768


def fits(T: int, C: int, hidden: int, out_dim: Optional[int] = None) -> bool:
    """True when the CUDA kernel takes these shapes: C a multiple of 64 and
    at least 128, the hidden width a multiple of 64, the output width a
    multiple of 8, at least one token."""
    Co = C if out_dim is None else out_dim
    return (T >= 1 and C >= 2 * _K_STEP and C % _K_STEP == 0
            and hidden >= _HIDDEN_CHUNK and hidden % _HIDDEN_CHUNK == 0
            and Co >= _OUT_ALIGN and Co % _OUT_ALIGN == 0)


class Plan(NamedTuple):
    """How ``csrc/fused_mlp.cu`` is launched for one shape: token rows a
    block (128: each consumer warpgroup owns 64 rows and the whole slab;
    64: the two share the rows and split the slab's columns), output
    columns a consumer warpgroup accumulates, output slabs (each recomputes
    fc1 for its rows), and blocks in the grid (one per row tile and slab)."""
    block_rows: int
    warpgroup_cols: int
    slabs: int
    blocks: int


# csrc/fused_mlp.cu's instances: columns a warpgroup for each row layout
_WG_COLS = {128: (128, 192, 256), 64: (64, 128, 192, 256, 384)}
# the H100 SXM's SMs, launch_plan's default
_H100_SMS = 132


def launch_plan(T: int, C: int, hidden: int, out_dim: Optional[int] = None,
                sms: int = _H100_SMS,
                block_rows: Optional[int] = None) -> Plan:
    """The kernel's launch plan for these shapes (the one the wrapper
    passes to the C entry point): as few slabs as the registers allow (one
    up to 768 output columns); 128-row blocks, which stream each weight
    tile once for twice the rows, where a slab is at most 256 columns and
    their row tiles fill at least one wave of ``sms`` SMs; else 64-row
    blocks, twice as many, whose two warpgroups split the slab.
    ``block_rows`` forces the row layout (128 takes at most 256 columns a
    slab)."""
    Co = C if out_dim is None else out_dim
    slabs = -(-Co // _ROW_COLS)
    per = -(-Co // slabs)
    if block_rows is None:
        block_rows = 128 if per <= 256 and -(-T // 128) >= sms else 64
    if block_rows == 128 and per <= 256:
        cols = _round_up(per, _WG_COLS[128])
    elif block_rows == 64:
        cols = _round_up(-(-per // 2), _WG_COLS[64])
    else:
        raise ValueError(f"no {block_rows}-row layout for {per} columns a "
                         f"slab")
    return Plan(block_rows, cols, slabs, -(-T // block_rows) * slabs)


def _round_up(n: int, widths) -> int:
    return next(w for w in widths if n <= w)


def fused_mlp_reference(x: torch.Tensor, w1: torch.Tensor,
                        b1: Optional[torch.Tensor], w2: torch.Tensor,
                        b2: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of :func:`fused_mlp` with ``_kernel``'s rounding points,
    differentiable through autograd."""
    fused_mlp_reference.calls += 1
    dt = x.dtype
    h = F.gelu(dense_f32(x, w1, b1)).to(dt)
    return dense_f32(h, w2, b2).to(dt)


fused_mlp_reference.calls = 0


@functools.lru_cache(maxsize=None)
def _mlp_fn():
    """fused_mlp.cu's entry point, built and loaded on first use."""
    fn = _build.load("fused_mlp").fused_mlp_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(x, w1, b1, w2, b2) -> None:
    """What the kernel takes: a contiguous, 16-byte aligned bf16 ``(T, C)``
    token matrix whose shapes :func:`fits`, and contiguous, aligned bf16
    weights and biases on its device."""
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the CUDA kernel takes contiguous bfloat16 (T, C) "
                        f"tokens, got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("the tokens must be 16-byte aligned")
    T, C = x.shape
    Hd, Co = w1.shape[0], w2.shape[0]
    if not fits(T, C, Hd, Co):
        raise ValueError(f"T = {T}, C = {C}, hidden {Hd}, out {Co}: the "
                         f"kernel takes C a multiple of 64 (>= 128), hidden "
                         f"a multiple of 64, out a multiple of 8")
    for name, t, shape in (("w1", w1, (Hd, C)), ("b1", b1, (Hd,)),
                           ("w2", w2, (Co, Hd)), ("b2", b2, (Co,))):
        if t is None:
            continue
        if (t.shape != shape or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bfloat16 {shape} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _forward(x, w1, b1, w2, b2) -> torch.Tensor:
    """B12 over (T, C) tokens without autograd: the plain version on CPU
    tensors, one kernel launch on CUDA tensors."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no fused MLP for device {x.device}")
    return launch(x, w1, b1, w2, b2, launch_plan(
        x.shape[0], x.shape[-1], w1.shape[0], w2.shape[0], sm_count(x.device)))


def launch(x, w1, b1, w2, b2, plan: Plan) -> torch.Tensor:
    """One launch of the kernel on CUDA (T, C) tokens with this plan (the
    wrapper passes :func:`launch_plan`'s); raises on inputs or a plan the
    kernel does not take."""
    _check_inputs(x, w1, b1, w2, b2)
    T, C = x.shape
    Hd, Co = w1.shape[0], w2.shape[0]
    out = torch.empty((T, Co), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(_mlp_fn()(x.data_ptr(), w1.data_ptr(), ptr(b1), w2.data_ptr(),
                    ptr(b2), out.data_ptr(), T, C, Hd, Co, plan.block_rows,
                    plan.warpgroup_cols, plan.slabs, stream), "fused_mlp")
    fused_mlp.launches += 1
    return out


def _recompute(x, w1, b1, w2, b2) -> torch.Tensor:
    """``_ref_forward``, the composition ``_mlp_bwd`` differentiates: each
    product rounded to x's dtype, then its bias added in it; GELU in fp32."""
    h = F.gelu(linear(x, w1, b1).float()).to(x.dtype)
    return linear(h, w2, b2)


class _FusedMlp(torch.autograd.Function):
    """B12 with gradients (``_mlp_fwd`` / ``_mlp_bwd``): the forward is the
    kernel; the backward recomputes :func:`_recompute` under autograd."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        return recompute_grads(ctx, _recompute, dout)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
              w2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """Fused fc1 → exact GELU → fc2 over ``(..., C)`` tokens (B12);
    ``(..., Co)`` out.  ``w1`` ``(Hd, C)``, ``w2`` ``(Co, Hd)``; biases may
    be None.  Differentiable in every tensor input.  Call :func:`fits`
    with ``T = prod(leading dims)`` first.  Tokens that are not one
    contiguous matrix (a view such as XCiT's CLS tokens ``x[:, :1]``) are
    copied into one first."""
    lead, C = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, C).contiguous()
    if needs_grad(x, w1, b1, w2, b2):
        out = _FusedMlp.apply(x2, w1, b1, w2, b2)
    else:
        out = _forward(x2, w1, b1, w2, b2)
    return out.reshape(*lead, w2.shape[0])


fused_mlp.launches = 0


def mlp_flops(T: int, C: int, hidden: int, out_dim: int) -> int:
    """Operations of the function: 2·T·C·Hd for fc1 and 2·T·Hd·Co for fc2.
    The kernel does as many where :func:`launch_plan` gives one slab; each
    further slab adds one fc1."""
    return 2 * T * hidden * (C + out_dim)
