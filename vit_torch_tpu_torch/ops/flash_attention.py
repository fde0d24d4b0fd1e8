"""Flash attention: hand-written CUDA kernels for Hopper, forward and
backward, and their plain PyTorch versions.

Counterpart of ``vit_torch_tpu/ops/flash_attention.py``: the forward
kernel ``csrc/flash_attention_fwd.cu`` replaces the Pallas ``_fwd_kernel``
and ``_fwd_kernel_hb``; the backward kernels ``csrc/flash_attention_bwd.cu``
replace ``_bwd_fused_kernel_hb``, ``_bwd_fused_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``.  Both are warp-specialised
``wgmma`` kernels fed by TMA on ``csrc/sm90.cuh``: the forward's
persistent blocks run B3's ping-pong attention loop
(``csrc/attention_sm90.cuh``) over items of 128 query rows; the backward
is one pass over the query tiles for each block of 128 keys (5 products,
one exp per score), between a preprocess launch
(Di, the statistics, a zeroed fp32 dQ accumulator) and a convert launch
(dq in bf16).  :func:`launch_plan` gives the tiles, stages, grid, shared
bytes and dQ accumulator rows the C entry points take; their source notes
give the designs, the ragged-edge waste and the bounds.  The TPU's
``block_q`` and head-blocking knobs are tilings of the same functions and
have no counterpart here.

q is ``(B, H, Nq, D)`` and k and v ``(B, H, Nk, D)``: self-attention has
Nq = Nk, DETR's cross-attention 100 queries against the Hf·Wf memory
tokens (the Pallas kernel masks keys past its ``kv_len`` in the same way).

Dispatch is by the tensors' device: a CPU tensor runs the plain version
(:func:`flash_attention_bhnd_reference`, :func:`flash_attention_bwd_reference`);
a CUDA tensor launches the kernel, or raises if the kernel does not take
the input.  There is no fallback.

Gradients: when an input requires grad, the entry points go through a
``torch.autograd.Function`` whose forward also writes the per-row
log-sum-exp and whose backward launches the backward kernel.
:func:`flash_attention_qkv` takes the fused ``(B, N, 3, H, D)`` qkv
projection itself, so its backward writes dq, dk and dv straight into one
gradient of that shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.gemm import sm_count

# (B * H) rides in the backward's gridDim.y; the forward numbers its items
# (128 rows of one head) in an int
_MAX_BH, _MAX_ITEMS = 65535, 2 ** 31 - 1
_HEAD_DIMS = (32, 64)
# csrc/flash_attention_fwd.cu: 64 query rows a consumer warpgroup, two an
# item; 64-key tiles; at most 8 ring stages
_FWD_Q, _FWD_K, _FWD_STAGES = 128, 64, 8
# the H100 SXM's SMs: launch_plan's default for the forward's persistent
# blocks
_H100_SMS = 132
# csrc/flash_attention_bwd.cu: 64-query tiles stream past 128 keys a block
# (64 a consumer warpgroup); at most 4 ring stages; 512 bytes of LSE and
# Di a stage
_BWD_Q, _BWD_K, _BWD_STAGES, _BWD_STATS = 64, 128, 4, 512
# a block's shared memory: 227 KB, 1 KB of it kept for alignment
_SMEM_MAX, _ALIGN = 232448, 1024


class Plan(NamedTuple):
    """A flash kernel's launch: query rows an item (forward) or a step
    (backward), keys a tile (forward) or a block (backward), ring stages,
    the grid (forward: persistent blocks, 1; backward: key blocks,
    B * H), dynamic shared bytes, and the rows of the backward's fp32 dQ
    accumulator (0 for the forward)."""
    block_q: int
    block_k: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int
    dq_rows: int


def launch_plan(B: int, H: int, N: int, D: int, *,
                Nk: Optional[int] = None, backward: bool = False,
                sms: int = _H100_SMS) -> Plan:
    """The kernels' launch plan for ``N`` queries against ``Nk`` keys (the
    one the wrappers pass to the C entry points); ``Nk`` None means
    ``N``, self-attention.  Forward: items of 128 query rows of one head
    (a warpgroup with no row before N takes no products), walked by one
    persistent block per SM (``sms``) or per item where there are fewer;
    64-key tiles (the last one masked), as many stages as key tiles up to
    8.  Backward: blocks of 128 keys (a warpgroup with no key before Nk
    takes no products), 64-query tiles, as many stages as query tiles up
    to 4, and a dQ accumulator of ``ceil(N / 64) * 64`` rows.  Both pad
    the products to ``ceil(N / 64) * 64`` rows and ``ceil(Nk / 64) * 64``
    keys.  Shapes the kernels do not take raise."""
    Nk = N if Nk is None else Nk
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if B < 1 or H < 1 or N < 1 or Nk < 1:
        raise ValueError(f"no flash attention launch for B, H, Nq, Nk = "
                         f"{B}, {H}, {N}, {Nk}")
    if backward and B * H > _MAX_BH:
        raise ValueError(f"B*H = {B * H} exceeds {_MAX_BH}")
    tile = 64 * D * 2                       # 64 rows of one operand
    if backward:
        n_qt = -(-N // _BWD_Q)
        stages = min(_BWD_STAGES, n_qt)
        stage = -(-(2 * tile + _BWD_STATS) // _ALIGN) * _ALIGN
        # K and V of 128 keys, two dS^T buffers (128 x 64 bf16), barriers
        smem = (_ALIGN + 4 * tile + 2 * _BWD_K * _BWD_Q * 2
                + stages * stage + (2 * _BWD_STAGES + 1) * 8)
        plan = Plan(_BWD_Q, _BWD_K, stages, (-(-Nk // _BWD_K), B * H),
                    smem, n_qt * _BWD_Q)
    else:
        stages = min(_FWD_STAGES, -(-Nk // _FWD_K))
        # two slots of two Q tiles, stages of a K and a V tile, barriers
        smem = (_ALIGN + 4 * tile + stages * 2 * tile
                + (2 * _FWD_STAGES + 4) * 8)
        items = -(-N // _FWD_Q) * B * H
        if items > _MAX_ITEMS:
            raise ValueError(f"{items} items of 128 rows exceed "
                             f"{_MAX_ITEMS}")
        plan = Plan(_FWD_Q, _FWD_K, stages, (min(items, sms), 1), smem, 0)
    if plan.smem_bytes > _SMEM_MAX:
        raise ValueError(f"the flash plan needs {plan.smem_bytes} bytes of "
                         f"shared memory, more than {_SMEM_MAX}")
    return plan


def _plan_arg(plan: Plan):
    return (ctypes.c_int * 7)(plan.block_q, plan.block_k, plan.stages,
                              *plan.grid, plan.smem_bytes, plan.dq_rows)


def flash_attention_bhnd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *,
                                   scale: Optional[float] = None,
                                   return_lse: bool = False):
    """Plain version over q ``(B, H, Nq, D)`` and k, v ``(B, H, Nk, D)``:
    fp32 scores, max-subtracted softmax, P rounded to V's dtype for the PV
    product, normalised after it (the TPU kernel's arithmetic).
    ``return_lse`` also returns the fp32 ``(B, H, Nq)`` log-sum-exp of the
    scaled scores, as the kernel writes it for training."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    o = (o / l).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor, *,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain backward over q, dO ``(B, H, Nq, D)`` and k, v ``(B, H, Nk,
    D)``, the TPU kernels' arithmetic
    (``_bwd_fused_kernel``): P recomputed in fp32 and normalised;
    dV = P(in dO's dtype)ᵀ·dO; dP = dO·Vᵀ in fp32; Di = rowsum(P∘dP);
    dS = P∘(dP − Di)·scale rounded to Q's dtype; dQ = dS·K, dK = dSᵀ·Q,
    all with fp32 accumulation.  Returns ``(dq, dk, dv)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    di = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - di) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(queries, keys):
    """What both kernels take: bf16 CUDA tensors, ``queries`` (the first
    one q) of q's (B, H, Nq, D) shape and ``keys`` (the first one k) of
    k's (B, H, Nk, D), one B, H and D (launch_plan checks D).  Each is a
    sequence of (name, tensor)."""
    q, k = queries[0][1], keys[0][1]
    dev = q.device
    if q.dim() != 4 or k.dim() != 4 or (k.shape[:2], k.shape[3]) != (
            q.shape[:2], q.shape[3]):
        raise ValueError(f"q (B, H, Nq, D) and k (B, H, Nk, D) must agree "
                         f"in B, H and D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    for (name, x), shape in ([(nx, q.shape) for nx in queries]
                             + [(nx, k.shape) for nx in keys]):
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16, {name} is "
                            f"{x.dtype}")


def _takes_rows(x: torch.Tensor) -> bool:
    """The kernels read and write 16-byte rows: unit stride along D,
    (batch, head, row) strides that are multiples of 8, 16-byte aligned."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _strides(*named):
    out = []
    for name, x in named:
        if not _takes_rows(x):
            raise ValueError(
                f"the kernel reads 16-byte rows: {name} needs unit stride "
                f"along D, strides that are multiples of 8 and a 16-byte "
                f"aligned pointer, got strides {x.stride()}")
        out.extend(x.stride()[:3])
    return (ctypes.c_longlong * len(out))(*out)


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    if (lse.dtype != torch.float32 or lse.shape != q.shape[:3]
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 "
                         f"{tuple(q.shape[:3])} tensor on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    """The forward's C entry point, built and loaded on first use."""
    fn = _build.load("flash_attention_fwd").flash_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    """The backward's C entry point, built and loaded on first use."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(q, k, v, o, lse, scale: float) -> None:
    """Launch the forward kernel on the current stream with
    :func:`launch_plan`'s plan; ``o`` may be any view with unit stride
    along D (e.g. into a (B, N, H, D) buffer); ``lse`` is a contiguous
    fp32 (B, H, Nq) buffer or None."""
    _check((("q", q), ("o", o)), (("k", k), ("v", v)))
    if lse is not None:
        _check_lse(lse, q)
    B, H, N, D = q.shape
    Nk = k.shape[2]
    if not B * H * N:
        return
    strides = _strides(("q", q), ("k", k), ("v", v), ("o", o))
    plan = _plan_arg(launch_plan(B, H, N, D, Nk=Nk,
                                 sms=sm_count(q.device)))
    fn = _fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, H, N, Nk, D,
                 ctypes.cast(strides, ctypes.c_void_p),
                 ctypes.cast(plan, ctypes.c_void_p), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bhnd.launches += 1


def _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, scale: float) -> None:
    """Launch the backward's three kernels on the current stream with
    :func:`launch_plan`'s plan: the fp32 scratch (log2(e) LSE and Di, the
    dQ accumulator) comes from the caching allocator; dq, dk and dv may be
    any views with unit stride along D."""
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
             ("dq", dq), ("dk", dk), ("dv", dv))
    _check((("q", q), ("o", o), ("do", do), ("dq", dq)),
           (("k", k), ("v", v), ("dk", dk), ("dv", dv)))
    _check_lse(lse, q)
    B, H, N, D = q.shape
    Nk = k.shape[2]
    if not B * H * N:
        return
    strides = _strides(*named)
    plan = launch_plan(B, H, N, D, Nk=Nk, backward=True)
    stats = torch.empty((B * H, 2, plan.dq_rows), dtype=torch.float32,
                        device=q.device)
    dq_acc = torch.empty((B * H, plan.dq_rows, D), dtype=torch.float32,
                         device=q.device)
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                 dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, N, Nk, D,
                 ctypes.cast(strides, ctypes.c_void_p),
                 ctypes.cast(_plan_arg(plan), ctypes.c_void_p), float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd.launches += 1


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: Optional[float] = None,
                        out: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """The forward over q ``(B, H, Nq, D)`` and k, v ``(B, H, Nk, D)``
    views into ``out`` (q's shape; a new contiguous tensor when None).
    ``return_lse`` also returns the fp32 ``(B, H, Nq)`` log-sum-exp,
    natural log, that the backward reads."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        o, lse = flash_attention_bhnd_reference(q, k, v, scale=scale,
                                                return_lse=True)
        if out is not None:
            o = out.copy_(o)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    _launch_fwd(q, k, v, out, lse, scale)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, scale: Optional[float] = None,
                        dq: Optional[torch.Tensor] = None,
                        dk: Optional[torch.Tensor] = None,
                        dv: Optional[torch.Tensor] = None):
    """Gradients of attention over q, o, dO ``(B, H, Nq, D)`` and k, v
    ``(B, H, Nk, D)`` views, from the forward's output ``o`` and
    log-sum-exp ``lse``.  ``dq``, ``dk`` and
    ``dv`` are written in place when given (any views with unit stride
    along D), else allocated.  Returns ``(dq, dk, dv)``.

    On CPU tensors the plain version runs (it recomputes P and reads
    neither ``o`` nor ``lse``).  ``flash_attention_bwd.launches`` counts
    kernel launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        grads = flash_attention_bwd_reference(q, k, v, do, scale=scale)
        return tuple(g if buf is None else buf.copy_(g)
                     for g, buf in zip(grads, (dq, dk, dv)))
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                  if buf is None else buf
                  for x, buf in ((q, dq), (k, dk), (v, dv)))
    _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, scale)
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it, else a contiguous copy
    (an incoming gradient may be expanded or oddly strided)."""
    if x.device.type == "cuda" and not _takes_rows(x):
        return x.contiguous()
    return x


class _FlashAttention(torch.autograd.Function):
    """Differentiable attention over q ``(B, H, Nq, D)`` and k, v ``(B, H,
    Nk, D)`` views."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, _rows(dout),
                                         scale=ctx.scale)
        return dq, dk, dv, None


class _FlashAttentionQKV(torch.autograd.Function):
    """Differentiable attention over the fused ``(B, N, 3, H, D)`` qkv
    projection, ``(B, N, H, D)`` out.  The backward writes dq, dk and dv
    through strides into one gradient of qkv's shape: no stack, no copy."""

    @staticmethod
    def forward(ctx, qkv, scale):
        B, N, _, H, D = qkv.shape
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        out = qkv.new_empty((B, N, H, D))
        _, lse = flash_attention_fwd(q, k, v, scale=scale,
                                     out=out.transpose(1, 2), return_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        dq, dk, dv = (x.transpose(1, 2) for x in dqkv.unbind(2))
        flash_attention_bwd(q, k, v, out.transpose(1, 2), lse,
                            _rows(dout).transpose(1, 2), scale=ctx.scale,
                            dq=dq, dk=dk, dv=dv)
        return dqkv, None


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``(B, H, Nq, D)`` over k, v ``(B, H, Nk, D)``, the
    kernel's native layout; differentiable.

    ``flash_attention_bhnd.launches`` counts forward kernel launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, float(scale))
    return flash_attention_fwd(q, k, v, scale=scale)


flash_attention_bhnd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``(B, Nq, H, D)`` over k, v ``(B, Nk, H, D)`` (the
    JAX package's layout); differentiable.

    On CUDA the kernel reads the inputs through their strides and, without
    grad, writes a contiguous ``(B, N, H, D)`` result, so no transposed
    copies are made.  (The model's call, with grad, is
    :func:`flash_attention_qkv`.)"""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(qt, kt, vt, float(scale)).transpose(1, 2)
    if q.device.type == "cpu":
        return flash_attention_bhnd_reference(
            qt, kt, vt, scale=scale).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention_fwd(qt, kt, vt, scale=scale, out=out.transpose(1, 2))
    return out


def flash_attention_qkv(qkv: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention over the fused ``(B, N, 3, H, D)`` qkv projection, the
    model's call; ``(B, N, H, D)`` out.  With grad, the backward fills one
    ``(B, N, 3, H, D)`` gradient in place."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, D), got "
                         f"{tuple(qkv.shape)}")
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    if _needs_grad(qkv):
        return _FlashAttentionQKV.apply(qkv, float(scale))
    return flash_attention(*qkv.unbind(2), scale=scale)
