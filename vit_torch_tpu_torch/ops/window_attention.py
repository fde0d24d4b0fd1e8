"""Swin window attention: hand-written CUDA kernels for Hopper, forward and
backward, and their plain PyTorch versions.

Counterpart of ``vit_torch_tpu/ops/window_attention.py``: the kernel
``csrc/window_attention_fwd.cu`` replaces the Pallas ``_fwd_kernel`` and
``csrc/window_attention_bwd.cu`` replaces ``_bwd_kernel``.  The forward
computes ``softmax(scale * Q K^T + bias[h] + mask[i mod nW]) V`` for every
window ``i`` and head ``h`` of ``(Bn, N, H, D)`` tensors (the flax layout,
``Bn = B * nW`` windows flattened window-major per image), with exact
softmax rows: fp32 scores, the row max subtracted, P rounded to V's dtype
for the PV product and the row sum divided out after it.  The backward
recomputes P and returns dq, dk, dv and ``dbias[h] = sum over windows of
dS`` (fp32); the mask gets no gradient.

Layout contracts (the JAX module's):

- ``bias``: ``(H, N, N)`` fp32, the relative-position bias gathered from
  its table outside the kernel (so the table's gradient stays an autograd
  gather);
- ``mask``: ``(nW, N, N)`` additive fp32 (the shifted-window mask), or
  None; window ``i`` takes row ``i mod nW``.

Dispatch is by the tensors' device: a CPU tensor runs the plain versions
(:func:`window_attention_reference`, :func:`window_attention_bwd_reference`);
a CUDA tensor launches the kernels, or raises if a kernel does not take the
input.  There is no fallback.  When an input requires grad, the entry
points go through a ``torch.autograd.Function`` whose backward is
:func:`window_attention_bwd`; :func:`window_attention_qkv` takes the
window-major ``(Bn, N, 3, H, D)`` qkv projection itself, so its backward
writes dq, dk and dv into one gradient of that shape.

The Swin block kernels of :mod:`.window_block` launch the forward kernel as
their attention core, through :func:`launch_window_attention`, so
``window_attention.launches`` counts every launch of the core and
``window_attention_bwd.launches`` every launch of the backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.gemm import needs_grad, sm_count

HEAD_DIM = 32          # every Swin config has head dim 32
MAX_TOKENS = 144       # N = w^2 up to window 12
# csrc/window_attention_fwd.cu: its instances' key widths (N padded), its
# ring's bounds, the shared memory a block may use, the H100 SXM's SMs
CORE_KEYS = (16, 32, 64, 144)
_CORE_MAX_STAGES = 6
# csrc/window_attention_bwd.cu: the ring's bound (keys <= 64), its
# barriers' bytes, the warps with live query rows at N = 144 (each keeps
# its table values in global scratch and its dbias sums in shared memory,
# keys / 2 fp32 a thread)
_BWD_MAX_STAGES = 4
_BWD_BARRIER_BYTES = 4 * _BWD_MAX_STAGES * 8
_BWD_SLOTS = 9
_SMEM_MAX = 232448
_H100_SMS = 132


class CorePlan(NamedTuple):
    """How ``csrc/window_attention_fwd.cu`` is launched: keys a window
    padded to an instance's width (S's wgmma N), query rows (64-row
    slices), groups (head ``h``, mask row ``j``: ``H * nW``), windows a
    group, windows a block, blocks a group, blocks, ring stages and the
    dynamic shared bytes.  Block ``x`` takes group ``g = x % groups``
    (``j = g // H``, ``h = g % H``: blocks that run together take the
    heads of the same windows) and the windows ``j + nW * b`` for ``b`` in
    ``[c * per_block, min(windows, (c + 1) * per_block))``,
    ``c = x // groups``: every window of a block takes mask row ``j``."""
    keys: int
    query_rows: int
    groups: int
    windows: int
    per_block: int
    chunks: int
    blocks: int
    stages: int
    smem_bytes: int


def core_plan(Bn: int, N: int, H: int, nW: int,
              sms: int = _H100_SMS) -> CorePlan:
    """The forward kernel's plan for ``Bn`` windows of ``N`` tokens, ``H``
    heads and ``nW`` mask rows (1 unmasked).  Each block stages its
    group's fp32 table (``bias[h] + mask[j]``) once, so a group's windows
    are split into runs only as far as it takes the blocks to fill the
    ``sms`` SMs; as many stages of one window's Q, K and V as shared memory
    holds, up to 6.  What the kernel does not take raises."""
    if not 1 <= N <= MAX_TOKENS or Bn < 1 or H < 1 or nW < 1 or Bn % nW:
        raise ValueError(f"no window attention plan for Bn, N, H, nW = "
                         f"{Bn}, {N}, {H}, {nW}")
    keys = next(k for k in CORE_KEYS if N <= k)
    rows = 64 * -(-keys // 64)
    groups, windows = H * nW, Bn // nW
    chunks = min(windows, max(1, sms // groups))
    per_block = -(-windows // chunks)
    chunks = -(-windows // per_block)
    stride = keys if keys % 32 in (8, 24) else keys + 8   # the table's row
    # 1 KB of alignment, each warpgroup's 64-row output slices, the table,
    # the barriers
    fixed = (1024 + 2 * (rows // 64) * 64 * HEAD_DIM * 2 + N * stride * 4
             + 2 * _CORE_MAX_STAGES * 8)
    stage = 3 * keys * HEAD_DIM * 2      # Q, K and V tiles of `keys` rows
    stages = min(_CORE_MAX_STAGES, (_SMEM_MAX - fixed) // stage)
    if stages < 2 or groups * chunks > 2 ** 31 - 1:
        raise ValueError(f"no window attention plan for Bn, N, H, nW = "
                         f"{Bn}, {N}, {H}, {nW}")
    return CorePlan(keys, rows, groups, windows, per_block, chunks,
                    groups * chunks, stages, fixed + stages * stage)


class BwdPlan(NamedTuple):
    """How ``csrc/window_attention_bwd.cu`` is launched: the forward's
    split of groups (head ``h``, mask row ``j``) into runs of windows
    (:class:`CorePlan`'s fields ``keys`` to ``blocks``), then ``split``:
    whether three consumer warpgroups share every window (keys = 144:
    query rows and keys 64 wg ... by warpgroup) or two take alternate
    windows (keys <= 64); the ring's stages (1 when split: K and V arrive
    apart from Q and dO, which have two slots); ``parts``, the (N, N)
    dbias partials the reduction sums (one a block when split, one a
    warpgroup otherwise; part ``(c * nW + j) * w + wg`` of head ``h``);
    the dynamic shared bytes; and ``table_bytes``, the global scratch of the split schedule,
    where each block keeps every thread's table values (0 otherwise)."""
    keys: int
    query_rows: int
    groups: int
    windows: int
    per_block: int
    chunks: int
    blocks: int
    split: bool
    stages: int
    parts: int
    smem_bytes: int
    table_bytes: int


def bwd_plan(Bn: int, N: int, H: int, nW: int,
             sms: int = _H100_SMS) -> BwdPlan:
    """The backward kernel's plan for ``Bn`` windows of ``N`` tokens, ``H``
    heads and ``nW`` mask rows (1 unmasked): :func:`core_plan`'s runs of
    windows, and the shared memory of the kernel's layout (1 KB of
    alignment, the P and dS tiles, then the dbias sums of every live warp
    when split or the group's fp32 table otherwise, the barriers, the
    ring).  What the kernel does not take raises."""
    core = core_plan(Bn, N, H, nW, sms)
    keys, split = core.keys, core.keys > 64
    tile = keys * HEAD_DIM * 2                   # one of Q, K, V, dO
    stride = keys if keys % 32 in (8, 24) else keys + 8   # the table's row
    per_thread = _BWD_SLOTS * 32 * keys // 2 * 4   # a float each, live warps
    if split:   # keys 0-127 in two 128-byte tiles, the rest in 64-byte rows
        bufs = 2 * (2 * keys * 128 + keys * 64)
        fixed = 1024 + bufs + per_thread + _BWD_BARRIER_BYTES
    else:       # one 64 x 64 tile a warpgroup for P, one for dS
        bufs = 4 * 64 * 128
        fixed = 1024 + bufs + N * stride * 4 + _BWD_BARRIER_BYTES
    stage = (6 if split else 4) * tile   # split: K, V and two Q/dO slots
    stages = 1 if split else min(_BWD_MAX_STAGES, (_SMEM_MAX - fixed) // stage)
    if fixed + stages * stage > _SMEM_MAX or (not split and stages < 2):
        raise ValueError(f"no window attention plan for Bn, N, H, nW = "
                         f"{Bn}, {N}, {H}, {nW}")
    parts = core.chunks * nW * (1 if split else 2)
    return BwdPlan(keys, core.query_rows, core.groups, core.windows,
                   core.per_block, core.chunks, core.blocks, split, stages,
                   parts, fixed + stages * stage,
                   core.blocks * per_thread if split else 0)


def _scores(q, k, bias, mask, scale):
    """fp32 ``scale * Q K^T + bias[h] + mask[i mod nW]`` over (Bn, H, N, N)."""
    Bn, N, H, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.view(Bn // nW, nW, H, N, N)
             + mask.float()[None, :, None]).view(Bn, H, N, N)
    return s


def window_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain version over ``(Bn, N, H, D)``: the Pallas ``_fwd_kernel``'s
    arithmetic.  Differentiable through autograd."""
    window_attention_reference.calls += 1
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                      # (Bn, H, N)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


window_attention_reference.calls = 0


def window_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, bias: torch.Tensor,
                                   mask: Optional[torch.Tensor],
                                   do: torch.Tensor, *,
                                   scale: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, ...]:
    """Plain backward over ``(Bn, N, H, D)``, the Pallas ``_bwd_kernel``'s
    arithmetic step by step: P recomputed in fp32 and normalised;
    dV = P(in dO's dtype)ᵀ·dO; dP = dO·Vᵀ in fp32; Di = rowsum(P∘dP);
    dS = P∘(dP − Di); dQ = dS(in Q's dtype)·K·scale, dK = dSᵀ·Q·scale, with
    fp32 accumulation; dbias[h] = the fp32 dS summed over windows, unrounded.
    Returns ``(dq, dk, dv, dbias)``, dbias ``(H, N, N)`` fp32."""
    window_attention_bwd_reference.calls += 1
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, mask, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    di = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - di)
    ds_lo = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lo, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lo, q.float()) * scale
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=0))


window_attention_bwd_reference.calls = 0


def _takes_rows(x: torch.Tensor) -> bool:
    """The kernels read and write 16-byte rows: unit stride along D,
    (window, row, head) strides that are multiples of 8, 16-byte aligned."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_bias_mask(bias, mask, H, N, Bn, dev) -> int:
    """The tables as the kernels read them (column pairs, 8 bytes at a
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


def _check_rows(**named) -> Tuple[int, int, int, int]:
    """What both kernels take: bf16 ``(Bn, N, H, D)`` CUDA views of one
    shape and device that :func:`_takes_rows` accepts, D = 32, N <= 144."""
    shape, dev = next(iter(named.values())).shape, None
    for name, x in named.items():
        dev = dev or x.device
        if x.dim() != 4 or x.shape != shape:
            raise ValueError(f"{name} must have q's (Bn, N, H, D) shape "
                             f"{tuple(shape)}, got {tuple(x.shape)}")
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernels take "
                             f"CUDA tensors on one device")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bfloat16, {name} is "
                            f"{x.dtype}")
        if not _takes_rows(x):
            raise ValueError(
                f"the kernels read 16-byte rows: {name} needs unit stride "
                f"along D, strides that are multiples of 8 and a 16-byte "
                f"aligned pointer, got strides {x.stride()}")
    Bn, N, H, D = shape
    if D != HEAD_DIM:
        raise ValueError(f"head dim {D} is not {HEAD_DIM}")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"{N} tokens per window: the kernels take 1 to "
                         f"{MAX_TOKENS}")
    return Bn, N, H, D


def _strides(*xs):
    out = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(out))(*out)


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    """The forward's C entry point, built and loaded on first use."""
    fn = _build.load("window_attention_fwd").window_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    """The backward's C entry point, built and loaded on first use."""
    fn = _build.load("window_attention_bwd").window_attention_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_window_attention(q, k, v, bias, mask, out, scale: float) -> None:
    """Launch the forward kernel on the current stream: ``q``, ``k``, ``v``
    and ``out`` are ``(Bn, N, H, D)`` bf16 CUDA views with unit stride
    along D (e.g. into the ``(Bn, N, 3, H, D)`` qkv projection and a
    ``(Bn, N, C)`` buffer); ``bias`` and ``mask`` as
    :func:`window_attention` takes them.  The plan is :func:`core_plan`'s."""
    Bn, N, H, D = _check_rows(q=q, k=k, v=v, out=out)
    nW = _check_bias_mask(bias, mask, H, N, Bn, q.device)
    if not Bn:
        return
    plan = core_plan(Bn, N, H, nW, sm_count(q.device))
    strides = _strides(q, k, v, out)
    fn = _fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bias.data_ptr(), None if mask is None else mask.data_ptr(),
                 Bn, H, N, D, nW, ctypes.cast(strides, ctypes.c_void_p),
                 float(scale), plan.keys, plan.per_block, plan.stages,
                 stream)
    if err != 0:
        raise RuntimeError(f"window_attention_fwd launch failed: CUDA error "
                           f"{err}")
    window_attention.launches += 1


def _attention_fwd(q, k, v, bias, mask, scale, out=None) -> torch.Tensor:
    """The forward without autograd: the plain version on CPU tensors, the
    kernel on CUDA tensors (into ``out``, a new contiguous tensor when
    None)."""
    if q.device.type == "cpu":
        o = window_attention_reference(q, k, v, bias, mask, scale=scale)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"no window attention for device {q.device}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_window_attention(q, k, v, bias, mask, out, scale)
    return out


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         do: torch.Tensor, *, scale: Optional[float] = None,
                         dq: Optional[torch.Tensor] = None,
                         dk: Optional[torch.Tensor] = None,
                         dv: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Gradients of window attention over ``(Bn, N, H, D)`` views: returns
    ``(dq, dk, dv, dbias)``, dbias an ``(H, N, N)`` fp32 tensor.  ``dq``,
    ``dk`` and ``dv`` are written in place when given (any views with unit
    stride along D, e.g. into one ``(Bn, N, 3, H, D)`` gradient), else
    allocated.

    On CPU tensors the plain version runs; on CUDA tensors the kernel
    (two launches: the window loop with per-block dbias sums, then their
    fixed-order reduction; the plan is :func:`bwd_plan`'s).
    ``window_attention_bwd.launches`` counts kernel launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        *grads, dbias = window_attention_bwd_reference(q, k, v, bias, mask,
                                                       do, scale=scale)
        return (*(g if buf is None else buf.copy_(g)
                  for g, buf in zip(grads, (dq, dk, dv))), dbias)
    if q.device.type != "cuda":
        raise ValueError(f"no window attention for device {q.device}")
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  if buf is None else buf for buf in (dq, dk, dv))
    Bn, N, H, D = _check_rows(q=q, k=k, v=v, do=do, dq=dq, dk=dk, dv=dv)
    nW = _check_bias_mask(bias, mask, H, N, Bn, q.device)
    dbias = torch.zeros((H, N, N), dtype=torch.float32, device=q.device)
    if not Bn:
        return dq, dk, dv, dbias
    plan = bwd_plan(Bn, N, H, nW, sm_count(q.device))
    partial = torch.empty((plan.parts, H, N, N), dtype=torch.float32,
                          device=q.device)
    tab = (torch.empty(plan.table_bytes, dtype=torch.uint8, device=q.device)
           if plan.table_bytes else None)
    strides = _strides(q, k, v, do, dq, dk, dv)
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 bias.data_ptr(), None if mask is None else mask.data_ptr(),
                 partial.data_ptr(), None if tab is None else tab.data_ptr(),
                 dbias.data_ptr(), Bn, H, N, D, nW,
                 ctypes.cast(strides, ctypes.c_void_p), float(scale),
                 plan.keys, plan.per_block, plan.stages, plan.parts, stream)
    if err != 0:
        raise RuntimeError(f"window_attention_bwd launch failed: CUDA error "
                           f"{err}")
    window_attention_bwd.launches += 1
    return dq, dk, dv, dbias


window_attention_bwd.launches = 0


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it, else a contiguous copy
    (an incoming gradient may be expanded or oddly strided)."""
    if x.device.type == "cuda" and not _takes_rows(x):
        return x.contiguous()
    return x


class _WindowAttention(torch.autograd.Function):
    """Differentiable window attention over ``(Bn, N, H, D)`` views."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale = scale
        return _attention_fwd(q, k, v, bias, mask, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(q, k, v, bias, mask,
                                                 _rows(dout), scale=ctx.scale)
        return dq, dk, dv, dbias, None, None


class _WindowAttentionQKV(torch.autograd.Function):
    """Differentiable window attention over the window-major
    ``(Bn, N, 3, H, D)`` qkv projection, ``(Bn, N, H, D)`` out.  The
    backward writes dq, dk and dv through strides into one gradient of
    qkv's shape: no stack, no copy."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.scale = scale
        return _attention_fwd(*qkv.unbind(2), bias, mask, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        _, _, _, dbias = window_attention_bwd(
            *qkv.unbind(2), bias, mask, _rows(dout), scale=ctx.scale,
            **dict(zip(("dq", "dk", "dv"), dqkv.unbind(2))))
        return dqkv, dbias, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     *, scale: Optional[float] = None) -> torch.Tensor:
    """Window attention over ``(Bn, N, H, D)`` tensors (the flax layout);
    ``(Bn, N, H, D)`` out, contiguous on CUDA.  Differentiable in q, k, v
    and bias.

    ``window_attention.launches`` counts forward kernel launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if needs_grad(q, k, v, bias):
        return _WindowAttention.apply(q, k, v, bias, mask, float(scale))
    return _attention_fwd(q, k, v, bias, mask, scale)


window_attention.launches = 0


def window_attention_qkv(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Window attention over the window-major ``(Bn, N, 3, H, D)`` qkv
    projection; ``(Bn, N, H, D)`` out.  With grad, the backward fills one
    ``(Bn, N, 3, H, D)`` gradient in place."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (Bn, N, 3, H, D), got "
                         f"{tuple(qkv.shape)}")
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    if needs_grad(qkv, bias):
        return _WindowAttentionQKV.apply(qkv, bias, mask, float(scale))
    return _attention_fwd(*qkv.unbind(2), bias, mask, scale)
