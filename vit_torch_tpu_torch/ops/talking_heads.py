"""CaiT talking-heads attention: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Counterpart of ``vit_torch_tpu/ops/talking_heads.py``: the kernels of
``csrc/talking_heads.cu`` replace both Pallas kernels there, ``_kernel``
(the ``(B, H, N, D)`` layout) and ``_kernel_v2`` (the head-concatenated
``(B, N, C)`` layout), which compute one function:

    S'_j = sum_i wl[i, j] * scale * Q_i K_i^T + bl[j]
    A_j  = sum_i ww[i, j] * softmax(S'_i) + bw[j]
    O_j  = A_j V_j

with fp32 scores, mixes and softmax and ``A`` rounded to the activation
dtype for PV (the einsum reference ``_ref_forward``).  ``wl`` and ``ww``
are ``(H, H)`` in the JAX layout (``wl[i, j]`` mixes head ``i`` into head
``j``: the transpose of timm's ``proj_l.weight``); ``bl`` and ``bw`` are
``(H,)``.  The source note gives the design (three launches: the softmax
statistics, the mixed weights A into a scratch, then O = A V) and the
bound.  The TPU's ``fits``/``fits_v2`` VMEM budgets have no counterpart:
on CUDA the kernels take every talking-heads attention of every
``CAIT_CONFIGS`` entry.

Dispatch is by the tensors' device: a CPU tensor runs the plain version
(:func:`talking_heads_reference`); a CUDA tensor launches the kernels, or
raises if they do not take the input.  There is no fallback.

Gradients: as in the JAX package (``_th_bwd``, ``_th_v2_bwd``), the
backward is not a kernel.  It recomputes the forward through the plain
version under autograd (:func:`talking_heads_bwd`), on either device.
:func:`talking_heads_attention_qkv` takes the model's fused
``(B, N, 3, H, D)`` qkv projection itself, so its backward returns one
gradient of that shape.

Counters: ``talking_heads_attention.launches`` counts the calls that
launch the kernels (three launches each),
``talking_heads_reference.calls`` the plain version run as a forward, and
``talking_heads_bwd.calls`` the backward's recomputes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.gemm import sm_count

HEAD_DIMS = (16, 32, 48, 64)
MAX_HEADS = 16
# the kernels stream the keys, and their scratch holds the mixed weights,
# 2 B H N^2 bytes; this cap is well past every CaiT config (cait_m48_448:
# N = 784)
MAX_TOKENS = 16384
_MAX_BATCH = 65535        # B rides in gridDim.z
_H100_SMS = 132
# csrc/talking_heads.cu: query rows a block, keys a K ring slot, the ring's
# bound, the shared memory a block may use (two blocks an SM: half an SM's
# 228 KB less the 1 KB each block reserves); launch 3's value tile (keys)
# and ring slots
_ROWS, _KEYS, _MAX_SLOTS = 64, 16, 8
_SMEM_MAX, _SMEM_HALF = 232448, 115712
_PV_KEYS, _PV_SLOTS = 64, 4


class Plan(NamedTuple):
    """How ``csrc/talking_heads.cu``'s three launches run: launches 1 and 2
    over ``grid`` (row tiles, key ``parts``, images), ``blocks_per_sm`` of
    them an SM, each with a ring of ``slots`` 16-key tiles of K of every
    head (padded to ``padded_heads``: 4, 8 or 16) in ``smem_bytes`` of
    shared memory; launch 3 over ``pv_grid`` (row tiles, heads, images) in
    ``pv_smem_bytes``; the scratch between them, ``stats_bytes`` of softmax
    statistics and ``mix_bytes`` of mixed weights."""
    padded_heads: int
    blocks_per_sm: int
    parts: int
    grid: Tuple[int, int, int]
    slots: int
    smem_bytes: int
    pv_grid: Tuple[int, int, int]
    pv_smem_bytes: int
    stats_bytes: int
    mix_bytes: int


def _parts(blocks: int, tiles: int, slots: int) -> int:
    """Key parts of a row tile: the fewest that minimise waves x (16-key
    tiles a block + 1, its set-up), over ``blocks`` (row tiles x images),
    ``tiles`` and ``slots`` block slots of the card."""
    def cost(p):
        return -(-blocks * p // slots) * (-(-tiles // p) + 1)
    parts = min(range(1, min(tiles, 64) + 1), key=lambda p: (cost(p), p))
    return -(-tiles // -(-tiles // parts))      # no part left empty


@functools.lru_cache(maxsize=256)
def talking_heads_plan(B: int, H: int, N: int, D: int, *,
                       sms: int = _H100_SMS) -> Plan:
    """The kernels' plan for ``(B, H, N, D)`` on a card of ``sms`` SMs.  A
    block of launches 1 and 2 keeps its 64 query rows of every head (``D``
    read as 64 columns above 32, else 32) in shared memory beside as many
    ring slots as fit (2 to 8).  What the kernels do not take raises.
    Cached: a model asks for the same few shapes at every call."""
    if (D not in HEAD_DIMS or not 1 <= H <= MAX_HEADS or N < 1 or B < 1
            or B > _MAX_BATCH):
        raise ValueError(f"no talking-heads plan for (B, H, N, D) = "
                         f"{(B, H, N, D)}")
    mh = next(m for m in (4, 8, 16) if H <= m)
    per_sm = 2 if mh <= 8 else 1
    row_bytes = 128 if D > 32 else 64
    slot = mh * _KEYS * row_bytes
    fixed = (1024 + mh * _ROWS * row_bytes + (2 * mh * mh + 2 * mh) * 4
             + mh * _ROWS * 8 + (2 * _MAX_SLOTS + 1) * 8)
    limit = _SMEM_HALF if per_sm == 2 else _SMEM_MAX
    slots = min(_MAX_SLOTS, (limit - fixed) // slot)
    rows, tiles = -(-N // _ROWS), -(-N // _KEYS)
    parts = _parts(rows * B, tiles, sms * per_sm)
    return Plan(mh, per_sm, parts, (rows, parts, B), slots,
                fixed + slots * slot, (rows, H, B),
                1024 + _PV_SLOTS * _PV_KEYS * row_bytes + 2 * _PV_SLOTS * 8,
                B * parts * mh * rows * _ROWS * 8,
                B * H * rows * _ROWS * tiles * _KEYS * 2)


def _reference(q, k, v, wl, bl, ww, bw, scale: float) -> torch.Tensor:
    """The einsum chain over ``(B, H, N, D)``, differentiable."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.einsum("bhqk,hg->bgqk", s, wl.float())
    s = s + bl.float()[None, :, None, None]
    attn = torch.softmax(s, dim=-1)
    attn = torch.einsum("bhqk,hg->bgqk", attn, ww.float())
    attn = attn + bw.float()[None, :, None, None]
    out = torch.einsum("bhqk,bhkd->bhqd", attn.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def talking_heads_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            wl: torch.Tensor, bl: torch.Tensor,
                            ww: torch.Tensor, bw: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain version over ``(B, H, N, D)``, the JAX ``_ref_forward``: fp32
    scores ``q·kᵀ·scale``, the ``wl`` mix plus ``bl``, exact fp32 softmax,
    the ``ww`` mix plus ``bw``, rounded to q's dtype, PV with fp32 sums.
    Differentiable through autograd."""
    talking_heads_reference.calls += 1
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _reference(q, k, v, wl, bl, ww, bw, float(scale))


talking_heads_reference.calls = 0


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(B, N, C)`` → a ``(B, H, N, D)`` view."""
    B, N, C = x.shape
    return x.view(B, N, num_heads, C // num_heads).transpose(1, 2)


def talking_heads_bnc_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, wl: torch.Tensor,
                                bl: torch.Tensor, ww: torch.Tensor,
                                bw: torch.Tensor, *, num_heads: int,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Plain version over the head-concatenated ``(B, N, C)`` layout, the
    JAX ``_ref_forward_bnc`` (``bl`` included)."""
    B, N, C = q.shape
    out = talking_heads_reference(*(_heads(x, num_heads) for x in (q, k, v)),
                                  wl, bl, ww, bw, scale=scale)
    return out.transpose(1, 2).reshape(B, N, C)


def talking_heads_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      wl: torch.Tensor, bl: torch.Tensor, ww: torch.Tensor,
                      bw: torch.Tensor, do: torch.Tensor, *,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Gradients of the ``(B, H, N, D)`` function by recomputing the plain
    version under autograd (the JAX ``_th_bwd``'s ``jax.vjp`` of the
    reference): ``(dq, dk, dv, dwl, dbl, dww, dbw)``, each in its input's
    dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _recompute(lambda *a: _reference(*a, float(scale)),
                      (q, k, v, wl, bl, ww, bw), do)


talking_heads_bwd.calls = 0


def _recompute(fn, inputs, dout) -> Tuple[torch.Tensor, ...]:
    talking_heads_bwd.calls += 1
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, dout)


def _takes_rows(x: torch.Tensor) -> bool:
    """The kernel reads and writes 16-byte rows: unit stride along D,
    (batch, head, row) strides that are multiples of 8, 16-byte aligned."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check(q, k, v, out, tables) -> Tuple[int, int, int, int]:
    """What the kernel takes: bf16 ``(B, H, N, D)`` CUDA views of one shape
    and device that :func:`_takes_rows` accepts, D a multiple of 16 up to
    64, H up to 16, N up to :data:`MAX_TOKENS`; fp32 ``(H, H)`` and
    ``(H,)`` tables on the same device."""
    shape, dev = q.shape, q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.dim() != 4 or x.shape != shape:
            raise ValueError(f"{name} must have q's (B, H, N, D) shape "
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
    B, H, N, D = shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{H} heads: the kernel takes 1 to {MAX_HEADS}")
    if N > MAX_TOKENS:
        raise ValueError(f"{N} tokens exceed the kernel's {MAX_TOKENS}")
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the grid's {_MAX_BATCH}")
    for name, x, want in zip(("wl", "bl", "ww", "bw"), tables,
                             ((H, H), (H,), (H, H), (H,))):
        if x.dtype != torch.float32 or x.shape != want or x.device != dev:
            raise ValueError(f"{name} must be a float32 {want} tensor on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    return B, H, N, D


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    """The kernel's C entry point, built and loaded on first use."""
    fn = _build.load("talking_heads").talking_heads_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float] + [
        ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def launch_talking_heads(q, k, v, out, wl, bl, ww, bw, scale: float) -> None:
    """Launch the three kernels on the current stream: ``q``, ``k``, ``v``
    and ``out`` are ``(B, H, N, D)`` bf16 CUDA views with unit stride along D
    (e.g. into the ``(B, N, 3, H, D)`` qkv projection and a
    ``(B, N, H, D)`` buffer); the tables are read through their strides
    (e.g. a transposed ``Linear(H, H)`` weight), so no copy is made.  The
    plan is :func:`talking_heads_plan`'s; the scratch between the
    launches is allocated here."""
    tables = (wl, bl, ww, bw)
    B, H, N, D = _check(q, k, v, out, tables)
    if not B * N:
        return
    plan = talking_heads_plan(B, H, N, D, sms=sm_count(q.device))
    scratch = torch.empty(plan.stats_bytes + plan.mix_bytes,
                          dtype=torch.uint8, device=q.device)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    strides = (ctypes.c_longlong * len(strides))(*strides)
    table_strides = (ctypes.c_longlong * 6)(*wl.stride(), *ww.stride(),
                                            *bl.stride(), *bw.stride())
    launch = (ctypes.c_int * 3)(plan.slots, plan.parts, plan.smem_bytes)
    fn = _fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *(x.data_ptr() for x in tables), B, H, N, D,
                 ctypes.cast(strides, ctypes.c_void_p),
                 ctypes.cast(table_strides, ctypes.c_void_p), float(scale),
                 ctypes.cast(launch, ctypes.c_void_p), scratch.data_ptr(),
                 scratch.data_ptr() + plan.stats_bytes,
                 stream)
    if err != 0:
        raise RuntimeError(f"talking_heads_fwd launch failed: CUDA error "
                           f"{err}")
    talking_heads_attention.launches += 1


def _attention_fwd(q, k, v, wl, bl, ww, bw, scale, out=None) -> torch.Tensor:
    """The forward without autograd over ``(B, H, N, D)`` views: the plain
    version on CPU tensors, the kernel on CUDA tensors (into ``out``, a new
    contiguous tensor when None)."""
    if q.device.type == "cpu":
        o = talking_heads_reference(q, k, v, wl, bl, ww, bw, scale=scale)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"no talking-heads attention for device {q.device}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_talking_heads(q, k, v, out, wl, bl, ww, bw, scale)
    return out


def _qkv_fwd(qkv, wl, bl, ww, bw, scale) -> torch.Tensor:
    """The forward without autograd over the fused ``(B, N, 3, H, D)`` qkv
    projection: q, k, v as strided views, a new ``(B, N, H, D)`` out."""
    B, N, _, H, D = qkv.shape
    out = qkv.new_empty((B, N, H, D))
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    _attention_fwd(q, k, v, wl, bl, ww, bw, scale, out=out.transpose(1, 2))
    return out


class _TalkingHeads(torch.autograd.Function):
    """Differentiable talking-heads attention over ``(B, H, N, D)`` views;
    the backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, wl, bl, ww, bw, scale):
        ctx.save_for_backward(q, k, v, wl, bl, ww, bw)
        ctx.scale = scale
        return _attention_fwd(q, k, v, wl, bl, ww, bw, scale)

    @staticmethod
    def backward(ctx, dout):
        return (*talking_heads_bwd(*ctx.saved_tensors, dout,
                                   scale=ctx.scale), None)


class _TalkingHeadsQKV(torch.autograd.Function):
    """Differentiable talking-heads attention over the fused
    ``(B, N, 3, H, D)`` qkv projection, ``(B, N, H, D)`` out.  The backward
    recomputes with qkv itself as the leaf, so it returns one gradient of
    qkv's shape."""

    @staticmethod
    def forward(ctx, qkv, wl, bl, ww, bw, scale):
        ctx.save_for_backward(qkv, wl, bl, ww, bw)
        ctx.scale = scale
        return _qkv_fwd(qkv, wl, bl, ww, bw, scale)

    @staticmethod
    def backward(ctx, dout):
        def fn(qkv, wl, bl, ww, bw):
            q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
            return _reference(q, k, v, wl, bl, ww, bw,
                              ctx.scale).transpose(1, 2)

        return (*_recompute(fn, ctx.saved_tensors, dout), None)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def talking_heads_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, wl: torch.Tensor,
                            bl: torch.Tensor, ww: torch.Tensor,
                            bw: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Talking-heads attention over ``(B, H, N, D)`` tensors (row 10's
    layout); differentiable in every tensor input.

    ``talking_heads_attention.launches`` counts the calls that launch the
    kernels, from every entry point."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v, wl, bl, ww, bw):
        return _TalkingHeads.apply(q, k, v, wl, bl, ww, bw, float(scale))
    return _attention_fwd(q, k, v, wl, bl, ww, bw, scale)


talking_heads_attention.launches = 0


def talking_heads_attention_bnc(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, wl: torch.Tensor,
                                bl: torch.Tensor, ww: torch.Tensor,
                                bw: torch.Tensor, *, num_heads: int,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Talking-heads attention over ``(B, N, C)`` tensors with the heads
    concatenated along C (row 11's layout); differentiable.  The kernel
    reads the heads as strided views and, without grad, writes a
    contiguous ``(B, N, C)`` result."""
    B, N, C = q.shape
    if scale is None:
        scale = (C // num_heads) ** -0.5
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    if _needs_grad(q, k, v, wl, bl, ww, bw):
        out = _TalkingHeads.apply(qh, kh, vh, wl, bl, ww, bw, float(scale))
        return out.transpose(1, 2).reshape(B, N, C)
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    _attention_fwd(qh, kh, vh, wl, bl, ww, bw, scale,
                   out=_heads(out, num_heads))
    return out


def talking_heads_attention_qkv(qkv: torch.Tensor, wl: torch.Tensor,
                                bl: torch.Tensor, ww: torch.Tensor,
                                bw: torch.Tensor, *,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Talking-heads attention over the fused ``(B, N, 3, H, D)`` qkv
    projection, the model's call; ``(B, N, H, D)`` out.  With grad, the
    backward returns one ``(B, N, 3, H, D)`` gradient and the four tables'
    gradients in fp32."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, D), got "
                         f"{tuple(qkv.shape)}")
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    if _needs_grad(qkv, wl, bl, ww, bw):
        return _TalkingHeadsQKV.apply(qkv, wl, bl, ww, bw, float(scale))
    return _qkv_fwd(qkv, wl, bl, ww, bw, scale)
