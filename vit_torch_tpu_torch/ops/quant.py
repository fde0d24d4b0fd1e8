"""Dynamic W8A8 int8 products for the serving path: two hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of ``vit_torch_tpu/ops/quant.py`` (``:39-117``), standard
dynamic post-training quantisation:

- weights: symmetric int8 per output channel (``scale = absmax / 127 +
  1e-8``).  The port's weights are torch's ``(N, K)``, so an output
  channel is a row, and one row quantisation (Q1) serves weights and
  activations alike;
- activations: symmetric int8 per token (per row), computed on the fly;
- the product accumulates in s32, is rescaled per row and per column in
  fp32 (+ bias) and cast to the caller's dtype (Q2).

On CUDA, Q1 is ``csrc/w8a8.cu``'s ``quantize_rows_kernel`` (a team of
threads a row holding it in registers, read once; :func:`quant_plan`) and
Q2 its ``w8a8_gemm_kernel`` (wgmma ``s32.s8.s8`` fed by TMA, the rescaled
output leaving through shared memory by TMA stores); the source note
gives their arithmetic, bounds and design.  Dispatch is by the tensors'
device: CPU tensors run the plain versions
(:func:`quantize_rowwise_reference`, :func:`int8_gemm_reference`); CUDA
tensors launch the kernels or raise, with no fallback.  The plain versions
compute what the kernels compute, bit for bit: IEEE divisions (a divisor
held as a tensor, never a Python number, which PyTorch's CUDA division
turns into a multiply by the reciprocal), round half to even, the s32 sum
exact (summed in float64, exact below 2^53), then ``(acc * x_scale) *
w_scale (+ bias)`` one rounding at a time.

The path is opt-in (``VITX_W8A8=1``, read per call) and inference only:
rounding has a zero gradient, so ``models/layers.py`` never routes a
training-mode forward through it.  ``quantize_rowwise.launches`` and
``int8_gemm.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.gemm import check, ptr, sm_count

_EPS = 1e-8
_QMAX = 127.0

# csrc/w8a8.cu: rows of 16-byte loads (Q1) and TMA rows (Q2), so K a
# multiple of 16; Q1's blocks (at most 512 threads, 256 where a row takes
# fewer) and the input a thread holds a pass (at most 128 bytes, in units
# of 16 values: 16 bytes of codes); Q2's tile heights (64 rows a consumer
# warpgroup) and widths, the widest first, k-steps of 128 int8, the
# ring's bounds, and the output slices (two 8 KB buffers a consumer
# warpgroup: 64 rows of 64 bf16 or 32 fp32 columns) with the tile's
# column scales and bias beside them
_K_ALIGN = 16
Q_THREADS = 512
Q_BLOCK = 256
Q_UNIT_BYTES = 128
BLOCK_MS = (192, 128)
BLOCK_NS = (192, 128)
_BLOCK_K = 128
_MAX_STAGES = 8
_SMEM_MAX = 232448
_SMEM_FIXED = 1024 + 2 * _MAX_STAGES * 8
SLICE_BYTES = 64 * 128


def w8a8_enabled() -> bool:
    """Opt-in flag for the int8 serving path (``VITX_W8A8=1``), read per
    call."""
    return os.environ.get("VITX_W8A8", "") == "1"


def quantize_rowwise_reference(x: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of Q1: symmetric int8 per row of the last axis, in
    fp32.  Returns ``(codes int8, scale fp32 x.shape[:-1] + (1,))``."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = absmax / torch.full_like(absmax, _QMAX) + _EPS
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def int8_gemm_reference(x_q: torch.Tensor, x_scale: torch.Tensor,
                        w_q: torch.Tensor, w_scale: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of Q2 over ``(T, K)`` codes, ``(N, K)`` weight codes,
    ``(T,)`` and ``(N,)`` scales: the exact s32 product (as float64), then
    ``(acc * x_scale) * w_scale (+ bias)`` in fp32, cast to ``out_dtype``."""
    acc = torch.matmul(x_q.double(), w_q.double().t()).to(torch.int32)
    y = acc.float() * x_scale.float()[:, None] * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


class QuantPlan(NamedTuple):
    """How ``csrc/w8a8.cu``'s row quantisation is launched: ``team``
    threads a row (a power of two), each holding ``units`` 16-element
    units of it in registers a pass, ``passes`` over the row (1 unless it
    is wider than a block of :data:`Q_THREADS` holds), ``threads`` a block
    of ``rows`` rows, and ``grid`` blocks."""
    team: int
    units: int
    passes: int
    threads: int
    rows: int
    grid: int


def quant_plan(R: int, K: int, dtype_bytes: int = 2,
               sms: int = 132) -> QuantPlan:
    """Q1's launch plan for ``R`` rows of ``K`` values of ``dtype_bytes``
    (2 bf16, 4 fp32).  A thread holds at most :data:`Q_UNIT_BYTES` of
    input a pass (4 bf16 or 2 fp32 units of 16 values): the team is the
    fewest threads (a power of two) that hold the row so, every load issued
    before the absmax.  Where the blocks would not give every SM one (few
    rows), each row is spread over more threads, fewer units each, up to
    :data:`Q_THREADS`.  A row wider than :data:`Q_THREADS` threads hold
    takes several passes.  Blocks are :data:`Q_BLOCK` threads, or one
    team.  Widths the kernel does not take raise ``ValueError``: K a
    multiple of 16."""
    if R < 1 or K < _K_ALIGN or K % _K_ALIGN or dtype_bytes not in (2, 4):
        raise ValueError(f"the row quantisation takes R >= 1 rows, K a "
                         f"multiple of {_K_ALIGN} and 2- or 4-byte values, "
                         f"got R, K = {R}, {K}, {dtype_bytes} bytes")
    units = K // _K_ALIGN
    most = Q_UNIT_BYTES // (_K_ALIGN * dtype_bytes)   # units a thread holds

    def blocks(team):
        return -(-R // (max(team, Q_BLOCK) // team))

    if units > Q_THREADS * most:
        team, per = Q_THREADS, most
    else:
        team = 1
        while team * most < units:
            team *= 2
        per = -(-units // team)
        while per > 1 and team < Q_THREADS and blocks(team) < sms:
            team *= 2
            per = -(-units // team)
    threads = max(team, Q_BLOCK)
    return QuantPlan(team, per, -(-units // (team * per)), threads,
                     threads // team, blocks(team))


class Int8Plan(NamedTuple):
    """How ``csrc/w8a8.cu``'s product is launched: the output tile
    (block_m rows, a consumer warpgroup each 64 of them, by block_n
    columns), row and column tiles, ring stages of (block_m + block_n) x
    128 int8, persistent blocks and their dynamic shared bytes (1 KB of
    alignment and the barriers, the ring, two output slice buffers of
    :data:`SLICE_BYTES` a consumer warpgroup, and the tile's column scales
    and bias)."""
    block_m: int
    block_n: int
    tiles_m: int
    tiles_n: int
    stages: int
    grid: int
    smem_bytes: int


def int8_smem_bytes(block_m: int, block_n: int, stages: int) -> int:
    """Dynamic shared bytes of one Q2 block (``csrc/w8a8.cu:smem_bytes``):
    alignment and barriers, per consumer warpgroup two output slices and
    the tile's fp32 column scales and bias, and the ring."""
    return (_SMEM_FIXED + block_m // 64 * (2 * SLICE_BYTES + 8 * block_n)
            + stages * (block_m + block_n) * _BLOCK_K)


def int8_plan(T: int, K: int, N: int, sms: int = 132) -> Int8Plan:
    """Q2's launch plan for ``T`` rows of ``K`` in, ``N`` out: of the
    tiles :data:`BLOCK_MS` x :data:`BLOCK_NS`, the one whose busiest SM
    (``ceil(tiles / sms)`` tiles) reads the fewest operand bytes, ``(block_m
    + block_n) K`` a tile (the larger tile on a tie); as many stages as
    shared memory holds beside the slices (up to 8); one persistent block
    per SM or per tile.  A slice holds 64 bf16 or 32 fp32 columns, the
    same bytes, so the plan does not depend on the output dtype.  Widths
    the kernel does not take raise ``ValueError``: K a multiple of 16, N
    of 8."""
    if T < 1 or K < _K_ALIGN or K % _K_ALIGN or N < 8 or N % 8:
        raise ValueError(f"the int8 product takes T >= 1 rows, K a multiple "
                         f"of {_K_ALIGN} and N a multiple of 8, got T, K, N "
                         f"= {T}, {K}, {N}")

    def tiles(bm, bn):
        return -(-T // bm) * -(-N // bn)

    def load(tile):   # operand rows the busiest SM reads a k-step
        bm, bn = tile
        return -(-tiles(bm, bn) // sms) * (bm + bn)

    bm, bn = min(((m, n) for m in BLOCK_MS for n in BLOCK_NS),
                 key=lambda tile: (load(tile), -tile[0] * tile[1]))
    if tiles(bm, bn) > 2 ** 31 - 1:
        raise ValueError(f"{tiles(bm, bn)} tiles exceed 2^31 - 1")
    stages = min(_MAX_STAGES, (_SMEM_MAX - int8_smem_bytes(bm, bn, 0))
                 // ((bm + bn) * _BLOCK_K))
    return Int8Plan(bm, bn, -(-T // bm), -(-N // bn), stages,
                    min(tiles(bm, bn), sms), int8_smem_bytes(bm, bn, stages))


@functools.lru_cache(maxsize=None)
def _lib():
    """w8a8.cu's entry points, built and loaded on first use."""
    lib = _build.load("w8a8")
    lib.w8a8_quantize_rows.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                       + [ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 2
                                       + [ctypes.c_void_p]
                                       + [ctypes.c_int] * 5)
    lib.w8a8_quantize_rows.restype = ctypes.c_int
    lib.w8a8_gemm.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                              + [ctypes.c_void_p])
    lib.w8a8_gemm.restype = ctypes.c_int
    return lib


def _on_cuda(*tensors) -> bool:
    """True when every given tensor lies on one CUDA device, False when all
    lie on the CPU; anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"the W8A8 operands lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no W8A8 kernel for device {dev}")
    return dev.type == "cuda"


def _check_k(K: int) -> None:
    if K < _K_ALIGN or K % _K_ALIGN:
        raise ValueError(f"the W8A8 kernels take K a multiple of {_K_ALIGN} "
                         f"(16-byte rows), got K = {K}")


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation over the last axis (Q1).

    Returns ``(x_q int8, scale fp32)`` with ``scale`` shaped ``x.shape[:-1]
    + (1,)`` such that ``x ~= x_q * scale``.  CPU tensors run the plain
    version; a CUDA tensor (bf16 or fp32) is one kernel launch, planned by
    :func:`quant_plan`."""
    if not _on_cuda(x):
        return quantize_rowwise_reference(x)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the row quantisation takes bfloat16 or float32, "
                        f"got {x.dtype}")
    K = x.shape[-1]
    _check_k(K)
    x2 = x.reshape(-1, K).contiguous()
    R = x2.shape[0]
    q = torch.empty((R, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((R,), dtype=torch.float32, device=x.device)
    if R:
        plan = quant_plan(R, K, x.element_size(), sm_count(x.device))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        check(_lib().w8a8_quantize_rows(
            x2.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            scale.data_ptr(), R, K, stream, plan.team, plan.units,
            plan.passes, plan.threads, plan.grid), "w8a8 quantize_rows")
        quantize_rowwise.launches += 1
    return q.view(x.shape), scale.view(*x.shape[:-1], 1)


quantize_rowwise.launches = 0


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantisation of an ``(N, K)``
    weight: Q1 over its rows.  Returns ``(w_q int8 (N, K), scale fp32
    (N,))`` such that ``w ~= w_q * scale[:, None]``."""
    w_q, scale = quantize_rowwise(w)
    return w_q, scale.view(-1)


def int8_gemm(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
              w_scale: torch.Tensor, bias: Optional[torch.Tensor],
              out_dtype: torch.dtype) -> torch.Tensor:
    """Q2: ``(x_q @ w_q.T) * x_scale[:, None] * w_scale (+ bias)`` over
    ``(T, K)`` and ``(N, K)`` int8 codes, ``(T,)``/``(N,)`` fp32 scales and
    an ``(N,)`` bias, in ``out_dtype``.  CPU tensors run the plain version;
    CUDA tensors are one kernel launch (fp32 or bf16 out) or raise."""
    T, K = x_q.shape
    N = w_q.shape[0]
    if w_q.shape != (N, K) or x_scale.shape != (T,) or w_scale.shape != (N,):
        raise ValueError(f"int8 product operands of shapes {tuple(x_q.shape)}"
                         f", {tuple(w_q.shape)}, scales "
                         f"{tuple(x_scale.shape)}, {tuple(w_scale.shape)}")
    if not _on_cuda(x_q, x_scale, w_q, w_scale, bias):
        return int8_gemm_reference(x_q, x_scale, w_q, w_scale, bias,
                                   out_dtype)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"the int8 product takes int8 codes, got "
                        f"{x_q.dtype}, {w_q.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the int8 product writes float32 or bfloat16, not "
                        f"{out_dtype}")
    _check_k(K)
    plan = int8_plan(T, K, N, sm_count(x_q.device))
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("the int8 codes must be 16-byte aligned")
    x_scale = x_scale.float().contiguous()
    w_scale = w_scale.float().contiguous()
    bias = None if bias is None else bias.float().contiguous()
    y = torch.empty((T, N), dtype=out_dtype, device=x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    check(_lib().w8a8_gemm(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), ptr(bias), y.data_ptr(),
        int(out_dtype == torch.bfloat16), T, K, N, plan.block_m,
        plan.block_n, plan.stages, plan.grid, stream), "w8a8 gemm")
    int8_gemm.launches += 1
    return y


int8_gemm.launches = 0


def w8a8_linear(x: torch.Tensor, w: Optional[torch.Tensor],
                bias: Optional[torch.Tensor],
                out_dtype: Optional[torch.dtype] = None,
                pre: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """``x @ w.T (+ bias)`` through the int8 path (JAX ``w8a8_dot``).

    ``x``: ``(..., K)`` activations; ``w``: the ``(N, K)`` weight, quantised
    per call (Q1 over its rows) unless ``pre = (w_q, w_scale)`` gives it
    prequantised (a serving bundle's int8 weights; ``w`` may then be
    None).  ``x`` is quantised per row (Q1), the product rescaled (Q2).
    Output dtype defaults to ``x.dtype``."""
    out_dtype = out_dtype or x.dtype
    K = x.shape[-1]
    x_q, x_scale = quantize_rowwise(x)
    w_q, w_scale = pre if pre is not None else quantize_weight(w)
    y = int8_gemm(x_q.reshape(-1, K), x_scale.reshape(-1), w_q, w_scale,
                  bias, out_dtype)
    return y.view(*x.shape[:-1], w_q.shape[0])
