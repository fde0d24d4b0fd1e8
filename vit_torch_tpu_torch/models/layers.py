"""Building blocks of the model zoo, counterpart of
``vit_torch_tpu/models/layers.py``.

Numerics follow the JAX package:

- parameters are fp32; activations run in the model's ``dtype`` (bfloat16
  by default), and every matmul and conv casts its weights to that dtype;
- LayerNorm, BatchNorm and GELU compute in fp32 and round once to the
  activation dtype; GELU is the exact erf form;
- the patch embedding is a reshape + matmul with fp32 accumulation.

The convolutional families (XCiT's stem and LPI, ResNeXt/WRN) take an
NHWC image as the transformers do; ``x.permute(0, 3, 1, 2)`` is an NCHW
view with ``channels_last`` strides, the layout cuDNN prefers for bf16, and
every conv and BatchNorm keeps it.  Grouped convs are ``nn.Conv2d`` with
``groups`` (cuDNN): the JAX package computes them outside any Pallas
kernel, and its block-diagonal regrouping (``VITX_DENSE_GROUPS``) is a
TPU-measured workaround that computes the same function, so it does not
carry over.

Parameter names follow torch/timm/DINO (``patch_embed.proj.weight`` as a
``(D, C, p, p)`` conv weight, ``blocks.{i}.attn.qkv.weight``,
``norm.weight``, ...), so a DINO state dict loads as it is.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from vit_torch_tpu_torch.ops import attn_block, fused_mlp, quant
from vit_torch_tpu_torch.ops.attention import active_seq, qkv_attention
from vit_torch_tpu_torch.parallel.collectives import (all_reduce_sum,
                                                      copy_to_group,
                                                      reduce_from_group)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU evaluated in fp32 and rounded once to ``x.dtype``.

    PyTorch's GELU computes a bf16 input in fp32 and rounds once, in one
    pass over memory.  (On the CPU its vectorised erf is up to one bf16 ulp
    off in the negative tail; the CUDA kernel uses ``erff``.)"""
    return F.gelu(x)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in fp32, in the input dtype.

    The base eps is torch's 1e-5 (Swin, detection); the ViT family passes
    1e-6 at every call site, as the reference does."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # PyTorch's CUDA LayerNorm takes no bf16 input with fp32 weights, so
        # the input goes up to fp32 and the result comes back down
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` that runs in the activation dtype: the (fp32) weight
    and bias are cast to ``x.dtype`` at the call, as the JAX Dense does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def _use_w8a8(training: bool, forced: Optional[bool] = None) -> bool:
    """Whether a forward takes the dynamic int8 serving path
    (:mod:`.quant`): never in training mode (rounding has a zero gradient,
    the JAX ``deterministic=False``); else ``forced`` where a bundle's
    manifest set it (:func:`set_w8a8`), else ``VITX_W8A8=1``, read per
    call."""
    if training:
        return False
    return quant.w8a8_enabled() if forced is None else forced


class QLinear(Linear):
    """:class:`Linear` that runs through W8A8 (:func:`.quant.w8a8_linear`)
    when :func:`_use_w8a8` says so: the counterpart of the JAX ``QDense``,
    with ``Linear``'s parameters and state-dict keys.

    ``w8a8`` is None (follow ``VITX_W8A8``) or a bundle's fixed choice.
    A serving bundle may hold the weight prequantised: :meth:`set_prequant`
    puts the int8 rows and their scales in the buffers ``weight_q`` and
    ``weight_scale`` (in the state dict once set) and drops the fp32
    ``weight``, after which the layer only serves through int8."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.w8a8: Optional[bool] = None
        self.register_buffer("weight_q", None)
        self.register_buffer("weight_scale", None)

    def quantized(self) -> bool:
        """Whether this call takes the int8 path."""
        return _use_w8a8(self.training, self.w8a8)

    def set_prequant(self, w_q: torch.Tensor, w_scale: torch.Tensor) -> None:
        """Hold the weight as int8 rows ``(N, K)`` and fp32 scales ``(N,)``
        (:func:`.quant.quantize_weight`'s) in place of the fp32 one."""
        self.weight_q, self.weight_scale = w_q, w_scale
        self.weight = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized():
            pre = None if self.weight_q is None else (self.weight_q,
                                                      self.weight_scale)
            return quant.w8a8_linear(x, self.weight, self.bias, pre=pre)
        if self.weight is None:
            raise RuntimeError("this layer holds only its prequantised int8 "
                               "weight and serves through W8A8 in eval mode")
        return super().forward(x)


def set_w8a8(model: nn.Module, on: Optional[bool]) -> None:
    """Fix every :class:`QLinear` of ``model`` to the int8 path (True), the
    fp path (False), or back to ``VITX_W8A8`` (None): a bundle's manifest,
    not the server's environment, decides how it serves."""
    for mod in model.modules():
        if isinstance(mod, QLinear):
            mod.w8a8 = on


def _keep_mask(x: torch.Tensor, shape, keep: float,
               generator: Optional[torch.Generator],
               shard: Optional[tuple] = None) -> torch.Tensor:
    """The keep mask of ``shape``; with ``shard = (index, count)`` (a data
    mesh, :func:`set_batch_shard`) the mask of the ``count`` times larger
    global batch is drawn and this rank's rows taken, so that every rank
    draws what one process would."""
    if generator is None:
        raise RuntimeError(
            "dropout and drop-path in training draw from an explicit "
            "torch.Generator: call set_generator(model, generator) first")
    if shard is not None and shard[1] > 1:
        i, n = shard
        B = shape[0]
        full = torch.rand((B * n, *shape[1:]), generator=generator,
                          device=x.device)
        return full[i * B:(i + 1) * B] < keep
    return torch.rand(shape, generator=generator, device=x.device) < keep


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None,
              shard: Optional[tuple] = None) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample, as the
    JAX ``drop_path`` does (``where(mask, x / keep, 0)``).  The keep mask
    (shape ``(B, 1, ...)``) is drawn from ``generator``, or given."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = _keep_mask(x, (x.shape[0],) + (1,) * (x.dim() - 1), keep,
                          generator, shard)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth; draws from ``self.generator`` (see
    :func:`set_generator`), never from the global RNG."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[tuple] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, self.generator,
                         shard=self.shard)


class Dropout(nn.Module):
    """Element dropout as flax's ``nn.Dropout`` (``where(mask, x / keep,
    0)``), drawing from ``self.generator`` (see :func:`set_generator`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[tuple] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = _keep_mask(x, x.shape, keep, self.generator, self.shard)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Give every :class:`DropPath` and :class:`Dropout` of ``model`` the
    generator they draw from in training (the trainer owns it, as the JAX
    train step owns the ``dropout`` rng)."""
    for mod in model.modules():
        if isinstance(mod, (DropPath, Dropout)):
            mod.generator = generator


def set_batch_shard(model: nn.Module, shard: Optional[tuple]) -> None:
    """Under a data mesh every :class:`DropPath` and :class:`Dropout` of
    ``model`` draws the global batch's mask and keeps rows ``shard =
    (index, count)`` (:func:`_keep_mask`); None draws per rank."""
    for mod in model.modules():
        if isinstance(mod, (DropPath, Dropout)):
            mod.shard = shard


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in the activation dtype: the (fp32) weight
    and bias are cast to ``x.dtype`` at the call, as :class:`Linear` does.
    Takes NCHW (``channels_last`` strides from an NHWC permute)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with torch's ``BatchNorm2d`` names and state
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), the names of the published checkpoints.

    The JAX ``BatchNorm`` (``vit_torch_tpu/models/layers.py:107-165``) is
    torch's: momentum 0.1 (flax's 0.9), eps 1e-5, the running variance
    updated with the unbiased estimator (x n/(n-1)) and the batch's biased
    variance normalising in train mode.  PyTorch's kernel takes a bf16
    input with the fp32 parameters and statistics, computes in fp32 and
    rounds once to the input dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        # set under a data mesh (parallel/api.py): train-mode statistics
        # over the global batch
        self.sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.sync_group is not None:
            return self._sync_forward(x)
        return super().forward(x)

    def _sync_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch of a data mesh, SyncBatchNorm's
        semantics and the JAX BatchNorm's under GSPMD: the fp32 per-channel
        sums all-reduced over ``sync_group`` (two passes: the mean, then the
        centred squares), the biased variance normalising, the unbiased
        one (x n/(n-1)) into the running variance."""
        g = self.sync_group
        dims = (0, 2, 3)
        xf = x.float() if x.dtype != torch.float64 else x
        n = x.numel() // x.shape[1] * torch.distributed.get_world_size(g)
        mean = all_reduce_sum(xf.sum(dims), g) / n
        xc = xf - mean[None, :, None, None]
        var = all_reduce_sum((xc * xc).sum(dims), g) / n
        y = xc * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight[None, :, None, None].to(y.dtype) \
            + self.bias[None, :, None, None].to(y.dtype)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach().to(
                self.running_mean.dtype))
            self.running_var.mul_(1 - m).add_(m * (var.detach() * n / max(
                n - 1, 1)).to(self.running_var.dtype))
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


# The conv+BN fold in eval is on by default on CUDA, as in the JAX
# package, whose default came from a TPU measurement that does not carry
# over.  chip_smoke.py's steady_state_resnext times the resnext50_32x4d
# @224 bs32 eval forward (inference mode, as served) with the fold on,
# off, off, on.  On an H100 80GB HBM3 at 700 W (three calls) it takes
# 3.78-5.62 ms on events folded against 6.20-8.23 unfolded, with device
# busy time 3.04-3.33 ms against 3.09-3.25: the BN pass goes and the
# conv's bias add costs about as much, so the fold wins by the launches
# it saves in a forward the host paces, not by device time.


def _fold(conv: nn.Conv2d, bn: BatchNorm, dtype: torch.dtype):
    """The eval-mode ``bn(conv(x))`` as one conv's weight and bias:
    ``w * a`` and ``bias - mean * a`` with ``a = weight / sqrt(var +
    eps)``, in fp32 and cast once (the JAX ``fold_conv_bn_eval``)."""
    a = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    w = (conv.weight.float() * a[:, None, None, None]).to(dtype)
    b = (bn.bias.float() - bn.running_mean.float() * a).to(dtype)
    return w, b


def _folded(conv: nn.Conv2d, bn: BatchNorm, dtype: torch.dtype):
    """:func:`_fold`, cached on ``bn`` while no gradient is recorded: the
    cache holds as long as the tensors and their version counters do (an
    optimizer step, a state-dict load or a train-mode forward, which adds
    one to ``num_batches_tracked``, moves them), so serving folds once."""
    if torch.is_grad_enabled():
        return _fold(conv, bn, dtype)
    tensors = (conv.weight, bn.weight, bn.bias, bn.running_mean,
               bn.running_var, bn.num_batches_tracked)
    key = (dtype, tuple((t.data_ptr(), t._version) for t in tensors))
    cached = getattr(bn, "_fold_cache", None)
    if cached is None or cached[0] != key:
        cached = bn._fold_cache = (key, *_fold(conv, bn, dtype))
    return cached[1], cached[2]


def conv_bn(conv: nn.Conv2d, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``bn(conv(x))``; in eval, as one conv with the BN folded into its
    weight and bias (exact up to fp association), unless
    ``VITX_FOLD_BN=0`` (read per call, as the JAX package's
    ``use_folded_bn`` reads it).  Train-mode BN depends on the batch and
    is never folded."""
    if bn.training or os.environ.get("VITX_FOLD_BN") == "0":
        return bn(conv(x))
    w, b = _folded(conv, bn, x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation,
                    conv.groups)


def run_block(block: nn.Module, *args, remat: bool = False):
    """``block(*args)``; with ``remat`` and autograd recording, under
    ``torch.utils.checkpoint`` (non-reentrant): the block's activations
    are recomputed in the backward instead of kept, as ``jax.checkpoint``
    does per block in the JAX package.

    The recompute must compute what the forward did.  Dropout and
    drop-path draw from the trainer's ``torch.Generator``, which
    ``preserve_rng_state`` does not cover, so the generators' states at
    the forward are set again for the recompute and their states at the
    backward put back after it; and a train-mode BatchNorm would fold the
    batch into its running statistics a second time, so they are put back
    too.  The port draws from no global RNG, so that is not saved."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args)
    gens = list({id(m.generator): m.generator for m in block.modules()
                 if isinstance(m, (DropPath, Dropout))
                 and m.generator is not None}.values())
    norms = [m for m in block.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
             and m.training and m.track_running_stats]
    at_forward = [g.get_state() for g in gens]
    calls = []

    def run(*inputs):
        if not calls:
            calls.append(1)
            return block(*inputs)
        at_backward = [g.get_state() for g in gens]
        stats = [[t.clone() for t in (m.running_mean, m.running_var,
                                      m.num_batches_tracked)]
                 for m in norms]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            return block(*inputs)
        finally:
            for g, state in zip(gens, at_backward):
                g.set_state(state)
            with torch.no_grad():
                for m, saved in zip(norms, stats):
                    for t, s in zip((m.running_mean, m.running_var,
                                     m.num_batches_tracked), saved):
                        t.copy_(s)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


# B12 is opt-in on CUDA too.  chip_smoke.py's steady_state_deit times
# whole deit_base_distilled_patch16_224 @224 bs32 steps with it off, on,
# on, off.  On an H100 80GB HBM3 at 700 W (two runs) the kernel takes
# 0.20 ms of device time per MLP against 0.12 ms for cuBLAS + GELU +
# cuBLAS (it ties at cait_s24_224's shape and wins at Swin stage 1's, not
# at ViT-B's), so each step's device time grows: the linear-eval step's
# busy time 5.48-5.58 ms against 4.37-4.46, the fine-tune step's
# 21.91-22.80 against 16.07-16.31 (its backward recomputes the hidden
# activation through cuBLAS; its peak memory 2.93 GB against 3.89).  The
# eval forward, 7.06-10.99 ms against 6.32-9.33, is inside the host's
# spread.


def _fused_mlp(x: torch.Tensor, mlp: "Mlp") -> bool:
    """Whether the MLP takes the fused kernel (:func:`.fused_mlp.fused_mlp`,
    B12): ``VITX_FUSED_MLP=1``, read per call as the JAX package reads it,
    with dropout inactive, for the shapes the kernel takes.  Without the
    flag (or with ``=0``) it is off on every device.  The W8A8 serving path
    comes first (:meth:`Mlp.forward`), as in the JAX dispatch."""
    if os.environ.get("VITX_FUSED_MLP", "") != "1":
        return False
    if mlp.drop.training and mlp.drop.rate > 0.0:
        return False
    C = x.shape[-1]
    return fused_mlp.fits(x.numel() // C, C, mlp.fc1.out_features,
                          mlp.fc2.out_features)


class Mlp(nn.Module):
    """Transformer MLP: Linear → exact GELU → Linear (+dropout), in the JAX
    module's dispatch order: the W8A8 serving path (both products through
    int8, eval only), then under ``VITX_FUSED_MLP=1`` the fused kernel
    (B12), then the two cuBLAS products."""

    def __init__(self, dim: int, hidden_dim: int,
                 out_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        self.fc1 = QLinear(dim, hidden_dim)
        self.fc2 = QLinear(hidden_dim, out_dim or dim)
        self.drop = Dropout(dropout)

    # set by parallel.partition.apply_tensor_parallel: fc1 holds this
    # rank's rows of the hidden width, fc2 the matching columns
    tp_group = None

    def _forward_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Column-sharded fc1, row-sharded fc2: the input's gradient and
        the output all-reduced over the ``model`` group, fc2's bias added
        once after the reduce.  Under ``VITX_FUSED_MLP=1`` the fused kernel
        runs over the local hidden columns with a zero output bias."""
        g, dt = self.tp_group, x.dtype
        x = copy_to_group(x, g)
        if _fused_mlp(x, self):
            y = fused_mlp.fused_mlp(
                x, self.fc1.weight.to(dt), self.fc1.bias.to(dt),
                self.fc2.weight.to(dt), torch.zeros_like(self.fc2.bias,
                                                         dtype=dt))
        else:
            y = F.linear(self.drop(gelu_exact(self.fc1(x))),
                         self.fc2.weight.to(dt))
        return self.drop(reduce_from_group(y, g) + self.fc2.bias.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            return self._forward_tp(x)
        if self.fc1.quantized():
            return self.fc2(gelu_exact(self.fc1(x)))
        if _fused_mlp(x, self):
            dt = x.dtype
            return fused_mlp.fused_mlp(
                x, self.fc1.weight.to(dt), self.fc1.bias.to(dt),
                self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        x = self.drop(gelu_exact(self.fc1(x)))
        return self.drop(self.fc2(x))


# B3 is opt-in on CUDA, as B4 is.  chip_smoke.py's
# steady_state_attention_block times whole dino_vits16 @224 steps with B3
# on and off in turns; on an H100 80GB HBM3 at 700 W (two runs of each
# side in each of two calls), with B3's wgmma kernels and the wgmma flash
# kernels the unfused path (off) takes:
# - bs64 linear-eval step: device busy 3.877-3.949 ms with B3 against
#   3.820-3.965 without; the step 10.32-13.99 ms against 13.83-19.10, a
#   gain within the host's spread between calls (the chain issues fewer
#   launches);
# - bs128 linear-eval step: device busy 7.727-7.852 ms against
#   7.402-7.735;
# - bs64 fine-tune step (B3's backward recomputes through the flash
#   kernels): 45.27-63.22 ms against 36.45-55.56, device busy
#   14.24-14.43 ms against 12.80-12.93.
# Without grad B3 saves no device time and with grad it adds some, so it
# stays off by default until the port's bench cells (ROADMAP A3) can
# judge on and off on a ledger line.  The serving buckets 1 and 8 and
# C = 768 were never timed with B3 off.


def _fused_attention(x: torch.Tensor, num_heads: int) -> bool:
    """Whether the attention block takes the fused kernel
    (:func:`.attn_block.attention_block`, B3): ``VITX_FUSED_ATTN=1``, read
    per call as the JAX package reads it, for the shapes the kernel takes.
    Without the flag (or with ``=0``) it is off on every device."""
    if os.environ.get("VITX_FUSED_ATTN", "") != "1":
        return False
    _, N, C = x.shape
    return attn_block.fits(N, C, num_heads)


def _packed_attention(x: torch.Tensor, num_heads: int) -> bool:
    """Whether the attention block takes the packed kernel
    (:func:`.attn_block.attention_block_packed`, B4): opt-in through
    ``VITX_PACKED_ATTN=1``, for N <= 32, as in the JAX package."""
    if os.environ.get("VITX_PACKED_ATTN", "") != "1":
        return False
    B, N, C = x.shape
    return N <= 32 and attn_block.fits_packed(N, C, num_heads)


class Attention(nn.Module):
    """Multi-head self-attention with one fused qkv projection whose
    outputs are ordered (3, H, D).

    The JAX module's dispatch order: the W8A8 serving path (eval only; the
    qkv and output products through int8, the attention core as below),
    then the packed kernel (B4), then the fused kernel (B3), then the qkv
    product, :func:`.qkv_attention` (q, k and v stay views into the qkv
    output; on CUDA the flash kernel reads them through their strides) and
    the output product.  ``attn_drop`` is
    kept for config parity; like the JAX module, no dropout is applied to
    the attention weights."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = QLinear(dim, 3 * dim, bias=qkv_bias)
        self.proj = QLinear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def _weights(self, dtype: torch.dtype):
        """The qkv and proj weights and biases in the activation dtype; the
        fp32 parameters get their gradients through the cast."""
        return tuple(None if t is None else t.to(dtype) for t in (
            self.qkv.weight, self.qkv.bias, self.proj.weight,
            self.proj.bias))

    # set by parallel.partition.apply_tensor_parallel: qkv holds this
    # rank's heads of each of q, k and v, proj their input columns
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        if self.tp_group is not None:
            # local heads: the flash kernel (or the ring) over H / model
            # heads; proj's bias once, after the all-reduce
            dt = x.dtype
            qkv = self.qkv(copy_to_group(x, self.tp_group)).view(
                B, N, 3, H, -1)
            out = F.linear(qkv_attention(qkv, scale=self.scale)
                           .reshape(B, N, -1), self.proj.weight.to(dt))
            out = reduce_from_group(out, self.tp_group) \
                + self.proj.bias.to(dt)
            return self.proj_drop(out)
        # under W8A8 the qkv and proj QLinears quantise themselves; the
        # fused blocks yield to ring attention, as the JAX dispatch does
        fused = not self.qkv.quantized() and active_seq() is None
        if fused and _packed_attention(x, H):
            out = attn_block.attention_block_packed(
                x, *self._weights(x.dtype), num_heads=H, scale=self.scale)
        elif fused and _fused_attention(x, H):
            out = attn_block.attention_block(
                x, *self._weights(x.dtype), num_heads=H, scale=self.scale)
        else:
            qkv = self.qkv(x).view(B, N, 3, H, C // H)
            out = self.proj(qkv_attention(qkv, scale=self.scale)
                            .reshape(B, N, C))
        return self.proj_drop(out)


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(LN(x)); x + mlp(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        # reference ViT/DeiT norm eps is 1e-6, not torch's 1e-5 default
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              qk_scale=qk_scale, attn_drop=attn_drop,
                              proj_drop=drop)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """Image-to-patch embedding over NHWC input as reshape + matmul.

    ``proj`` is a stride-p ``nn.Conv2d`` only as the holder of the DINO
    weight layout ``(D, C, p, p)``; the forward flattens each patch in
    ``(p, p, C)`` order and multiplies in the activation dtype with fp32
    accumulation.  Output ``(B, H/p * W/p, D)``."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} not divisible by patch {p}")
        gh, gw = H // p, W // p
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, p * p * C)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, p * p * C)
        y = torch.matmul(x, w.to(x.dtype).t())
        return y + self.proj.bias.to(x.dtype)


class ClassifierHead(nn.Module):
    """MLP classifier head: GELU between Linears, no bias on the last one.
    ``units`` is the full stack including the class count."""

    def __init__(self, in_dim: int, units: Sequence[int]):
        super().__init__()
        self.units = tuple(units)
        dims = (in_dim,) + self.units
        for i in range(len(self.units)):
            is_last = i == len(self.units) - 1
            setattr(self, f"fc{i}", Linear(dims[i], dims[i + 1],
                                           bias=not is_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.units)):
            x = getattr(self, f"fc{i}")(x)
            if i < len(self.units) - 1:
                x = gelu_exact(x)
        return x


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the JAX package's scheme: LayerNorm and BatchNorm
    weight 1, every bias 0, BatchNorm's running statistics reset (mean 0,
    variance 1), LayerScale gates (``gamma_1``/``gamma_2`` of CaiT,
    ``gamma1``-``gamma3`` of XCiT: a module with an ``init_scale``) the
    constant ``init_scale``, XCA's ``temperature`` 1, a :class:`Conv2d`
    weight flax's ``lecun_normal`` (truncated normal of std
    ``1/sqrt(fan_in)``, corrected for the cut at two standard
    deviations), every other parameter truncated normal (std 0.02, cut at
    two standard deviations).  Parameters are visited in module order, so
    one seed gives one set of weights on every device."""
    for mod in model.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_running_stats()
        for name, param in mod.named_parameters(recurse=False):
            if isinstance(mod, (LayerNorm, BatchNorm)) and name == "weight":
                param.fill_(1.0)
            elif name == "bias":
                param.zero_()
            elif name.startswith("gamma") and hasattr(mod, "init_scale"):
                param.fill_(mod.init_scale)
            elif name == "temperature":
                param.fill_(1.0)
            elif isinstance(mod, Conv2d) and name == "weight":
                fan_in = param[0].numel()
                std = 1.0 / math.sqrt(fan_in) / .87962566103423978
                nn.init.trunc_normal_(param, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            else:
                nn.init.trunc_normal_(param, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
