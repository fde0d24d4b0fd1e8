"""Transformer building blocks of the ViT family, counterpart of
``vit_torch_tpu/models/layers.py``.

Numerics follow the JAX package:

- parameters are fp32; activations run in the model's ``dtype`` (bfloat16
  by default), and every matmul casts its weights to that dtype;
- LayerNorm and GELU compute in fp32 and round once to the activation
  dtype; GELU is the exact erf form;
- the patch embedding is a reshape + matmul with fp32 accumulation.

Parameter names follow torch/timm/DINO (``patch_embed.proj.weight`` as a
``(D, C, p, p)`` conv weight, ``blocks.{i}.attn.qkv.weight``,
``norm.weight``, ...), so a DINO state dict loads as it is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.ops.attention import qkv_attention


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


def _keep_mask(x: torch.Tensor, shape, keep: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise RuntimeError(
            "dropout and drop-path in training draw from an explicit "
            "torch.Generator: call set_generator(model, generator) first")
    return torch.rand(shape, generator=generator, device=x.device) < keep


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample, as the
    JAX ``drop_path`` does (``where(mask, x / keep, 0)``).  The keep mask
    (shape ``(B, 1, ...)``) is drawn from ``generator``, or given."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = _keep_mask(x, (x.shape[0],) + (1,) * (x.dim() - 1), keep,
                          generator)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth; draws from ``self.generator`` (see
    :func:`set_generator`), never from the global RNG."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, self.generator)


class Dropout(nn.Module):
    """Element dropout as flax's ``nn.Dropout`` (``where(mask, x / keep,
    0)``), drawing from ``self.generator`` (see :func:`set_generator`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = _keep_mask(x, x.shape, keep, self.generator)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Give every :class:`DropPath` and :class:`Dropout` of ``model`` the
    generator they draw from in training (the trainer owns it, as the JAX
    train step owns the ``dropout`` rng)."""
    for mod in model.modules():
        if isinstance(mod, (DropPath, Dropout)):
            mod.generator = generator


class Mlp(nn.Module):
    """Transformer MLP: Linear → exact GELU → Linear (+dropout)."""

    def __init__(self, dim: int, hidden_dim: int,
                 out_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim or dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(gelu_exact(self.fc1(x)))
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Multi-head self-attention with one fused qkv projection whose
    outputs are ordered (3, H, D).  q, k and v stay views into the qkv
    output; on CUDA the flash kernel reads them through their strides.

    ``attn_drop`` is kept for config parity; like the JAX module, no
    dropout is applied to the attention weights."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).view(B, N, 3, H, C // H)
        out = qkv_attention(qkv, scale=self.scale)
        return self.proj_drop(self.proj(out.reshape(B, N, C)))


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
    """Seeded init in the JAX package's scheme: LayerNorm weight 1, every
    bias 0, LayerScale gates (``gamma_1``/``gamma_2`` of a module with an
    ``init_scale``, CaiT) the constant ``init_scale``, every other
    parameter truncated normal (std 0.02, cut at two standard deviations).
    Parameters are visited in module order, so one seed gives one set of
    weights on every device."""
    for mod in model.modules():
        for name, param in mod.named_parameters(recurse=False):
            if isinstance(mod, LayerNorm) and name == "weight":
                param.fill_(1.0)
            elif name == "bias":
                param.zero_()
            elif name in ("gamma_1", "gamma_2") and hasattr(mod,
                                                            "init_scale"):
                param.fill_(mod.init_scale)
            else:
                nn.init.trunc_normal_(param, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
