"""CaiT backbone (Class-Attention in image Transformers), counterpart of
``vit_torch_tpu/models/cait.py``: patch embed, a patch-only position table
(no CLS slot), ``depth`` LayerScale blocks of talking-heads self-attention,
then ``depth_token_only`` LayerScale blocks of class attention that update
only the CLS token, and the final LayerNorm (eps 1e-6 everywhere); CLS
features out.

NHWC input.  Numerics follow the JAX package: fp32 parameters, activations
in the model's ``dtype`` (bfloat16 by default), LayerScale's ``gamma_1`` /
``gamma_2`` cast to that dtype at the residual.  Parameter names follow the
Facebook/timm CaiT state dict (``blocks.{i}.gamma_1``,
``blocks.{i}.attn.proj_l.weight``, ``blocks_token_only.{i}.attn.q.weight``,
...), so a published checkpoint loads by name
(``checkpoint/torch_import.py``).

Every talking-heads block passes its fused qkv projection straight to
:func:`~vit_torch_tpu_torch.ops.talking_heads.talking_heads_attention_qkv`:
the CUDA kernel on the card at every CaiT shape (the TPU's VMEM ``fits``
test has no counterpart here), the plain version on the CPU.  Class
attention has one query per image and no kernel, as in the JAX package,
which leaves it to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.models.layers import (LayerNorm, Linear, Mlp,
                                               PatchEmbed, run_block)
from vit_torch_tpu_torch.ops import talking_heads as th
from vit_torch_tpu_torch.parallel.collectives import (copy_to_group,
                                                      reduce_from_group)


@dataclasses.dataclass(frozen=True)
class CaiTConfig:
    patch_size: int = 16
    embed_dim: int = 192
    depth: int = 24
    num_heads: int = 4
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    init_scale: float = 1e-5
    depth_token_only: int = 2
    default_image_size: int = 224


_c = CaiTConfig

# the Facebook CaiT registrations (lowercase timm naming; the capitalized
# spellings are aliased below)
CAIT_CONFIGS = {
    "cait_xxs24_224": _c(),
    "cait_xxs24_384": _c(default_image_size=384),
    "cait_xxs36_224": _c(depth=36),
    "cait_xxs36_384": _c(depth=36, default_image_size=384),
    "cait_xs24_384": _c(embed_dim=288, num_heads=6, default_image_size=384),
    "cait_s24_224": _c(embed_dim=384, num_heads=8),
    "cait_s24_384": _c(embed_dim=384, num_heads=8, default_image_size=384),
    "cait_s36_384": _c(embed_dim=384, num_heads=8, depth=36, init_scale=1e-6,
                       default_image_size=384),
    "cait_m36_384": _c(embed_dim=768, num_heads=16, depth=36, init_scale=1e-6,
                       default_image_size=384),
    "cait_m48_448": _c(embed_dim=768, num_heads=16, depth=48, init_scale=1e-6,
                       default_image_size=448),
    # tiny smoke config
    "cait_test": _c(embed_dim=32, depth=2, num_heads=2, patch_size=8),
}
for _k in list(CAIT_CONFIGS):
    _parts = _k.split("_")
    if len(_parts) == 3:
        CAIT_CONFIGS[f"cait_{_parts[1].upper()}_{_parts[2]}"] = \
            CAIT_CONFIGS[_k]


def cait_flops(config: CaiTConfig, image_size: int) -> int:
    """Analytic forward FLOPs per image (multiply-adds × 2), the JAX
    package's accounting: the talking-heads blocks with their two (H, H)
    score mixes, and the class-attention blocks (q and MLP on the CLS
    token, k and v over every token)."""
    p, d, H = config.patch_size, config.embed_dim, config.num_heads
    n = (image_size // p) ** 2                         # SA blocks: no CLS
    hidden = int(d * config.mlp_ratio)
    flops = 2 * n * (p * p * 3) * d                    # patch embed
    per_sa = (
        2 * n * d * 3 * d                              # qkv
        + 2 * n * n * d * 2                            # QK^T + PV
        + 2 * n * n * H * H * 2                        # proj_l + proj_w mixes
        + 2 * n * d * d                                # out proj
        + 2 * n * d * hidden * 2)                      # MLP
    flops += config.depth * per_sa
    nk = n + 1                                         # CA blocks see CLS too
    per_ca = (
        2 * 1 * d * d + 2 * nk * d * d * 2             # q (CLS) + k/v
        + 2 * 1 * nk * d * 2                           # attn matmuls
        + 2 * 1 * d * d                                # proj
        + 2 * 1 * d * hidden * 2)                      # CLS-only MLP
    return flops + config.depth_token_only * per_ca


class TalkingHeadAttention(nn.Module):
    """Self-attention with head mixes before (``proj_l``) and after
    (``proj_w``) the softmax, ``Linear(H, H)`` each as in timm."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.proj_l = Linear(num_heads, num_heads)
        self.proj_w = Linear(num_heads, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).view(B, N, 3, H, C // H)
        # the ops take the mixes in the JAX layout (in, out): Linear's
        # weight transposed
        out = th.talking_heads_attention_qkv(
            qkv, self.proj_l.weight.t(), self.proj_l.bias,
            self.proj_w.weight.t(), self.proj_w.bias, scale=self.scale)
        return self.proj(out.reshape(B, N, C))


class ClassAttention(nn.Module):
    """CLS-query attention: q from the first token, k and v from every
    token.  q is scaled after its projection, the logits are fp32 and the
    softmax is rounded to the activation dtype before PV, as in the JAX
    module."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.k = Linear(dim, dim, bias=qkv_bias)
        self.v = Linear(dim, dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    # set by parallel.partition.apply_tensor_parallel: q, k and v hold
    # this rank's heads, proj their input columns
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        d = self.q.weight.shape[0] // H
        x = copy_to_group(x, self.tp_group)
        q = self.q(x[:, :1]).view(B, 1, H, d) * d ** -0.5
        k = self.k(x).view(B, N, H, d)
        v = self.v(x).view(B, N, H, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, 1, H * d)
        if self.tp_group is None:
            return self.proj(out)
        dt = out.dtype
        return reduce_from_group(F.linear(out, self.proj.weight.to(dt)),
                                 self.tp_group) + self.proj.bias.to(dt)


class LayerScaleBlock(nn.Module):
    """Pre-norm talking-heads block with LayerScale residual gates."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, init_scale: float = 1e-5):
        super().__init__()
        self.init_scale = init_scale      # read by layers.init_weights
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = TalkingHeadAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_scale))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma_1.to(x.dtype) * self.attn(self.norm1(x))
        return x + self.gamma_2.to(x.dtype) * self.mlp(self.norm2(x))


class LayerScaleBlockCA(nn.Module):
    """Class-attention block: updates the CLS token from itself and the
    patch tokens."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, init_scale: float = 1e-5):
        super().__init__()
        self.init_scale = init_scale
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = ClassAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_scale))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_scale))

    def forward(self, x: torch.Tensor, x_cls: torch.Tensor) -> torch.Tensor:
        u = torch.cat([x_cls, x], dim=1)
        x_cls = x_cls + self.gamma_1.to(x.dtype) * self.attn(self.norm1(u))
        return x_cls + self.gamma_2.to(x.dtype) * self.mlp(self.norm2(x_cls))


class CaiT(nn.Module):
    """CaiT backbone returning CLS features ``(B, embed_dim)``.

    ``dtype`` is the activation dtype; parameters stay fp32.  The position
    table covers the patches of ``image_size`` only
    (``num_prefix_tokens = 0`` for the checkpoint importer).  ``remat``
    recomputes each talking-heads block in the backward
    (:func:`layers.run_block`), as the JAX model's ``remat`` does."""

    family = "cait"
    num_prefix_tokens = 0

    def __init__(self, config: CaiTConfig, image_size: int = 224,
                 image_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = False
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, image_channels, D)
        n_patches = (image_size // cfg.patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches, D))
        self.blocks = nn.ModuleList(
            LayerScaleBlock(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                            cfg.init_scale) for _ in range(cfg.depth))
        self.blocks_token_only = nn.ModuleList(
            LayerScaleBlockCA(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                              cfg.init_scale)
            for _ in range(cfg.depth_token_only))
        self.norm = LayerNorm(D, eps=1e-6)

    @property
    def feature_dim(self) -> int:
        return self.config.embed_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.patch_embed(x.to(dt)) + self.pos_embed.to(dt)
        for blk in self.blocks:
            x = run_block(blk, x, remat=self.remat)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        for blk in self.blocks_token_only:
            cls = blk(x, cls)
        # LayerNorm is per token: norming the CLS token alone is norming
        # the concatenated sequence and taking its first token
        return self.norm(cls)[:, 0]
