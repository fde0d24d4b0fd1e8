"""Vision Transformer (DINO-style) backbone, counterpart of
``vit_torch_tpu/models/vit.py``: NHWC input, patch embed, CLS token,
learned position embeddings, pre-norm blocks, final LayerNorm (eps 1e-6),
CLS-token features out.

Position embeddings are created for the grid of ``image_size``;
``checkpoint.torch_import`` interpolates a table trained at another size.

Under a mesh (``parallel/api.py``) the forward has two more routes.  With
``seq`` set (the mesh's ``seq`` axis) the tokens are padded to a multiple
of the axis and each rank runs the blocks over its contiguous shard, its
attention a ring over the ``seq`` group (``ops/ring_attention.py``); the
prefix tokens' normed features come from the rank holding position 0.
With ``pipe`` set (a pipeline stage, ``parallel/pipeline.py``) the blocks
this rank holds are its stage of a GPipe schedule.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.models.layers import (Block, Dropout, LayerNorm,
                                               PatchEmbed, run_block)
from vit_torch_tpu_torch.ops.attention import sequence_parallel
from vit_torch_tpu_torch.parallel.collectives import broadcast_from


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0


VIT_CONFIGS = {
    # DINO self-supervised checkpoints (facebookresearch/dino)
    "dino_vits16": ViTConfig(patch_size=16, embed_dim=384, depth=12, num_heads=6),
    "dino_vits8": ViTConfig(patch_size=8, embed_dim=384, depth=12, num_heads=6),
    "dino_vitb16": ViTConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "dino_vitb8": ViTConfig(patch_size=8, embed_dim=768, depth=12, num_heads=12),
    # tiny config for smoke tests / CI (not a reference arch)
    "vit_tiny_test": ViTConfig(patch_size=8, embed_dim=64, depth=2, num_heads=2),
    # plain supervised ViTs (timm naming), same topology
    "vit_small_patch16": ViTConfig(patch_size=16, embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch16": ViTConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16": ViTConfig(patch_size=16, embed_dim=1024, depth=24, num_heads=16),
}


class VisionTransformer(nn.Module):
    """ViT backbone returning CLS-token features ``(B, embed_dim)``, or all
    tokens ``(B, 1 + N, embed_dim)`` with ``return_all_tokens``.

    ``dtype`` is the activation dtype; parameters stay fp32.  ``remat``
    recomputes each block in the backward (:func:`layers.run_block`)."""

    family = "dino"
    num_prefix_tokens = 1
    # (seq group, seq size, this rank's index) under sequence parallelism
    seq = None
    # parallel.pipeline.PipeStage of this rank under pipeline parallelism
    pipe = None

    def __init__(self, config: ViTConfig, image_size: int = 224,
                 image_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 return_all_tokens: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.return_all_tokens = return_all_tokens
        self.remat = False
        self.patch_embed = PatchEmbed(cfg.patch_size, image_channels,
                                      cfg.embed_dim)
        n_patches = (image_size // cfg.patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_patches + 1, cfg.embed_dim))
        self.pos_drop = Dropout(cfg.drop_rate)
        # stochastic depth decays linearly over depth (timm convention)
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                  qkv_bias=cfg.qkv_bias, drop=cfg.drop_rate,
                  attn_drop=cfg.attn_drop_rate,
                  drop_path_rate=cfg.drop_path_rate * i / max(cfg.depth - 1, 1))
            for i in range(cfg.depth))
        self.norm = LayerNorm(cfg.embed_dim, eps=1e-6)

    @property
    def feature_dim(self) -> int:
        return self.config.embed_dim

    def _prefix_tokens(self, B: int):
        """The tokens before the patches: the CLS token."""
        return [self.cls_token.to(self.dtype).expand(B, -1, -1)]

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """The features of the normed tokens: the CLS token's."""
        return x if self.return_all_tokens else x[:, 0]

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Patch embedding, prefix tokens and positions: (B, 1 + N, C)."""
        dt = self.dtype
        x = self.patch_embed(x.to(dt))
        x = torch.cat([*self._prefix_tokens(x.shape[0]), x], dim=1) \
            + self.pos_embed.to(dt)
        return self.pos_drop(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pipe is not None:
            from vit_torch_tpu_torch.parallel.pipeline import (
                vit_pipeline_features)
            return vit_pipeline_features(self, x)
        x = self.embed(x)
        if self.seq is not None:
            return self._forward_seq(x)
        for blk in self.blocks:
            x = run_block(blk, x, remat=self.remat)
        return self._pool(self.norm(x))

    def _forward_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks over this rank's token shard (see the module)."""
        group, S, idx = self.seq
        if self.return_all_tokens:
            raise ValueError("sequence parallelism returns the prefix "
                             "tokens' features only")
        B, N, C = x.shape
        n = -(-N // S)
        if n < self.num_prefix_tokens:
            raise ValueError(f"{N} tokens over seq={S}: the prefix tokens "
                             "must sit on the first shard")
        x = F.pad(x, (0, 0, 0, n * S - N))[:, idx * n:(idx + 1) * n]
        with sequence_parallel(group, N):
            for blk in self.blocks:
                x = run_block(blk, x, remat=self.remat)
        k = self.num_prefix_tokens
        prefix = broadcast_from(self.norm(x[:, :k]).contiguous(), 0, group)
        return self._pool(prefix)


def vit_flops(config: ViTConfig, image_size: int,
              image_channels: int = 3, extra_tokens: int = 1) -> int:
    """Analytic forward FLOPs per image (multiply-adds × 2), the JAX
    package's accounting.  ``extra_tokens`` counts non-patch tokens."""
    p, d = config.patch_size, config.embed_dim
    n_patch = (image_size // p) ** 2
    n = n_patch + extra_tokens
    flops = 2 * n_patch * (p * p * image_channels) * d    # patch embed
    per_block = (
        2 * n * d * 3 * d                             # qkv projection
        + 2 * n * n * d * 2                           # QK^T and PV matmuls
        + 2 * n * d * d                               # output projection
        + 2 * n * d * int(d * config.mlp_ratio) * 2   # MLP fc1+fc2
    )
    return flops + config.depth * per_block
