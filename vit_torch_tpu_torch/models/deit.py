"""DeiT backbones, counterpart of ``vit_torch_tpu/models/deit.py``.

The distilled configs build :class:`DistilledVisionTransformer`: a ViT
with a distillation token beside the CLS token (a position table of
n + 2), whose features are the average of the two normed tokens, the
reference ``DeitCustom``'s forced average (JAX ``:44-82``), so the zoo's
classifier head applies on top.  The other configs are plain ViTs and
build the port's :class:`VisionTransformer` (JAX ``_build_deit``,
``:93-112``).  The blocks are the ViT blocks, so attention takes the flash
kernels and, under ``VITX_FUSED_MLP=1``, every MLP the fused kernel (B12).

Parameter names are timm's (``cls_token``, ``dist_token``, ``pos_embed``,
``blocks.{i}``, ``norm``), so a Facebook DeiT state dict loads by name;
``num_prefix_tokens = 2`` tells the checkpoint importer to keep both
tokens' positions when it interpolates the table.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_torch_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                            vit_flops)

DEIT_CONFIGS = {
    # (config, distilled)
    "deit_tiny_patch16_224": (ViTConfig(16, 192, 12, 3), False),
    "deit_small_patch16_224": (ViTConfig(16, 384, 12, 6), False),
    "deit_base_patch16_224": (ViTConfig(16, 768, 12, 12), False),
    "deit_base_patch16_384": (ViTConfig(16, 768, 12, 12), False),
    "deit_tiny_distilled_patch16_224": (ViTConfig(16, 192, 12, 3), True),
    "deit_small_distilled_patch16_224": (ViTConfig(16, 384, 12, 6), True),
    "deit_base_distilled_patch16_224": (ViTConfig(16, 768, 12, 12), True),
    "deit_base_distilled_patch16_384": (ViTConfig(16, 768, 12, 12), True),
    "deit_test_distilled": (ViTConfig(8, 64, 2, 2), True),
}


class DistilledVisionTransformer(VisionTransformer):
    """ViT with CLS and distillation tokens; returns the average of the two
    normed tokens ``(B, embed_dim)``."""

    family = "deit"
    num_prefix_tokens = 2

    def __init__(self, config: ViTConfig, image_size: int = 224,
                 image_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(config, image_size=image_size,
                         image_channels=image_channels, dtype=dtype)
        D = config.embed_dim
        self.dist_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.pos_embed.shape[1] + 1, D))

    def _prefix_tokens(self, B: int):
        return super()._prefix_tokens(B) + [
            self.dist_token.to(self.dtype).expand(B, -1, -1)]

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return (x[:, 0] + x[:, 1]) / 2


def build_deit(entry, image_size: int = 224, image_channels: int = 3,
               dtype: torch.dtype = torch.bfloat16) -> VisionTransformer:
    """The backbone of a ``DEIT_CONFIGS`` entry ``(config, distilled)``."""
    config, distilled = entry
    cls = DistilledVisionTransformer if distilled else VisionTransformer
    return cls(config, image_size=image_size, image_channels=image_channels,
               dtype=dtype)


def deit_flops(arch: str, image_size: int) -> int:
    """Analytic forward FLOPs per image (multiply-adds × 2): plain ViT
    accounting with a second (distillation) token for distilled
    configs."""
    config, distilled = DEIT_CONFIGS[arch]
    return vit_flops(config, image_size, extra_tokens=2 if distilled else 1)
