"""ResNeXt / Wide-ResNet backbones, counterpart of
``vit_torch_tpu/models/resnet.py``: the bottleneck ResNet-50/101 topology
with grouped 3x3 convs (ResNeXt) or doubled width (WRN), as torchvision
builds it.  The stem is a 7x7/2 conv, BatchNorm, ReLU and a 3x3/2 max
pool; each stage's first block has a 1x1 downsample (conv, BN) and its
stride on the 3x3 conv; the features are the global average pool.

NHWC input, as every backbone of the zoo; the convs run on the NCHW view
with ``channels_last`` strides (cuDNN, grouped convs through
``nn.Conv2d(groups=G)``).  BatchNorm keeps its running statistics as
buffers; in eval every conv+BN pair runs as one folded conv unless
``VITX_FOLD_BN=0`` (:func:`layers.conv_bn`).  Parameter names are
torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{1,2,3}`` /
``bn{1,2,3}``, ``downsample.0`` / ``.1``), so a torchvision state dict
loads by name (its ``fc.*`` head skipped).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.models.layers import (BatchNorm, Conv2d, conv_bn,
                                               run_block)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    groups: int = 1
    width_per_group: int = 64


RESNET_CONFIGS = {
    "resnext50_32x4d": ResNetConfig((3, 4, 6, 3), groups=32,
                                    width_per_group=4),
    "resnext101_32x8d": ResNetConfig((3, 4, 23, 3), groups=32,
                                     width_per_group=8),
    "wide_resnet50_2": ResNetConfig((3, 4, 6, 3), width_per_group=128),
    "wide_resnet101_2": ResNetConfig((3, 4, 23, 3), width_per_group=128),
    # tiny smoke config
    "resnet_test": ResNetConfig((1, 1), groups=1, width_per_group=64),
}

EXPANSION = 4


def resnet_flops(config: ResNetConfig, image_size: int) -> int:
    """Analytic forward FLOPs per image (multiply-adds x 2), the JAX
    package's accounting: the 7x7/2 stem and each bottleneck's 1x1 ->
    grouped 3x3 -> 1x1 with the 1x1 downsample at each stage start (the
    head is left out, as ``vit_flops`` leaves it)."""
    s = image_size // 2
    flops = 2 * s * s * 64 * 3 * 49                    # 7x7 stem
    s = s // 2                                         # 3x3/2 max pool
    cin = 64
    for li, n_blocks in enumerate(config.layers):
        planes = 64 * 2 ** li
        width = int(planes * (config.width_per_group / 64.0)) * config.groups
        out_ch = planes * EXPANSION
        for bi in range(n_blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            s_out = s // stride
            flops += 2 * s * s * width * cin           # conv1 1x1
            flops += 2 * s_out * s_out * width * (width // config.groups) * 9
            flops += 2 * s_out * s_out * out_ch * width  # conv3 1x1
            if bi == 0:
                flops += 2 * s_out * s_out * out_ch * cin  # downsample
            cin, s = out_ch, s_out
    return flops


class Bottleneck(nn.Module):
    """1x1 -> grouped 3x3 (stride here) -> 1x1, each followed by
    BatchNorm, ReLU after the first two and after the residual sum."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64,
                 downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * EXPANSION
        self.conv1 = Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, out_ch, 1, stride=stride, bias=False),
            BatchNorm(out_ch)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(conv_bn(self.conv1, self.bn1, x))
        y = F.relu(conv_bn(self.conv2, self.bn2, y))
        y = conv_bn(self.conv3, self.bn3, y)
        if self.downsample is not None:
            x = conv_bn(self.downsample[0], self.downsample[1], x)
        return F.relu(x + y)


class ResNet(nn.Module):
    """Bottleneck ResNet: pooled ``(B, feature_dim)`` features, or with
    ``features_only`` the per-stage maps ``[C2, C3, C4, C5]`` (strides 4,
    8, 16, 32) in NHWC, the FPN's input for the detection slice.

    ``dtype`` is the activation dtype; parameters and BN statistics stay
    fp32.  ``image_size`` is accepted for the zoo's uniform call and not
    used.  ``remat`` recomputes each bottleneck in the backward
    (:func:`layers.run_block`)."""

    family = "resnet"

    def __init__(self, config: ResNetConfig, image_size: int = 224,
                 image_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 features_only: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = False
        self.features_only = features_only
        self.conv1 = Conv2d(image_channels, 64, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for li, n_blocks in enumerate(cfg.layers):
            planes = 64 * 2 ** li
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(
                    inplanes, planes, stride=2 if (li > 0 and bi == 0) else 1,
                    groups=cfg.groups, base_width=cfg.width_per_group,
                    downsample=bi == 0))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    @property
    def feature_dim(self) -> int:
        return 64 * 2 ** (len(self.config.layers) - 1) * EXPANSION

    def stages(self) -> List[nn.Sequential]:
        return [getattr(self, f"layer{i + 1}")
                for i in range(len(self.config.layers))]

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(conv_bn(self.conv1, self.bn1, x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        maps = []
        for stage in self.stages():
            for blk in stage:
                x = run_block(blk, x, remat=self.remat)
            maps.append(x)
        if self.features_only:
            return [m.permute(0, 2, 3, 1) for m in maps]
        return x.mean(dim=(2, 3))              # global average pool
