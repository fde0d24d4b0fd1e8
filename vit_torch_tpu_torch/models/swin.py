"""Swin Transformer backbone, counterpart of ``vit_torch_tpu/models/swin.py``
(hierarchical shifted-window attention: patch embed, four stages of Swin
blocks with patch merging between them, final LayerNorm).

NHWC input.  Numerics follow the JAX package: fp32 parameters, activations
in the model's ``dtype`` (bfloat16 by default), LayerNorm eps 1e-5, the
relative-position bias gathered from its table outside the kernels.

Parameter and buffer names follow the Microsoft Swin state dict
(``patch_embed.proj.weight`` as a ``(D, C, p, p)`` conv weight,
``layers.{i}.blocks.{j}.attn.qkv.weight``, ``layers.{i}.downsample.
reduction.weight``, ``norm.weight``, ...), so a published checkpoint loads
by name (``checkpoint/torch_import.py``).  ``relative_position_index`` and
``attn_mask`` are non-persistent buffers computed from numpy constants.

Dispatch of a block (the port's own, for CUDA; the TPU's measured policy
does not carry over): a block whose map needs no padding and whose
DropPath is inactive (eval, or rate 0), outside W8A8, runs the
whole-block kernel
:func:`~vit_torch_tpu_torch.ops.window_block.window_block_full_spatial`
(B9); every other block runs PyTorch ops around the window-block kernel
:func:`~vit_torch_tpu_torch.ops.window_block.window_block_spatial` (B8):
LN1, pad, B8 (with the cyclic shift folded in), crop, DropPath, residual,
LN2, MLP, DropPath, residual.  With ``VITX_FUSED_SPATIAL=0`` (read per
call) those blocks take the flat window block
:func:`~vit_torch_tpu_torch.ops.window_block.window_block` (B7) in B8's
place, as the JAX dispatch does when its spatial route is off: roll,
window partition, B7, window reverse, roll back.  The MLP there is
:class:`Mlp`: int8 under W8A8 in eval (``VITX_W8A8=1``; the window qkv
and proj products stay fp, as in the JAX package), the fused kernel
(B12) under ``VITX_FUSED_MLP=1``.  With
grad, every route goes through the block functions' autograd Functions,
whose attention backward is the window-attention backward kernel (B6);
the bias table's gradient flows through the autograd gather of
:meth:`WindowAttention.gathered_bias`.  On the CPU the same dispatch runs
the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.models.layers import (DropPath, Dropout, LayerNorm,
                                               Linear, Mlp, run_block)
from vit_torch_tpu_torch.ops import window_block as wb
from vit_torch_tpu_torch.parallel.collectives import (copy_to_group,
                                                      reduce_from_group)
from vit_torch_tpu_torch.ops.window_block import (  # noqa: F401 (re-export)
    window_partition, window_reverse)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    patch_norm: bool = True

    @property
    def feature_dim(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


_cfg = SwinConfig

# the Microsoft Swin configs; *_22k variants share the architecture (they
# differ only in pretraining data)
SWIN_CONFIGS: Dict[str, SwinConfig] = {
    "swin_tiny_patch4_window7_224": _cfg(),
    "swin_small_patch4_window7_224": _cfg(depths=(2, 2, 18, 2)),
    "swin_base_patch4_window7_224": _cfg(embed_dim=128, depths=(2, 2, 18, 2),
                                         num_heads=(4, 8, 16, 32)),
    "swin_base_patch4_window12_384": _cfg(embed_dim=128, depths=(2, 2, 18, 2),
                                          num_heads=(4, 8, 16, 32),
                                          window_size=12),
    "swin_large_patch4_window7_224": _cfg(embed_dim=192, depths=(2, 2, 18, 2),
                                          num_heads=(6, 12, 24, 48)),
    "swin_large_patch4_window12_384": _cfg(embed_dim=192, depths=(2, 2, 18, 2),
                                           num_heads=(6, 12, 24, 48),
                                           window_size=12),
    # tiny smoke configs (not reference archs)
    "swin_test": _cfg(embed_dim=16, depths=(1, 1), num_heads=(2, 4),
                      window_size=4, drop_path_rate=0.0),
    "swin_test3": _cfg(embed_dim=16, depths=(1, 1, 1), num_heads=(2, 2, 4),
                       window_size=4, drop_path_rate=0.0),
}
for _name in list(SWIN_CONFIGS):
    if _name.endswith(("_224", "_384")):
        SWIN_CONFIGS[_name + "_22k"] = SWIN_CONFIGS[_name]


# --------------------------------------------------------------------------
# static helpers
# --------------------------------------------------------------------------

def relative_position_index(w: int) -> np.ndarray:
    """Static (w², w²) index into the (2w-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)                          # (2, w²)
    rel = coords[:, :, None] - coords[:, None, :]           # (2, w², w²)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shifted_window_mask(Hp: int, Wp: int, w: int, shift: int) -> np.ndarray:
    """Static SW-MSA mask: (nW, w², w²) additive, -100 between tokens that
    came from different regions of the rolled map, 0 elsewhere."""
    img = np.zeros((1, Hp, Wp, 1), np.float32)
    cnt = 0
    for h_sl in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for w_sl in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, h_sl, w_sl, :] = cnt
            cnt += 1
    windows = img.reshape(1, Hp // w, w, Wp // w, w, 1)
    windows = windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, w * w)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _mask_on(Hp: int, Wp: int, w: int, shift: int,
             device: torch.device) -> torch.Tensor:
    """The mask as a device tensor, built once per shape and device."""
    return torch.from_numpy(shifted_window_mask(Hp, Wp, w, shift)).to(device)


def block_geometry(H: int, W: int, window: int,
                   shift_size: int) -> Tuple[int, int]:
    """(w, shift) of a block on an H×W map: the window shrinks to the map,
    and a window that covers the map takes no shift."""
    w = min(window, H, W)
    shift = shift_size if w < min(H, W) else 0
    if min(H, W) <= window:
        shift = 0
    return w, shift


def _stage_maps(config: SwinConfig, image_size: int) -> List[Tuple[int, int]]:
    """The (H, W) token map of each stage for a square input."""
    side = -(-image_size // config.patch_size)
    maps = []
    for _ in config.depths:
        maps.append((side, side))
        side = -(-side // 2)
    return maps


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

class WindowAttention(nn.Module):
    """The parameters of W-MSA with a relative-position bias: ``qkv``
    (outputs ordered (3, H, D)), ``proj`` and the ``(2w-1)², H`` bias
    table.  The block kernels consume them; :meth:`gathered_bias` is the
    table gathered to ``(H, N, N)``."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.empty(window * window, window * window,
                                         dtype=torch.long), persistent=False)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        # set by parallel.partition.apply_tensor_parallel: qkv, proj and
        # the bias table hold this rank's heads
        self.tp_group = None
        self.reset_buffers()

    def reset_buffers(self, device=None) -> None:
        """(Re)compute the buffer on ``device`` (its own when None): after
        ``to_empty`` or a state-dict load onto a model built on meta."""
        device = device or self.relative_position_index.device
        idx = torch.from_numpy(relative_position_index(self.window))
        self.relative_position_index = idx.to(device)

    def gathered_bias(self) -> torch.Tensor:
        N = self.window * self.window
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        return bias.reshape(N, N, self.num_heads).permute(2, 0, 1) \
            .contiguous().float()


class SwinBlock(nn.Module):
    """One Swin block on a ``(B, H, W, C)`` map.  ``input_resolution`` is
    the map it is built for: it fixes the window (and so the bias table's
    size) and the ``attn_mask`` buffer; a map of another size recomputes
    the mask (cached per shape)."""

    def __init__(self, dim: int, num_heads: int,
                 input_resolution: Tuple[int, int], window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0):
        super().__init__()
        H, W = input_resolution
        self.input_resolution = (H, W)
        self.window_size = window_size
        self.shift_size = shift_size
        w, shift = block_geometry(H, W, window_size, shift_size)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, w, qkv_bias)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.register_buffer("attn_mask", None, persistent=False)
        self.reset_buffers(torch.empty(0).device)

    def reset_buffers(self, device=None) -> None:
        """(Re)compute ``attn_mask`` (empty for an unshifted block) on
        ``device`` (its own when None)."""
        device = device or self.attn_mask.device
        H, W = self.input_resolution
        w, shift = block_geometry(H, W, self.window_size, self.shift_size)
        mask = np.zeros((0, w * w, w * w), np.float32)
        if shift:
            mask = shifted_window_mask(-(-H // w) * w, -(-W // w) * w, w,
                                       shift)
        self.attn_mask = torch.from_numpy(mask).to(device)

    def _mask(self, Hp: int, Wp: int, w: int, shift: int, H: int, W: int):
        if not shift:
            return None
        if (H, W) == self.input_resolution:
            return self.attn_mask
        return _mask_on(Hp, Wp, w, shift, self.attn_mask.device)

    def _full_block_route(self, pad_needed: bool) -> bool:
        """B9 takes the block when the map needs no padding (LayerNorm does
        not commute with zero padding), DropPath is inactive (the
        residuals are inside the kernel) and W8A8 is off: under W8A8 in
        eval the block runs B8 with its fp window products and the MLP
        through int8, as the JAX ``_use_fused_block_full`` decides."""
        drop_active = self.training and self.drop_path.rate > 0.0
        return (not pad_needed and not drop_active
                and not self.mlp.fc1.quantized())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w, shift = block_geometry(H, W, self.window_size, self.shift_size)
        if w != self.attn.window:
            raise ValueError(f"a {H}x{W} map takes window {w}; this block "
                             f"was built for window {self.attn.window}")
        pad_b, pad_r = (-H) % w, (-W) % w
        Hp, Wp = H + pad_b, W + pad_r
        dt = x.dtype
        attn = self.attn
        bias = attn.gathered_bias()
        mask = self._mask(Hp, Wp, w, shift, H, W)
        b = lambda t: None if t is None else t.to(dt)   # noqa: E731
        qkv = (attn.qkv.weight.to(dt), b(attn.qkv.bias))
        proj = (attn.proj.weight.to(dt), b(attn.proj.bias))
        if attn.tp_group is not None:
            return self._forward_tp(x, qkv, bias, mask, proj, w, shift,
                                    pad_b, pad_r)
        if self._full_block_route(bool(pad_b or pad_r)):
            mlp = self.mlp
            return wb.window_block_full_spatial(
                x, (self.norm1.weight, self.norm1.bias), qkv, bias, mask,
                proj, (self.norm2.weight, self.norm2.bias),
                (mlp.fc1.weight.to(dt), mlp.fc1.bias.to(dt)),
                (mlp.fc2.weight.to(dt), mlp.fc2.bias.to(dt)),
                num_heads=attn.num_heads, window=w, scale=attn.scale,
                shift=shift)
        y = self.norm1(x)
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        if os.environ.get("VITX_FUSED_SPATIAL", "") == "0":
            y = torch.roll(y, (-shift, -shift), dims=(1, 2)) if shift else y
            y = window_reverse(wb.window_block(
                window_partition(y, w), *qkv, bias, mask, *proj,
                num_heads=attn.num_heads, scale=attn.scale), w, Hp, Wp)
            y = torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y
        else:
            y = wb.window_block_spatial(y, *qkv, bias, mask, *proj,
                                        num_heads=attn.num_heads, window=w,
                                        scale=attn.scale, shift=shift)
        if pad_b or pad_r:
            y = y[:, :H, :W]
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x)))

    def _forward_tp(self, x, qkv, bias, mask, proj, w, shift, pad_b, pad_r):
        """The block on this rank's heads (tensor parallel): LN1, pad, B8
        over the local heads with a zero output bias, the output
        all-reduced over the ``model`` group and proj's bias added once,
        crop, DropPath, residual, then the (sharded) MLP."""
        B, H, W, C = x.shape
        g = self.attn.tp_group
        y = self.norm1(x)
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        y = wb.window_block_spatial(
            copy_to_group(y, g), *qkv, bias, mask, proj[0],
            torch.zeros_like(proj[1]), num_heads=self.attn.num_heads,
            window=w, scale=self.attn.scale, shift=shift)
        y = reduce_from_group(y, g) + proj[1]
        if pad_b or pad_r:
            y = y[:, :H, :W]
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2×2 neighbourhood concat (4C, order x0, x1, x2, x3) → LayerNorm →
    Linear to 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        pad_b, pad_r = H % 2, W % 2
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        x = torch.cat([x0, x1, x2, x3], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: ``blocks`` and the optional ``downsample`` after them."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 input_resolution: Tuple[int, int], config: SwinConfig,
                 drop_path_rates: List[float], downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, input_resolution,
                      window_size=config.window_size,
                      shift_size=0 if i % 2 == 0 else config.window_size // 2,
                      mlp_ratio=config.mlp_ratio, qkv_bias=config.qkv_bias,
                      drop_path_rate=drop_path_rates[i])
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    """Patch embedding as reshape + matmul over NHWC input (zero-padded to
    a multiple of the patch), fp32 accumulation and bias, then the
    optional LayerNorm.  ``proj`` is a stride-p conv only as the holder of
    the ``(D, C, p, p)`` weight layout."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 patch_norm: bool):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = LayerNorm(embed_dim) if patch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.patch_size
        pad_b, pad_r = (-H) % p, (-W) % p
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            H, W = H + pad_b, W + pad_r
        gh, gw = H // p, W // p
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh, gw, p * p * C)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, p * p * C)
        # the activation-dtype values multiply with fp32 accumulation
        y = torch.matmul(x.float(), w.to(x.dtype).float().t())
        y = (y + self.proj.bias.float()).to(x.dtype)
        return y if self.norm is None else self.norm(y)


class SwinTransformer(nn.Module):
    """Swin backbone for ``image_size`` inputs.  Token-mean features
    ``(B, C_final)`` out; ``features_only`` gives the final normed map
    ``(B, H', W', C_final)``; ``multi_features`` the per-stage maps (the
    last one normed).  ``dtype`` is the activation dtype; parameters stay
    fp32.  ``remat`` recomputes each block in the backward
    (:func:`layers.run_block`)."""

    family = "swin"

    def __init__(self, config: SwinConfig, image_size: int = 224,
                 image_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 features_only: bool = False, multi_features: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = False
        self.features_only = features_only
        self.multi_features = multi_features
        self.patch_embed = PatchEmbed(cfg.patch_size, image_channels,
                                      cfg.embed_dim, cfg.patch_norm)
        self.pos_drop = Dropout(cfg.drop_rate)
        total = sum(cfg.depths)
        # stochastic depth grows linearly over the total depth
        rates = [cfg.drop_path_rate * i / max(total - 1, 1)
                 for i in range(total)]
        maps = _stage_maps(cfg, image_size)
        layers, start, dim = [], 0, cfg.embed_dim
        for li, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            layers.append(BasicLayer(
                dim, depth, heads, maps[li], cfg,
                rates[start:start + depth],
                downsample=li < len(cfg.depths) - 1))
            start += depth
            dim *= 2
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(cfg.feature_dim)

    @property
    def feature_dim(self) -> int:
        return self.config.feature_dim

    @property
    def stage_dims(self) -> List[int]:
        """The channels of the ``multi_features`` maps, stage by stage."""
        return [self.config.embed_dim * 2 ** i
                for i in range(len(self.config.depths))]

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = self.pos_drop(self.patch_embed(x.to(self.dtype)))
        stages = []
        for layer in self.layers:
            for blk in layer.blocks:
                x = run_block(blk, x, remat=self.remat)
            stages.append(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        x = self.norm(x)
        if self.multi_features:
            return stages[:-1] + [x]
        if self.features_only:
            return x
        return x.mean(dim=(1, 2))


def swin_flops(config: SwinConfig, image_size: int) -> int:
    """Analytic forward FLOPs per image (multiply-adds × 2), the JAX
    package's accounting."""
    p, w = config.patch_size, config.window_size
    gh = gw = image_size // p
    flops = 2 * gh * gw * config.embed_dim * 3 * p * p  # patch embed
    dim = config.embed_dim
    H_, W_ = gh, gw
    for li, (depth, heads) in enumerate(zip(config.depths, config.num_heads)):
        for _ in range(depth):
            n = H_ * W_
            ws = min(w, H_, W_) ** 2
            flops += 2 * n * dim * dim * 3              # qkv
            flops += 2 * n * ws * dim * 2               # attn matmuls
            flops += 2 * n * dim * dim                  # proj
            flops += 2 * n * dim * int(dim * config.mlp_ratio) * 2  # mlp
        if li < len(config.depths) - 1:
            flops += 2 * (H_ // 2) * (W_ // 2) * 4 * dim * 2 * dim
            H_, W_, dim = H_ // 2, W_ // 2, dim * 2
    return flops
