"""XCiT backbone (Cross-Covariance Image Transformer), counterpart of
``vit_torch_tpu/models/xcit.py``: a conv patch embedding of 3 (patch 8) or
4 (patch 16) stride-2 3x3 convs, each followed by BatchNorm with GELU
between them, a Fourier position encoding projected by a 1x1 conv, XCA
blocks (cross-covariance attention, Local Patch Interaction, MLP, each
with a LayerScale gate), then class-attention blocks over the CLS token
and the final LayerNorm (eps 1e-6 everywhere); CLS features out.

NHWC input.  Numerics follow the JAX package: fp32 parameters, activations
in the model's ``dtype`` (bfloat16 by default), BatchNorm and LayerNorm in
fp32.  Parameter names are facebookresearch/xcit's
(``patch_embed.proj.{2i}.0`` / ``.1`` for conv and BN,
``pos_embeder.token_projection``, ``blocks.{i}.local_mp.{conv1,bn,conv2}``,
``cls_attn_blocks.{i}``, ``cls_token``, ``norm``), so a published
checkpoint loads by name with its BN running statistics
(``checkpoint/torch_import.py``).

No Pallas kernel lies on this family in the JAX package: XCA and the class
attention are einsums and the convs are XLA's, so here they are PyTorch
ops (cuBLAS and cuDNN).  Every block's MLP is :class:`layers.Mlp`, which
takes the fused MLP kernel (B12) under ``VITX_FUSED_MLP=1``, as the JAX
module dispatches it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from vit_torch_tpu_torch.models.layers import (BatchNorm, Conv2d, DropPath,
                                               LayerNorm, Linear, Mlp,
                                               gelu_exact, run_block)


@dataclasses.dataclass(frozen=True)
class XCiTConfig:
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    eta: float = 1.0                 # LayerScale init
    tokens_norm: bool = True
    cls_attn_layers: int = 2
    use_pos: bool = True
    # stochastic depth of the XCA blocks, one rate for every block as in
    # facebookresearch/xcit; the JAX package has none (0 is its model)
    drop_path_rate: float = 0.0


def _x(**kw) -> XCiTConfig:
    return XCiTConfig(**kw)


# the facebookresearch/xcit registrations
XCIT_CONFIGS = {}
for _p in (16, 8):
    XCIT_CONFIGS.update({
        f"xcit_nano_12_p{_p}": _x(patch_size=_p, embed_dim=128, depth=12,
                                  num_heads=4, eta=1.0, tokens_norm=False),
        f"xcit_tiny_12_p{_p}": _x(patch_size=_p, embed_dim=192, depth=12,
                                  num_heads=4, eta=1.0),
        f"xcit_small_12_p{_p}": _x(patch_size=_p, embed_dim=384, depth=12,
                                   num_heads=8, eta=1.0),
        f"xcit_tiny_24_p{_p}": _x(patch_size=_p, embed_dim=192, depth=24,
                                  num_heads=4, eta=1e-5),
        f"xcit_small_24_p{_p}": _x(patch_size=_p, embed_dim=384, depth=24,
                                   num_heads=8, eta=1e-5),
        f"xcit_medium_24_p{_p}": _x(patch_size=_p, embed_dim=512, depth=24,
                                    num_heads=8, eta=1e-5),
        f"xcit_large_24_p{_p}": _x(patch_size=_p, embed_dim=768, depth=24,
                                   num_heads=16, eta=1e-5),
    })
# tiny smoke config
XCIT_CONFIGS["xcit_test"] = _x(patch_size=8, embed_dim=32, depth=2,
                               num_heads=2)


def _stem_widths(patch_size: int, d: int):
    if patch_size == 16:
        return [d // 8, d // 4, d // 2, d]
    if patch_size == 8:
        return [d // 4, d // 2, d]
    raise ValueError("conv patch embed supports patch size 8 or 16")


def xcit_flops(config: XCiTConfig, image_size: int) -> int:
    """Analytic forward FLOPs per image (multiply-adds x 2), the JAX
    package's accounting: the conv stem, the XCA blocks (the d_h x d_h
    covariance and its apply are linear in N; LPI's two depthwise 3x3s)
    and the class-attention blocks (q, attention and MLP on the CLS token;
    qkv over every token)."""
    d, H = config.embed_dim, config.num_heads
    dh = d // H
    hidden = int(d * config.mlp_ratio)
    flops = 0
    cin, s = 3, image_size
    for w in _stem_widths(config.patch_size, d):       # conv patch embed
        s = (s + 1) // 2
        flops += 2 * s * s * w * cin * 9
        cin = w
    n = s * s
    per_block = (
        2 * n * d * 3 * d                              # qkv
        + 2 * n * dh * d * 2                           # XCA q.k^T + apply
        + 2 * n * d * d                                # proj
        + 2 * n * d * 9 * 2                            # LPI depthwise x2
        + 2 * n * d * hidden * 2)                      # MLP
    flops += config.depth * per_block
    nk = n + 1                                         # CA blocks see CLS
    per_ca = (
        2 * nk * d * 3 * d                             # fused qkv
        + 2 * 1 * nk * d * 2                           # CLS-query attn
        + 2 * 1 * d * d                                # proj
        + 2 * 1 * d * hidden * 2)                      # CLS-only MLP
    return flops + config.cls_attn_layers * per_ca


def fourier_pos_encoding(H: int, W: int, hidden_dim: int = 32,
                         temperature: float = 10000.0) -> torch.Tensor:
    """The ``(1, H, W, 2 * hidden_dim)`` sine/cosine grid encoding in fp32
    on the CPU (facebookresearch's ``PositionalEncodingFourier`` with an
    all-valid mask): y features first, then x, sine on even and cosine on
    odd channels."""
    scale, eps = 2 * math.pi, 1e-6
    y = torch.arange(1, H + 1, dtype=torch.float32)[:, None] / (H + eps)
    x = torch.arange(1, W + 1, dtype=torch.float32)[None, :] / (W + eps)
    y, x = (t * scale for t in torch.broadcast_tensors(y, x))
    dim_t = torch.arange(hidden_dim, dtype=torch.float32)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / hidden_dim)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(H, W, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(H, W, -1)
    return torch.cat([pos_y, pos_x], dim=-1)[None]


class PositionalEncodingFourier(nn.Module):
    """The Fourier encoding's projection to the embedding width: a 1x1
    conv ``token_projection`` (weight ``(C, 64, 1, 1)``), applied to the
    encoding as an fp32 matmul and cast to the activation dtype, as the
    JAX model does with its ``pos_proj_kernel``.  The encoding depends on
    neither the weights nor the batch, so :meth:`tokens` makes it once per
    grid and device."""

    def __init__(self, dim: int, hidden_dim: int = 32):
        super().__init__()
        self.token_projection = nn.Conv2d(2 * hidden_dim, dim, 1)
        self._tokens = {}

    def tokens(self, hw: Tuple[int, int], device: torch.device
               ) -> torch.Tensor:
        """:func:`fourier_pos_encoding` as ``(1, H*W, 64)`` tokens on
        ``device``, made outside inference mode, so that a table first
        made while serving can be saved for a later backward."""
        key = (*hw, device)
        if key not in self._tokens:
            with torch.inference_mode(False):
                self._tokens[key] = fourier_pos_encoding(*hw).reshape(
                    1, hw[0] * hw[1], -1).to(device)
        return self._tokens[key]

    def forward(self, hw: Tuple[int, int], device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
        w = self.token_projection.weight[:, :, 0, 0]
        return (self.tokens(hw, device) @ w.float().t()
                + self.token_projection.bias.float()).to(dtype)


class ConvPatchEmbed(nn.Module):
    """Stride-2 3x3 convs, each followed by BatchNorm, GELU between them:
    ``proj`` is the ``nn.Sequential`` of facebookresearch/xcit, whose even
    entries are (conv, BN) pairs.  NCHW in, ``(B, Hp*Wp, C)`` tokens and
    ``(Hp, Wp)`` out."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3):
        super().__init__()
        mods, cin = [], in_chans
        for i, w in enumerate(_stem_widths(patch_size, embed_dim)):
            if i:
                mods.append(nn.GELU())
            mods.append(nn.Sequential(
                Conv2d(cin, w, 3, stride=2, padding=1, bias=False),
                BatchNorm(w)))
            cin = w
        self.proj = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        B, C, Hp, Wp = x.shape
        return x.permute(0, 2, 3, 1).reshape(B, Hp * Wp, C), (Hp, Wp)


class LPI(nn.Module):
    """Local Patch Interaction: depthwise 3x3 (with bias) -> GELU -> BN ->
    depthwise 3x3 over the token grid."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.bn = BatchNorm(dim)
        self.conv2 = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        B, N, C = x.shape
        y = x.reshape(B, *hw, C).permute(0, 3, 1, 2)
        y = self.conv2(self.bn(gelu_exact(self.conv1(y))))
        return y.permute(0, 2, 3, 1).reshape(B, N, C)


def xca_core(qkv: torch.Tensor, temperature: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """The XCA math between the qkv and proj products (the JAX
    ``xca_core``): per head, the d x d covariance of q and k over the token
    axis, normalised by the L2 norms of their columns, times the
    temperature, softmax, applied to v.

    Transpose-free: ``normalize(q) . normalize(k)^T`` is ``q . k^T`` over
    the outer product of the norms, so the covariance contracts the token
    axis of the ``(B, N, H, d)`` views in place (accumulated and kept in
    fp32) and the normalisation runs on the small d x d matrix.  The
    softmax is rounded to the activation dtype before the apply.  ``qkv``
    is ``(B, N, 3C)``; ``(B, N, C)`` out."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    q, k, v = qkv.view(B, N, 3, num_heads, d).unbind(2)
    q32, k32 = q.float(), k.float()
    cov = torch.einsum("bnhd,bnhe->bhde", q32, k32)
    qn = torch.linalg.vector_norm(q32, dim=1).clamp_min(1e-12)
    kn = torch.linalg.vector_norm(k32, dim=1).clamp_min(1e-12)
    attn = cov / (qn[..., None] * kn[:, :, None, :])
    attn = torch.softmax(attn * temperature.float(), dim=-1).to(qkv.dtype)
    return torch.einsum("bhde,bnhe->bnhd", attn, v).reshape(B, N, C)


class XCA(nn.Module):
    """Cross-covariance attention: d x d channel attention with L2-normalised
    q and k and a learnable per-head ``temperature`` ``(H, 1, 1)``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(xca_core(self.qkv(x), self.temperature,
                                  self.num_heads))


class XCABlock(nn.Module):
    """XCA -> LPI -> MLP, each pre-normed and gated by LayerScale
    (``gamma1``, ``gamma3``, ``gamma2`` in that order)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, eta: float = 1.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.init_scale = eta            # read by layers.init_weights
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = XCA(dim, num_heads, qkv_bias)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.local_mp = LPI(dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)
        for name in ("gamma1", "gamma2", "gamma3"):
            setattr(self, name, nn.Parameter(torch.full((dim,), eta)))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        dt = x.dtype
        x = x + self.drop_path(self.gamma1.to(dt) * self.attn(self.norm1(x)))
        x = x + self.drop_path(self.gamma3.to(dt)
                               * self.local_mp(self.norm3(x), hw))
        return x + self.drop_path(self.gamma2.to(dt)
                                  * self.mlp(self.norm2(x)))


class XCiTClassAttention(nn.Module):
    """Class attention with a fused qkv over every token, the query taken
    from the CLS token: fp32 logits, the softmax rounded to the activation
    dtype before PV, the patch tokens passed through."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        d = C // H
        qkv = self.qkv(x).view(B, N, 3, H, d)
        q = qkv[:, :1, 0] * d ** -0.5                    # (B, 1, H, d)
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        cls = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, 1, C)
        return torch.cat([self.proj(cls), x[:, 1:]], dim=1)


class ClassAttentionBlock(nn.Module):
    """Class-attention block with both ``tokens_norm`` variants.

    facebookresearch/xcit's residual quirk is kept so that its checkpoints
    compute what they were trained to (PARITY.md): the MLP residual starts
    from the post-norm tensor, and the patch tokens come out doubled."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, eta: float = 1.0,
                 tokens_norm: bool = True):
        super().__init__()
        self.init_scale = eta
        self.tokens_norm = tokens_norm
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = XCiTClassAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(torch.full((dim,), eta))
        self.gamma2 = nn.Parameter(torch.full((dim,), eta))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x + self.gamma1.to(dt) * self.attn(self.norm1(x))
        if self.tokens_norm:
            xn = self.norm2(x)
        else:
            xn = torch.cat([self.norm2(x[:, :1]), x[:, 1:]], dim=1)
        cls = xn[:, :1] + self.gamma2.to(dt) * self.mlp(xn[:, :1])
        return torch.cat([cls, 2.0 * xn[:, 1:]], dim=1)


class XCiT(nn.Module):
    """XCiT backbone returning CLS features ``(B, embed_dim)``.

    ``dtype`` is the activation dtype; parameters stay fp32.  The conv
    stem takes any image size (``image_size`` is accepted for the zoo's
    uniform call and not used); the grid is the stem's output.  ``remat``
    recomputes each XCA block in the backward (:func:`layers.run_block`),
    as the JAX model's ``remat`` does."""

    family = "xcit"

    def __init__(self, config: XCiTConfig, image_size: int = 224,
                 image_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = False
        D = cfg.embed_dim
        self.patch_embed = ConvPatchEmbed(cfg.patch_size, D, image_channels)
        if cfg.use_pos:
            self.pos_embeder = PositionalEncodingFourier(D)
        self.blocks = nn.ModuleList(
            XCABlock(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias, cfg.eta,
                     cfg.drop_path_rate) for _ in range(cfg.depth))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.cls_attn_blocks = nn.ModuleList(
            ClassAttentionBlock(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                                cfg.eta, cfg.tokens_norm)
            for _ in range(cfg.cls_attn_layers))
        self.norm = LayerNorm(D, eps=1e-6)

    @property
    def feature_dim(self) -> int:
        return self.config.embed_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x, hw = self.patch_embed(x.to(dt).permute(0, 3, 1, 2))
        if self.config.use_pos:
            x = x + self.pos_embeder(hw, x.device, dt)
        for blk in self.blocks:
            x = run_block(blk, x, hw, remat=self.remat)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for blk in self.cls_attn_blocks:
            x = blk(x)
        # LayerNorm is per token: the CLS token's norm alone is the norm of
        # the sequence's first token
        return self.norm(x[:, :1])[:, 0]
