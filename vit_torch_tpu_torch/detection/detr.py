"""DETR set-prediction detector, counterpart of
``vit_torch_tpu/detection/detr.py`` (the reference's
``object_detr/models/detr.py:41-376``, ``transformer.py`` and
``position_encoding.py:12-76``): a backbone feature map, an encoder and a
decoder with the position embeddings injected into the attention's
queries and keys, class and box heads on every decoder layer's normed
output, the Hungarian-matched set losses and the postprocess to scored
boxes in original pixels.

Fixed shapes, as in the JAX package: a fixed query count, letterboxed
images, padded gt sets with a validity mask, boxes normalised cxcywh in
[0, 1], background at class 0 and the no-object weight ``eos_coef``
0.1.  Attention is :func:`~vit_torch_tpu_torch.ops.attention.
dot_product_attention`: on CUDA the flash kernels, the decoder's
cross-attention with a key length of its own (100 queries against the
Hf·Wf memory tokens).  ``MHA``'s q/k/v/out, ``linear1``/``linear2`` and
``input_proj`` are :class:`~vit_torch_tpu_torch.models.layers.QLinear`:
int8 in eval under ``VITX_W8A8=1``, never in training.  Parameters are
fp32 and activations run in the model's ``dtype``; the backbone is the
port's ``SwinTransformer(features_only=True)``, whose state-dict keys stay
Swin's own under ``backbone.``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.detection.boxes import (cxcywh_to_xyxy,
                                                 generalized_box_iou)
from vit_torch_tpu_torch.models.layers import (LayerNorm, Linear, QLinear,
                                               init_weights)
from vit_torch_tpu_torch.ops.attention import dot_product_attention
from vit_torch_tpu_torch.parallel.collectives import global_sum


@functools.lru_cache(maxsize=16)
def _sine(h: int, w: int, dim: int, temperature: float,
          device: torch.device) -> torch.Tensor:
    half = dim // 2
    scale, eps = 2 * math.pi, 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32) / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32) / (w + eps) * scale
    dim_t = torch.arange(half // 2, dtype=torch.float32)
    dim_t = temperature ** (2 * dim_t / half)

    def enc(v):   # (n,) -> (n, half)
        pos = v[:, None] / dim_t
        return torch.stack([pos.sin(), pos.cos()], dim=2).reshape(len(v), -1)

    pos_y = enc(y)[:, None, :].expand(h, w, -1)
    pos_x = enc(x)[None, :, :].expand(h, w, -1)
    return torch.cat([pos_y, pos_x], -1).reshape(1, h * w, -1).to(device)


def sine_position_embedding(h: int, w: int, dim: int,
                            temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """(1, h*w, dim) fp32 sine/cosine 2-D position embedding (reference
    ``position_encoding.py:12-49`` with an all-valid mask), cached per
    grid and device."""
    return _sine(h, w, dim, float(temperature),
                 torch.device(device or "cpu"))


class LearnedPositionEmbedding(nn.Module):
    """Learned 50×50 row and column tables (reference
    ``position_encoding.py:52-76``): pos(y, x) = [col_embed[x],
    row_embed[y]]."""

    def __init__(self, hidden_dim: int, table_size: int = 50):
        super().__init__()
        half = hidden_dim // 2
        self.row_embed = nn.Parameter(torch.empty(table_size, half))
        self.col_embed = nn.Parameter(torch.empty(table_size, half))

    def forward(self, h: int, w: int) -> torch.Tensor:
        half = self.row_embed.shape[1]
        pos = torch.cat([self.col_embed[None, :w].expand(h, w, half),
                         self.row_embed[:h, None].expand(h, w, half)], -1)
        return pos.reshape(1, h * w, 2 * half)


class MHA(nn.Module):
    """Multi-head attention with its queries, keys and values given apart
    (DETR adds the position embeddings to q and k only)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v, self.out = (QLinear(dim, dim)
                                            for _ in range(4))

    def forward(self, q, k, v):
        B, Nq, C = q.shape
        H = self.num_heads
        d = C // H
        qp = self.q(q).reshape(B, Nq, H, d)
        kp = self.k(k).reshape(B, -1, H, d)
        vp = self.v(v).reshape(B, -1, H, d)
        out = dot_product_attention(qp, kp, vp, scale=d ** -0.5)
        return self.out(out.reshape(B, Nq, C))


class _FFN(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.linear1 = QLinear(dim, ffn_dim)
        self.linear2 = QLinear(ffn_dim, dim)

    def ffn(self, y):
        return self.linear2(F.relu(self.linear1(y)))


class EncoderLayer(_FFN):
    """Self-attention and FFN, post-norm (DETR's default) or pre-norm (the
    reference transformer's ``normalize_before``)."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 pre_norm: bool = False):
        super().__init__(dim, ffn_dim)
        self.pre_norm = pre_norm
        self.self_attn = MHA(dim, num_heads)
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, pos):
        if self.pre_norm:
            y = self.norm1(x)
            x = x + self.self_attn(y + pos, y + pos, y)
            return x + self.ffn(self.norm2(x))
        x = self.norm1(x + self.self_attn(x + pos, x + pos, x))
        return self.norm2(x + self.ffn(x))


class DecoderLayer(_FFN):
    """Self-attention over the queries, cross-attention into the memory,
    FFN; post-norm or pre-norm."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 pre_norm: bool = False):
        super().__init__(dim, ffn_dim)
        self.pre_norm = pre_norm
        self.self_attn = MHA(dim, num_heads)
        self.cross_attn = MHA(dim, num_heads)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim)
                                              for _ in range(3))

    def forward(self, tgt, memory, query_pos, mem_pos):
        mem_k = memory + mem_pos
        if self.pre_norm:
            y = self.norm1(tgt)
            tgt = tgt + self.self_attn(y + query_pos, y + query_pos, y)
            y = self.norm2(tgt)
            tgt = tgt + self.cross_attn(y + query_pos, mem_k, memory)
            return tgt + self.ffn(self.norm3(tgt))
        tgt = self.norm1(tgt + self.self_attn(tgt + query_pos,
                                              tgt + query_pos, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + query_pos, mem_k,
                                               memory))
        return self.norm3(tgt + self.ffn(tgt))


class BoxMLP(nn.Module):
    """3-layer box head (reference ``MLP``, ``detr.py:297-309``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc0 = Linear(dim, hidden)
        self.fc1 = Linear(hidden, hidden)
        self.fc2 = Linear(hidden, 4)

    def forward(self, x):
        x = F.relu(self.fc0(x))
        return self.fc2(F.relu(self.fc1(x)))


@dataclasses.dataclass(frozen=True)
class DETRConfig:
    num_classes: int = 91
    num_queries: int = 100
    hidden_dim: int = 256
    num_heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 2048
    aux_loss: bool = True
    # "sine" (default) or "learned", the reference's two variants
    position_embedding: str = "sine"
    # pre-norm (the reference's normalize_before): trains stably from
    # scratch; post-norm is DETR's default and wants warmup
    pre_norm: bool = False


class DETR(nn.Module):
    """Backbone feature map → encoder/decoder → class and box predictions
    of every decoder layer.  ``backbone`` maps NHWC images to a
    ``(B, H', W', C)`` map and has a ``feature_dim``."""

    def __init__(self, config: DETRConfig, backbone: nn.Module,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.backbone = backbone
        C = cfg.hidden_dim
        self.input_proj = QLinear(backbone.feature_dim, C)
        self.position_embedding = (LearnedPositionEmbedding(C)
                                   if cfg.position_embedding == "learned"
                                   else None)
        self.encoder = nn.ModuleList(
            EncoderLayer(C, cfg.num_heads, cfg.ffn_dim, cfg.pre_norm)
            for _ in range(cfg.enc_layers))
        self.encoder_norm = LayerNorm(C) if cfg.pre_norm else None
        self.query_embed = nn.Parameter(torch.empty(cfg.num_queries, C))
        self.decoder = nn.ModuleList(
            DecoderLayer(C, cfg.num_heads, cfg.ffn_dim, cfg.pre_norm)
            for _ in range(cfg.dec_layers))
        self.decoder_norm = LayerNorm(C)
        self.class_embed = Linear(C, cfg.num_classes + 1)
        self.bbox_embed = BoxMLP(C, C)

    def position(self, h: int, w: int, device) -> torch.Tensor:
        if self.position_embedding is not None:
            return self.position_embedding(h, w)
        return sine_position_embedding(h, w, self.config.hidden_dim,
                                       device=device)

    def detect(self, feats: torch.Tensor):
        """The transformer and the heads over a backbone map ``(B, Hf, Wf,
        C')``: the predictions of every decoder layer, the encoder memory
        ``(B, Hf·Wf, hidden)`` and the last decoder layer's normed output
        ``(B, Q, hidden)`` (what the mask branch of
        :class:`~vit_torch_tpu_torch.detection.segmentation.DETRSegm`
        reads)."""
        cfg = self.config
        B, Hf, Wf, Cf = feats.shape
        src = self.input_proj(feats.reshape(B, Hf * Wf, Cf).to(self.dtype))
        pos = self.position(Hf, Wf, src.device).to(src.dtype)
        memory = src
        for layer in self.encoder:
            memory = layer(memory, pos)
        if self.encoder_norm is not None:
            memory = self.encoder_norm(memory)
        query_pos = self.query_embed.to(src.dtype)[None].expand(
            B, cfg.num_queries, cfg.hidden_dim)
        tgt = torch.zeros_like(query_pos)
        outputs: List[Dict[str, torch.Tensor]] = []
        for layer in self.decoder:
            tgt = layer(tgt, memory, query_pos, pos)
            h = self.decoder_norm(tgt)
            outputs.append({"pred_logits": self.class_embed(h),
                            "pred_boxes": torch.sigmoid(self.bbox_embed(h))})
        out = dict(outputs[-1])
        if cfg.aux_loss:
            out["aux_outputs"] = outputs[:-1]
        return out, memory, h

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.detect(self.backbone(x))[0]


def build_detr(config: DETRConfig,
               backbone: str = "swin_tiny_patch4_window7_224",
               image_size: int = 512, dtype: torch.dtype = torch.bfloat16,
               generator: Optional[torch.Generator] = None,
               device=None, masks: bool = False,
               num_mask_heads: int = 8) -> DETR:
    """DETR over the port's ``SwinTransformer(features_only=True)`` of the
    Swin config ``backbone`` for ``image_size`` inputs, initialised from
    ``generator`` (seed 0 when None) by :func:`init_detr`, on ``device``.
    With ``masks``, :class:`~vit_torch_tpu_torch.detection.segmentation.
    DETRSegm` over the Swin's stage maps (``multi_features=True``) with
    ``num_mask_heads`` attention-map heads.  On the meta device the init
    is skipped, for a state-dict load next.  ``model.backbone_arch`` keeps
    ``backbone``'s name (a serving bundle's manifest records it)."""
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS, SwinTransformer
    if backbone not in SWIN_CONFIGS:
        raise ValueError(f"unsupported DETR backbone {backbone!r} (use a "
                         f"swin config, or --head faster_rcnn for the "
                         f"ResNet trunks)")
    meta = device is not None and torch.device(device).type == "meta"
    with torch.device("meta" if meta else "cpu"):
        trunk = SwinTransformer(SWIN_CONFIGS[backbone],
                                image_size=image_size, dtype=dtype,
                                features_only=not masks,
                                multi_features=masks)
        if masks:
            from vit_torch_tpu_torch.detection.segmentation import DETRSegm
            model = DETRSegm(config, trunk, num_mask_heads, dtype=dtype)
        else:
            model = DETR(config, trunk, dtype=dtype)
    model.backbone_arch = backbone
    if meta:
        return model
    init_detr(model, generator or torch.Generator().manual_seed(0))
    return model.to(device) if device is not None else model


@torch.no_grad()
def init_detr(model: DETR, generator: torch.Generator) -> None:
    """Seeded init in the JAX DETR's scheme: the backbone as
    :func:`~vit_torch_tpu_torch.models.layers.init_weights` initialises
    it; Xavier-uniform on the transformer's attention and FFN weights
    (upstream DETR re-initialises every matrix of its transformer so);
    flax's ``lecun_normal`` (truncated normal of std ``1/sqrt(fan_in)``)
    on ``input_proj``, the heads, the mask branch's attention-map
    projections and its convs (flax's defaults); N(0, 1) on
    ``query_embed``, whose spread is the anchor structure of set
    prediction; U[0, 1) on the learned position tables; biases 0 and
    LayerNorm and GroupNorm weights 1."""
    init_weights(model.backbone, generator)
    for name, mod in model.named_modules():
        if name.startswith("backbone"):
            continue
        if isinstance(mod, (LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (Linear, nn.Conv2d)):
            if mod.bias is not None:
                mod.bias.zero_()
            if isinstance(mod, QLinear) and name != "input_proj":
                nn.init.xavier_uniform_(mod.weight, generator=generator)
            else:
                fan_in = mod.weight[0].numel()
                std = 1.0 / math.sqrt(fan_in) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
    model.query_embed.normal_(0.0, 1.0, generator=generator)
    if model.position_embedding is not None:
        for p in model.position_embedding.parameters():
            p.uniform_(0.0, 1.0, generator=generator)


# --------------------------------------------------------------------------
# losses (SetCriterion) given the host assignment
# --------------------------------------------------------------------------

def detr_losses(outputs: Dict[str, torch.Tensor],
                targets: Dict[str, torch.Tensor], assign: torch.Tensor,
                num_classes: int, *, eos_coef: float = 0.1,
                w_class: float = 1.0, w_bbox: float = 5.0,
                w_giou: float = 2.0) -> Dict[str, torch.Tensor]:
    """Hungarian-matched losses (reference ``SetCriterion``,
    ``object_detr/models/detr.py:91-263``): cross-entropy over all queries
    with the no-object class (0) down-weighted by ``eos_coef``, L1 and
    GIoU over matched pairs, the cardinality error (not differentiated).

    ``assign`` (B, Q): gt slot per query or -1.  Targets: ``labels`` (B,
    N) in 1..K, ``boxes_cxcywh`` (B, N, 4) normalised, ``box_mask`` (B,
    N), ``mask`` (B,)."""
    logits = outputs["pred_logits"].float()             # (B, Q, K+1)
    boxes = outputs["pred_boxes"].float()               # (B, Q, 4)
    B, Q, _ = logits.shape
    assign = assign.long()
    matched = assign >= 0
    safe = assign.clamp_min(0)
    tgt_labels = torch.gather(targets["labels"].long(), 1, safe)
    cls_target = torch.where(matched, tgt_labels, torch.zeros_like(safe))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 2, cls_target[..., None])[..., 0]
    sample_mask = targets.get("mask")
    if sample_mask is None:
        sample_mask = torch.ones((B,), device=logits.device)
    sample_mask = sample_mask.float()
    weights = torch.where(matched, 1.0, eos_coef) * sample_mask[:, None]
    loss_ce = (nll * weights).sum() / global_sum(weights.sum()).clamp_min(1.0)

    box_mask = targets["box_mask"].float()
    num_boxes = global_sum((box_mask * sample_mask[:, None]).sum()
                           ).clamp_min(1.0)
    tgt_boxes = torch.gather(targets["boxes_cxcywh"].float(), 1,
                             safe[..., None].expand(-1, -1, 4))
    pair_mask = matched.float() * sample_mask[:, None]
    l1 = (boxes - tgt_boxes).abs().sum(-1)
    loss_bbox = (l1 * pair_mask).sum() / num_boxes
    giou = generalized_box_iou(
        cxcywh_to_xyxy(boxes.reshape(B * Q, 1, 4)),
        cxcywh_to_xyxy(tgt_boxes.reshape(B * Q, 1, 4)))[:, 0, 0]
    loss_giou = ((1.0 - giou.reshape(B, Q)) * pair_mask).sum() / num_boxes
    with torch.no_grad():
        pred_nonempty = (logits.argmax(-1) != 0).float().sum(1)
        # over the global image count (a fill, not a copy from the host:
        # the step reads nothing before its loss)
        card = (pred_nonempty - box_mask.sum(1)).abs()
        cardinality = card.sum() / global_sum(card.new_full((), float(B)))
    total = w_class * loss_ce + w_bbox * loss_bbox + w_giou * loss_giou
    return {"loss": total, "loss_ce": loss_ce, "loss_bbox": loss_bbox,
            "loss_giou": loss_giou, "cardinality_error": cardinality}


def postprocess(outputs: Dict[str, torch.Tensor], image_size: int,
                scale: torch.Tensor, pad: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Scores, labels (1..K) and xyxy boxes in original image pixels
    (reference ``PostProcess``, ``detr.py:266-294``, then the letterbox
    undone: pad subtracted, divided by the scale), in fp32."""
    prob = torch.softmax(outputs["pred_logits"].float(), dim=-1)[..., 1:]
    scores, labels = prob.amax(-1), prob.argmax(-1)
    boxes = cxcywh_to_xyxy(outputs["pred_boxes"].float()) * image_size
    pad_xy = torch.cat([pad, pad], -1).float()[:, None, :]     # (B, 1, 4)
    boxes = (boxes - pad_xy) / scale.float()[:, None, None]
    return {"scores": scores, "labels": labels + 1, "boxes": boxes}
