"""Multi-head attention compute op, counterpart of
``vit_torch_tpu/ops/attention.py``.

Layout: ``(batch, seq, heads, head_dim)``, q's sequence of its own
length (DETR's cross-attention: 100 queries against the memory tokens).
On CUDA, attention without a bias or mask always runs the flash kernel
(:mod:`.flash_attention`), at every sequence length: the TPU package's
``VITX_FLASH_MIN_SEQ`` crossover was measured on a TPU and does not carry
over.  Gradients flow through it: the kernel has a backward kernel.
Swin's biased and masked window attention does not come through here: it
has its own kernels (:mod:`.window_attention`, :mod:`.window_block`).  No
model of either package passes a bias or mask to this function (DETR's
attention passes neither; the JAX segmentation head's attention map
computes its own softmax), so on CUDA such a call raises: it has no
kernel.  On the CPU the plain softmax attention below runs, as the JAX
package's ``_xla_attention`` does off the TPU.

Sequence parallelism: inside :class:`sequence_parallel` (entered by the
ViT forward when the mesh's ``seq`` axis is larger than one) attention
without a bias or mask goes to ring attention
(:mod:`.ring_attention`) over the ``seq`` group, as the JAX
``_active_seq_mesh`` dispatch does.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_torch_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_qkv)

# (seq group, true sequence length) of the active sequence-parallel region
_SEQ: list = []


class sequence_parallel:
    """Context manager routing bias-free attention through ring attention
    over ``group`` for a sequence of true length ``kv_len`` whose shards
    the group's ranks hold (the JAX ``sequence_parallel``)."""

    def __init__(self, group, kv_len: int):
        self.entry = (group, int(kv_len))

    def __enter__(self):
        _SEQ.append(self.entry)
        return self

    def __exit__(self, *exc):
        _SEQ.pop()
        return False


def active_seq():
    """The active (group, kv_len), or None outside a sequence-parallel
    region."""
    return _SEQ[-1] if _SEQ else None


def _ring(q, k, v, scale):
    from vit_torch_tpu_torch.ops.ring_attention import ring_attention
    group, kv_len = _SEQ[-1]
    return ring_attention(q, k, v, group, kv_len=kv_len, scale=scale)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Scaled dot-product attention of q ``(B, Nq, H, Dh)`` over k and v
    ``(B, Nk, H, Dh)``.

    ``bias`` is an additive logits bias broadcastable to ``(B, H, Nq, Nk)``;
    ``mask`` is a boolean mask broadcastable to the same shape whose
    ``False`` positions are excluded."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _SEQ and bias is None and mask is None:
        return _ring(q, k, v, scale)
    if q.device.type == "cuda":
        if bias is not None or mask is not None:
            raise NotImplementedError(
                "generic attention with a bias or mask has no CUDA kernel: "
                "Swin's window attention has its own "
                "(ops/window_attention.py), and no other model passes a "
                "bias or a mask here")
        return flash_attention(q, k, v, scale=scale)
    return _plain_attention(q, k, v, scale=scale, bias=bias, mask=mask)


def qkv_attention(qkv: torch.Tensor, *,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Attention over the fused ``(B, N, 3, H, Dh)`` qkv projection, the
    ViT block's call; ``(B, N, H, Dh)`` out.  On CUDA the flash kernel
    reads q, k and v through their strides and its backward writes one
    gradient of qkv's shape; on the CPU the plain attention runs on the
    three views."""
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    if _SEQ:
        return _ring(*qkv.unbind(2), scale)
    if qkv.device.type == "cuda":
        return flash_attention_qkv(qkv, scale=scale)
    return _plain_attention(*qkv.unbind(2), scale=scale)


def _plain_attention(q, k, v, *, scale, bias=None, mask=None):
    """fp32 logits and softmax, weights cast to the input dtype for PV."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
