"""Multi-head attention compute op, counterpart of
``vit_torch_tpu/ops/attention.py``.

Layout: ``(batch, seq, heads, head_dim)``.  On CUDA, attention without a
bias or mask always runs the flash kernel (:mod:`.flash_attention`), at
every sequence length: the TPU package's ``VITX_FLASH_MIN_SEQ`` crossover
was measured on a TPU and does not carry over.  Gradients flow through it:
the kernel has a backward kernel.  Swin's biased and masked window
attention does not come through here: it has its own kernels
(:mod:`.window_attention`, :mod:`.window_block`).  No model of the JAX
package passes a bias or mask to this function; on CUDA such a call
raises until a slice that needs it brings a kernel (the detection slice,
ROADMAP.md A10, is the first candidate).  On the CPU the plain softmax
attention below runs, as the JAX package's ``_xla_attention`` does off the
TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_torch_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_qkv)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Scaled dot-product attention over ``(B, N, H, Dh)`` tensors.

    ``bias`` is an additive logits bias broadcastable to ``(B, H, Nq, Nk)``;
    ``mask`` is a boolean mask broadcastable to the same shape whose
    ``False`` positions are excluded."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        if bias is not None or mask is not None:
            raise NotImplementedError(
                "generic attention with a bias or mask has no CUDA kernel: "
                "Swin's window attention has its own "
                "(ops/window_attention.py), and a kernel for this call comes "
                "with the first slice that needs it (detection, ROADMAP.md "
                "A10)")
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
