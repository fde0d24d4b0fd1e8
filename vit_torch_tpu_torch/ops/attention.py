"""Multi-head attention compute op, counterpart of
``vit_torch_tpu/ops/attention.py``.

Layout: ``(batch, seq, heads, head_dim)``.  On CUDA, attention without a
bias or mask always runs the flash kernel (:mod:`.flash_attention`), at
every sequence length: the TPU package's ``VITX_FLASH_MIN_SEQ`` crossover
was measured on a TPU and does not carry over.  Biased or masked attention
(Swin's windows) has no CUDA kernel yet.  On the CPU the plain softmax
attention below runs, as the JAX package's ``_xla_attention`` does off the
TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_torch_tpu_torch.ops.flash_attention import flash_attention


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
                "attention with a bias or mask has no CUDA kernel yet: it "
                "comes with the Swin slice (ROADMAP.md)")
        return flash_attention(q, k, v, scale=scale)
    return _plain_attention(q, k, v, scale=scale, bias=bias, mask=mask)


def _plain_attention(q, k, v, *, scale, bias=None, mask=None):
    """fp32 logits and softmax, weights cast to the input dtype for PV."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
