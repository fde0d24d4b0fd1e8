"""Ring attention, counterpart of ``vit_torch_tpu/ops/ring_attention.py``:
context/sequence-parallel attention over the mesh ``seq`` axis.

Each rank of the ``seq`` group holds one contiguous shard of the (padded)
token sequence.  The forward rotates K/V around the ring with
``batch_isend_irecv`` while it accumulates an online softmax in fp32, as
the JAX ``_local_ring`` does (keys at global positions >= ``kv_len`` are
padding and get -inf; the output is ``o / max(l, 1e-30)``).  The backward
is a second ring pass: dQ stays home, while dK and dV travel with their
K/V blocks and arrive home after a full turn.  The block products stay
PyTorch ops in fp32, as the JAX body's einsums are.  Non-causal (ViT
attention is bidirectional).

A query row whose every key so far is padding keeps a running maximum of
-inf; its rescale factors are taken at 0 there, so such rows (padded
queries, which the model never reads) stay finite instead of NaN.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from vit_torch_tpu_torch.parallel.collectives import ring_exchange


def _block_logits(qf, kb, scale, src, n, kv_len, padded):
    """(B, H, n, n) fp32 logits of the local queries against the key block
    that started on ring position ``src``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
    if padded:
        col = src * n + torch.arange(n, device=s.device)
        s = s.masked_fill(col >= kv_len, float("-inf"))
    return s


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, kv_len, scale):
        B, n, H, D = q.shape
        S = dist.get_world_size(group)
        me = dist.get_group_rank(group, dist.get_rank())
        padded = kv_len < n * S
        qf = q.float()
        o = torch.zeros((B, H, n, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, n, 1), float("-inf"), device=q.device)
        l = torch.zeros((B, H, n, 1), device=q.device)
        kv = torch.stack([k, v])
        for step in range(S):
            s = _block_logits(qf, kv[0], scale, (me - step) % S, n, kv_len,
                              padded)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                               m_new)
            alpha = torch.exp(m - safe)
            p = torch.exp(s - safe)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", p,
                                         kv[1].float())
            m = m_new
            if step < S - 1:
                kv = ring_exchange(kv, group)
        out = o / l.clamp_min(1e-30)
        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                          torch.full_like(l, float("inf")))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (group, kv_len, scale)
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, kv_len, scale = ctx.cfg
        B, n, H, D = q.shape
        S = dist.get_world_size(group)
        me = dist.get_group_rank(group, dist.get_rank())
        padded = kv_len < n * S
        qf = q.float()
        do = dout.float().transpose(1, 2)                 # (B, H, n, D)
        di = (do * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2, B, n, H, D), dtype=torch.float32,
                          device=q.device)
        for step in range(S):
            s = _block_logits(qf, kv[0], scale, (me - step) % S, n, kv_len,
                              padded)
            p = torch.exp(s - lse)
            dkv[1] += torch.einsum("bhqk,bhqd->bkhd", p, do)
            ds = p * (torch.einsum("bhqd,bkhd->bhqk", do, kv[1].float())
                      - di)
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kv[0].float()) * scale
            dkv[0] += torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            # dK/dV travel with their block: after S moves they are home
            if step < S - 1:
                kv = ring_exchange(kv, group)
            dkv = ring_exchange(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None, *,
                   kv_len: Optional[int] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's ``(B, n, H, D)`` query shard over the whole
    sequence, whose shards the ranks of ``group`` hold in ring order;
    ``kv_len`` is the true length (keys past it are padding).  With no
    group, or a group of one, it is :func:`.attention.dot_product_attention`
    (the flash kernel on CUDA), as the JAX function is at ``seq == 1``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if group is None or dist.get_world_size(group) == 1:
        from vit_torch_tpu_torch.ops.attention import dot_product_attention
        n = q.shape[1] if kv_len is None else kv_len
        return dot_product_attention(q, k[:, :n], v[:, :n], scale=scale)
    n_total = q.shape[1] * dist.get_world_size(group)
    return _RingAttention.apply(q, k, v, group,
                                n_total if kv_len is None else int(kv_len),
                                float(scale))
