"""GPipe pipeline parallelism over the ``pipe`` mesh axis, counterpart of
``vit_torch_tpu/parallel/pipeline.py``.

The JAX package stacks the L blocks on a leading layer axis sharded over
``pipe`` and runs the schedule as a ``lax.scan`` inside ``shard_map``,
reverse-mode AD giving the mirrored backward.  The port runs one process a
stage: a rank keeps its contiguous L/P blocks (stage-local weights and
optimizer moments, the point of PP) and :func:`pipeline_apply` runs the
schedule by hand over point-to-point sends in the ``pipe`` group:

- forward: every microbatch in turn, stage 0 feeding it and every other
  stage receiving it from the previous one, applying its blocks and
  sending on (fill/drain bubble of P - 1 microbatch slots out of M + P - 1);
- the last stage's outputs are broadcast over the group, so that every
  stage runs the head, as ``psum`` replicates them in JAX;
- backward (the Function's backward): every microbatch in the same order,
  the last stage starting from its output gradient, every other stage from
  the gradient the next one sends back; each stage's block gradients
  accumulate into its own parameters.

Only the last stage's loss drives the backward (the step multiplies the
others' by 0), so the replicated embedding and head gradients sum
correctly over ``pipe`` (``api.sync_gradients``).  Blocks must be
identical and rate-free: nonzero drop rates are refused, as in JAX.

The stacked forms stay for checkpoint interchange: :func:`state_to_pipe`
/ :func:`state_from_pipe` re-lay a flat state dict between the standard
``blocks.{i}.*`` keys and ``pipe_blocks.*`` tensors stacked over L.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from vit_torch_tpu_torch.parallel.collectives import isend, recv

PIPE_AXIS = "pipe"


def stack_params(trees: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """Stack per-block state dicts into one with a leading layer axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_params(stacked: Dict[str, torch.Tensor]
                   ) -> List[Dict[str, torch.Tensor]]:
    """Inverse of :func:`stack_params`."""
    L = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(L)]


def split_vit_params(params: Dict[str, torch.Tensor], depth: int,
                     prefix: str = "") -> Tuple[Dict, Dict]:
    """A ViT state dict (keys under ``prefix``) into (rest, stacked
    blocks); the stacked keys drop ``{prefix}blocks.{i}.``."""
    blocks = []
    for i in range(depth):
        head = f"{prefix}blocks.{i}."
        blocks.append({k[len(head):]: v for k, v in params.items()
                       if k.startswith(head)})
    rest = {k: v for k, v in params.items()
            if not k.startswith(f"{prefix}blocks.")}
    return rest, stack_params(blocks)


def merge_vit_params(rest: Dict[str, torch.Tensor],
                     blocks: Dict[str, torch.Tensor],
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_vit_params`."""
    out = dict(rest)
    for i, tree in enumerate(unstack_params(blocks)):
        out.update({f"{prefix}blocks.{i}.{k}": v for k, v in tree.items()})
    return out


def state_to_pipe(state: Dict[str, torch.Tensor], prefix: str = "backbone."
                  ) -> Dict[str, torch.Tensor]:
    """A standard flat state dict with the blocks under ``{prefix}blocks``
    stacked into ``{prefix}pipe_blocks.*`` (depth from the keys)."""
    head = f"{prefix}blocks."
    depth = len({k[len(head):].split(".")[0] for k in state
                 if k.startswith(head)})
    if not depth:
        return dict(state)
    rest, blocks = split_vit_params(state, depth, prefix)
    rest.update({f"{prefix}pipe_blocks.{k}": v for k, v in blocks.items()})
    return rest


def state_from_pipe(state: Dict[str, torch.Tensor],
                    prefix: str = "backbone.") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`state_to_pipe`: the standard layout, in which
    checkpoints are always written so that they resume under any mesh."""
    head = f"{prefix}pipe_blocks."
    blocks = {k[len(head):]: v for k, v in state.items()
              if k.startswith(head)}
    rest = {k: v for k, v in state.items() if not k.startswith(head)}
    return merge_vit_params(rest, blocks, prefix) if blocks else rest


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PipeStage:
    """This rank's place in the pipeline."""
    group: dist.ProcessGroup
    stage: int
    n_stages: int
    num_microbatches: int
    depth: int

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1

    def peer(self, offset: int) -> int:
        return dist.get_global_rank(self.group, self.stage + offset)

    @property
    def first_block(self) -> int:
        return self.stage * self.depth // self.n_stages


def _forward_schedule(stage_fn, pipe: PipeStage, x: torch.Tensor,
                      keep_graph: bool):
    mbs = x.chunk(pipe.num_microbatches)
    ins, outs, sends = [], [], []
    for mb in mbs:
        if pipe.stage == 0:
            h = mb.detach()
        else:
            h = recv(mb, pipe.peer(-1), pipe.group)
        if keep_graph:
            h.requires_grad_(pipe.stage > 0 or x.requires_grad)
            with torch.enable_grad():
                y = stage_fn(h)
        else:
            y = stage_fn(h)
        if not pipe.last:
            sends.append(isend(y.detach(), pipe.peer(1), pipe.group))
        ins.append(h)
        outs.append(y)
    for w in sends:
        w.wait()
    out = (torch.cat([y.detach() for y in outs]) if pipe.last
           else torch.empty_like(x))
    dist.broadcast(out, pipe.peer(pipe.n_stages - 1 - pipe.stage),
                   group=pipe.group)
    return out, ins, outs


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, pipe, x):
        out, ins, outs = _forward_schedule(stage_fn, pipe, x, True)
        ctx.pipe, ctx.ins, ctx.outs = pipe, ins, outs
        ctx.x_grad = x.requires_grad
        return out

    @staticmethod
    def backward(ctx, g):
        pipe, ins, outs = ctx.pipe, ctx.ins, ctx.outs
        gs = g.chunk(pipe.num_microbatches) if pipe.last else None
        sends = []
        for m, (h, y) in enumerate(zip(ins, outs)):
            gy = gs[m] if pipe.last else recv(y, pipe.peer(1), pipe.group)
            torch.autograd.backward(y, gy)
            if pipe.stage > 0:
                sends.append(isend(h.grad, pipe.peer(-1), pipe.group))
        for w in sends:
            w.wait()
        gx = None
        if pipe.stage == 0 and ctx.x_grad:
            gx = torch.cat([h.grad for h in ins])
        ctx.ins = ctx.outs = None
        return None, None, gx


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, pipe: PipeStage) -> torch.Tensor:
    """Apply the pipeline's blocks to ``x`` (B, ...), which every stage
    passes (only stage 0 reads it): ``stage_fn`` is this rank's blocks and
    must keep the shape.  Returns the last stage's output on every stage,
    differentiable in ``x`` and in the stages' parameters."""
    if x.shape[0] % pipe.num_microbatches:
        raise ValueError(f"per-shard batch {x.shape[0]} not divisible into "
                         f"{pipe.num_microbatches} microbatches")
    if torch.is_grad_enabled():
        return _GPipe.apply(stage_fn, pipe, x)
    return _forward_schedule(stage_fn, pipe, x, False)[0]


# --------------------------------------------------------------------------
# ViT integration
# --------------------------------------------------------------------------

def _check_pipeline_vit(backbone: nn.Module, n_stages: int,
                        arch: str = "") -> None:
    from vit_torch_tpu_torch.models.vit import VisionTransformer
    if not isinstance(backbone, VisionTransformer):
        raise ValueError(
            f"pipeline parallelism supports plain ViT backbones; "
            f"{arch!r} has {type(backbone).__name__}")
    config = backbone.config
    if config.drop_rate or config.attn_drop_rate or config.drop_path_rate:
        raise ValueError(
            "pipeline parallelism runs blocks deterministically; nonzero "
            "drop/droppath rates are not representable (see pipeline.py)")
    if config.depth % n_stages:
        raise ValueError(
            f"depth {config.depth} not divisible into {n_stages} pipeline "
            "stages")


def vit_pipeline_features(backbone: nn.Module, x: torch.Tensor
                          ) -> torch.Tensor:
    """``VisionTransformer`` forward with its blocks pipelined: embedding,
    :func:`pipeline_apply` over this stage's blocks, the final LayerNorm
    (eps 1e-6, the full model's) and the prefix tokens' features."""
    pipe = backbone.pipe
    blocks = list(backbone.blocks)

    def stage_fn(h):
        for blk in blocks:
            h = blk(h)
        return h

    h = pipeline_apply(stage_fn, backbone.embed(x), pipe)
    h = backbone.norm(h)
    return h if backbone.return_all_tokens else backbone._pool(h)


def pipeline_stage(model: nn.Module, mesh, *,
                   num_microbatches: Optional[int] = None, arch: str = ""):
    """Make a ViT classifier (``model.backbone`` a ``VisionTransformer``)
    this rank's pipeline stage, in place: the backbone keeps its stage's
    L/P blocks and routes its forward through :func:`vit_pipeline_features`.
    Returns ``(to_pipe, from_pipe)``: a standard parameter name's local
    one (None: another stage's) and back, for checkpoint interchange
    (``api.full_state``)."""
    backbone = model.backbone
    P = mesh.shape[PIPE_AXIS]
    _check_pipeline_vit(backbone, P, arch)
    pipe = PipeStage(mesh.group(PIPE_AXIS), mesh.coords[PIPE_AXIS], P,
                     int(num_microbatches or P), backbone.config.depth)
    per = pipe.depth // P
    lo = pipe.first_block
    backbone.blocks = nn.ModuleList(list(backbone.blocks)[lo:lo + per])
    backbone.pipe = pipe
    return _renamer(lo, per)


def zoo_pipeline_forms(zoo_model, mesh, *,
                       num_microbatches: Optional[int] = None):
    """:func:`pipeline_stage` of a ViT-family zoo model (the JAX
    function's name and refusals)."""
    return pipeline_stage(zoo_model.model, mesh,
                          num_microbatches=num_microbatches,
                          arch=zoo_model.arch)


def _renamer(lo: int, per: int):
    def to_pipe(name: str) -> Optional[str]:
        """The local name of a standard one (None: another stage's)."""
        parts = name.split(".")
        if "blocks" in parts:
            i = parts.index("blocks")
            b = int(parts[i + 1]) - lo
            if not 0 <= b < per:
                return None
            parts[i + 1] = str(b)
        return ".".join(parts)

    def from_pipe(name: str) -> str:
        parts = name.split(".")
        if "blocks" in parts:
            i = parts.index("blocks")
            parts[i + 1] = str(int(parts[i + 1]) + lo)
        return ".".join(parts)

    return to_pipe, from_pipe


def build_pipeline_classifier(config, num_classes: int, mesh, *,
                              image_size: int, lr: float = 1e-3,
                              num_microbatches: Optional[int] = None,
                              dtype=torch.float32, seed: int = 0,
                              device="cpu"):
    """A complete pipeline-parallel ViT classifier training setup over a
    ``data x pipe`` mesh: ``(model, optimizer, step)`` where ``model`` is
    this rank's stage (with the replicated linear head), ``optimizer``
    AdamW over its parameters and ``step(images, labels) -> loss`` one
    train step on the global batch (each data rank takes its rows)."""
    from vit_torch_tpu_torch.models.layers import init_weights
    from vit_torch_tpu_torch.models.vit import VisionTransformer
    from vit_torch_tpu_torch.models.zoo import Classifier
    from vit_torch_tpu_torch.parallel.api import Layout, sync_gradients

    backbone = VisionTransformer(config, image_size=image_size, dtype=dtype)
    model = Classifier(backbone, nn.Linear(config.embed_dim, num_classes))
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    pipeline_stage(model, mesh, num_microbatches=num_microbatches)
    layout = Layout(mesh, ring=False, pipe=backbone.pipe)
    params = list(model.parameters())
    optimizer = torch.optim.AdamW(params, lr=lr)

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        x, y = layout.shard(images), layout.shard(labels)
        mask = torch.ones(len(y), device=y.device)
        count = layout.reduce_batch(mask.sum())
        logits = model(x).float()
        nll = -torch.log_softmax(logits, -1).gather(-1, y[:, None])[:, 0]
        loss = (nll * mask).sum() / count
        optimizer.zero_grad(set_to_none=True)
        (loss * layout.loss_scale).backward()
        sync_gradients(params, layout)
        optimizer.step()
        return layout.reduce_batch(loss.detach())

    return model, optimizer, step
