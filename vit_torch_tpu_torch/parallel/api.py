"""Laying a model out over a mesh, counterpart of
``vit_torch_tpu/parallel/api.py``.

GSPMD makes the JAX package's sharded step *equal to the single-device
step* (``tests/test_parallel.py:107``).  The port keeps that equality by
hand, with the single-process steps of ``train/steps.py`` given this
module's :class:`Layout` (:func:`prepare_model` makes it; the pair is the
counterpart of the JAX ``shard_train_fns``):

- every rank takes its rows of the global batch (:meth:`Layout.shard`,
  before they leave the host), and draws its augmentation (and every
  dropout / drop-path mask, ``layers.set_batch_shard``) for the global
  batch from the same seeded generator, keeping its rows of the draws;
- the masked cross-entropy divides each rank's sum by the **global** mask
  count (all-reduced), and the loss that drives the backward is scaled by
  the number of batch shards, so that averaging the gradients over the
  replicas (:func:`sync_gradients`, and FSDP2's reduce-scatter) gives the
  single-process gradient;
- the ``loss_sum``, ``correct`` and ``count`` metrics are summed over the
  batch shards, and BatchNorm's train-mode statistics are all-reduced
  (``layers.BatchNorm.sync_group``).

The gradient all-reduce is DDP's, bucketed per dtype and issued after the
backward rather than through the ``DistributedDataParallel`` wrapper: the
linear-eval step calls the backbone and the head separately, and the
sequence-parallel and pipeline paths need the same sum semantics over
groups DDP does not know.  The batch is split over ``data`` (and over
``seq`` too for a backbone whose attention never reaches the ring: the
``seq`` ranks then act as further data ranks, which gives the same
numbers).  Tensor parallelism lives in the modules
(``partition.apply_tensor_parallel``), the ring in the ViT forward, the
pipeline in ``pipeline.py``.

Checkpoints are always the single-process layout (:func:`full_state`,
:func:`load_full_state`), so a run saved under one mesh resumes under any
other and under none.
"""

from __future__ import annotations

import re
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from vit_torch_tpu_torch.parallel.mesh import Mesh
from vit_torch_tpu_torch.parallel.partition import (apply_fsdp,
                                                    apply_tensor_parallel,
                                                    fsdp_dims, gather_tp,
                                                    slice_tp)

BATCH_KEYS = ("image", "label", "mask")


def batch_shardings(mesh: Mesh, ring: bool = True) -> Dict[str, tuple]:
    """The mesh axes each batch entry's leading dim splits over."""
    axes = ("data",) if ring or mesh.shape["seq"] == 1 else ("data", "seq")
    return {k: axes for k in BATCH_KEYS}


class Layout:
    """How one rank's step sits in the mesh: its batch shard, the groups
    its gradients and metrics reduce over, its tensor-parallel slices and
    pipeline stage, and the standard (single-process) order of its
    trainable parameters."""

    def __init__(self, mesh: Mesh, ring: bool = False, pipe=None):
        self.mesh = mesh
        self.ring = ring
        self.pipe = pipe
        axes = batch_shardings(mesh, ring)["image"]
        self.batch_count = mesh.extent(*axes)
        self.batch_index = mesh.index(*axes)
        self.batch_group = mesh.group(*axes) if self.batch_count > 1 \
            else None
        self.replica_size = mesh.extent("data", "seq")
        self.replica_group = mesh.group("data", "seq") \
            if self.replica_size > 1 else None
        self.model_group = mesh.group("model") \
            if mesh.shape["model"] > 1 else None
        self.tp_slices: Dict[str, Tuple[int, bool]] = {}
        self.fsdp_dims: Dict[str, int] = {}
        self.pipe_local: set = set()          # ids of stage-local params
        self.trainable: List[str] = []        # standard trainable order
        self.from_pipe: Callable[[str], str] = lambda n: n

    @property
    def loss_scale(self) -> float:
        """The factor on each rank's loss before the backward (see the
        module); 0 on a pipeline stage other than the last."""
        if self.pipe is not None and not self.pipe.last:
            return 0.0
        return float(self.batch_count)

    def shard(self, t, dim: int = 0):
        """This rank's rows of a global batch tensor or array (along
        ``dim``)."""
        if self.batch_count == 1:
            return t
        n, rest = divmod(t.shape[dim], self.batch_count)
        if rest:
            raise ValueError(f"global batch {t.shape[dim]} not divisible by "
                             f"the {self.batch_count} batch shards")
        rows = slice(self.batch_index * n, (self.batch_index + 1) * n)
        return t[(slice(None),) * dim + (rows,)]

    def shard_tree(self, tree, batch: int):
        """:meth:`shard` over every tensor or array of a nested dict whose
        leading dim is the global ``batch``."""
        if isinstance(tree, dict):
            return {k: self.shard_tree(v, batch) for k, v in tree.items()}
        if getattr(tree, "ndim", 0) and tree.shape[0] == batch:
            return self.shard(tree)
        return tree

    def reduce_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the batch shards (no gradient)."""
        if self.batch_group is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=self.batch_group)
        return t

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-shard tensor (rank order)."""
        if self.batch_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.batch_count)]
        dist.all_gather(parts, t.contiguous(), group=self.batch_group)
        return torch.cat(parts)


# --------------------------------------------------------------------------
# model preparation
# --------------------------------------------------------------------------

def _ring_capable(backbone: nn.Module) -> bool:
    """Whether the backbone's attention reaches the ring: the ViT/DeiT
    ``Attention`` path (bias-free ``dot_product_attention``), as in JAX."""
    from vit_torch_tpu_torch.models.vit import VisionTransformer
    return isinstance(backbone, VisionTransformer)


def _fsdp_units(module: nn.Module) -> List[nn.Module]:
    """The per-layer FSDP units: every ``blocks.<i>`` module."""
    return [m for name, m in module.named_modules()
            if re.search(r"(^|\.)blocks\.\d+$", name)]


def prepare_model(model: nn.Module, mesh: Mesh, *, fsdp: bool = False,
                  fsdp_min_size: int = 2 ** 16,
                  pipe_microbatches: int = 0, arch: str = "") -> Layout:
    """Lay ``model`` (a zoo ``Classifier`` or a detector with a
    ``backbone``) out over ``mesh`` in place and return its
    :class:`Layout`: the pipeline stage (``pipe`` > 1, ViT only), tensor
    parallelism (``model`` > 1), the ring (``seq`` > 1 on a ViT), the
    global-batch draws and BatchNorm statistics, and FSDP2 (``fsdp``).
    The optimizer is built after, over the parameters this leaves."""
    from vit_torch_tpu_torch.models.layers import BatchNorm, set_batch_shard
    from vit_torch_tpu_torch.parallel.pipeline import pipeline_stage
    backbone = getattr(model, "backbone", model)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    ring = mesh.shape["seq"] > 1 and _ring_capable(backbone)
    pipe = from_pipe = None
    if mesh.shape["pipe"] > 1:
        if mesh.shape["seq"] > 1:
            raise ValueError("the pipeline runs its blocks on whole "
                             "sequences: seq > 1 does not compose with it")
        _, from_pipe = pipeline_stage(
            model, mesh, num_microbatches=pipe_microbatches or None,
            arch=arch)
        pipe = backbone.pipe
    layout = Layout(mesh, ring=ring, pipe=pipe)
    layout.trainable = trainable
    if pipe is not None:
        layout.from_pipe = from_pipe
        layout.pipe_local = {id(p) for p in backbone.blocks.parameters()}
    if layout.model_group is not None and pipe is None:
        layout.tp_slices = apply_tensor_parallel(model, layout.model_group)
    elif layout.model_group is not None:
        # as in JAX (partition.py's pipe_blocks rule comes first), tensor
        # parallelism does not compose inside the pipeline: the model
        # ranks hold the stage whole
        warnings.warn("tensor parallelism does not compose with the "
                      "pipeline: the model axis replicates the stages",
                      stacklevel=2)
    if ring:
        backbone.seq = (mesh.group("seq"), mesh.shape["seq"],
                        mesh.coords["seq"])
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.sync_group = layout.batch_group
    if layout.batch_count > 1:
        set_batch_shard(model, (layout.batch_index, layout.batch_count))
    if fsdp:
        exclude = {n for n, p in model.named_parameters()
                   if id(p) in layout.pipe_local}
        layout.fsdp_dims = fsdp_dims(model, layout.replica_size,
                                     fsdp_min_size, exclude,
                                     layout.tp_slices)
        if layout.fsdp_dims:
            apply_fsdp(model, mesh.sub_mesh("data", "seq"), layout.fsdp_dims,
                       _fsdp_units(model))
    return layout


# --------------------------------------------------------------------------
# gradients and the steps
# --------------------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _all_reduce_flat(grads: List[torch.Tensor], group, divide: int) -> None:
    """All-reduce ``grads`` in place over ``group`` in one bucket a dtype,
    then divide by ``divide``."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = _flatten_dense_tensors(same)
        dist.all_reduce(flat, group=group)
        if divide > 1:
            flat /= divide
        for g, synced in zip(same, _unflatten_dense_tensors(flat, same)):
            g.copy_(synced)


def sync_gradients(params: List[nn.Parameter], layout: Layout) -> None:
    """After the backward: the embedding and head gradients summed over the
    pipeline stages (only one stage computes each), then every gradient
    FSDP2 did not reduce averaged over the replicas (``data`` x ``seq``).
    A parameter that got no gradient on this rank counts as zero."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if layout.pipe is not None:
        shared = [p.grad.to_local() if _is_dtensor(p.grad) else p.grad
                  for p in params if id(p) not in layout.pipe_local]
        _all_reduce_flat(shared, layout.pipe.group, 1)
    if layout.replica_group is not None:
        plain = [p.grad for p in params if not _is_dtensor(p.grad)]
        _all_reduce_flat(plain, layout.replica_group, layout.replica_size)


def param_groups(params: List[nn.Parameter]) -> list:
    """The optimizer's parameters: FSDP's DTensors in a group apart from
    the tensors FSDP leaves whole, so that each group keeps the
    multi-tensor (``foreach``) update, which cannot mix the two (torch's
    optimizers group ``foreach`` per param group)."""
    sharded = [p for p in params if _is_dtensor(p)]
    if not sharded:
        return list(params)
    plain = [p for p in params if not _is_dtensor(p)]
    return [{"params": g} for g in (sharded, plain) if g]


# --------------------------------------------------------------------------
# checkpoints in the single-process layout
# --------------------------------------------------------------------------

def _full(t: torch.Tensor, name: str, layout: Layout) -> torch.Tensor:
    """The whole tensor of a local parameter-shaped tensor: FSDP's shards
    gathered, then the tensor-parallel ones."""
    if _is_dtensor(t):
        t = t.full_tensor()
    if name in layout.tp_slices:
        t = gather_tp(t, layout.tp_slices[name], layout.model_group)
    return t.detach().cpu()


def _local(full: torch.Tensor, name: str, like: torch.Tensor,
           layout: Layout) -> torch.Tensor:
    """This rank's part of a whole tensor, shaped (and placed) as
    ``like``: the inverse of :func:`_full`."""
    if name in layout.tp_slices:
        full = slice_tp(full, layout.tp_slices[name], layout.model_group)
    full = full.to(like.device, like.dtype)
    if _is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(full, like.device_mesh, like.placements)
    return full


def _gather_pipe(local: dict, layout: Layout) -> dict:
    if layout.pipe is None:
        return local
    from vit_torch_tpu_torch.parallel.multihost import all_gather_objects
    out = {}
    for part in all_gather_objects(local, layout.pipe.group):
        out.update(part)
    return out


def full_state(model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
               layout: Layout) -> Tuple[dict, Optional[dict]]:
    """The single-process model state dict and optimizer state dict of a
    laid-out model, on the CPU: collective (every rank of the mesh
    calls it); rank 0 writes them."""
    state = {}
    for name, t in model.state_dict().items():
        if t is None:
            continue
        state[layout.from_pipe(name)] = _full(t, name, layout)
    names = {id(p): n for n, p in model.named_parameters()}
    opt = None
    if optimizer is not None:
        local = optimizer.state_dict()
        group = dict(local["param_groups"][0])
        params = [p for g in optimizer.param_groups for p in g["params"]]
        per_param = {}
        for i, p in enumerate(params):
            entry = local["state"].get(i)
            if entry is None:
                continue
            name = names[id(p)]
            per_param[layout.from_pipe(name)] = {
                k: (_full(v, name, layout) if torch.is_tensor(v)
                    and v.shape == p.shape else
                    (v.detach().cpu() if torch.is_tensor(v) else v))
                for k, v in entry.items()}
        per_param = _gather_pipe(per_param, layout)
        group["params"] = list(range(len(layout.trainable)))
        opt = {"state": {layout.trainable.index(n): v
                         for n, v in per_param.items()},
               "param_groups": [group]}
        opt["state"] = dict(sorted(opt["state"].items()))
    return _gather_pipe(state, layout), opt


def full_grads(model: nn.Module, layout: Layout) -> Dict[str, torch.Tensor]:
    """The single-process gradients of a laid-out model after
    :func:`sync_gradients`, on the CPU, by standard parameter name (FSDP's
    shards, the tensor-parallel ones and the stages gathered): collective,
    as :func:`full_state`."""
    grads = {layout.from_pipe(n): _full(p.grad, n, layout)
             for n, p in model.named_parameters() if p.grad is not None}
    return _gather_pipe(grads, layout)


@torch.no_grad()
def load_full_state(model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer],
                    layout: Layout, state: dict,
                    opt_state: Optional[dict] = None) -> None:
    """Load a single-process model (and optimizer) state dict into a
    laid-out model: the inverse of :func:`full_state`."""
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        std = layout.from_pipe(name)
        if std not in state:
            continue
        local = _local(state[std], name, t, layout)
        if _is_dtensor(t):
            t.to_local().copy_(local.to_local())
        else:
            t.copy_(local)
    if optimizer is None or opt_state is None:
        return
    names = {id(p): n for n, p in model.named_parameters()}
    hyper = {k: v for k, v in opt_state["param_groups"][0].items()
             if k != "params"}
    for g in optimizer.param_groups:
        g.update(hyper)
        for p in g["params"]:
            name = names[id(p)]
            entry = opt_state["state"].get(
                layout.trainable.index(layout.from_pipe(name)))
            if entry is None:
                continue
            optimizer.state[p] = {
                k: (_local(v, name, p, layout) if torch.is_tensor(v)
                    and v.dim() and v.dim() == p.dim() else
                    (v.clone() if torch.is_tensor(v) else v))
                for k, v in entry.items()}


def shard_batch(batch: Dict[str, torch.Tensor], layout: Layout
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch dict."""
    return {k: layout.shard(v) if k in BATCH_KEYS else v
            for k, v in batch.items()}
