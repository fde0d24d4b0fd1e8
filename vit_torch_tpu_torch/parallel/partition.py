"""Parameter partition rules and their application, counterpart of
``vit_torch_tpu/parallel/partition.py``.

:data:`DEFAULT_RULES` are the JAX package's path rules (``partition.py:
25-42``) on the port's state-dict names and layouts: a torch ``Linear``
weight is ``(out, in)``, the flax kernel ``(in, out)``, so a column-sharded
kernel ``P(None, "model")`` is a row-sharded weight ``("model", None)``
here.  A spec is a tuple with one axis name (or None) per dimension.

The JAX package only annotates; GSPMD re-shards wherever a shard crosses a
head.  The port splits the modules itself (:func:`apply_tensor_parallel`),
Megatron-style on **local heads**: each ``model`` rank keeps whole heads,
so the fused ``qkv`` weight, whose rows are ordered (3, H, D), is split per
head of each of q, k and v (a plain split of its 3C rows would put q, k
and v of different heads on one rank), ``proj`` keeps the matching input
columns, and a Swin block's bias table the matching head columns.  A
module whose head count (or MLP width) the ``model`` axis does not divide
stays replicated, and CaiT's talking-heads attention (its mixes run across
heads) stays replicated too; one warning lists them all, as
:func:`validate_divisibility` lists its downgrades.

FSDP (ZeRO-3, :func:`add_fsdp_axis`) shards every parameter of at least
``min_size`` elements on its largest free dimension that the axis size
divides, the JAX rule; :func:`apply_fsdp` hands those to FSDP2's
``fully_shard`` over the batch sub-mesh and leaves the rest (and every
pipeline-stage parameter, ``partition.py:134-137``) replicated.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

Spec = Tuple[Optional[str], ...]

# (name regex, spec) — first match wins
DEFAULT_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*\.pipe_blocks\..*", ("pipe",)),
    (r".*\.attn\.qkv\.weight$", ("model", None)),
    (r".*\.attn\.qkv\.bias$", ("model",)),
    (r".*\.attn\.proj\.weight$", (None, "model")),
    (r".*\.attn\.proj\.bias$", ()),
    (r".*\.mlp\.fc1\.weight$", ("model", None)),
    (r".*\.mlp\.fc1\.bias$", ("model",)),
    (r".*\.mlp\.fc2\.weight$", (None, "model")),
    (r".*\.mlp\.fc2\.bias$", ()),
    # CaiT talking-heads / class-attention projections
    (r".*\.attn\.(q|k|v)\.weight$", ("model", None)),
    (r".*\.attn\.(q|k|v)\.bias$", ("model",)),
    (r".*", ()),
)


def partition_specs(shapes: Mapping[str, Tuple[int, ...]],
                    rules=DEFAULT_RULES) -> Dict[str, Spec]:
    """Each name's spec by the first rule that matches; a spec longer than
    the tensor's rank is dropped (replicated), as in JAX."""
    out = {}
    for name, shape in shapes.items():
        spec: Spec = ()
        for pattern, s in rules:
            if re.match(pattern, name):
                spec = s if len(s) <= len(shape) else ()
                break
        out[name] = spec
    return out


def validate_divisibility(shapes: Mapping[str, Tuple[int, ...]],
                          specs: Mapping[str, Spec],
                          axis_sizes: Mapping[str, int],
                          warn: bool = True) -> Dict[str, Spec]:
    """Downgrade to replicated every spec whose sharded dim the axis size
    does not divide; one warning lists each downgraded parameter."""
    downgraded, out = [], {}
    for name, spec in specs.items():
        shape = tuple(shapes[name])
        ok = True
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            size = axis_sizes.get(axis, 1)
            if shape[dim] % size:
                downgraded.append(f"{name}: dim {dim} of {shape} not "
                                  f"divisible by {axis}={size}")
                ok = False
                break
        out[name] = spec if ok else ()
    if downgraded and warn:
        warnings.warn(
            "tensor-parallel sharding downgraded to replicated for "
            f"{len(downgraded)} parameter(s):\n  " + "\n  ".join(downgraded),
            stacklevel=2)
    return out


def add_fsdp_axis(shapes: Mapping[str, Tuple[int, ...]],
                  specs: Mapping[str, Spec], axis_size: int,
                  axis: str = "data", min_size: int = 2 ** 16
                  ) -> Dict[str, Spec]:
    """The JAX ``add_fsdp_axis``: every tensor of at least ``min_size``
    elements gets ``axis`` on its largest dim that no other axis shards
    and ``axis_size`` divides (ties go to the first dim in the JAX
    layout, which is the torch layout reversed); a pipeline-stage tensor
    keeps its spec."""
    if axis_size <= 1:
        return dict(specs)
    out = {}
    for name, spec in specs.items():
        shape = tuple(shapes[name])
        n = 1
        for d in shape:
            n *= d
        if not shape or n < min_size or "pipe" in spec:
            out[name] = spec
            continue
        parts = list(spec) + [None] * (len(shape) - len(spec))
        best = None
        for dim in reversed(range(len(shape))):
            if parts[dim] is None and shape[dim] % axis_size == 0:
                if best is None or shape[dim] > shape[best]:
                    best = dim
        if best is not None:
            parts[best] = axis
            spec = tuple(parts)
        out[name] = spec
    return out


# --------------------------------------------------------------------------
# tensor parallelism on local heads
# --------------------------------------------------------------------------

def _chunk(t: torch.Tensor, dim: int, rank: int, n: int,
           split3: bool = False) -> torch.Tensor:
    """Rank ``rank``'s ``n``-th of ``t`` along ``dim``; with ``split3`` the
    dim is (3, rest) and each of the three parts is split."""
    if split3:
        v = t.reshape(3, -1, *t.shape[1:])
        return v.chunk(n, dim=1)[rank].reshape(-1, *t.shape[1:]).clone()
    return t.chunk(n, dim=dim)[rank].clone()


# the local slice of each parameter of a sharded module: (dim, split3)
_TP_SLICES = {
    "qkv.weight": (0, True), "qkv.bias": (0, True),
    "q.weight": (0, False), "q.bias": (0, False),
    "k.weight": (0, False), "k.bias": (0, False),
    "v.weight": (0, False), "v.bias": (0, False),
    "proj.weight": (1, False),
    "relative_position_bias_table": (1, False),
    "fc1.weight": (0, False), "fc1.bias": (0, False),
    "fc2.weight": (1, False),
}


def _shard_module(mod: nn.Module, names: Iterable[str], rank: int,
                  n: int) -> Dict[str, Tuple[int, bool]]:
    done = {}
    for pname in names:
        owner, _, leaf = pname.rpartition(".")
        sub = mod.get_submodule(owner) if owner else mod
        p = getattr(sub, leaf)
        if p is None:
            continue
        dim, split3 = _TP_SLICES[pname]
        setattr(sub, leaf, nn.Parameter(_chunk(p.data, dim, rank, n, split3),
                                        requires_grad=p.requires_grad))
        done[pname] = (dim, split3)
    return done


def apply_tensor_parallel(model: nn.Module, group: dist.ProcessGroup,
                          warn: bool = True
                          ) -> Dict[str, Tuple[int, bool]]:
    """Split every attention module and MLP of ``model`` whose ``qkv``
    (``q``) or ``fc1`` weight :data:`DEFAULT_RULES` shard over ``model``
    (after :func:`validate_divisibility`) over ``group`` (the ``model``
    axis) on local heads, in place, and give it the group
    (its forward then calls :func:`~.collectives.copy_to_group` before the
    sharded products and :func:`~.collectives.reduce_from_group` after).
    Returns ``{parameter name: (dim, split3)}``, how each local tensor is
    cut from the full one."""
    from vit_torch_tpu_torch.models.cait import (ClassAttention,
                                                 TalkingHeadAttention)
    from vit_torch_tpu_torch.models.layers import Attention, Mlp
    from vit_torch_tpu_torch.models.swin import WindowAttention
    n = dist.get_world_size(group)
    rank = dist.get_group_rank(group, dist.get_rank())
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    specs = validate_divisibility(shapes, partition_specs(shapes),
                                  {"model": n}, warn=warn)

    def ruled(name: str, leaf: str) -> bool:
        """Whether the rules (after the downgrade) shard the module's
        ``leaf`` over ``model``."""
        return "model" in specs.get(f"{name}.{leaf}" if name else leaf, ())

    slices, kept = {}, []
    for name, mod in list(model.named_modules()):
        if isinstance(mod, (Attention, WindowAttention, ClassAttention)):
            if not ruled(name, "q.weight" if isinstance(mod, ClassAttention)
                         else "qkv.weight"):
                continue
            if mod.num_heads % n:
                kept.append(f"{name}: {mod.num_heads} heads not divisible "
                            f"by model={n}")
                continue
            names = {Attention: ("qkv.weight", "qkv.bias", "proj.weight"),
                     WindowAttention: ("qkv.weight", "qkv.bias",
                                       "proj.weight",
                                       "relative_position_bias_table"),
                     ClassAttention: ("q.weight", "q.bias", "k.weight",
                                      "k.bias", "v.weight", "v.bias",
                                      "proj.weight")}[type(mod)]
            cut = _shard_module(mod, names, rank, n)
            mod.num_heads //= n
        elif isinstance(mod, Mlp):
            if not ruled(name, "fc1.weight"):
                continue
            hidden = mod.fc1.out_features
            if hidden % n:
                kept.append(f"{name}: hidden width {hidden} not divisible "
                            f"by model={n}")
                continue
            cut = _shard_module(mod, ("fc1.weight", "fc1.bias",
                                      "fc2.weight"), rank, n)
        elif isinstance(mod, TalkingHeadAttention) and ruled(name,
                                                             "qkv.weight"):
            kept.append(f"{name}: talking heads mix every head")
            continue
        else:
            continue
        mod.tp_group = group
        for pname, how in cut.items():
            slices[f"{name}.{pname}"] = how
    if kept and warn:
        warnings.warn(
            f"tensor parallelism keeps {len(kept)} module(s) replicated:\n  "
            + "\n  ".join(kept), stacklevel=2)
    return slices


def gather_tp(local: torch.Tensor, how: Tuple[int, bool],
              group: dist.ProcessGroup) -> torch.Tensor:
    """The full tensor of ``local`` shards cut by ``how`` over ``group``."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    dim, split3 = how
    if split3:
        return torch.cat([p.reshape(3, -1, *p.shape[1:]) for p in parts],
                         dim=1).reshape(-1, *local.shape[1:])
    return torch.cat(parts, dim=dim)


def slice_tp(full: torch.Tensor, how: Tuple[int, bool],
             group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's shard of ``full`` (the inverse of :func:`gather_tp`)."""
    return _chunk(full, how[0], dist.get_group_rank(group, dist.get_rank()),
                  dist.get_world_size(group), how[1])


# --------------------------------------------------------------------------
# FSDP2
# --------------------------------------------------------------------------

def fsdp_dims(model: nn.Module, axis_size: int, min_size: int = 2 ** 16,
              exclude: Iterable[str] = (),
              tp_slices: Mapping[str, Tuple[int, bool]] = ()
              ) -> Dict[str, int]:
    """The dim FSDP shards each parameter of ``model`` on (absent: stays
    replicated): :func:`add_fsdp_axis`'s choice over the local shapes, the
    tensor-parallel dim counted as taken.  Over one rank nothing, as the
    JAX package shards nothing over an axis of size 1."""
    tp = dict(tp_slices)
    shapes, specs = {}, {}
    for name, p in model.named_parameters():
        if name in exclude:
            continue
        shapes[name] = tuple(p.shape)
        spec = [None] * p.dim()
        if name in tp:
            spec[tp[name][0]] = "model"
        specs[name] = tuple(spec)
    out = add_fsdp_axis(shapes, specs, axis_size, "data", min_size)
    return {n: s.index("data") for n, s in out.items() if "data" in s}


def apply_fsdp(model: nn.Module, mesh, dims: Mapping[str, int],
               blocks: Iterable[nn.Module] = ()) -> None:
    """``fully_shard`` each of ``blocks`` and then ``model`` over ``mesh``
    (a one-dimensional DeviceMesh), sharding the parameters of ``dims`` on
    their dim and leaving every other parameter out of FSDP."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    by_id = {id(p): dims[n] for n, p in model.named_parameters() if n in dims}
    ignored = {p for n, p in model.named_parameters() if n not in dims}

    def placement(p):
        return Shard(by_id[id(p)])

    for blk in blocks:
        fully_shard(blk, mesh=mesh, ignored_params=ignored,
                    shard_placement_fn=placement)
    fully_shard(model, mesh=mesh, ignored_params=ignored,
                shard_placement_fn=placement)
