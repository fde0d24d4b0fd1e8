"""The device mesh, counterpart of ``vit_torch_tpu/parallel/mesh.py``.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``; the
port runs one process per device over ``torch.distributed`` and lays the
world out as a :class:`~torch.distributed.device_mesh.DeviceMesh` of the
same four axes, row-major in rank (the JAX mesh's device order):

- ``data``  batch (data parallel; the gradient all-reduce)
- ``model`` tensor parallel (local heads of attention, column/row MLP)
- ``seq``   sequence parallel (ring attention, ``ops/ring_attention.py``)
- ``pipe``  pipeline parallel (the GPipe schedule, ``pipeline.py``)

``make_mesh('')`` puts every rank on ``data``; ``make_mesh('data=2,
model=2')`` carves the world explicitly.  NCCL backs the groups on CUDA,
gloo on the CPU (:func:`.multihost.init_distributed_mode`).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("data", "model", "seq", "pipe")


def parse_mesh_spec(spec: str, n_devices: int) -> Tuple[int, int, int, int]:
    """``'data=4,model=2'`` → (4, 2, 1, 1); '' → (n_devices, 1, 1, 1).

    A single ``-1`` entry absorbs the remaining devices.  The JAX
    function's arithmetic and errors."""
    sizes = {"data": 0, "model": 0, "seq": 0, "pipe": 0}
    if spec:
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in sizes:
                raise ValueError(f"unknown mesh axis {k!r}; have {AXES}")
            sizes[k] = int(v)
    fixed = {k: v for k, v in sizes.items() if v > 0}
    n_fixed = math.prod(fixed.values()) if fixed else 1
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("at most one -1 axis allowed")
    for k in AXES:  # unspecified axes default to 1
        if sizes[k] == 0:
            sizes[k] = 1
    if wild:
        if n_devices % n_fixed:
            raise ValueError(f"{n_devices} devices not divisible by {n_fixed}")
        sizes[wild[0]] = n_devices // n_fixed
    elif not spec:
        sizes["data"] = n_devices
    total = math.prod(sizes[k] for k in AXES)
    if total != n_devices:
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {n_devices}")
    return tuple(sizes[k] for k in AXES)


def rank_groups(shape: Sequence[int], axes: Sequence[str]) -> list:
    """The rank lists of the groups along ``axes``: ranks that differ
    only in their coordinates on ``axes`` (row-major rank order)."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    keep = [i for i, a in enumerate(AXES) if a not in axes]
    moved = np.transpose(ranks, keep + [AXES.index(a) for a in axes])
    n = math.prod(shape[AXES.index(a)] for a in axes)
    return [list(map(int, g)) for g in moved.reshape(-1, n)]


class Mesh:
    """The world as a four-axis mesh: ``shape`` (axis → size), this rank's
    ``coords``, a process group per axis and per pair of axes asked for
    (:meth:`group`), and the :class:`DeviceMesh` (``device_mesh``) that
    FSDP2 takes its sub-meshes from (:meth:`sub_mesh`)."""

    def __init__(self, shape: Tuple[int, int, int, int], device_type: str):
        from torch.distributed.device_mesh import init_device_mesh
        self.shape: Dict[str, int] = dict(zip(AXES, shape))
        self.device_type = device_type
        self.device_mesh = init_device_mesh(device_type, tuple(shape),
                                            mesh_dim_names=AXES)
        rank = dist.get_rank()
        self.coords: Dict[str, int] = dict(zip(
            AXES, map(int, np.unravel_index(rank, shape))))
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        self._meshes: Dict[Tuple[str, ...], object] = {}
        # the pair FSDP and the gradient average span when seq > 1 (every
        # rank must create it: new_group is collective over the world)
        if self.shape["data"] > 1 and self.shape["seq"] > 1:
            self.group("data", "seq")

    def group(self, *axes: str) -> dist.ProcessGroup:
        """The process group of this rank along ``axes``."""
        axes = tuple(a for a in AXES if a in axes)
        live = tuple(a for a in axes if self.shape[a] > 1)
        if len(live) <= 1:
            return self.device_mesh.get_group(live[0] if live else axes[0])
        if live not in self._groups:
            mine, _ = dist.new_subgroups_by_enumeration(
                rank_groups(tuple(self.shape.values()), live))
            self._groups[live] = mine
        return self._groups[live]

    def extent(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's row-major position along ``axes``."""
        i = 0
        for a in AXES:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i

    def sub_mesh(self, *axes: str):
        """A one-dimensional DeviceMesh over ``axes`` (FSDP2's mesh)."""
        from torch.distributed.device_mesh import DeviceMesh
        live = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        if len(live) <= 1:
            return self.device_mesh[live[0] if live else axes[0]]
        if live not in self._meshes:
            self._meshes[live] = DeviceMesh.from_group(
                self.group(*live), self.device_type)
        return self._meshes[live]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(spec: str = "", device_type: str = "cpu") -> Mesh:
    """The mesh of ``spec`` over the initialised world (see
    :func:`.multihost.init_distributed_mode`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call parallel.multihost.init_distributed_mode")
    return Mesh(parse_mesh_spec(spec, dist.get_world_size()), device_type)
