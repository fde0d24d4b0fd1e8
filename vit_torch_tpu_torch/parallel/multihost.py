"""Process-group set-up and rank utilities, counterpart of
``vit_torch_tpu/parallel/multihost.py`` (the reference's
``object/torch_utils.py:244-310``: rank discovery, the process group,
rank-0 printing, ``save_on_master``, the pickle ``all_gather``).

One process drives one device.  Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in the
environment) the group spans its world; without it a world of one forms
on a free local port, so ``--mesh data=1`` runs in a plain process.  The
backend is NCCL on CUDA and gloo on the CPU; on CUDA, gloo only where
torchrun's local ranks (``LOCAL_WORLD_SIZE``) outnumber the host's cards,
so that they share them (NCCL refuses two ranks on one card).  A group
that fails to form raises.
"""

from __future__ import annotations

import builtins
import os
import socket
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist


def free_port() -> int:
    """A free local TCP port (bind to port 0 and read it back)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_backend(device: torch.device) -> str:
    """NCCL on CUDA; gloo on the CPU, and on CUDA where torchrun's local
    ranks (``LOCAL_WORLD_SIZE``) outnumber the host's cards."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def init_distributed_mode(device: torch.device, filter_print: bool = True
                          ) -> Dict[str, Any]:
    """Join (or form) the process group for ``device``'s type and return
    ``{"rank", "world_size", "local_rank", "backend", "device",
    "formed"}`` (``formed``: this call created the group); on CUDA
    ``device`` becomes ``cuda:<local rank mod card count>``."""
    env = os.environ
    rank = int(env.get("RANK", 0))
    world = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = dist_backend(device)
    formed = not dist.is_initialized()
    if formed:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif world == 1:
            init = f"tcp://localhost:{free_port()}"
        else:
            raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR and "
                               "MASTER_PORT: launch with torchrun")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank, **kw)
    info = {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "local_rank": local_rank, "backend": dist.get_backend(),
            "device": device, "formed": formed}
    if filter_print and info["world_size"] > 1:
        setup_for_distributed(info["rank"] == 0)
    return info


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """Rank-0-only printing (reference ``torch_utils.py:244-256``);
    ``print(..., force=True)`` prints on every rank."""
    builtin_print = builtins.print

    def print_fn(*args, force: bool = False, **kwargs):
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_fn


def save_on_master(save_fn: Callable, *args: Any, **kwargs: Any) -> None:
    """Run a save callback on rank 0 only (reference ``save_on_master``,
    ``torch_utils.py:283-285``)."""
    if is_main_process():
        save_fn(*args, **kwargs)


def all_gather_objects(obj: Any, group: Optional[dist.ProcessGroup] = None
                       ) -> list:
    """Every rank's picklable ``obj``, in rank order (the reference's
    pickle ``all_gather``, ``torch_utils.py:77-117``)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def setup_mesh(spec: str, device: torch.device, force: bool = False):
    """The CLIs' mesh: ``(mesh, device, formed)``.  With ``spec`` empty,
    outside torchrun and without ``force``, ``(None, device, False)``: the
    single-process path, no process group.  Otherwise the group is joined
    or formed (:func:`init_distributed_mode`) and the mesh of ``spec``
    laid over it; ``formed`` says whether the caller should destroy the
    group at its end."""
    if not (spec or force or launched_by_torchrun()):
        return None, device, False
    from vit_torch_tpu_torch.parallel.mesh import make_mesh
    info = init_distributed_mode(device)
    mesh = make_mesh(spec, info["device"].type)
    print(f"mesh: {mesh.shape} over {info['world_size']} rank(s), "
          f"{info['backend']} on {info['device']}")
    return mesh, info["device"], info["formed"]
