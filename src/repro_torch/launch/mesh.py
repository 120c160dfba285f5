"""Mesh construction (the reference's ``src/repro/launch/mesh.py``).

Defined as FUNCTIONS, never module-level state, so importing this module
touches no process group and no device. Each builds a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default
process group, which the caller starts first
(``torch.distributed.init_process_group``: nccl on the card, gloo on the
CPU, the fake backend for the dry run).
"""
from __future__ import annotations


def _device_type() -> str:
    """"cuda" when the default group's backend is NCCL, else "cpu"."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16 x 16 = 256 ranks per pod ("data", "model"); ``multi_pod`` adds
    a 2-pod leading axis ("pod", "data", "model"). Needs a world of 256
    (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type=None):
    """A ("data", "model") mesh over every rank of the default group
    (tests, the smoke run): ``model`` ranks on "model" (at most the
    world), the rest on "data"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = max(1, min(model, n))
    return init_device_mesh(device_type or _device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))

