"""Host meshes for the sharded step: the JAX package's
``repro.launch.mesh``, on ``torch.distributed``.

A mesh here is a ``DeviceMesh`` named ("data", "model") over a process
group of one process a rank.  ``make_host_mesh`` joins the group the
environment describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` and ``repro_torch.launch.train`` set
them), or, for a one-rank mesh, starts a group of its own.  The production
meshes (16x16 and 2x16x16, ``make_production_mesh``) wait for the dry run
(ROADMAP.md, queue 1, item 9c).
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(data: int = 1, model: int = 1,
                   device: str = "cpu") -> DeviceMesh:
    """A (data, model) mesh of ``data * model`` ranks: gloo on the CPU
    (each rank a process; the counterpart of XLA's forced host device
    count), NCCL on cards (one card a rank, the card of the rank's index).

    Unlike the JAX package, which clamps the mesh to the devices there
    are, a mesh larger than the world or than the visible cards is
    refused, with the count."""
    n = int(data) * int(model)
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a host mesh runs on the CPU or on cards, not "
                         f"{device!r}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(f"a {data}x{model} mesh needs {n} cards; "
                             f"{cards} visible")
    if not dist.is_initialized():
        if n == 1 and "RANK" not in os.environ:
            rank, world = 0, 1
            init = f"tcp://localhost:{free_port()}"
        else:
            rank = int(os.environ["RANK"])
            world = int(os.environ["WORLD_SIZE"])
            init = "env://"
        if dev.type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init, rank=rank,
                                world_size=world)
    backend = dist.get_backend()
    if dev.type == "cuda" and backend != "nccl":
        raise ValueError(f"a mesh of cards runs over NCCL; the process "
                         f"group runs over {backend}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {data}x{model} mesh needs {n} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(dev.type, (int(data), int(model)),
                            mesh_dim_names=("data", "model"))
