"""Host meshes for the sharded step: the JAX package's
``repro.launch.mesh``, on ``torch.distributed``.

A mesh here is a ``DeviceMesh`` named ("data", "model") over a process
group of one process a rank.  ``make_host_mesh`` joins the group the
environment describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` and ``repro_torch.launch.train`` set
them), or, for a one-rank mesh, starts a group of its own.

The production meshes (``make_production_mesh``: 16x16 ("data", "model")
or 2x16x16 ("pod", "data", "model")) are the dry run's: this process is
rank 0 of 256 or 512 on PyTorch's ``fake`` process-group backend, whose
collectives move nothing, the counterpart of XLA's forced host devices.
The dry run sets the fake group up and tears it down itself
(``fake_mesh``); it refuses to start while another group is live.
"""
from __future__ import annotations

import contextlib
import math
import os
import socket
from typing import Sequence

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


def make_fake_mesh(shape: Sequence[int], names: Sequence[str]
                   ) -> DeviceMesh:
    """A mesh of ``shape`` named ``names`` with this process as rank 0 of
    a ``fake`` process group over all of its ranks (CPU tensors, nothing
    communicated).  The caller destroys the group
    (``dist.destroy_process_group()``); ``fake_mesh`` does it for it."""
    if dist.is_initialized():
        raise RuntimeError(
            f"cannot start the dry run's fake process group: a "
            f"{dist.get_backend()} group of {dist.get_world_size()} ranks "
            f"is live in this process (rank {dist.get_rank()})")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        return init_device_mesh("cpu", tuple(int(n) for n in shape),
                                mesh_dim_names=tuple(names))
    except BaseException:
        dist.destroy_process_group()
        raise


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str]):
    """``make_fake_mesh`` while open; its group destroyed on exit."""
    mesh = make_fake_mesh(shape, names)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the 16x16 pod or the 2x16x16 pair of pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), this
    process rank 0 of a fake group (``make_fake_mesh``)."""
    return make_fake_mesh(*production_shape(multi_pod))
