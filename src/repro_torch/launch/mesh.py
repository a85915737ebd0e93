"""The host mesh over the ranks of a ``torch.distributed`` world, and the
production meshes over fake ranks.

Ports :func:`repro.launch.mesh.make_host_mesh`: a (world / N, N) mesh
on the axes ("data", "model"), built over the ranks of the process
group where the JAX package builds it over the host's devices; and
:func:`repro.launch.mesh.make_production_mesh` (:func:`make_production_mesh`),
one rank of the 256 or 512 on ``torch.distributed``'s ``fake`` backend,
for the dry run.  One
process per rank; the world comes from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or from :func:`spawn`, which the tests and
``chip_smoke.py`` use.

A rank computes on ``cuda:(LOCAL_RANK % device_count)``, or on the CPU
when the caller names it.  The backend is chosen once, by
:func:`backend_for`: NCCL when every rank of the host has a card of its
own, gloo when ranks share one (NCCL refuses two ranks on one device)
or run on the CPU.  Gloo is handed the CUDA tensors themselves
(:mod:`repro_torch.parallel.collectives`), so a rank's compute stays on
its card either way.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import ProcessMesh


def env_world() -> tuple[int, int, int]:
    """(rank, world size, local rank) from ``torchrun``'s environment;
    (0, 1, 0) outside it."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    return rank, world, int(os.environ.get("LOCAL_RANK", str(rank)))


def backend_for(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, why): ``nccl`` when each of the host's ``local_world``
    ranks has a card of its own, else ``gloo``."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", f"{local_world} ranks on {cards} cards, one card each"
    return "gloo", f"{local_world} ranks share {cards} card(s); NCCL takes one rank a device"


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: the CPU when ``device`` names it, else
    ``cuda:(LOCAL_RANK % device_count)`` (raises without a card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    _, _, local = env_world()
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_distributed(device: DeviceLike = None, init_method: str = "env://"
                     ) -> tuple[torch.device, str, str]:
    """Join the process group of ``torchrun``'s environment (or the one
    ``init_method`` names): (this rank's device, backend, why)."""
    dev = rank_device(device)
    rank, world, _ = env_world()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend, why = backend_for(dev, local_world)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **kw)
    return dev, backend, why


def make_host_mesh(model_parallel: int = 1, axis_names=("data", "model"), *,
                   device: torch.device) -> ProcessMesh:
    """(world / model_parallel, model_parallel) over the ranks of the
    initialised process group, rank = data * model_parallel + model;
    ``device`` is where this rank's tensors live.  Every rank must call
    it (each creates every axis group, in the same order)."""
    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not divide the "
                         f"world of {world} ranks")
    return _process_mesh((world // model_parallel, model_parallel), tuple(axis_names), device)


def _process_mesh(shape: tuple, axis_names: tuple, device: torch.device) -> ProcessMesh:
    """A :class:`ProcessMesh` of ``shape`` over the initialised process
    group's ranks, row-major; each axis's groups made by every rank in the
    same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    groups = {}
    for a, name in enumerate(axis_names):
        mine = None
        # every line of ranks along axis a: the other coordinates fixed
        for rest in itertools.product(*(range(n) for i, n in enumerate(shape) if i != a)):
            ranks = [int(np.ravel_multi_index(rest[:a] + (c,) + rest[a:], shape))
                     for c in range(shape[a])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        groups[name] = mine
    return ProcessMesh(tuple(range(world)), tuple(axis_names), tuple(shape), rank, groups,
                       dist.get_backend(), device)


def make_fake_mesh(shape: tuple, axis_names: tuple, rank: int = 0) -> ProcessMesh:
    """Rank ``rank`` of a mesh of ``shape`` on ``axis_names`` whose other
    ranks do not exist: the default process group of this process is
    (re)made on ``torch.distributed``'s ``fake`` backend (its collectives
    return outputs of the right shapes and move nothing), so that one
    process can run one rank's step on abstract tensors (the dry run,
    :mod:`repro_torch.launch.dryrun`).  Its tensors live on the CPU
    device, as FakeTensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(np.prod(shape)))
    return _process_mesh(tuple(shape), tuple(axis_names), torch.device("cpu"))


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> ProcessMesh:
    """The JAX package's production meshes (``repro.launch.mesh``), as
    rank ``rank`` of fake ranks (:func:`make_fake_mesh`): one pod,
    (16, 16) on ("data", "model"), 256 ranks; two pods, (2, 16, 16) on
    ("pod", "data", "model"), 512."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"), rank)
    return make_fake_mesh((16, 16), ("data", "model"), rank)


def _rank_main(rank: int, world: int, init_file: str, device: str, fn: Callable, args: tuple):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    init_distributed(device, f"file://{init_file}")
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, init_file: str, device: str = "cpu",
          timeout: float = 600.0) -> None:
    """Run ``fn(*args)`` in ``world`` new processes (the ``spawn`` start
    method), each a rank of one process group over ``init_file`` (a
    ``FileStore``: it must not exist yet) on ``device`` ("cpu", or
    "cuda": ``cuda:(rank % device_count)``).  ``fn`` must be importable
    by name; it builds its mesh with :func:`make_host_mesh`.  Raises if
    any rank raises or exits non-zero (the others are then terminated),
    or if the ranks have not all ended within ``timeout`` seconds (all
    are then terminated)."""
    if os.path.exists(init_file):
        raise FileExistsError(init_file)
    ctx = mp.start_processes(_rank_main, args=(world, init_file, device, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
