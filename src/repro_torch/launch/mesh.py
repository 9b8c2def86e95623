"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

A mesh runs SPMD over processes: one process a rank, each with a
``torch.distributed`` process group and a ``DeviceMesh`` of named axes
(``("data", "model")`` for serving). :func:`run_mesh` spawns the ranks
(start method ``spawn``), brings the group up over a ``FileStore`` in a
fresh temporary directory (no TCP port, so parallel runs cannot
collide), calls ``fn(mesh, *args)`` on every rank and returns each
rank's result to the caller. Rank ``r`` runs on ``cuda:{r %
device_count}`` unless the caller passes the devices, and on the CPU
only when asked (``devices="cpu"``).

The backend follows one rule, decided before the group exists:
``nccl`` when every rank has a card of its own, ``gloo`` on the CPU or
when ranks share a card (NCCL refuses two ranks on one device,
"Duplicate GPU detected"). ``gloo`` runs ``all_reduce``, ``all_gather``
and ``broadcast`` on CUDA tensors itself (staging them through host
memory); those three are the only collectives the port calls. A
failure is raised, never retried on another backend.
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (Placement, Recipe,
                                      check_mesh_family, use_mesh)

__all__ = ["Mesh", "make_mesh", "pick_backend", "rank_device", "run_mesh",
           "use_mesh"]

Devices = Optional[Union[str, Sequence[str]]]


def rank_device(rank: int, devices: Devices = None) -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:{rank % device_count}``
    by default or for ``"cuda"`` (a host with no card raises), the CPU
    for ``"cpu"``, else ``devices[rank]``."""
    if devices is None or devices == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass "
                               "devices='cpu' to run the mesh on the CPU")
        return torch.device("cuda", rank % torch.cuda.device_count())
    if isinstance(devices, str):
        return torch.device(devices)
    return torch.device(devices[rank])


def pick_backend(world: int, devices: Devices = None) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    if devices == "cpu":
        return "gloo"
    if devices is None or devices == "cuda":
        if not torch.cuda.is_available():
            return "gloo"
        return "nccl" if torch.cuda.device_count() >= world else "gloo"
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        return "gloo"
    return "nccl" if len({str(d) for d in devs}) == world else "gloo"


class Mesh:
    """One rank's view of a device mesh: the axes and their sizes, this
    rank's coordinates and device, the backend, and the three
    collectives the port's tensor-parallel forms call, each over one
    named axis."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.axis_sizes = tuple(int(s) for s in device_mesh.mesh.shape)
        self.sizes = dict(zip(self.axis_names, self.axis_sizes))
        self.devices = math.prod(self.axis_sizes)
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               device_mesh.get_coordinate()))
        self._groups = {a: device_mesh.get_group(a) for a in self.axis_names}
        self._placements = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.sizes}, rank {self.rank} at {self.coords}, "
                f"{self.device}, {self.backend})")

    def placement(self, cfg, recipe: Recipe) -> Placement:
        """``cfg``'s placement on this rank under ``recipe`` (cached)."""
        key = (cfg, recipe.key())
        if key not in self._placements:
            check_mesh_family(cfg, self.sizes)
            self._placements[key] = Placement(cfg, recipe, self)
        return self._placements[key]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, in f32 (a bf16 partial sum is
        widened first and the total rounded once), in ``t``'s dtype."""
        if self.sizes[axis] == 1:
            return t
        buf = t.to(torch.float32, copy=True)
        dist.all_reduce(buf, group=self._groups[axis])
        return buf.to(t.dtype)

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
        coordinate order."""
        n = self.sizes[axis]
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._groups[axis])
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` as the rank at coordinate 0 of ``axis`` holds it."""
        if self.sizes[axis] == 1:
            return t
        group = self._groups[axis]
        t = t.contiguous()
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t


def make_mesh(shape, axes=("data", "model"), *,
              devices: Devices = None) -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` over ``axes``, on the
    process group already up (:func:`run_mesh` brings it up); rank ``r``
    takes ``rank_device(r, devices)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the "
                           "ranks with run_mesh")
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size()
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh {shape} over {axes} does not match the "
                         f"{world} ranks of the process group")
    device = rank_device(dist.get_rank(), devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dm = DeviceMesh(device.type, torch.arange(world).reshape(shape),
                    mesh_dim_names=axes)
    return Mesh(dm, device, dist.get_backend())


def _rank_main(fn, args, rank: int, shape, axes, devices, backend: str,
               tmp: str, threads: Optional[int]) -> None:
    world = math.prod(shape)
    try:
        if threads:
            torch.set_num_threads(threads)
        device = rank_device(rank, devices)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world)
        mesh = make_mesh(shape, axes, devices=devices)
        out = fn(mesh, *args)
        with open(os.path.join(tmp, f"out{rank}.tmp"), "wb") as fh:
            pickle.dump(out, fh)
        os.replace(os.path.join(tmp, f"out{rank}.tmp"),
                   os.path.join(tmp, f"out{rank}.pkl"))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        # the other ranks may wait in a collective on this one: leave at
        # once, and let the parent stop them
        os._exit(1)


def run_mesh(fn: Callable, shape, *args, axes=("data", "model"),
             devices: Devices = None, timeout: float = 600.0,
             threads: Optional[int] = 1) -> List[Any]:
    """Spawn ``prod(shape)`` ranks, run ``fn(mesh, *args)`` on each and
    return their results in rank order.

    ``fn`` must be importable (a module-level function); its results are
    pickled back, so return host data. ``args`` cross by
    ``torch.multiprocessing``'s pickler: CPU tensors through shared
    memory, CUDA tensors through CUDA IPC (the ranks read the caller's
    tensors; the caller must keep them alive until this returns).
    ``threads`` sets each rank's intra-op threads. A rank's exception
    stops every rank and raises here with its traceback; so does
    ``timeout`` (seconds)."""
    import torch.multiprocessing as mp

    shape = tuple(int(s) for s in shape)
    world = math.prod(shape)
    backend = pick_backend(world, devices)
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh-")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, shape, tuple(axes), devices,
                               backend, tmp, threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        timed_out = any(p.is_alive() for p in procs) and not any(
            p.exitcode not in (None, 0) for p in procs)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for r in range(world):
            path = os.path.join(tmp, f"err{r}.txt")
            if os.path.exists(path):
                with open(path) as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
        if errors:
            raise RuntimeError(f"mesh {shape} ({backend}) failed:\n"
                               + "\n".join(errors))
        if timed_out:
            raise TimeoutError(f"mesh {shape} ({backend}) ran past "
                               f"{timeout} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"mesh {shape} ({backend}): ranks exited "
                               f"with {bad}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
