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
memory); those three are the only collectives the port calls (a ring
shift is an ``all_gather`` and a pick, a reduce-scatter an
``all_reduce`` and a slice). A failure is raised, never retried on
another backend.

Training differentiates through the collectives, so each has an
autograd form over one named axis (or a subgroup of it), Megatron's
two operators among them: :meth:`Mesh.sum` (*g*: the sum forward, the
identity backward, for a row-parallel product's partial sums whose
consumers compute the same thing on every rank), :meth:`Mesh.enter`
(*f*: the identity forward, the sum backward, for a replicated tensor
entering a split region), :meth:`Mesh.gather` (backward: this rank's
slice of the gradient, summed over the axis first for a weight
gathered over ``data``) and :meth:`Mesh.shift` (a ring shift whose
backward shifts the gradient the other way).
"""
from __future__ import annotations

import gc
import math
import multiprocessing
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

__all__ = ["Mesh", "make_mesh", "parse_mesh", "pick_backend", "rank_device",
           "run_mesh", "use_mesh"]

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


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in f32 (a bf16 partial sum is
    widened first and the total rounded once), in ``t``'s dtype."""
    buf = t.to(torch.float32, copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def _gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return parts


class _SumOver(torch.autograd.Function):
    """g: the sum over a group; backward the identity."""

    @staticmethod
    def forward(ctx, t, group):
        return _sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Enter(torch.autograd.Function):
    """f: the identity; backward the sum over a group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """Every rank's ``t`` concatenated on ``dim`` in coordinate order;
    backward this rank's slice of the gradient, summed over the group
    first when ``reduce``."""

    @staticmethod
    def forward(ctx, t, group, n, index, dim, reduce):
        ctx.group, ctx.index, ctx.dim, ctx.reduce = group, index, dim, reduce
        ctx.size = t.shape[dim]
        return torch.cat(_gather(t, group, n), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            grad = _sum(grad, ctx.group)
        return (grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None, None, None)


class _Shift(torch.autograd.Function):
    """A ring shift by one over a group of ``n``: the rank at ``index``
    gets ``index - 1``'s ``t``; backward the gradient goes the other
    way."""

    @staticmethod
    def forward(ctx, t, group, n, index):
        ctx.group, ctx.n, ctx.index = group, n, index
        return _gather(t, group, n)[(index - 1) % n]

    @staticmethod
    def backward(ctx, grad):
        return (_gather(grad, ctx.group, ctx.n)[(ctx.index + 1) % ctx.n],
                None, None, None)


class Mesh:
    """One rank's view of a device mesh: the axes and their sizes, this
    rank's coordinates and device, the backend, and the collectives the
    port's tensor-parallel forms call, each over one named axis: the
    three plain ones serving calls and their autograd forms (module
    docstring), plus subgroups of an axis and the collectives over the
    whole world that assemble a tree."""

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
        self._subgroups = {}
        self._placements = {}
        grid = device_mesh.mesh
        self.rank_coords = [
            dict(zip(self.axis_names,
                     (int(i) for i in (grid == r).nonzero()[0])))
            for r in range(self.devices)]

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
        return _sum(t, self._groups[axis])

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
        coordinate order."""
        n = self.sizes[axis]
        if n == 1:
            return t
        return torch.cat(_gather(t, self._groups[axis], n), dim=dim)

    def broadcast(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` as the rank at coordinate 0 of ``axis`` holds it."""
        if self.sizes[axis] == 1:
            return t
        group = self._groups[axis]
        t = t.contiguous()
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t

    # ------------------------------------------------------ autograd forms
    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """g over ``axis``: the sum (as :meth:`all_reduce`); its backward
        is the identity."""
        if self.sizes[axis] == 1:
            return t
        return _SumOver.apply(t, self._groups[axis])

    def enter(self, t: torch.Tensor, axis: Optional[str] = None,
              group=None) -> torch.Tensor:
        """f over ``axis`` (or over ``group``, a subgroup of it): the
        identity; its backward sums the gradient over the ranks."""
        if group is None:
            if self.sizes[axis] == 1:
                return t
            group = self._groups[axis]
        return _Enter.apply(t, group)

    def gather(self, t: torch.Tensor, axis: str, dim: int,
               reduce: bool = False) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim``;
        the backward takes this rank's slice of the gradient, summed over
        ``axis`` first when ``reduce``."""
        n = self.sizes[axis]
        if n == 1:
            return t
        return _Gather.apply(t, self._groups[axis], n, self.coords[axis],
                             dim % t.dim(), reduce)

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ring shift by one along ``axis``: coordinate ``i`` gets
        ``i - 1``'s ``t`` (the last's goes to the first)."""
        n = self.sizes[axis]
        if n == 1:
            return t
        return _Shift.apply(t, self._groups[axis], n, self.coords[axis])

    # ---------------------------------------------------------- subgroups
    def subgroup(self, groups) -> Optional[Any]:
        """This rank's process group among ``groups`` (tuples of global
        ranks covering some ranks once each), built on first use; every
        rank must ask for the same ``groups`` at the same point, since
        each group is made by all of them. None when this rank's group
        is itself alone (or it is in none)."""
        groups = tuple(tuple(sorted(int(r) for r in g)) for g in groups)
        if groups not in self._subgroups:
            mine = None
            for g in sorted(groups):
                if len(g) < 2:
                    continue
                pg = dist.new_group(list(g))
                if self.rank in g:
                    mine = pg
            self._subgroups[groups] = mine
        return self._subgroups[groups]

    # --------------------------------------------------------- the world
    def barrier(self) -> None:
        """Wait until every rank has reached this call."""
        if self.devices > 1:
            dist.barrier()

    def world_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (all of one shape), in rank order."""
        if self.devices == 1:
            return [t]
        return _gather(t, None, self.devices)

    def world_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The f32 sum of ``t`` over every rank, in ``t``'s dtype."""
        if self.devices == 1:
            return t
        return _sum(t, None)


def parse_mesh(text: str):
    """``DxM`` -> ((D, M), {"data": D, "model": M})."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: expected DxM, e.g. 2x4") \
            from None
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {text!r}: both sizes must be >= 1")
    return (d, m), {"data": d, "model": m}


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
        del args
        _drop_caller_tensors(device)
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


def _drop_caller_tensors(device: torch.device) -> None:
    """Let go of what the caller passed this rank before it exits: the
    process object keeps its arguments to the end, and a CUDA tensor read
    over IPC that is still held when the process exits never returns its
    memory to the caller."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    proc = multiprocessing.current_process()
    proc._args, proc._kwargs = (), {}
    gc.collect()


def _release_ipc() -> None:
    """Free this process's CUDA tensors that earlier ranks read over
    CUDA IPC: once dropped here they stay allocated until their readers
    are known to be gone, which only a collection finds out."""
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()


def run_mesh(fn: Callable, shape, *args, axes=("data", "model"),
             devices: Devices = None, timeout: float = 600.0,
             threads: Optional[int] = 1) -> List[Any]:
    """Spawn ``prod(shape)`` ranks, run ``fn(mesh, *args)`` on each and
    return their results in rank order.

    ``fn`` must be importable (a module-level function); its results are
    pickled back, so return host data. ``args`` cross by
    ``torch.multiprocessing``'s pickler: CPU tensors through shared
    memory, CUDA tensors through CUDA IPC (the ranks read the caller's
    tensors; the caller must keep them alive until this returns; what
    the caller has dropped of earlier ranks' tensors is freed here).
    ``threads`` sets each rank's intra-op threads. A rank's exception
    stops every rank and raises here with its traceback; so does
    ``timeout`` (seconds)."""
    import torch.multiprocessing as mp

    shape = tuple(int(s) for s in shape)
    world = math.prod(shape)
    backend = pick_backend(world, devices)
    _release_ipc()
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
        _release_ipc()
