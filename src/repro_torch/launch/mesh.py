"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

A mesh runs SPMD over processes: one process a rank, each with a
``torch.distributed`` process group and a ``DeviceMesh`` of named axes
(``("data", "model")`` for serving). :func:`run_mesh` forks the ranks
from a server that imported torch once (start method ``forkserver``),
brings the group up over a ``FileStore`` in a
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
entering a split region), :meth:`Mesh.total` (the sum forward and
backward: a total each rank consumes differently, as the Mamba-2 gated
norm's sum of squares, or a global-batch statistic, as the MoE aux
loss's means), :meth:`Mesh.gather` (backward: this rank's
slice of the gradient, summed over the axis first for a weight
gathered over ``data``) and :meth:`Mesh.shift` (a ring shift whose
backward shifts the gradient the other way).

Every collective a process makes is counted, as each kernel wrapper
counts its launches: :data:`COLLECTIVES` (``Mesh.collectives``) holds,
per kind (``all-reduce``, ``all-gather``, ``broadcast``) and group size,
the calls and the payload bytes this rank put in (an all-reduce's f32
buffer, a gather's own part, a broadcast's tensor), the backward
collectives of the autograd forms included. :class:`DryMesh` is one
rank of a mesh that does not exist: the same attributes and methods,
every collective a ``meta`` tensor of the shape and dtype the real one
returns and a record of it (``launch.lowering`` traces a rank's step on
it); its :meth:`DryMesh.counts` has the counters' form.
"""
from __future__ import annotations

import atexit
import gc
import itertools
import math
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
import weakref
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Placement, Recipe, use_mesh

__all__ = ["COLLECTIVES", "DryMesh", "Mesh", "make_mesh", "parse_mesh",
           "pick_backend", "rank_device", "run_mesh", "use_mesh"]

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


class CollectiveCounts:
    """The collectives one process made, by ``(kind, group size)``: the
    calls and the payload bytes this rank put in."""

    def __init__(self) -> None:
        self.by: dict = {}

    def add(self, kind: str, n: int, nbytes: int) -> None:
        calls, total = self.by.get((kind, n), (0, 0))
        self.by[(kind, n)] = (calls + 1, total + int(nbytes))

    def reset(self) -> None:
        self.by.clear()

    def as_dict(self) -> dict:
        """``{"<kind>/<n>": {"calls", "bytes"}}``, sorted."""
        return {f"{k}/{n}": {"calls": c, "bytes": b}
                for (k, n), (c, b) in sorted(self.by.items())}


#: This process's collectives (one process is one rank).
COLLECTIVES = CollectiveCounts()


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in f32 (a bf16 partial sum is
    widened first and the total rounded once), in ``t``'s dtype."""
    buf = t.to(torch.float32, copy=True)
    COLLECTIVES.add("all-reduce", dist.get_world_size(group),
                    buf.numel() * buf.element_size())
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def _gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    COLLECTIVES.add("all-gather", n, t.numel() * t.element_size())
    dist.all_gather(parts, t, group=group)
    return parts


def _broadcast(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    COLLECTIVES.add("broadcast", dist.get_world_size(group),
                    t.numel() * t.element_size())
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


class _Live:
    """The process group's collectives (counted), as the forms call
    them: ``reduce`` the f32 sum, ``collect`` every rank's part,
    ``bcast`` the first rank's tensor."""

    reduce = staticmethod(_sum)
    collect = staticmethod(_gather)
    bcast = staticmethod(_broadcast)


_LIVE = _Live()


class _SumOver(torch.autograd.Function):
    """g: the sum over a group; backward the identity."""

    @staticmethod
    def forward(ctx, t, comm, group):
        return comm.reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Enter(torch.autograd.Function):
    """f: the identity; backward the sum over a group."""

    @staticmethod
    def forward(ctx, t, comm, group):
        ctx.comm, ctx.group = comm, group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce(grad, ctx.group), None, None


class _Total(torch.autograd.Function):
    """The sum over a group whose backward is the sum too."""

    @staticmethod
    def forward(ctx, t, comm, group):
        ctx.comm, ctx.group = comm, group
        return comm.reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce(grad, ctx.group), None, None


class _Gather(torch.autograd.Function):
    """Every rank's ``t`` concatenated on ``dim`` in coordinate order;
    backward this rank's slice of the gradient, summed over the group
    first when ``reduce``."""

    @staticmethod
    def forward(ctx, t, comm, group, n, index, dim, reduce):
        ctx.comm, ctx.group, ctx.index = comm, group, index
        ctx.dim, ctx.reduce = dim, reduce
        ctx.size = t.shape[dim]
        return torch.cat(comm.collect(t, group, n), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            grad = ctx.comm.reduce(grad, ctx.group)
        return (grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None, None, None, None)


class _Shift(torch.autograd.Function):
    """A ring shift by one over a group of ``n``: the rank at ``index``
    gets ``index - 1``'s ``t``; backward the gradient goes the other
    way."""

    @staticmethod
    def forward(ctx, t, comm, group, n, index):
        ctx.comm, ctx.group, ctx.n, ctx.index = comm, group, n, index
        return comm.collect(t, group, n)[(index - 1) % n]

    @staticmethod
    def backward(ctx, grad):
        return (ctx.comm.collect(grad, ctx.group, ctx.n)[
            (ctx.index + 1) % ctx.n], None, None, None, None)


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
        self.collectives = COLLECTIVES
        self._comm = _LIVE
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
            self._placements[key] = Placement(cfg, recipe, self)
        return self._placements[key]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, in f32 (a bf16 partial sum is
        widened first and the total rounded once), in ``t``'s dtype."""
        if self.sizes[axis] == 1:
            return t
        return self._comm.reduce(t, self._groups[axis])

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
        coordinate order."""
        n = self.sizes[axis]
        if n == 1:
            return t
        return torch.cat(self._comm.collect(t, self._groups[axis], n),
                         dim=dim)

    def broadcast(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` as the rank at coordinate 0 of ``axis`` holds it."""
        if self.sizes[axis] == 1:
            return t
        return self._comm.bcast(t, self._groups[axis])

    # ------------------------------------------------------ autograd forms
    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """g over ``axis``: the sum (as :meth:`all_reduce`); its backward
        is the identity."""
        if self.sizes[axis] == 1:
            return t
        return _SumOver.apply(t, self._comm, self._groups[axis])

    def enter(self, t: torch.Tensor, axis: Optional[str] = None,
              group=None) -> torch.Tensor:
        """f over ``axis`` (or over ``group``, a subgroup of it): the
        identity; its backward sums the gradient over the ranks."""
        if group is None:
            if self.sizes[axis] == 1:
                return t
            group = self._groups[axis]
        return _Enter.apply(t, self._comm, group)

    def total(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` whose backward sums the gradient over it
        too: for a total that every rank consumes differently (a norm's
        sum of squares over a split row), or a statistic of the global
        batch that each data rank's loss reads."""
        if self.sizes[axis] == 1:
            return t
        return _Total.apply(t, self._comm, self._groups[axis])

    def gather(self, t: torch.Tensor, axis: str, dim: int,
               reduce: bool = False) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim``;
        the backward takes this rank's slice of the gradient, summed over
        ``axis`` first when ``reduce``."""
        n = self.sizes[axis]
        if n == 1:
            return t
        return _Gather.apply(t, self._comm, self._groups[axis], n,
                             self.coords[axis], dim % t.dim(), reduce)

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ring shift by one along ``axis``: coordinate ``i`` gets
        ``i - 1``'s ``t`` (the last's goes to the first)."""
        n = self.sizes[axis]
        if n == 1:
            return t
        return _Shift.apply(t, self._comm, self._groups[axis], n,
                            self.coords[axis])

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
        return self._comm.collect(t, None, self.devices)

    def world_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The f32 sum of ``t`` over every rank, in ``t``'s dtype."""
        if self.devices == 1:
            return t
        return self._comm.reduce(t, None)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class DryMesh(Mesh):
    """One rank of a mesh that does not exist: the attributes and
    methods of :class:`Mesh`, on ``meta``, with no process group. Every
    collective allocates what the real one allocates (the f32 buffer of
    a sum, the parts of a gather) and returns a ``meta`` tensor of the
    shape and dtype the real one returns, and appends a record to
    :attr:`records`: ``kind``, ``axis`` (a mesh axis, ``world``, or the
    axis a subgroup is part of), the group size ``n``, the payload
    ``bytes`` this rank puts in (as :data:`COLLECTIVES` counts them),
    and ``src``, the index of the collective whose output this one reads
    (its buffer or a view of it; None for any other buffer).
    :meth:`subgroup` returns a token and :meth:`barrier` does nothing.

    ``shape`` and ``axes`` give the mesh; ranks are numbered with the
    last axis fastest, as ``make_mesh`` numbers them."""

    def __init__(self, shape, axes=("data", "model"), rank: int = 0):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh {shape} over {axes}")
        self.device_mesh = None
        self.axis_names, self.axis_sizes = axes, shape
        self.sizes = dict(zip(axes, shape))
        self.devices = math.prod(shape)
        if not 0 <= rank < self.devices:
            raise ValueError(f"rank {rank} of a mesh of {self.devices}")
        self.device = torch.device("meta")
        self.backend = "dry"
        self.rank = rank
        self.rank_coords = [dict(zip(axes, c)) for c in itertools.product(
            *(range(n) for n in shape))]
        self.coords = dict(self.rank_coords[rank])
        self._groups = {a: a for a in axes}
        self._subgroups = {}
        self._placements = {}
        self._comm = self
        self.records: List[dict] = []
        self._produced: dict = {}

    def __repr__(self) -> str:
        return f"DryMesh({self.sizes}, rank {self.rank} at {self.coords})"

    # -- the collectives, recorded ------------------------------------------
    def _n(self, group) -> int:
        if group is None:
            return self.devices
        if isinstance(group, tuple):
            return len(group[1])
        return self.sizes[group]

    def _record(self, kind: str, group, read: torch.Tensor,
                payload: torch.Tensor, outs) -> None:
        """One record: ``read`` is the tensor the caller passed,
        ``payload`` what this rank puts in, ``outs`` what it allocates
        for the result."""
        axis = "world" if group is None else \
            group[0] if isinstance(group, tuple) else group
        i = len(self.records)
        self.records.append(dict(
            kind=kind, axis=axis, n=self._n(group),
            bytes=payload.numel() * payload.element_size(),
            src=self._produced.get(_storage_key(read))))
        for out in outs:
            key = _storage_key(out)
            self._produced[key] = i
            weakref.finalize(out.untyped_storage(), self._produced.pop,
                             key, None)

    def reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        buf = t.to(torch.float32, copy=True)
        out = buf.to(t.dtype)
        self._record("all-reduce", group, t, buf, (out,))
        return out

    def collect(self, t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
        read, t = t, t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        self._record("all-gather", group, read, t, parts)
        return parts

    def bcast(self, t: torch.Tensor, group) -> torch.Tensor:
        read, t = t, t.contiguous()
        self._record("broadcast", group, read, t, ())
        return t

    def _produced_by_last(self, out: torch.Tensor) -> torch.Tensor:
        """``out`` (a gather's concatenation) as the last record's
        output."""
        if self.records:
            key = _storage_key(out)
            self._produced[key] = len(self.records) - 1
            weakref.finalize(out.untyped_storage(), self._produced.pop,
                             key, None)
        return out

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        if self.sizes[axis] == 1:
            return t
        return self._produced_by_last(super().all_gather(t, axis, dim))

    def gather(self, t: torch.Tensor, axis: str, dim: int,
               reduce: bool = False) -> torch.Tensor:
        if self.sizes[axis] == 1:
            return t
        return self._produced_by_last(super().gather(t, axis, dim, reduce))

    def counts(self) -> dict:
        """The records in :data:`COLLECTIVES`' form (``as_dict``)."""
        c = CollectiveCounts()
        for r in self.records:
            c.add(r["kind"], r["n"], r["bytes"])
        return c.as_dict()

    # -- no process group -----------------------------------------------------
    def subgroup(self, groups) -> Optional[Any]:
        """A token for this rank's group among ``groups``, of the axis
        ``model`` (the groups the placement asks for), or None when the
        group is this rank alone."""
        for g in groups:
            g = tuple(sorted(int(r) for r in g))
            if self.rank in g and len(g) > 1:
                return ("model", g)
        return None

    def barrier(self) -> None:
        return None


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


#: What the server :func:`run_mesh` forks its ranks from imports once:
#: a rank skips torch's import (~8 s a rank on the card's machine, where
#: a forked (2, 2) mesh starts in ~2 s). The server never touches CUDA,
#: so each rank builds its own context and reads the caller's CUDA
#: tensors over CUDA IPC, as a spawned rank would.
FORKSERVER_PRELOAD = ("torch", "torch.distributed", "repro_torch.launch.mesh")


def stop_forkserver() -> None:
    """Stop the server the ranks fork from, if one runs, and wait for it
    (it would notice its caller's exit only a moment after). Runs at
    exit; the next mesh after it starts a new server."""
    from multiprocessing import forkserver
    forkserver._forkserver._stop()


atexit.register(stop_forkserver)


def run_mesh(fn: Callable, shape, *args, axes=("data", "model"),
             devices: Devices = None, timeout: float = 600.0,
             threads: Optional[int] = 1) -> List[Any]:
    """Fork ``prod(shape)`` ranks from the server, run ``fn(mesh,
    *args)`` on each and return their results in rank order.

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
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(FORKSERVER_PRELOAD))
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
