"""Launch plans of the port's CUDA kernels.

A :class:`KernelPlan` says what one wrapper call launches, without
launching it: per launch the kernel's name, its grid and block, its
static and dynamic shared memory and, for each buffer the launch writes,
the buffer's shape and dtype and a vectorised map from a block index to
the tile of the buffer that block writes (the counterpart of a Pallas
BlockSpec's index map); and the shapes and dtypes the wrapper returns.
Each wrapper module has a ``launch_plan`` (``quant.py`` and
``moe_gemm.py`` one per wrapper) that raises where the wrapper would
refuse; ``repro_torch.analysis.kernel_validator`` checks them on the host.

The library computes the same geometry in C++: in each source one
dispatch function makes the body choice and one ``plan_*`` function per
kernel the launch arithmetic, and both the ``<<<...>>>`` site and the
source's ``rt_*_plan`` export go through them (``csrc/plan.cuh``).
:func:`library_plan` reads such an export and :func:`kernel_attributes`
a kernel's registers, shared memory and occupancy, on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

#: The most launches a wrapper call makes (the SSD scan's three).
MAX_LAUNCHES = 8

#: One thread block's limits on sm_90: the opt-in shared memory a block
#: (227 KiB), threads a block, and the grid's y and z extents.
SMEM_OPTIN_BYTES = 232448
MAX_BLOCK_THREADS = 1024
MAX_GRID_YZ = 65535
#: 32-bit registers an SM (and so at most a block).
REGISTERS_PER_SM = 65536

Coords = Tuple[np.ndarray, ...]
#: (bx, by, bz) flat arrays over the grid's blocks -> one tuple of tile
#: coordinates per write slot; a block writes nothing into a slot where
#: its first coordinate is negative.
TileMap = Callable[[np.ndarray, np.ndarray, np.ndarray], Sequence[Coords]]


@dataclass(frozen=True)
class Output:
    """A buffer a launch writes: the wrapper's ``torch.empty`` (or a view
    of one), tiled as ``view`` (default ``shape``) in tiles of ``tile``;
    ``tiles`` maps each block to the tile(s) it writes. ``required``,
    over the grid of tiles, marks the tiles the consumer reads (default:
    every tile)."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    tile: Tuple[int, ...]
    tiles: TileMap
    view: Optional[Tuple[int, ...]] = None
    required: Optional[np.ndarray] = field(default=None, compare=False)

    @property
    def tiled_shape(self) -> Tuple[int, ...]:
        return tuple(self.view if self.view is not None else self.shape)

    @property
    def tile_grid(self) -> Tuple[int, ...]:
        return tuple(max(1, -(-d // t))
                     for d, t in zip(self.tiled_shape, self.tile))


@dataclass(frozen=True)
class Launch:
    """One kernel launch as the host code issues it."""

    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem_static: int
    smem_dynamic: int
    outputs: Tuple[Output, ...] = ()
    accumulates: bool = False

    @property
    def threads(self) -> int:
        return int(np.prod(self.block))

    def geometry(self) -> Tuple[str, Tuple[int, ...], Tuple[int, ...], int]:
        """What the library's plan export reports: name, grid, block and
        dynamic shared memory."""
        return (self.kernel, tuple(self.grid), tuple(self.block),
                int(self.smem_dynamic))


@dataclass(frozen=True)
class KernelPlan:
    """The launches of one wrapper call, in order, and the shapes and
    dtypes the wrapper returns."""

    launches: Tuple[Launch, ...]
    results: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]

    def geometry(self):
        return [launch.geometry() for launch in self.launches]


def grid3(*g: int) -> Tuple[int, int, int]:
    g = tuple(int(x) for x in g) + (1,) * (3 - len(g))
    return g[0], g[1], g[2]


def cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def last_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def type_name(dtype: torch.dtype) -> str:
    """The kernels' name for a dtype, as ``csrc/plan.cuh`` prints it;
    raises for a dtype the kernels do not take."""
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    if dtype not in names:
        raise TypeError(f"dtype {dtype} is not supported by the kernels "
                        f"(float32, bfloat16)")
    return names[dtype]


def dtype_code(dtype: torch.dtype) -> int:
    """The library's code for ``dtype`` (``_build.DTYPE_CODES``)."""
    type_name(dtype)
    return _build.DTYPE_CODES[str(dtype)]


# ===========================================================================
# The library's plans and kernel attributes (on the card)
# ===========================================================================
class RtLaunch(ctypes.Structure):
    """``struct RtLaunch`` of ``csrc/plan.cuh``."""

    _fields_ = [("func", ctypes.c_void_p), ("name", ctypes.c_char * 96),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("smem", ctypes.c_ulonglong)]


@dataclass(frozen=True)
class LibraryLaunch:
    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem_dynamic: int
    func: int

    def geometry(self):
        return (self.kernel, tuple(self.grid), tuple(self.block),
                int(self.smem_dynamic))


def library_plan(export: str, *args: int) -> Tuple[LibraryLaunch, ...]:
    """The launches the library's ``export`` (an ``rt_*_plan``) reports
    for ``args``; raises where the launch function would refuse."""
    lib = _build.library()
    buf = (RtLaunch * MAX_LAUNCHES)()
    n = getattr(lib, export)(*args, buf, MAX_LAUNCHES)
    if n < 0:
        raise ValueError(f"{export}{args}: the library refuses the call "
                         f"(CUDA error {-n}: "
                         f"{lib.rt_error_string(-n).decode()})")
    if n > MAX_LAUNCHES:
        raise RuntimeError(f"{export}: {n} launches, past {MAX_LAUNCHES}")
    return tuple(LibraryLaunch(
        buf[i].name.decode(), tuple(buf[i].grid), tuple(buf[i].block),
        int(buf[i].smem), int(buf[i].func or 0)) for i in range(n))


ATTRIBUTE_KEYS = ("registers", "smem_static", "local_bytes",
                  "max_threads", "max_dynamic_smem", "blocks_per_sm",
                  "smem_optin", "sms")


def kernel_attributes(launch: LibraryLaunch) -> dict:
    """``cudaFuncGetAttributes`` of the launch's kernel, and its resident
    blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) at
    the launch's block and dynamic shared memory; raises on a CUDA
    error."""
    lib = _build.library()
    out = (ctypes.c_longlong * len(ATTRIBUTE_KEYS))()
    err = lib.rt_kernel_attributes(
        ctypes.c_void_p(launch.func), int(np.prod(launch.block)),
        ctypes.c_ulonglong(launch.smem_dynamic), out)
    if err:
        raise RuntimeError(f"attributes of {launch.kernel}: CUDA error "
                           f"{err} ({lib.rt_error_string(err).decode()})")
    return dict(zip(ATTRIBUTE_KEYS, (int(v) for v in out)))
