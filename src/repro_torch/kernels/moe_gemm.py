"""Grouped expert GEMM: sorting rows by expert, the CUDA kernel's wrapper
and the plain PyTorch versions.

Replaces ``src/repro/kernels/moe_gemm.py`` ``grouped_gemm_padded``. The
``moe_gemm`` op computes ``out[t] = x[t] @ w[expert_of_row[t]]``:

* :func:`moe_gemm` (the ``cuda`` impl) sorts the rows by expert into
  :data:`BLOCK_M`-row blocks that each belong to one expert
  (:func:`sort_by_expert`), runs :func:`grouped_gemm_padded` over the
  blocks and gathers the real rows back into the caller's order;
* :func:`moe_gemm_plain` (the ``torch`` impl) loops over the experts
  present: the rows of expert ``e`` times ``w[e]``. It computes the
  reference ``xla`` gather ``einsum(x, w[expert_of_row])`` without
  materialising one ``(d, f)`` matrix per row, so it fits at full width;
* :func:`moe_gemm_glu` is what the dropless MoE layer runs under the
  ``cuda`` impl: its three expert products (gate, up, down) share one
  sorted layout, so the layer sorts its routed rows once, not once per
  product, and gathers the real rows back once.

A row whose ``expert_of_row`` is ``n_experts`` belongs to no expert here
(an expert-parallel rank's row routed to another rank's expert): every
version leaves it out of the products and gives it a zero output row,
so the layer keeps a fixed number of rows and no shape depends on the
routing.

Every version multiplies in float32 and casts the result to ``x``'s
dtype once, as the Pallas body does. See ``csrc/moe_gemm.cu`` for what
bounds the kernel and its design.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import plan as P
from repro_torch.kernels.dispatch import meta_launch

#: Rows per block of the sorted layout: the kernel's one block height.
BLOCK_M = 64


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each of ``0..n-1`` in ``idx`` (int64). A
    scatter-add of ones: ``torch.bincount`` reads the maximum back to the
    host on CUDA, which would sync every expert GEMM."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def sort_by_expert(x: torch.Tensor, expert_of_row: torch.Tensor,
                   n_experts: int, block_m: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Sort rows by expert and pad each group to a ``block_m`` multiple,
    as the reference's ``sort_by_expert`` does, in torch ops and without
    a host sync (the stable argsort and the counts stay on the device).

    Returns ``(x_pad (Tp, d), block_expert (nb,) int32, inv (T,) int64,
    Tp)``: ``x_pad[inv] == x`` for every row of an expert, padding rows
    are zero, and each block's expert is ``block_expert``. ``Tp =
    ceil(T / block_m) * block_m + (n_experts - 1) * block_m`` is a
    static bound (every group wastes fewer than ``block_m`` rows); the
    blocks past the last group get ``block_expert == n_experts``, which
    names no expert: nothing may read ``w`` for them. A row of no expert
    (``expert_of_row == n_experts``) is left out: its ``inv`` is
    ``Tp``."""
    T = x.shape[0]
    dev = x.device
    eor = expert_of_row.long()
    order = torch.argsort(eor, stable=True)
    sizes = _counts(eor, n_experts + 1)[:n_experts]
    padded = (sizes + block_m - 1) // block_m * block_m
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    pad_off = torch.cat([zero, torch.cumsum(padded, 0)])
    csizes = torch.cat([zero, torch.cumsum(sizes, 0)])
    e_sorted = eor[order]
    Tp = -(-T // block_m) * block_m + (n_experts - 1) * block_m
    dest = torch.where(e_sorted < n_experts, pad_off[e_sorted]
                       + torch.arange(T, device=dev) - csizes[e_sorted], Tp)
    x_pad = x.new_zeros((Tp + 1,) + tuple(x.shape[1:]))
    x_pad[dest] = x[order]                  # rows of no expert: row Tp
    x_pad = x_pad[:Tp]
    starts = torch.arange(0, Tp, block_m, device=dev)
    block_expert = torch.searchsorted(pad_off[1:], starts, right=True)
    inv = torch.empty_like(dest)
    inv[order] = dest
    return x_pad, block_expert.to(torch.int32), inv, Tp


def block_rows(inv: torch.Tensor, n_blocks: int, block_m: int
               ) -> torch.Tensor:
    """Real rows in each block (int32): a group's rows fill its blocks
    from the top, so a block's real rows are a prefix of it. Trailing
    blocks, and only they, have 0; a row of no expert (``inv`` past the
    last block) counts in none."""
    return _counts(inv // block_m, n_blocks + 1)[:n_blocks].to(torch.int32)


def grouped_gemm_padded_plain(x_pad: torch.Tensor, w: torch.Tensor,
                              block_expert: torch.Tensor,
                              rows: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each block's first
    ``rows[i]`` rows times ``w[block_expert[i]]``, f32 products cast to
    ``x_pad``'s dtype. Padding rows come out zero (the kernel leaves
    them unwritten; nothing reads them)."""
    Tp, nb = x_pad.shape[0], block_expert.shape[0]
    bm = Tp // nb
    real = (torch.arange(bm, device=x_pad.device)[None, :]
            < rows[:, None].long()).reshape(Tp)
    row_expert = block_expert.long().repeat_interleave(bm)
    out = x_pad.new_zeros((Tp, w.shape[-1]))
    for e in torch.unique(row_expert[real]).tolist():
        idx = torch.nonzero(real & (row_expert == e))[:, 0]
        out[idx] = (x_pad[idx].float() @ w[e].float()).to(out.dtype)
    return out


def grouped_gemm_padded(x_pad: torch.Tensor, w: torch.Tensor,
                        block_expert: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors.
    x_pad (Tp, d); w (E, d, f); block_expert, rows (nb,) int32, with
    ``Tp == nb * BLOCK_M``. Only the real rows of the output are
    written. On ``meta`` the checks and an empty output."""
    if x_pad.device.type == "cpu":
        return grouped_gemm_padded_plain(x_pad, w, block_expert, rows)
    Tp, d = x_pad.shape
    E, dw, f = w.shape
    nb = block_expert.shape[0]
    for name, t in (("w", w), ("block_expert", block_expert),
                    ("rows", rows)):
        if t.device != x_pad.device:
            raise ValueError(f"moe_gemm: {name} on {t.device}, x on "
                             f"{x_pad.device}")
    if x_pad.device.type not in _build.KERNEL_DEVICES:
        raise ValueError(f"moe_gemm: tensors on {x_pad.device}")
    if w.dtype != x_pad.dtype or dw != d:
        raise ValueError(f"moe_gemm: w {tuple(w.shape)} {w.dtype} does not "
                         f"match x {tuple(x_pad.shape)} {x_pad.dtype}")
    if block_expert.dtype != torch.int32 or rows.dtype != torch.int32 \
            or tuple(rows.shape) != (nb,):
        raise ValueError("moe_gemm: block_expert and rows must be int32 of "
                         "one length")
    if nb == 0 or Tp != nb * BLOCK_M:
        raise ValueError(f"moe_gemm: block height {Tp}/{nb}, not "
                         f"{BLOCK_M}")
    if not all(t.is_contiguous() for t in (x_pad, w, block_expert, rows)):
        raise ValueError("moe_gemm: inputs must be contiguous")
    code = _build.dtype_code(x_pad)
    out = torch.empty((Tp, f), dtype=x_pad.dtype, device=x_pad.device)
    if x_pad.device.type == "meta":
        return meta_launch("moe_gemm", out)
    err = _build.library().rt_moe_gemm(
        _build.ptr(x_pad), _build.ptr(w), _build.ptr(block_expert),
        _build.ptr(rows), _build.ptr(out), nb, d, f, E, code,
        _build.stream_handle())
    _build.check_launch(err, "moe_gemm")
    grouped_gemm_padded.launches += 1
    return out


grouped_gemm_padded.launches = 0


def moe_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                   expert_of_row: torch.Tensor, *,
                   n_experts: int) -> torch.Tensor:
    """x (T, d); w (E, d, f); expert_of_row (T,) -> (T, f): the rows of
    each expert present times its weights, f32 products cast to x's
    dtype, a row of no expert (``n_experts``) zero. On ``meta``, where
    there is no routing to loop over, the reference's gather
    ``einsum(x, w[expert_of_row])``: the same shapes, dtype and
    autograd."""
    eor = expert_of_row.long()
    if x.device.type == "meta":
        return torch.einsum("td,tdf->tf", x.float(),
                            w[eor].float()).to(x.dtype)
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for e in torch.unique(eor).tolist():
        if e == n_experts:
            continue
        idx = torch.nonzero(eor == e)[:, 0]
        out[idx] = (x[idx].float() @ w[e].float()).to(out.dtype)
    return out


def sorted_layout(x: torch.Tensor, expert_of_row: torch.Tensor,
                  n_experts: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """:func:`sort_by_expert` and :func:`block_rows` at :data:`BLOCK_M`:
    ``(x_pad, block_expert, rows, inv)``, the arguments of
    :func:`grouped_gemm_padded` and the gather back to ``x``'s order.
    It depends on ``(expert_of_row, n_experts)`` alone, so every product
    over the same routing can share it."""
    x_pad, be, inv, Tp = sort_by_expert(x, expert_of_row, n_experts,
                                        BLOCK_M)
    return x_pad, be, block_rows(inv, Tp // BLOCK_M, BLOCK_M), inv


def unsort(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """The rows of ``y`` (the grouped GEMM's output) back in the
    caller's order (``y[inv]``), a row of no expert (``inv`` past
    ``y``) zero."""
    Tp = y.shape[0]
    return y[inv.clamp(max=Tp - 1)].masked_fill((inv == Tp)[:, None], 0)


def moe_gemm(x: torch.Tensor, w: torch.Tensor, expert_of_row: torch.Tensor,
             *, n_experts: int) -> torch.Tensor:
    """Sort by expert, the grouped GEMM (the kernel on the card), and the
    gather of the real rows back into ``x``'s row order."""
    x_pad, be, rows, inv = sorted_layout(x, expert_of_row, n_experts)
    return unsort(grouped_gemm_padded(x_pad, w, be, rows), inv)


def moe_gemm_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, expert_of_row: torch.Tensor, act,
                 *, n_experts: int) -> torch.Tensor:
    """``act(x @ w_gate[e], x @ w_up[e]) @ w_down[e]`` for each row's
    expert ``e``: the three products of a gated expert FFN as three
    :func:`grouped_gemm_padded` calls on one sorted layout. x (T, d);
    w_gate, w_up (E, d, f); w_down (E, f, d_out) -> (T, d_out).

    ``act`` runs elementwise over the padded rows too. Their values are
    whatever the first two products left there, and nothing reads them:
    the kernel and the plain version read only each block's first
    ``rows[i]`` rows. Each real row's result equals :func:`moe_gemm`'s
    three calls bit for bit, since the layout is the same each time."""
    x_pad, be, rows, inv = sorted_layout(x, expert_of_row, n_experts)
    h = act(grouped_gemm_padded(x_pad, w_gate, be, rows),
            grouped_gemm_padded(x_pad, w_up, be, rows))
    return unsort(grouped_gemm_padded(h, w_down, be, rows), inv)


#: Output columns a block of the f32 body and of the bf16 tensor-core
#: body (``csrc/moe_gemm.cu`` BN, MMA_BN).
SIMT_COLS, MMA_COLS = 64, 128


def balanced_routing(T: int, E: int) -> np.ndarray:
    """Row t routed to expert t mod E: the routing a plan assumes where
    the data is not known (``meta`` tensors)."""
    return np.arange(T, dtype=np.int64) % max(E, 1)


def layout_of(expert_of_row, E: int) -> Tuple[np.ndarray, np.ndarray]:
    """(block_expert, block_rows) of :func:`sorted_layout` for this
    routing, on the host: each expert's rows fill ``ceil(size / BLOCK_M)``
    blocks from the top, in expert order; the blocks past the last group
    name expert E and hold no row."""
    eor = np.asarray(expert_of_row, dtype=np.int64).reshape(-1)
    T = eor.shape[0]
    sizes = np.bincount(eor, minlength=E)[:E]
    nb = P.cdiv(T, BLOCK_M) + (E - 1)
    be = np.full(nb, E, dtype=np.int64)
    rows = np.zeros(nb, dtype=np.int64)
    i = 0
    for e, n in enumerate(sizes.tolist()):
        for r in range(P.cdiv(n, BLOCK_M)):
            be[i], rows[i] = e, min(BLOCK_M, n - r * BLOCK_M)
            i += 1
    return be, rows


def launch_plan(nb: int, d: int, f: int, E: int, dtype: torch.dtype,
                block_expert=None, block_rows=None) -> P.KernelPlan:
    """What :func:`grouped_gemm_padded` launches for ``nb`` blocks of
    :data:`BLOCK_M` rows of d (``dtype``) against (E, d, f) weights
    (``csrc/moe_gemm.cu`` ``dispatch``, by dtype alone): f32 one block a
    (row block, 64 columns); bf16 one CTA a (row block, 128 columns), where
    the CTA at an even position of its expert's group also writes the
    group's next block and the odd one returns. A block with no real row
    writes nothing, and its rows are never read: given the layout
    (``block_expert``, ``block_rows``) the output tiles map exactly; without
    it, every block is taken to hold rows of its own expert."""
    tn = P.type_name(dtype)
    Tp = nb * BLOCK_M
    results = (((Tp, f), dtype),)
    if nb <= 0:
        raise ValueError(f"moe_gemm: block height {Tp}/{nb}, not {BLOCK_M}")
    if f <= 0:
        return P.KernelPlan((), results)
    if block_expert is None:
        be = np.arange(nb, dtype=np.int64) % max(E, 1)
        rows = np.full(nb, BLOCK_M, dtype=np.int64)
    else:
        be = np.asarray(block_expert, dtype=np.int64).reshape(-1)
        rows = np.asarray(block_rows, dtype=np.int64).reshape(-1)
    live = (rows > 0) & (be >= 0) & (be < E)
    if dtype == torch.bfloat16:
        cols, threads, name, static = MMA_COLS, 256, "moe_gemm_mma", 0
        smem = 2 * 3 * (2 * BLOCK_M * 72 + 64 * (MMA_COLS + 8))
        # position of each block in its expert's run of blocks
        start = np.ones(nb, dtype=bool)
        start[1:] = be[1:] != be[:-1]
        first = np.maximum.accumulate(np.where(start, np.arange(nb), 0))
        even = (np.arange(nb) - first) % 2 == 0
        pair = np.zeros(nb, dtype=bool)
        pair[:-1] = be[1:] == be[:-1]
        own = np.where(live & even, np.arange(nb), -1)
        nxt = np.where(live & even & pair, np.arange(nb) + 1, -1)

        def tiles(bx, by, bz):
            return [(own[bx], by), (nxt[bx], by)]
    else:
        cols, threads, name, smem = SIMT_COLS, 256, f"moe_gemm_kernel<{tn}>", 0
        static = 2 * 4 * 64 * (64 + 4)
        own = np.where(live, np.arange(nb), -1)

        def tiles(bx, by, bz):
            return [(own[bx], by)]

    ncol = P.cdiv(f, cols)
    required = np.repeat((rows > 0)[:, None], ncol, axis=1)
    out = P.Output("out", (Tp, f), dtype, (BLOCK_M, cols), tiles,
                   required=required)
    return P.KernelPlan((P.Launch(name, P.grid3(nb, ncol), P.grid3(threads),
                                  static, smem, (out,)),), results)


def library_plan(nb: int, d: int, f: int, E: int, dtype: torch.dtype,
                 block_expert=None, block_rows=None):
    """The library's plan of the same call (``rt_moe_gemm_plan``)."""
    return P.library_plan("rt_moe_gemm_plan", nb, f, P.dtype_code(dtype))


def moe_gemm_plan(T: int, d: int, f: int, E: int, dtype: torch.dtype,
                  expert_of_row=None) -> P.KernelPlan:
    """What :func:`moe_gemm` launches for x (T, d) of ``dtype`` routed by
    ``expert_of_row`` (a host array, or None for :func:`balanced_routing`)
    over E experts: the grouped GEMM over the sorted layout's static
    bound of blocks; the rows gathered back are (T, f)."""
    if expert_of_row is None:
        expert_of_row = balanced_routing(T, E)
    be, rows = layout_of(expert_of_row, E)
    plan = launch_plan(len(be), d, f, E, dtype, be, rows)
    return P.KernelPlan(plan.launches, (((T, f), dtype),))


def moe_gemm_library_plan(T: int, d: int, f: int, E: int,
                          dtype: torch.dtype, expert_of_row=None):
    return library_plan(P.cdiv(T, BLOCK_M) + E - 1, d, f, E, dtype)
