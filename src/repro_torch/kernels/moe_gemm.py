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
  materialising one ``(d, f)`` matrix per row, so it fits at full width.

Every version multiplies in float32 and casts the result to ``x``'s
dtype once, as the Pallas body does. See ``csrc/moe_gemm.cu`` for what
bounds the kernel and its design.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

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
    Tp)``: ``x_pad[inv] == x``, padding rows are zero, and each block's
    expert is ``block_expert``. ``Tp = ceil(T / block_m) * block_m +
    (n_experts - 1) * block_m`` is a static bound (every group wastes
    fewer than ``block_m`` rows); the blocks past the last group get
    ``block_expert == n_experts``, which names no expert: nothing may
    read ``w`` for them."""
    T = x.shape[0]
    dev = x.device
    eor = expert_of_row.long()
    order = torch.argsort(eor, stable=True)
    sizes = _counts(eor, n_experts)
    padded = (sizes + block_m - 1) // block_m * block_m
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    pad_off = torch.cat([zero, torch.cumsum(padded, 0)])
    csizes = torch.cat([zero, torch.cumsum(sizes, 0)])
    e_sorted = eor[order]
    dest = pad_off[e_sorted] + torch.arange(T, device=dev) - csizes[e_sorted]
    Tp = -(-T // block_m) * block_m + (n_experts - 1) * block_m
    x_pad = x.new_zeros((Tp,) + tuple(x.shape[1:]))
    x_pad[dest] = x[order]
    starts = torch.arange(0, Tp, block_m, device=dev)
    block_expert = torch.searchsorted(pad_off[1:], starts, right=True)
    inv = torch.empty_like(dest)
    inv[order] = dest
    return x_pad, block_expert.to(torch.int32), inv, Tp


def block_rows(inv: torch.Tensor, n_blocks: int, block_m: int
               ) -> torch.Tensor:
    """Real rows in each block (int32): a group's rows fill its blocks
    from the top, so a block's real rows are a prefix of it. Trailing
    blocks, and only they, have 0."""
    return _counts(inv // block_m, n_blocks).to(torch.int32)


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
    written."""
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
    if x_pad.device.type != "cuda":
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
    dtype."""
    del n_experts
    eor = expert_of_row.long()
    out = x.new_empty((x.shape[0], w.shape[-1]))
    for e in torch.unique(eor).tolist():
        idx = torch.nonzero(eor == e)[:, 0]
        out[idx] = (x[idx].float() @ w[e].float()).to(out.dtype)
    return out


def moe_gemm(x: torch.Tensor, w: torch.Tensor, expert_of_row: torch.Tensor,
             *, n_experts: int) -> torch.Tensor:
    """Sort by expert, the grouped GEMM (the kernel on the card), and the
    gather of the real rows back into ``x``'s row order."""
    x_pad, be, inv, Tp = sort_by_expert(x, expert_of_row, n_experts,
                                        BLOCK_M)
    rows = block_rows(inv, Tp // BLOCK_M, BLOCK_M)
    return grouped_gemm_padded(x_pad, w, be, rows)[inv]
