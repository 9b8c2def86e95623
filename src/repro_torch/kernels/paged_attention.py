"""Paged split-KV decode attention: the kernel's wrapper and its plain
version.

Replaces ``src/repro/kernels/paged_attention.py``
``paged_decode_attention_splitkv``. The kernel
(``csrc/paged_attention.cu``) is the row-parallel split body of
``csrc/splitkv.cuh`` reading each logical row through the page table,
one table read per row: no contiguous copy of a sequence is ever made,
and a paged cache gives the contiguous kernel's bits. See the sources
for what bounds it and the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import plan as P
from repro_torch.kernels.dispatch import meta_launch
from repro_torch.kernels.decode_attention import (_check_group, check_input,
                                                  check_query,
                                                  decode_attention_plain,
                                                  splitkv_buffers,
                                                  splitkv_plan)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P, ps, ...) pool rows of each sequence's pages, as contiguous
    (B, NP * ps, ...) logical rows."""
    B, NP = page_table.shape
    rows = pages[page_table.long()]
    return rows.reshape((B, NP * pages.shape[1]) + tuple(pages.shape[2:]))


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_mask: torch.Tensor) -> torch.Tensor:
    """The reference ``xla`` implementation: gather the table's pages,
    then contiguous decode. q: (B, Hq, D); k/v_pages: (P, ps, Hkv, D);
    page_table: (B, NP) int32; kv_mask: (B, NP * ps) bool."""
    return decode_attention_plain(q, gather_pages(k_pages, page_table),
                                  gather_pages(v_pages, page_table), kv_mask)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           kv_mask: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors.
    Table entries must name pages of the pool (the caller's invariant:
    the kernel does not read them back to check). On ``meta`` the
    checks, the buffers and an empty output."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            kv_mask)
    op = "paged_decode_attention"
    B, Hq, D = q.shape
    P, ps, Hkv = k_pages.shape[:3]
    NP = page_table.shape[1]
    code = check_query(op, q, Hkv)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        check_input(op, name, t, (P, ps, Hkv, D), q.dtype, q.device,
                    aligned=True)
    check_input(op, "page_table", page_table, (B, NP), torch.int32, q.device)
    check_input(op, "kv_mask", kv_mask, (B, NP * ps), torch.bool, q.device)
    o_part, ml, out = splitkv_buffers(q, Hkv, NP * ps)
    if q.device.type == "meta":
        return meta_launch(op, out)
    err = _build.library().rt_paged_decode_attention(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(page_table), _build.ptr(kv_mask), _build.ptr(o_part),
        _build.ptr(ml[0]), _build.ptr(ml[1]), _build.ptr(out), B, NP, ps,
        Hkv, Hq // Hkv, D, code, _build.stream_handle())
    _build.check_launch(err, op)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def launch_plan(B: int, NP: int, ps: int, Hq: int, Hkv: int, D: int,
                dtype: torch.dtype) -> P.KernelPlan:
    """What :func:`paged_decode_attention` launches for q (B, Hq, D) over
    tables of ``NP`` pages of ``ps`` rows (Hkv kv heads, ``dtype``)."""
    _check_group("paged_decode_attention", Hq, Hkv)
    if ps <= 0:
        raise ValueError(f"paged_decode_attention: page size {ps}")
    return splitkv_plan("split_rows_kernel", B, NP * ps, Hkv, Hq // Hkv, D,
                        dtype, paged=True)


def library_plan(B: int, NP: int, ps: int, Hq: int, Hkv: int, D: int,
                 dtype: torch.dtype):
    """The library's plan of the same call
    (``rt_paged_decode_attention_plan``)."""
    return P.library_plan("rt_paged_decode_attention_plan", B, NP, ps, Hkv,
                          Hq // Hkv, D, P.dtype_code(dtype))
