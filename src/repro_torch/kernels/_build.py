"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` process per source, all started together), linked into one
shared library with a plain C interface, and loaded with ``ctypes``.
The library lands in ``kernels/_build/<hash>/``, where the hash covers
the sources and the flags, so a changed source rebuilds and an
unchanged one is reused.

Nothing falls back: a missing ``nvcc``, a compile error or a non-zero
CUDA error code after a launch raises, with nvcc's stderr or the CUDA
error string.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_ROOT = HERE / "_build"
CUDA_HOME_DEFAULT = "/usr/local/cuda"
LIB_NAME = "librepro_torch_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: ``argtypes`` of every exported function: pointers and the stream as
#: ``c_void_p`` (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    # x, scale, out, rows, d, eps, dtype, stream
    "rt_rmsnorm": (_P, _P, _P, _L, _I, _F, _I, _P),
    # q, k, v, out, B, S, T, Hq, Hkv, D, causal, window, chunk, dtype,
    # stream
    "rt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _P),
    # q, k, v, mask, o_part, m_part, l_part, out, B, W, Hkv, G, D, dtype,
    # stream
    "rt_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _P),
    # q, k_pages, v_pages, page_table, mask, o_part, m_part, l_part, out,
    # B, NP, ps, Hkv, G, D, dtype, stream
    "rt_paged_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, ks, vs, mask, o_part, m_part, l_part, out, B, W, Hkv, G, D,
    # dtype, stream
    "rt_quant_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P),
    # q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
    # l_part, out, B, NP, ps, Hkv, G, D, dtype, stream
    "rt_quant_paged_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                        _P),
    # x_pad, w, block_expert, block_rows, out, nb, d, f, E, dtype, stream
    "rt_moe_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, dt, A, B, C, y, h, ws, b, S, nh, hp, N, L, dtype, stream
    "rt_ssd_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _P),
    # x, w_q, scale, out, T, K, N, dtype, stream
    "rt_quant_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the plan exports (csrc/plan.cuh): the launch function's sizes, then
    # an RtLaunch array and its capacity; each returns the launch count
    # rows, d, dtype, scale_aligned
    "rt_rmsnorm_plan": (_L, _I, _I, _I, _P, _I),
    # B, S, T, Hq, D, chunk, dtype, aligned
    "rt_flash_attention_plan": (_I, _I, _I, _I, _I, _I, _I, _I, _P, _I),
    # B, W, Hkv, G, D, dtype
    "rt_decode_attention_plan": (_I, _I, _I, _I, _I, _I, _P, _I),
    "rt_quant_decode_attention_plan": (_I, _I, _I, _I, _I, _I, _P, _I),
    # B, NP, ps, Hkv, G, D, dtype
    "rt_paged_decode_attention_plan": (_I, _I, _I, _I, _I, _I, _I, _P, _I),
    "rt_quant_paged_decode_attention_plan": (_I, _I, _I, _I, _I, _I, _I, _P,
                                             _I),
    # nb, f, dtype
    "rt_moe_gemm_plan": (_I, _I, _I, _P, _I),
    # b, S, nh, hp, N, L, dtype
    "rt_ssd_scan_plan": (_I, _I, _I, _I, _I, _I, _I, _P, _I),
    # T, K, N, dtype
    "rt_quant_matmul_plan": (_I, _I, _I, _I, _P, _I),
    # kernel, block threads, dynamic smem, out[8]
    "rt_kernel_attributes": (_P, _I, ctypes.c_ulonglong, _P),
}

#: dtype codes shared with ``csrc/common.cuh``.
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin``, else the toolkit's
    default prefix. Raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or CUDA_HOME_DEFAULT
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        f"nvcc not found on PATH or under {home}/bin: the CUDA kernels "
        f"of repro_torch need the CUDA toolkit to build")


def build_library(out_root: Path = BUILD_ROOT,
                  nvcc: Optional[str] = None) -> Path:
    """Compile every ``csrc/*.cu`` and link the shared library; returns
    its path. Reuses a library built from the same sources and flags."""
    srcs = sources()
    out_dir = Path(out_root) / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = nvcc or find_nvcc()
    Path(out_root).mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_root))
    try:
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log, failed = [], []
        for src, obj, proc in procs:
            out, err = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}{err}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(log))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}"
                   f"{link.stderr}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)     # atomic publish of the whole dir
        except OSError:
            if not lib.is_file():        # lost a race only if it exists
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = library().rt_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {what} failed: error {code} "
                           f"({msg})")


#: Devices a kernel wrapper takes past its plain version: ``cuda``
#: launches the kernel, ``meta`` runs the wrapper's checks and
#: allocations and returns empty outputs (``dispatch.meta_launch``).
KERNEL_DEVICES = ("cuda", "meta")


def dtype_code(t) -> int:
    try:
        return DTYPE_CODES[str(t.dtype)]
    except KeyError:
        raise TypeError(f"dtype {t.dtype} is not supported by the kernels "
                        f"(float32, bfloat16)") from None


#: The instantiations that served bf16 shapes run, as (label, pattern
#: of ptxas' mangled name): the SSD scan's kernels at hp 64 (mamba2-1.3b
#: and zamba2-2.7b; 64 columns a block), RMSNorm's row-in-registers
#: body at 16 rows or more (32 threads a row: 16 vectors of 4 a thread
#: at d 2048, 32 at 2304, 2560, 3584 and 4096, 2 at stablelm-12b's
#: qk-norm width 160; zamba2's gated norm at d 5120, 40 vectors a
#: thread, rereads its row) and at 4 rows (128 threads a row), and the
#: split-KV kernels past G 1 (the G-1 ones ``chip_smoke.py`` lists
#: apart): D 128 in bucket 8 (qwen2-vl-7b's G 7, starcoder2-3b's 12 and
#: chatglm3-6b's 16, two blocks of 6 or 8 heads), D 160 in bucket 4
#: (stablelm-12b, bf16 and int8 KV), and flash's D-80 body (bf16 served,
#: f32 in the parity checks). The host code chooses which one a
#: shape runs (``dispatch`` in ``csrc/ssd_scan.cu``, ``csrc/rmsnorm.cu``
#: and ``csrc/splitkv.cuh``; the launch plans of ``kernels/plan.py``
#: name the same instantiations): a change there must be made here too. ``chip_smoke.py`` prints their registers and spills, and the card
#: tests hold each to no spill.
SERVED_BUILDS = (
    ("ssd_chunk_state<bf16, 64 columns>",
     r"ssd_chunk_stateI13__nv_bfloat16Li4E"),
    ("ssd_state_pass", r"ssd_state_pass"),
    ("ssd_chunk_out<bf16, 64 columns>",
     r"ssd_chunk_outI13__nv_bfloat16Li4E"),
    ("rmsnorm_vec<bf16, 32 threads, 16 vectors> (d 2048)",
     r"rmsnorm_vecI13__nv_bfloat16Li32ELi16E"),
    ("rmsnorm_vec<bf16, 32 threads, 32 vectors> (d 2304, 2560, 4096)",
     r"rmsnorm_vecI13__nv_bfloat16Li32ELi32E"),
    ("rmsnorm_wide<bf16, 32 threads> (d 5120)",
     r"rmsnorm_wideI13__nv_bfloat16Li32EE"),
    ("rmsnorm_vec<bf16, 128 threads, 4 vectors> (d 2048, 4 rows)",
     r"rmsnorm_vecI13__nv_bfloat16Li128ELi4E"),
    ("rmsnorm_vec<bf16, 128 threads, 8 vectors> (d 2304, 2560, 4096, 4 "
     "rows)", r"rmsnorm_vecI13__nv_bfloat16Li128ELi8E"),
    ("rmsnorm_vec<bf16, 128 threads, 16 vectors> (d 5120, 4 rows)",
     r"rmsnorm_vecI13__nv_bfloat16Li128ELi16E"),
    ("rmsnorm_vec<bf16, 32 threads, 2 vectors> (d 160, stablelm-12b's "
     "qk-norm)", r"rmsnorm_vecI13__nv_bfloat16Li32ELi2E"),
    ("split_rows_kernel<bf16, D 128, bucket 8, contiguous> (G 7, 12, 16)",
     r"split_rows_kernelI13__nv_bfloat16Li128ELi8ELb0E"),
    ("split_rows_kernel<bf16, D 128, bucket 8, paged> (G 7, 12, 16)",
     r"split_rows_kernelI13__nv_bfloat16Li128ELi8ELb1E"),
    ("split_rows_kernel<bf16, D 160, bucket 4, contiguous> (G 4)",
     r"split_rows_kernelI13__nv_bfloat16Li160ELi4ELb0E"),
    ("split_rows_kernel<bf16, D 160, bucket 4, paged> (G 4)",
     r"split_rows_kernelI13__nv_bfloat16Li160ELi4ELb1E"),
    ("quant_split_kernel<bf16 q, D 160, bucket 4, contiguous> (G 4)",
     r"quant_split_kernelI13__nv_bfloat16Li160ELi4ELb0E"),
    ("quant_split_kernel<bf16 q, D 160, bucket 4, paged> (G 4)",
     r"quant_split_kernelI13__nv_bfloat16Li160ELi4ELb1E"),
    ("flash_fwd_chunked<bf16, 80> (zamba2-2.7b, hubert-xlarge)",
     r"flash_fwd_chunkedI13__nv_bfloat16Li80EE"),
    ("flash_fwd_chunked<f32, 80> (the f32 parity checks)",
     r"flash_fwd_chunkedIfLi80EE"),
)


def ptxas_entries(log: str) -> List[Tuple[str, int, int]]:
    """(mangled name, registers, bytes of spill stores) of every entry
    function in a build log (``build.log`` beside the library: ``-Xptxas
    -v`` prints each)."""
    entries = []
    for entry in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if regs is None or spill is None:
            raise ValueError(f"ptxas entry without registers or spills: "
                             f"{entry[:200]}")
        entries.append((entry.split("'")[1], int(regs.group(1)),
                        int(spill.group(1))))
    return entries


def stream_handle():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
