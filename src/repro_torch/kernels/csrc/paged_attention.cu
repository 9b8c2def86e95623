// Split-KV decode attention through a page table.
//
// Replaces: src/repro/kernels/paged_attention.py,
// paged_decode_attention_splitkv (body _paged_decode_kernel, merge in the
// wrapper): one query token per sequence against pooled (P, ps, Hkv, D)
// pages, logical page i of sequence b at physical page pt[b, i].
//
// Bound on this card: bytes, as the contiguous kernel (G flops per byte
// of K/V; G = 1 at minicpm-2b). The page table adds NP * 4 bytes per
// sequence, read from L1/L2 by every block of that sequence.
//
// Design: the contiguous kernel's row-parallel body (splitkv.cuh) with
// the row lookup j -> pt[b, j / ps] * ps + j % ps. There is no scalar
// prefetch on this card: thread t of a block reads logical row t's table
// entry with its mask bit, once, and the lanes of the row read the
// physical row index from shared memory; the pages are never gathered
// into a contiguous copy. The split is over logical rows, 128 per block
// as in the contiguous kernel, so a paged cache and a contiguous one with
// the same rows sum in the same order and give bit-identical outputs.
// Masked rows are never read, so padding entries of the table (the null
// page) cost nothing, and the ragged edge of the last page is masked by
// the caller's mask, not padded.
#include "splitkv.cuh"

// The f32 forms (paged_attention_f32.cu): each dtype's kernels build in
// an nvcc process of their own, in parallel.
int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* page_table,
                        const void* mask, void* o_part, void* m_part,
                        void* l_part, void* out, int B, int NP, int ps,
                        int Hkv, int G, int D, void* stream);
int paged_attention_f32_plan(int B, int NP, int ps, int Hkv, int G, int D,
                             RtLaunch* out, int cap);

extern "C" int rt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* mask, void* o_part, void* m_part,
    void* l_part, void* out, int B, int NP, int ps, int Hkv, int G, int D,
    int dtype, void* stream) {
  if (ps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return splitkv::launch_same<__nv_bfloat16, true>(
        q, k_pages, v_pages, page_table, mask, o_part, m_part, l_part, out,
        B, NP * ps, Hkv, G, D, ps, NP, stream);
  if (dtype == RT_F32)
    return paged_attention_f32(q, k_pages, v_pages, page_table, mask,
                               o_part, m_part, l_part, out, B, NP, ps, Hkv,
                               G, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches rt_paged_decode_attention makes (split, then merge): the
// count, at most cap of them written to out; a negative CUDA error code
// where it would refuse.
extern "C" int rt_paged_decode_attention_plan(int B, int NP, int ps, int Hkv,
                                              int G, int D, int dtype,
                                              RtLaunch* out, int cap) {
  if (ps <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return splitkv::plan_same<__nv_bfloat16, true>(B, NP * ps, Hkv, G, D,
                                                   out, cap);
  if (dtype == RT_F32)
    return paged_attention_f32_plan(B, NP, ps, Hkv, G, D, out, cap);
  return -static_cast<int>(cudaErrorInvalidValue);
}
