// Split-KV decode attention over a paged int8 KV cache with per-row
// scales (body, design and bound in quant_splitkv.cuh).
//
// Replaces: src/repro/kernels/quant.py,
// quant_paged_decode_attention_splitkv (body _quant_paged_decode_kernel,
// merge in the wrapper).
#include "quant_splitkv.cuh"

// The f32 forms (quant_paged_attention_f32.cu): each dtype's kernels
// build in an nvcc process of their own, in parallel.
int quant_paged_attention_f32(const void* q, const void* k_pages,
                              const void* v_pages, const void* ks,
                              const void* vs, const void* page_table,
                              const void* mask, void* o_part, void* m_part,
                              void* l_part, void* out, int B, int NP, int ps,
                              int Hkv, int G, int D, void* stream);
int quant_paged_attention_f32_plan(int B, int NP, int ps, int Hkv, int G,
                                   int D, RtLaunch* out, int cap);

extern "C" int rt_quant_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* ks,
    const void* vs, const void* page_table, const void* mask, void* o_part,
    void* m_part, void* l_part, void* out, int B, int NP, int ps, int Hkv,
    int G, int D, int dtype, void* stream) {
  if (ps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return quant_splitkv::launch<__nv_bfloat16, true>(
        q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
        l_part, out, B, NP * ps, Hkv, G, D, ps, NP, stream);
  if (dtype == RT_F32)
    return quant_paged_attention_f32(q, k_pages, v_pages, ks, vs,
                                     page_table, mask, o_part, m_part,
                                     l_part, out, B, NP, ps, Hkv, G, D,
                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches of rt_quant_paged_decode_attention (split, then merge):
// the count, at most cap of them written to out; a negative CUDA error
// code where the call would refuse.
extern "C" int rt_quant_paged_decode_attention_plan(int B, int NP, int ps,
                                                    int Hkv, int G, int D,
                                                    int dtype, RtLaunch* out,
                                                    int cap) {
  if (ps <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return quant_splitkv::plan<__nv_bfloat16, true>(B, NP * ps, Hkv, G, D,
                                                    out, cap);
  if (dtype == RT_F32)
    return quant_paged_attention_f32_plan(B, NP, ps, Hkv, G, D, out, cap);
  return -static_cast<int>(cudaErrorInvalidValue);
}
